"""Where the time of a train step goes, on the card.

    python -m mcan_vqa_tpu_torch.cli.profile_train [--model large]
        [--steps 5] [--batch 64] [--in_kernel_dropout {0,1}]

Builds the ``Trainer`` at MCAN-small width (or MCAN-large, whose batch of
64 is two micro-batches of 32; random weights from a seed) on
``SyntheticVQADataset(answer_size=3129)``, its fused blocks drawing their
dropout inside the kernels as the Trainer does on the card
(``--in_kernel_dropout 1``, the default) or reading generator masks
(``0``), and times its step two ways:

  * ``loader``: the Trainer's own loop, batches assembled on the host by
    ``BatchLoader`` while the card trains (host clock, synchronised);
  * ``preloaded``: the same step on batches already on the card, first
    by the host clock alone, then under ``torch.profiler``: ms per step
    (the profiler's own host cost included), the device's busy time (the
    union of its kernel and copy intervals) and idle share against the
    unprofiled step, device events per step, the generator's mask draws
    per step (host calls of ``uniform_`` / ``random_``), and device time by
    kernel group (the port's kernels by name, PyTorch's random-number
    kernels, GEMMs, elementwise and reduction kernels, copies) with the
    largest PyTorch kernels by name.

Prints one JSON line with every number last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import torch

# the port's kernels by name, checked before the library groups: the
# Hopper GEMMs' "sm90::gemm_sm90_kernel<...>" would otherwise count as
# cuBLAS ("sm90_"). Its forward instances (layout 3, NN: gemm_bias_act)
# form a group of their own, apart from the backward ones (NT, TN). Each
# group gathers the kernels named beside it: the attention forward's
# one-block and long instances as "masked_attention_kernel", the attention
# backward's as "masked_attention_bwd_kernel", each LayerNorm's rolled
# instance (the widths other than 256, 512, 1024) with its row kernel.
GEMM_SM90_NN = "gemm_sm90_kernel<3,"
PORT_KERNELS = (
    ("gemm_sm90_kernel", ("gemm_sm90_kernel",)),
    ("masked_attention_bwd_kernel", ("masked_attention_bwd_kernel",
                                     "attention_bwd_rows_kernel",
                                     "attention_bwd_keys_kernel")),
    ("masked_attention_kernel", ("masked_attention_kernel",
                                 "masked_attention_long_kernel")),
    ("residual_layernorm_bwd_kernel",
     ("residual_layernorm_bwd_kernel",
      "residual_layernorm_bwd_rolled_kernel")),
    ("residual_layernorm_kernel", ("residual_layernorm_kernel",
                                   "residual_layernorm_rolled_kernel")),
    ("col_sum_kernel", ("col_sum_kernel",)))


def kernel_group(name: str) -> str:
    if GEMM_SM90_NN in name:
        return "gemm_sm90_kernel NN"
    for group, names in PORT_KERNELS:
        if any(k in name for k in names):
            return group
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "distribution" in low or "philox" in low:
        return "torch rng"
    if any(s in low for s in ("gemm", "cutlass", "sm90_", "sm80_", "cublas")):
        return "torch gemm"
    if "reduce" in low:
        return "torch reduction"
    return "torch elementwise/other"


def is_annotation(name: str) -> bool:
    """A range name such as "Optimizer.step#AdamW.step": a '#' and no C++
    signature. Kernels whose names hold a lambda ("...{lambda(float)#1}...",
    PyTorch's random-number and comparison kernels among them) are kernels
    and stay."""
    return "#" in name and "(" not in name and "<" not in name


def union_us(intervals: List[tuple]) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--in_kernel_dropout", type=int, choices=[0, 1],
                   default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.train.trainer import Trainer

    n = args.warmup + args.steps
    cfg = Config.for_model(args.model, batch_size=args.batch, max_epoch=1,
                           verbose=False, ckpts_dir="ckpts/profile_train",
                           log_path="results/profile_train")
    ds = SyntheticVQADataset(cfg, size=n * args.batch, answer_size=3129)
    trainer = Trainer(cfg, ds)
    trainer.build_step(bool(args.in_kernel_dropout))
    state = trainer.state
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    print(f"[model] {args.model}: hidden {cfg.hidden_size}, batch "
          f"{cfg.batch_size} in {cfg.grad_accu_steps} micro-batch(es), "
          f"in_kernel_dropout={trainer.in_kernel_dropout}", flush=True)

    # the Trainer's loop: host-assembled batches through the loader
    times = []
    for i, batch in enumerate(trainer.loader()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(trainer.step_fn(state, batch)["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    loader_ms = sum(times[args.warmup:]) / args.steps
    print(f"[loader] ms/step {loader_ms:.3f} (steps {args.warmup + 1}.."
          f"{n}: {', '.join(f'{t:.1f}' for t in times[args.warmup:])})",
          flush=True)

    # the same step on batches already on the card: host clock, then
    # profiled
    batches = list(trainer.loader())
    for b in batches[:args.warmup]:
        trainer.step_fn(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[args.warmup:]:
        trainer.step_fn(state, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"[preloaded] ms/step {step_ms:.3f}", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[args.warmup:]:
            trainer.step_fn(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    # device kernels and copies; the profiler also lays user annotations
    # (the optimizer's "Optimizer.step#AdamW.step" range) on the device
    # timeline, which span other kernels and are left out
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not is_annotation(e.name)]
    draws = sum(e.count for e in prof.key_averages()
                if e.key in ("aten::uniform_", "aten::random_")) / args.steps
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3 / args.steps
    groups = defaultdict(float)
    counts = defaultdict(int)
    torch_names = defaultdict(float)
    for e in dev:
        g = kernel_group(e.name)
        ms = (e.time_range.end - e.time_range.start) / 1e3
        groups[g] += ms
        counts[g] += 1
        if g.startswith("torch"):
            torch_names[e.name[:90]] += ms / args.steps
    top = dict(sorted(torch_names.items(), key=lambda kv: -kv[1])[:10])
    by_group = {g: {"ms_per_step": groups[g] / args.steps,
                    "events_per_step": counts[g] / args.steps}
                for g in sorted(groups, key=groups.get, reverse=True)}
    print(f"[preloaded, profiled] ms/step {wall_ms:.3f}, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / step_ms:.3f} of the "
          f"unprofiled step, {len(dev) / args.steps:.0f} device events per "
          f"step, {draws:.0f} generator mask draws per step", flush=True)
    for g, v in by_group.items():
        print(f"  {g:32s} {v['ms_per_step']:8.3f} ms  "
              f"{v['events_per_step']:6.0f} events", flush=True)
    print("  largest PyTorch kernels (ms per step):", flush=True)
    for name, ms in top.items():
        print(f"    {ms:8.3f}  {name}", flush=True)
    result = {"card": smi, "model": args.model, "batch": args.batch,
              "in_kernel_dropout": trainer.in_kernel_dropout,
              "steps": args.steps, "loader_ms_per_step": loader_ms,
              "preloaded_ms_per_step": step_ms,
              "profiled_ms_per_step": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": 1 - busy_ms / step_ms,
              "device_events_per_step": len(dev) / args.steps,
              "mask_draws_per_step": draws,
              "by_group": by_group, "largest_torch_kernels": top}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
