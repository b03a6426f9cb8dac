"""Device time of the attention forward and backward at the main paths'
shapes.

    python mcan_vqa_tpu_torch/cli/bench_attention.py [--root DIR] [--tag T]

Times ``kernels.masked_attention`` (csrc/masked_attention.cu) of the
``mcan_vqa_tpu_torch`` package under ``--root`` (default: the checkout this
file lies in; another checkout, such as an older commit unpacked with
``git archive``, compares two versions within one run on the card) beside
one PyTorch call of the same function where there is one
(``scaled_dot_product_attention`` of the bf16 operands with the boolean
key mask; it has no dropout of ours, so the dropout shapes time it
without), at every shape of

  * unit S: one B=64 bf16 serving forward of MCAN-small (8 heads of 64):
    the six SA encoder blocks' self-attention over 14 tokens (q, k, v
    views of the fused [B*L, 3D] qkv buffer), the six SGA decoder blocks'
    self-attention over 60 regions and their cross-attention against the
    14 question keys (pre-projected f32 k / v [B, H, 14, 64]);
  * unit B1: the same at B=1, each shape also timed eagerly (CUDA events
    around eager calls: the host's issue time, the plan included, counts);
  * unit T, one B=64 MCAN-small train step: the decoder's self- and
    cross-attention with the att1 / att2 dropout and the encoder's with
    its own, each twice a block (the forward and the attention backward's
    recompute), drawn in the kernel (Philox) as the Trainer runs it on the
    card; the same shapes with a keep-mask read from memory are timed with
    0 calls per unit;
  * unit L, one B=64 MCAN-large train step (two micro-batches of 32, 8
    heads of 128): the decoder's self- and cross-attention with dropout
    (keep-masks, as the MCAN-large rows of chip_smoke.py), twice a block;
  * unit Q: the f32 output of the int8 engines' level-3 merges, the three
    shapes of unit S;
  * unit M0: the per-sub-op engine (mode 0): f32 q, k, v views of the
    plain projections, f32 out;
  * unit long: the long kernel's shapes of chip_smoke.py's [per-sub-op]
    (Dh 192 self 160 x 160, Dh 256 cross 60 x 14, Dh 64 self 608 x 608,
    Dh 256 cross 608 x 14; B = 8), one call each.

The backward (``kernels.masked_attention_bwd``, csrc/masked_attention_bwd.cu)
at

  * unit T: one B=64 MCAN-small train step's 18 calls (the decoder's
    self-attention with dq / dk / dv and their bf16 copies, its
    cross-attention against f32 k / v with dq's copy, the encoder's
    self-attention), with the seeded dropout the Trainer runs on the card;
    the same with keep-masks read from memory at 0 calls per unit;
  * unit L: one B=64 MCAN-large step's 24 calls (two micro-batches of 32,
    Dh 128; the decoder's self- and cross-attention), with keep-masks as
    the MCAN-large rows of chip_smoke.py; seeded at 0 calls;
  * unit long: the forward's long shapes with a keep-mask, one call each
    (the backward's long kernels);

beside the backward of ``scaled_dot_product_attention`` (one autograd call
of the bf16 operands with the boolean key mask, no dropout; captured in a
graph like the kernel, null where the capture is refused).

Each device time: 50 calls captured in one CUDA graph, replayed 5 times,
the median per call. Prints one JSON line per shape (with the plan where
the package has ``attention_plan`` / ``attention_bwd_plan``), one per unit
with its totals (calls x time, beside the library call's and the bound:
989 TFLOP/s bf16 and 3.35 TB/s, each input read once and each output
written once; unit B1 also its eager total), then the card.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

PEAK_BF16, HBM = 989e12, 3.35e12

# (unit, label, B, H, Lq, Lk, Dh, operands, q dtype, kv dtype, out dtype,
# dropout: None, "mask" or "seeded", calls per unit). operands: "qkv" (q,
# k, v views of one fused [B * L, 3 H Dh] buffer), "cross" (q a view of a
# [B * Lq, H Dh] buffer, k / v [B, H, Lk, Dh]) or "heads" (all [B, H, L,
# Dh])
SHAPES = []
for unit, B in (("S", 64), ("B1", 1)):
    SHAPES += [(unit, "enc self 14x14", B, 8, 14, 14, 64, "qkv", "bf16",
                "bf16", "bf16", None, 6),
               (unit, "dec self 60x60", B, 8, 60, 60, 64, "qkv", "bf16",
                "bf16", "bf16", None, 6),
               (unit, "dec cross 60x14 f32 kv", B, 8, 60, 14, 64, "cross",
                "bf16", "f32", "bf16", None, 6)]
for keep, calls in (("seeded", 12), ("mask", 0)):
    SHAPES += [("T", f"dec self 60x60 + att1 {keep}", 64, 8, 60, 60, 64,
                "qkv", "bf16", "bf16", "bf16", keep, calls),
               ("T", f"dec cross 60x14 f32 kv + att2 {keep}", 64, 8, 60, 14,
                64, "cross", "bf16", "f32", "bf16", keep, calls),
               ("T", f"enc self 14x14 + att {keep}", 64, 8, 14, 14, 64,
                "qkv", "bf16", "bf16", "bf16", keep, calls)]
SHAPES += [("L", "dec self 60x60 + dropout", 32, 8, 60, 60, 128, "qkv",
            "bf16", "bf16", "bf16", "mask", 24),
           ("L", "dec cross 60x14 f32 kv + dropout", 32, 8, 60, 14, 128,
            "cross", "bf16", "f32", "bf16", "mask", 24),
           ("Q", "enc self 14x14", 64, 8, 14, 14, 64, "heads", "bf16",
            "bf16", "f32", None, 6),
           ("Q", "dec self 60x60", 64, 8, 60, 60, 64, "heads", "bf16",
            "bf16", "f32", None, 6),
           ("Q", "dec cross 60x14 f32 kv", 64, 8, 60, 14, 64, "heads",
            "bf16", "f32", "f32", None, 6),
           ("M0", "enc self 14x14", 64, 8, 14, 14, 64, "qkv", "f32", "f32",
            "f32", None, 6),
           ("M0", "dec self 60x60", 64, 8, 60, 60, 64, "qkv", "f32", "f32",
            "f32", None, 6),
           ("M0", "dec cross 60x14", 64, 8, 60, 14, 64, "cross", "f32",
            "f32", "f32", None, 6),
           ("long", "Dh 192 self 160x160 (hidden 1536)", 8, 8, 160, 160, 192,
            "heads", "f32", "f32", "f32", None, 1),
           ("long", "Dh 256 cross 60x14 (hidden 2048)", 8, 8, 60, 14, 256,
            "heads", "bf16", "f32", "bf16", None, 1),
           ("long", "Dh 64 self 608x608 (grid features)", 8, 8, 608, 608, 64,
            "heads", "bf16", "bf16", "bf16", None, 1),
           ("long", "Dh 256 cross 608x14", 8, 8, 608, 14, 256, "heads",
            "bf16", "f32", "f32", None, 1)]

# the backward: (unit, label, B, H, Lq, Lk, Dh, operands, kv dtype,
# dropout, the outputs with a bf16 copy, calls per unit); q and dout bf16
BWD_SHAPES = []
for keep, calls in (("seeded", 6), ("mask", 0)):
    BWD_SHAPES += [("T", f"dec self 60x60 + att1 {keep}", 64, 8, 60, 60, 64,
                    "qkv", "bf16", keep, "qkv", calls),
                   ("T", f"dec cross 60x14 f32 kv + att2 {keep}", 64, 8, 60,
                    14, 64, "cross", "f32", keep, "q", calls),
                   ("T", f"enc self 14x14 + att {keep}", 64, 8, 14, 14, 64,
                    "qkv", "bf16", keep, "qkv", calls)]
for keep, calls in (("mask", 12), ("seeded", 0)):
    BWD_SHAPES += [("L", f"dec self 60x60 + {keep}", 32, 8, 60, 60, 128,
                    "qkv", "bf16", keep, "qkv", calls),
                   ("L", f"dec cross 60x14 f32 kv + {keep}", 32, 8, 60, 14,
                    128, "cross", "f32", keep, "q", calls)]
BWD_SHAPES += [("long", "Dh 192 self 160x160 (hidden 1536)", 8, 8, 160, 160,
                192, "heads", "f32", "mask", "", 1),
               ("long", "Dh 256 cross 60x14 (hidden 2048)", 8, 8, 60, 14, 256,
                "heads", "f32", "mask", "", 1),
               ("long", "Dh 64 self 608x608 (grid features)", 8, 8, 608, 608,
                64, "heads", "bf16", "mask", "", 1),
               ("long", "Dh 256 cross 608x14", 8, 8, 608, 14, 256, "heads",
                "f32", "mask", "", 1)]

SIZE = {"bf16": 2, "f32": 4}


def bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM) * 1e3


def operands(torch, g, dev, B, H, Lq, Lk, Dh, kind, qdt, kvdt):
    """q, k, v and a key mask with a fully padded sample 0 (and, at B = 1,
    a sample padded past a third of its keys)."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    D = H * Dh

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dt[dtype])

    def heads(x, L):
        return x.view(B, L, H, Dh).transpose(1, 2)

    if kind == "qkv":
        qkv = randn(B * Lq, 3 * D, dtype=kvdt).view(B, Lq, 3 * D)
        q, k, v = (heads(t, Lq) for t in qkv.split(D, dim=-1))
        q = q if qdt == kvdt else q.to(dt[qdt])
    elif kind == "cross":
        q = heads(randn(B * Lq, D, dtype=qdt), Lq)
        k, v = randn(B, H, Lk, Dh, dtype=kvdt), randn(B, H, Lk, Dh,
                                                      dtype=kvdt)
    else:
        q = randn(B, H, Lq, Dh, dtype=qdt)
        k, v = randn(B, H, Lk, Dh, dtype=kvdt), randn(B, H, Lk, Dh,
                                                      dtype=kvdt)
    lens = torch.tensor([(i * 17) % (Lk + 1) if B > 1 else Lk - Lk // 3
                         for i in range(B)], device=dev)
    mask = (torch.arange(Lk, device=dev)[None] >= lens[:, None])
    return q, k, v, mask[:, None, None, :]


def keep_source(torch, K, g, dev, keep, shape):
    """The dropout of a case: None, a keep-mask at rate 0.1 or its Philox
    source -> (drop, inv_keep)."""
    if keep == "mask":
        return (torch.rand(shape, generator=g, device=dev)
                >= 0.1).to(torch.uint8), 1 / 0.9
    if keep == "seeded":
        return K.Philox(7, 0x200, 3865470566), 2 ** 32 / 3865470566
    return None, 1.0


def sdpa_backward_ms(torch, q, k, v, mask, d4, calls: int = 50,
                     rounds: int = 5):
    """Device ms of one autograd backward of scaled_dot_product_attention
    (bf16 copies of q, k, v, the boolean key mask) with d4 [B, H, Lq, Dh]
    flowing back, timed as ``bench_layernorm.graph_ms`` times the kernels
    (the median of `rounds` replays of a graph of `calls` calls); None
    where the capture is refused. Autograd runs each backward op on the
    stream its forward op ran on, and a capture refuses work on the legacy
    default stream, so the forward, the warm-up and the capture share one
    side stream (``graph_ms`` takes no stream, and under ``--root`` it
    comes from the other checkout)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [t.detach().to(torch.bfloat16).clone().requires_grad_()
                  for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=~mask)

        def call():
            return torch.autograd.grad(out, leaves, d4, retain_graph=True)

        for _ in range(3):
            call()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                call()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def time_backward(torch, K, g, dev, tag, graph_ms, totals) -> None:
    """The backward's JSON lines per BWD_SHAPES case; totals per unit
    ("bwd T", "bwd L", "bwd long") into ``totals``."""
    plan_of = getattr(K, "attention_bwd_plan", None)
    for (unit, label, B, H, Lq, Lk, Dh, kind, kvdt, keep, copies,
         calls) in BWD_SHAPES:
        q, k, v, mask = operands(torch, g, dev, B, H, Lq, Lk, Dh, kind,
                                 "bf16", kvdt)
        drop, inv = keep_source(torch, K, g, dev, keep, (B, H, Lq, Lk))
        dout = torch.randn(B, Lq, H * Dh, generator=g,
                           device=dev).to(torch.bfloat16)
        outs = [torch.empty(B, H, L, Dh, device=dev) for L in (Lq, Lk, Lk)]
        c16 = [torch.empty(t.shape, dtype=torch.bfloat16, device=dev)
               if c in copies else None for t, c in zip(outs, "qkv")]

        def call():
            K.masked_attention_bwd(q, k, v, mask, dout, *outs, *c16,
                                   drop=drop, inv_keep=inv)

        nbytes = (2 * B * H * Lq * Dh + 2 * SIZE[kvdt] * B * H * Lk * Dh
                  + 2 * B * Lq * H * Dh + B * Lk
                  + B * H * Lq * Lk * (keep == "mask")
                  + 4 * B * H * (Lq + 2 * Lk) * Dh
                  + sum(2 * B * H * L * Dh for L, c in zip((Lq, Lk, Lk),
                                                            "qkv")
                        if c in copies))
        b = bound_ms(10 * B * H * Lq * Lk * Dh, nbytes)
        ms = graph_ms(torch, call)
        lib_ms = sdpa_backward_ms(torch, q, k, v, mask, dout.view(
            B, Lq, H, Dh).transpose(1, 2))
        row = {"tag": tag, "unit": "bwd " + unit, "case": label,
               "shape": [B, H, Lq, Lk, Dh], "kv": kvdt, "dropout": keep,
               "copies": copies, "calls": calls, "ms": ms,
               "sdpa_bwd_ms": lib_ms, "bound_ms": b}
        if plan_of is not None:
            p = plan_of(B, H, Lq, Lk, Dh)
            row["plan"] = {"instance": ("one-block", "long")[p.instance],
                           "dhp": p.dhp, "rows": p.rows, "grid": p.grid,
                           "threads": p.threads, "smem": p.smem,
                           "key_rows": p.key_rows, "key_grid": p.key_grid,
                           "key_threads": p.key_threads,
                           "key_smem": p.key_smem}
        print(json.dumps(row), flush=True)
        t = totals.setdefault("bwd " + unit, [0, 0.0, 0.0, 0.0, 0.0])
        t[0] += calls
        t[1] += calls * ms
        # a unit with a refused capture has no library total
        t[2] = None if None in (lib_ms, t[2]) else t[2] + calls * lib_ms
        t[3] += calls * b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import mcan_vqa_tpu_torch
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.cli.bench_layernorm import graph_ms
    from mcan_vqa_tpu_torch.cli.bench_gemm import eager_ms
    if Path(mcan_vqa_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"mcan_vqa_tpu_torch was not imported from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    plan_of = getattr(K, "attention_plan", None)
    totals = {}
    for (unit, label, B, H, Lq, Lk, Dh, kind, qdt, kvdt, odt, keep,
         calls) in SHAPES:
        q, k, v, mask = operands(torch, g, dev, B, H, Lq, Lk, Dh, kind, qdt,
                                 kvdt)
        out_dtype = torch.float32 if odt == "f32" else torch.bfloat16
        drop, inv = keep_source(torch, K, g, dev, keep, (B, H, Lq, Lk))

        def call():
            return K.masked_attention(q, k, v, mask, drop, inv,
                                      out_dtype=out_dtype)

        q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
        keep_mask = ~mask
        nbytes = (SIZE[qdt] * B * H * Lq * Dh + 2 * SIZE[kvdt] * B * H * Lk
                  * Dh + B * Lk + B * H * Lq * Lk * (keep == "mask")
                  + SIZE[odt] * B * Lq * H * Dh)
        b = bound_ms(4 * B * H * Lq * Lk * Dh, nbytes)
        ms = graph_ms(torch, call)
        lib_ms = graph_ms(torch, lambda: sdpa(q16, k16, v16,
                                              attn_mask=keep_mask))
        row = {"tag": args.tag, "unit": unit, "case": label,
               "shape": [B, H, Lq, Lk, Dh], "q": qdt, "kv": kvdt,
               "out": odt, "dropout": keep, "calls": calls, "ms": ms,
               "sdpa_ms": lib_ms, "bound_ms": b}
        if unit == "B1":
            row["eager_ms"] = eager_ms(torch, call)
        if plan_of is not None:
            p = plan_of(B, H, Lq, Lk, Dh)
            row["plan"] = {"instance": ("one-block", "long")[p.instance],
                           "dhp": p.dhp, "kc": p.kc, "rows": p.rows,
                           "grid": p.grid, "threads": p.threads,
                           "smem": p.smem}
        print(json.dumps(row), flush=True)
        t = totals.setdefault(unit, [0, 0.0, 0.0, 0.0, 0.0])
        t[0] += calls
        t[1] += calls * ms
        t[2] += calls * lib_ms
        t[3] += calls * b
        t[4] += calls * row.get("eager_ms", 0.0)
    time_backward(torch, K, g, dev, args.tag, graph_ms, totals)
    for unit, (calls, ms, lib_ms, b, eager) in totals.items():
        lib = "sdpa_bwd_ms" if unit.startswith("bwd") else "sdpa_ms"
        line = {"tag": args.tag, "unit": unit, "calls": calls, "ms": ms,
                lib: lib_ms, "x_sdpa": lib_ms and ms / lib_ms,
                "bound_ms": b}
        if eager:
            line["eager_ms"] = eager
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
