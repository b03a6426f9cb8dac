"""Device time of the all-layer stacks against the per-block engine.

    python mcan_vqa_tpu_torch/cli/bench_stacks.py [--root DIR] [--tag T]
        [--batches 1,8,64] [--no-forward]

Times ``kernels.sga_decoder`` (the cross k/v projected in the kernel, mode
3, and given, modes 4 and 5) and ``kernels.sa_encoder`` (mode 5) of the
``mcan_vqa_tpu_torch`` package under ``--root`` (default: the checkout this
file lies in; another checkout, such as an older commit unpacked with ``git
archive``, compares two versions within one run on the card) at MCAN-small
(6 layers, D 512, F 2048, 8 heads, 60 regions, 14 tokens; seeded random
weights, bf16 streams, ragged pads with a fully padded sample past B = 1)
for each batch, beside

  * the stack's plain version (``sga_decoder_plain`` / ``sa_encoder_plain``,
    the per-block plain composition);
  * the per-block engine's kernels computing the same layers: the six
    mode-2 ``fused_sga_block`` calls with each layer's cross k/v product
    (``serving._cross_kv``), or the six ``fused_sa_block`` calls -- the
    port's own kernels, not a library call -- eagerly and captured in a
    CUDA graph (device time, without the host's);
  * the bound: the operations at 989 TFLOP/s bf16 and the bytes (the stream
    in and out, the pads, the cross k/v or q, every layer's weights read
    once) at 3.35 TB/s.

Each time is the median of 5 rounds of CUDA events around 10 eager calls (a
cooperative launch is not captured in a graph here); the stacks' launch
takes their plan and tensor maps on the host, which counts. Prints one JSON
line per stack and batch (with the plan where the checkout has
``kernels.stack_plan``), then, unless ``--no-forward``, one per engine and
batch for the bf16 serving forward (``build_production_engine(qffn=0)``)
in mode 5 (``alllayer=True``: one ``sa_encoder`` and one ``sga_decoder``)
and in mode 2 at B = 1 and 64, then the card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

PEAK_BF16, HBM = 989e12, 3.35e12


def weight_bytes(D: int, F: int, cross: bool) -> int:
    """bf16 matrices and f32 vectors of one block."""
    mats = 3 * D * D + D * D + 2 * D * F + (2 * D * D if cross else 0)
    vecs = 3 * D + D + F + D + 4 * D + (2 * D + 2 * D if cross else 0)
    return 2 * mats + 4 * vecs


def stack_work(B, Lv, Lq, D, F, L, kind):
    """(operations, bytes) of one all-layer call, as chip_smoke.py's
    [all-layer] counts them."""
    if kind == "encoder":
        M = B * Lq
        flops = 2 * M * D * 3 * D + 2 * M * D * D + 4 * M * D * F \
            + 4 * B * Lq * Lq * D
        return L * flops, 4 * M * D + B * Lq + L * weight_bytes(D, F, False)
    M, Mq = B * Lv, B * Lq
    flops = 2 * M * D * 3 * D + 6 * M * D * D + 4 * M * D * F \
        + 4 * B * Lv * Lv * D + 4 * B * Lv * Lq * D
    nbytes = 4 * M * D + B * (Lv + Lq) + L * weight_bytes(D, F, True)
    if kind == "in":
        flops += 4 * Mq * D * D
        nbytes += 2 * Mq * D + L * (2 * 2 * D * D + 4 * 2 * D)
    else:
        nbytes += 2 * 4 * L * Mq * D
    return L * flops, nbytes


def median_ms(torch, fn, rounds: int = 5, calls: int = 10) -> float:
    """Median over rounds of the mean ms of `calls` eager calls (CUDA
    events; the host's issue time counts where it exceeds the device's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def graph_ms(torch, fn, iters: int = 10):
    """Device ms per call of fn, its launches captured in one CUDA graph
    and replayed (median of 5 replays): the per-block engine without its
    host time. None where the capture is refused."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError:
        return None
    out = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def plan_note(K, B, Lv, Lq, D, F, H, kv):
    """The checkout's stack plan, where it has one: per product tile x
    splits, per attention instance / dhp / rows, the grid's cap."""
    if not hasattr(K, "stack_plan"):
        return None
    p = K.stack_plan(B, Lv, D, F, H, Lq, kv)
    return {"gemms": [None if g is None else f"{g.bm}x{g.bn}/{g.splits}"
                      for g in p.gemms],
            "attention": [f"{a.instance}/{a.dhp}/{a.rows}"
                          for a in p.attention],
            "items": p.items}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--no-forward", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import mcan_vqa_tpu_torch
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sga_block
    from mcan_vqa_tpu_torch.ops.serving import (_cross_kv,
                                                build_production_engine,
                                                prepare_params)
    if Path(mcan_vqa_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"mcan_vqa_tpu_torch was not imported from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = Config()
    L, H, D, F = cfg.layer, cfg.multi_head, cfg.hidden_size, cfg.ff_size
    Lq, Lv = cfg.max_token, cfg.img_feat_pad_size
    net = MCANet(cfg, 20, 3129, generator=torch.Generator().manual_seed(0))
    state = net.state_dict()
    bb = prepare_params(state, L, device=dev, prune=False, num_heads=H,
                        alllayer=True)["backbone"]
    wd, we = bb["_mk_dec"], bb["_mk_enc"]
    bf16 = torch.bfloat16

    for B in (int(b) for b in args.batches.split(",")):
        g = torch.Generator(device=dev).manual_seed(B)
        v = torch.randn(B, Lv, D, generator=g, device=dev).to(bf16)
        q = torch.randn(B, Lq, D, generator=g, device=dev).to(bf16)
        lv = [Lv if B == 1 else (i * 17) % (Lv + 1) for i in range(B)]
        lq = [Lq if B == 1 else (i * 5) % (Lq + 1) for i in range(B)]
        vm = (torch.arange(Lv, device=dev)[None] >= torch.tensor(
            lv, device=dev)[:, None])[:, None, None]
        qm = (torch.arange(Lq, device=dev)[None] >= torch.tensor(
            lq, device=dev)[:, None])[:, None, None]
        layers = [bb[f"dec_{i}"] for i in range(L)]
        kvs = [_cross_kv(p["mhatt2"], q, H) for p in layers]
        kq = torch.cat([k for k, _ in kvs], 1)
        vq = torch.cat([x for _, x in kvs], 1)

        def dec_blocks():
            x = v
            for p in layers:
                k_l, v_l = _cross_kv(p["mhatt2"], q, H)
                x = sga_block.fused_sga_block(x, k_l, v_l, vm, qm, p["_mk"],
                                              num_heads=H)
            return x

        def enc_blocks():
            x = q
            for i in range(L):
                x = sga_block.fused_sa_block(x, qm, bb[f"enc_{i}"]["_mk"],
                                             num_heads=H)
            return x

        cases = {
            "sga_decoder, in-kernel k/v": (
                "in", lambda: K.sga_decoder(v, vm, qm, wd, num_heads=H, q=q),
                lambda: K.sga_decoder_plain(v, vm, qm, wd, num_heads=H, q=q),
                dec_blocks),
            "sga_decoder, external k/v": (
                "ext", lambda: K.sga_decoder(v, vm, qm, wd, num_heads=H,
                                             kq=kq, vq=vq),
                lambda: K.sga_decoder_plain(v, vm, qm, wd, num_heads=H,
                                            kq=kq, vq=vq), dec_blocks),
            "sa_encoder": (
                "", lambda: K.sa_encoder(q, qm, we, num_heads=H),
                lambda: K.sa_encoder_plain(q, qm, we, num_heads=H),
                enc_blocks)}
        with torch.inference_mode():
            for case, (kv, stack, plain, blocks) in cases.items():
                err = float((stack().float() - plain().float()).abs().max())
                work = stack_work(B, Lv, Lq, D, F, L,
                                  "encoder" if not kv else kv)
                bound = max(work[0] / PEAK_BF16, work[1] / HBM) * 1e3
                Lx = Lq if not kv else Lv
                print(json.dumps({
                    "tag": args.tag, "case": case, "B": B,
                    "ms": median_ms(torch, stack),
                    "plain_ms": median_ms(torch, plain, rounds=3, calls=3),
                    "blocks_ms": median_ms(torch, blocks),
                    "blocks_graph_ms": graph_ms(torch, blocks),
                    "bound_ms": bound, "max_abs_err": err,
                    "grid": list(K.LAST_GRID.get(
                        "sa_encoder" if not kv else "sga_decoder", ())),
                    "plan": plan_note(K, B, Lx, Lq if kv else 0, D, F, H,
                                      kv)}), flush=True)

    if not args.no_forward:
        import numpy as np
        engines = {}
        for name, kw in (("mode 5", dict(sga_mode=5, alllayer=True)),
                         ("mode 2", {})):
            engines[name] = build_production_engine(state, L, H, qffn=0,
                                                    device=dev, **kw)
        rng = np.random.default_rng(0)
        for B in (1, 64):
            img = np.abs(rng.normal(size=(B, Lv, cfg.img_feat_size))
                         ).astype(np.float32)
            img[1:, 40:] = 0
            ques = rng.integers(1, 20, size=(B, Lq))
            ques[1:, 9:] = 0
            img_t = torch.from_numpy(img).to(dev)
            ques_t = torch.from_numpy(ques).to(dev)
            t = {name: [] for name in engines}
            for _ in range(5):       # the engines in turns
                for name, (fwd, prep) in engines.items():
                    def call():
                        with torch.inference_mode():
                            return fwd(prep, img_t, ques_t)
                    t[name].append(median_ms(torch, call, rounds=1))
            for name, ms in t.items():
                print(json.dumps({"tag": args.tag, "forward": name, "B": B,
                                  "ms": statistics.median(ms),
                                  "min_ms": min(ms), "max_ms": max(ms)}),
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
