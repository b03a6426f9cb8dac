"""How far the SGA train block through the kernels lands from its plain
versions and from its autograd twin, by width.

    python -m mcan_vqa_tpu_torch.cli.block_gap [--widths 512,1024,1536]
        [--heads 8] [--rows 60] [--trace]

For each width D (F = 4 D, B = 64, 14 question keys, ragged pads with
fully padded samples, dropout masks at rate 0.1, weights of LN-scale
activations as ``chip_smoke.py`` draws them) runs the block's forward and
backward (``ops/sga_train.py::fused_sga_block_train``) three ways: through
the kernels, through the kernels' plain versions on the same tensors
(every wrapper's CPU path), and as the plain twin under autograd
(``fused_sga_block_train_plain``). Prints, per width, one JSON line with
the largest relative-norm gaps of the output and the 21 gradients for
kernels vs autograd (what ``chip_smoke.py``'s 3e-2 gate reads), plain
versions vs autograd, and kernels vs plain versions. ``--trace`` adds,
per kernel call in order, the relative-norm gap between the kernel run's
output and the plain run's: where the two runs part. Then the card.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import sga_train as st

TRACED = ("gemm_bias_act", "gemm_dx", "gemm_dw", "masked_attention",
          "masked_attention_bwd", "residual_layernorm",
          "residual_layernorm_bwd", "col_sum")


def block_inputs(D, H, Lv, Lq=14, B=64, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = 0.05 * (512 / D) ** 0.5
    F = 4 * D

    def mat(*shape, base=0.0):
        return base + torch.randn(*shape, generator=g, device="cuda") * s

    w = {n: mat(*shape, base=1.0 if n.endswith("_s") else 0.0)
         for n, shape in (("wqkv", (D, 3 * D)), ("bqkv", (3 * D,)),
                          ("wm1", (D, D)), ("bm1", (D,)), ("ln1_s", (D,)),
                          ("ln1_b", (D,)), ("wq2", (D, D)), ("bq2", (D,)),
                          ("wm2", (D, D)), ("bm2", (D,)), ("ln2_s", (D,)),
                          ("ln2_b", (D,)), ("w1", (D, F)), ("b1", (F,)),
                          ("w2", (F, D)), ("b2", (D,)), ("ln3_s", (D,)),
                          ("ln3_b", (D,)))}
    x = torch.randn(B, Lv, D, generator=g, device="cuda")
    kq, vq = (torch.randn(B, H, Lq, D // H, generator=g, device="cuda")
              for _ in range(2))
    idx_v, idx_q = (torch.arange(L, device="cuda") for L in (Lv, Lq))
    v_mask = (idx_v[None] >= torch.tensor(
        [(i * 17) % (Lv + 1) for i in range(B)], device="cuda")[:, None])
    q_mask = (idx_q[None] >= torch.tensor(
        [(i * 5) % (Lq + 1) for i in range(B)], device="cuda")[:, None])
    masks, inv = st.make_dropout_masks(g, 0.1, B, Lv, Lq, D, F, H)
    probe = torch.randn(B, Lv, D, generator=g, device="cuda")
    return ((x, kq, vq), v_mask[:, None, None, :], q_mask[:, None, None, :],
            masks, inv, w, probe)


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / (b.float().norm() + 1e-30))


def run_block(block, leaves, w, probe):
    ls = [t.clone().requires_grad_() for t in leaves]
    ws = {k: t.clone().requires_grad_() for k, t in w.items()}
    out = block(ls, ws)
    (out * probe).sum().backward()
    torch.cuda.synchronize()
    return [out.detach()] + [t.grad for t in ls] + [ws[n].grad
                                                    for n in st.WEIGHT_NAMES]


def plain_wrappers(fn):
    """fn with every wrapper on its plain version (the CPU path)."""
    on_cuda = K.on_cuda
    K.on_cuda = lambda t: False
    try:
        return fn()
    finally:
        K.on_cuda = on_cuda


def traced(fn):
    """fn's result and the first outputs of every traced wrapper call."""
    calls, saved = [], {n: getattr(K, n) for n in TRACED}

    def wrap(name, orig):
        def call(*a, **k):
            out = orig(*a, **k)
            outs = a[5:8] if name == "masked_attention_bwd" else (
                out if isinstance(out, (tuple, list)) else (out,))
            calls.append((name, [t.clone() for t in outs]))
            return out
        return call

    for n, orig in saved.items():
        setattr(K, n, wrap(n, orig))
    try:
        return fn(), calls
    finally:
        for n, orig in saved.items():
            setattr(K, n, orig)


def worst(names, a, b, n=3):
    gaps = sorted(((rel(u, v), name) for name, u, v in zip(names, a, b)),
                  reverse=True)
    return [[name, round(g, 6)] for g, name in gaps[:n]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="512,1024,1536,2048")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--rows", type=int, default=60)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_gap needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["out", "x", "kq", "vq"] + list(st.WEIGHT_NAMES)
    for D in (int(d) for d in args.widths.split(",")):
        H = args.heads
        leaves, vm, qm, masks, inv, w, probe = block_inputs(D, H, args.rows)

        def kern(ls, ws):
            return st.fused_sga_block_train(*ls, vm, qm, masks, ws,
                                            num_heads=H, inv_keep=inv)

        def twin(ls, ws):
            return st.fused_sga_block_train_plain(*ls, vm, qm, masks, ws,
                                                  num_heads=H,
                                                  inv_keep=inv)

        a, kcalls = traced(lambda: run_block(kern, leaves, w, probe))
        b, pcalls = traced(lambda: plain_wrappers(
            lambda: run_block(kern, leaves, w, probe)))
        c = run_block(twin, leaves, w, probe)
        line = {"D": D, "heads": H, "rows": args.rows,
                "kernels_vs_autograd": worst(names, a, c),
                "plain_versions_vs_autograd": worst(names, b, c),
                "kernels_vs_plain_versions": worst(names, a, b)}
        if args.trace:
            line["trace"] = [[n, [round(rel(u, v), 6) for u, v in zip(oa, ob)]]
                             for (n, oa), (_, ob) in zip(kcalls, pcalls)]
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}))


if __name__ == "__main__":
    main()
