"""Device time per call of the LayerNorm kernels and the column sums at
the train shapes.

    python mcan_vqa_tpu_torch/cli/bench_layernorm.py [--root DIR] [--tag T]

Times ``residual_layernorm`` and ``residual_layernorm_bwd`` of the
``mcan_vqa_tpu_torch`` package under ``--root`` (default: the checkout this
file lies in; another checkout, such as an older commit unpacked with
``git archive``, compares two versions within one run on the card) at the
MCAN-small decoder shape (3840 rows of 512: 64 samples x 60 regions), the
MCAN-large micro-batch shape (1920 rows of 1024) and 3840 rows of 768 (a
width without a row-in-registers instance; ``null`` where the version
refuses it):

  * ``fwd LN1``: the train forward's LN1 / LN2, f32 residual, y + bias
    through a keep-mask, f32 and bf16 out;
  * ``fwd LN3``: y through a keep-mask, f32 out, r saved;
  * ``fwd serve``: bf16 residual, y + bias, no dropout, f32 and bf16 out;
  * ``bwd LN1``: g and res f32, y + bias through a keep-mask, dy f32 and
    bf16;
  * ``bwd LN3``: from the saved r (no y), dy f32 and bf16;
  * ``... seeded``: the two dropout cases with the Philox keep source in
    place of the mask, where the package has one.

Then ``col_sum`` (the bias and LayerNorm gradients: up to four column
sums in one launch) at every call of unit T, one B=64 MCAN-small train
step (the decoder's three sums a block at 3840 rows, the encoder's two at
896; six blocks each), and of unit L, one B=64 MCAN-large step (the
decoder's three at 1920 rows a micro-batch of 32, the cross sums with the
bf16 gv2; six blocks, two micro-batches), beside ``sum(0)`` of each matrix
and the bound (each input read once, each sum written once, at 3.35
TB/s); one line per call shape, then one per unit with its totals.

Each time: 50 calls captured in one CUDA graph, replayed 5 times, the
median per call (the host's time per wrapper call stays out). Prints one
JSON line per case, then the card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def graph_ms(torch, fn, calls: int = 50, rounds: int = 5) -> float:
    """Median device ms per call of fn over `rounds` replays of one CUDA
    graph of `calls` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
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


def cases(torch, K, D: int, rows: int, per_sample: int):
    """-> [(name, fn)] at one shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(D)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    res, y, gout = randn(rows, D), randn(rows, D), randn(rows, D)
    res16 = res.to(bf16)
    bias, gamma, beta = randn(D) * 0.1, 1 + randn(D) * 0.1, randn(D) * 0.1
    mask = (torch.rand(rows, D, generator=g, device=dev) < 0.9).to(
        torch.uint8)
    inv = 1 / 0.9
    out = [
        ("fwd LN1", lambda m: K.residual_layernorm(
            res, y, bias, gamma, beta, (f32, bf16), mask=m, inv_keep=inv,
            reciprocal=True)),
        ("fwd LN3", lambda m: K.residual_layernorm(
            res, y, None, gamma, beta, (f32,), mask=m, inv_keep=inv,
            save_r=True, reciprocal=True)),
        ("bwd LN1", lambda m: K.residual_layernorm_bwd(
            gout, res, y, bias, gamma, mask=m, inv_keep=inv,
            dy_dtypes=(f32, bf16))),
        ("bwd LN3", lambda m: K.residual_layernorm_bwd(
            gout, res, None, None, gamma, mask=m, inv_keep=inv,
            dy_dtypes=(f32, bf16))),
    ]
    named = [(name, (lambda f: lambda: f(mask))(f)) for name, f in out]
    named.append(("fwd serve", lambda: K.residual_layernorm(
        res16, y, bias, gamma, beta, (f32, bf16))))
    if hasattr(K, "Philox"):
        keep = K.Philox(seed=1234, site=0x301, thresh=3865470566,
                        rows=per_sample)
        named += [(f"{name} seeded", (lambda f: lambda: f(keep))(f))
                  for name, f in out if "LN1" in name]
    return named


HBM = 3.35e12
# (unit, label, rows, widths, the last matrix bf16, calls per unit)
COL_SUMS = [("T", "dec db1, db2, dln3", 3840, (2048, 512, 512, 512), False, 6),
            ("T", "dec dbq2, dbm2, dln2", 3840, (512,) * 4, False, 6),
            ("T", "dec dbqkv, dbm1, dln1", 3840, (1536, 512, 512, 512), False,
             6),
            ("T", "enc dbqkv, dbm, dln1", 896, (1536, 512, 512, 512), False,
             6),
            ("T", "enc db1, db2, dln2", 896, (2048, 512, 512, 512), False, 6),
            ("L", "db1, db2, dln3", 1920, (4096, 1024, 1024, 1024), False, 12),
            ("L", "dbq2, dbm2, dln2 (bf16 gv2)", 1920, (1024,) * 4, True, 12),
            ("L", "dbqkv, dbm1, dln1", 1920, (3072, 1024, 1024, 1024), False,
             12)]


def time_col_sums(torch, K, tag: str) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    totals = {}
    for unit, label, rows, widths, bf16_last, calls in COL_SUMS:
        mats = [torch.randn(rows, w, generator=g, device=dev) for w in widths]
        if bf16_last:
            mats[-1] = mats[-1].to(torch.bfloat16)
        nbytes = sum(m.numel() * m.element_size() + 4 * m.shape[1]
                     for m in mats)
        ms = graph_ms(torch, lambda: K.col_sum(mats))
        sum_ms = graph_ms(torch, lambda: [m.sum(0) for m in mats])
        bound = nbytes / HBM * 1e3
        t = totals.setdefault(unit, [0, 0.0, 0.0, 0.0])
        for i, v in enumerate((calls, calls * ms, calls * sum_ms,
                               calls * bound)):
            t[i] += v
        print(json.dumps({"tag": tag, "kernel": "col_sum", "unit": unit,
                          "case": label, "rows": rows, "widths": widths,
                          "calls": calls, "ms": ms, "sum_ms": sum_ms,
                          "bound_ms": bound}), flush=True)
    for unit, (calls, ms, sum_ms, bound) in totals.items():
        print(json.dumps({"tag": tag, "kernel": "col_sum", "unit": unit,
                          "calls": calls, "ms": ms, "sum_ms": sum_ms,
                          "bound_ms": bound}), flush=True)


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
    if Path(mcan_vqa_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"mcan_vqa_tpu_torch was not imported from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    for D, rows, per_sample in ((512, 3840, 60), (1024, 1920, 60),
                                (768, 3840, 60)):
        for name, fn in cases(torch, K, D, rows, per_sample):
            try:
                ms = graph_ms(torch, fn)
            except ValueError as e:     # a width this version refuses
                ms = None
                torch.cuda.synchronize()
                print(f"# {name} at D={D}: {e}", file=sys.stderr)
            print(json.dumps({"tag": args.tag, "root": str(root),
                              "case": name, "D": D, "rows": rows,
                              "ms_per_call": ms}), flush=True)
    time_col_sums(torch, K, args.tag)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
