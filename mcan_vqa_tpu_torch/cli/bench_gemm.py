"""Device time of the backward GEMMs at the train steps' shapes.

    python mcan_vqa_tpu_torch/cli/bench_gemm.py [--root DIR] [--tag T]

Times ``gemm_dx`` (dY . W^T with its gate / residual epilogue) and
``gemm_dw`` (X^T . dY, f32) of the ``mcan_vqa_tpu_torch`` package under
``--root`` (default: the checkout this file lies in; another checkout, such
as an older commit unpacked with ``git archive``, compares two versions
within one run on the card) beside one ``torch.mm`` of the same operands,
at every shape of one B=64 train step:

  * unit T, MCAN-small: the six SGA decoder blocks (M = R = 3840 rows, D
    512, F 2048) and the six SA encoder blocks (896 rows);
  * unit L, MCAN-large: the six SGA decoder blocks of each of the two
    micro-batches of 32 (1920 rows, D 1024, F 4096, bf16 saves).

Each time: 50 calls captured in one CUDA graph, replayed 5 times, the
median per call. Prints one JSON line per shape, one per kernel
and unit with the unit's totals (calls x time; the bound at 989 TFLOP/s
bf16 and 3.35 TB/s, each input read once and each output written once),
then the card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PEAK_BF16, HBM = 989e12, 3.35e12

# (unit, label, rows, K = width of dy, N = width of dx, gate, res, out
# sizes, calls per unit)
DX = [("T", "da1 = dy3 W2^T, gate", 3840, 512, 2048, True, False, (4, 2), 6),
      ("T", "gv2 = da1 W1^T + gr3", 3840, 2048, 512, False, True, (4,), 6),
      ("T", "datt2 = dy2 Wm2^T", 3840, 512, 512, False, False, (2,), 6),
      ("T", "gv1 = dqx Wq2^T + gr2", 3840, 512, 512, False, True, (4,), 6),
      ("T", "datt1 = dy1 Wm1^T", 3840, 512, 512, False, False, (2,), 6),
      ("T", "dx = dqkv Wqkv^T + gr1", 3840, 1536, 512, False, True, (4,), 6),
      ("T", "enc da1, gate", 896, 512, 2048, True, False, (4, 2), 6),
      ("T", "enc gx1 + gr2", 896, 2048, 512, False, True, (4,), 6),
      ("T", "enc datt", 896, 512, 512, False, False, (2,), 6),
      ("T", "enc dx + gr1", 896, 1536, 512, False, True, (4,), 6),
      ("L", "da1, gate", 1920, 1024, 4096, True, False, (4, 2), 12),
      ("L", "gv2 + gr3 -> bf16", 1920, 4096, 1024, False, True, (2,), 12),
      ("L", "datt2", 1920, 1024, 1024, False, False, (2,), 12),
      ("L", "gv1 + gr2", 1920, 1024, 1024, False, True, (4,), 12),
      ("L", "datt1", 1920, 1024, 1024, False, False, (2,), 12),
      ("L", "dx + gr1", 1920, 3072, 1024, False, True, (4,), 12)]
# (unit, label, R, M = width of x, N = width of dy, calls per unit)
DW = [("T", "dW1 = v2^T da1", 3840, 512, 2048, 6),
      ("T", "dW2 = h1d^T dy3", 3840, 2048, 512, 6),
      ("T", "dWqkv", 3840, 512, 1536, 6),
      ("T", "dWm1, dWq2, dWm2", 3840, 512, 512, 18),
      ("T", "enc dWqkv", 896, 512, 1536, 6),
      ("T", "enc dWm", 896, 512, 512, 6),
      ("T", "enc dW1", 896, 512, 2048, 6),
      ("T", "enc dW2", 896, 2048, 512, 6),
      ("L", "dW1", 1920, 1024, 4096, 12),
      ("L", "dW2", 1920, 4096, 1024, 12),
      ("L", "dWqkv", 1920, 1024, 3072, 12),
      ("L", "dWm1, dWq2, dWm2", 1920, 1024, 1024, 36)]


def bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM) * 1e3


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
    if Path(mcan_vqa_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"mcan_vqa_tpu_torch was not imported from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)

    totals = {}

    def emit(kernel, unit, label, shape, calls, ms, mm_ms, b):
        t = totals.setdefault((kernel, unit), [0, 0.0, 0.0, 0.0])
        t[0] += calls
        t[1] += calls * ms
        t[2] += calls * mm_ms
        t[3] += calls * b
        print(json.dumps({"tag": args.tag, "kernel": kernel, "unit": unit,
                          "case": label, "shape": shape, "calls": calls,
                          "ms": ms, "mm_ms": mm_ms, "bound_ms": b}),
              flush=True)

    for unit, label, M, Kd, N, has_gate, has_res, outs, calls in DX:
        dy = randn(M, Kd, dtype=bf16)
        w = randn(N, Kd, dtype=bf16, s=Kd ** -0.5)
        kw = dict(gate=torch.relu(randn(M, N)).to(bf16) if has_gate else None,
                  inv_keep=1 / 0.9, res=randn(M, N) if has_res else None,
                  out_dtypes=tuple(torch.float32 if o == 4 else bf16
                                   for o in outs))
        nbytes = 2 * (M * Kd + N * Kd) + M * N * (2 * has_gate + 4 * has_res
                                                  + sum(outs))
        emit("gemm_dx", unit, label, [M, Kd, N], calls,
             graph_ms(torch, lambda: K.gemm_dx(dy, w, **kw)),
             graph_ms(torch, lambda: torch.mm(dy, w.t())),
             bound_ms(2 * M * Kd * N, nbytes))
    for unit, label, R, M, N, calls in DW:
        x = randn(R, M, dtype=bf16)
        dy = randn(R, N, dtype=bf16, s=R ** -0.5)
        emit("gemm_dw", unit, label, [R, M, N], calls,
             graph_ms(torch, lambda: K.gemm_dw(x, dy)),
             graph_ms(torch, lambda: torch.mm(x.t(), dy)),
             bound_ms(2 * R * M * N, 2 * R * (M + N) + 4 * M * N))
    for (kernel, unit), (calls, ms, mm_ms, b) in totals.items():
        print(json.dumps({"tag": args.tag, "kernel": kernel, "unit": unit,
                          "calls": calls, "ms": ms, "mm_ms": mm_ms,
                          "x_mm": ms / mm_ms, "bound_ms": b}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
