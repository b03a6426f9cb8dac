"""What the card checks share: ``chip_smoke.py`` and the validators
(``cli/validate_inkernel_dw.py``, ``cli/validate_prng_dropout.py``) print,
gate, time and record kernels through these, so a check moved out of the
smoke run keeps its gates and its rows.

  * ``say`` / ``fail`` (a line; FAIL on stderr and exit 1), ``gate``
    (max|err| against a tolerance, or fail), ``max_err``, ``pad_mask``;
  * ``cuda_ms`` (CUDA events around eager calls, host issue time
    included), ``device_ms`` (the calls captured in a CUDA graph and
    replayed: device time alone), ``plain_path`` (a call with every wrapper
    forced onto its plain version), ``time_pieces``;
  * ``bound_parts`` at the published peaks of one H100 SXM, and ``Rows``,
    the kernels' JSON record (per kernel: its launches on the main paths,
    and per unit of them its device time, its plain version's, one library
    call's and its bound).
"""

from __future__ import annotations

import sys

SEED = 0
BATCH = 64                      # the max_batch bucket and the train batch
SRC = "mcan_vqa_tpu_torch/csrc/"
TPU_TRAIN = "mcan_vqa_tpu/ops/sga_train.py"
TPU_SA_TRAIN = "mcan_vqa_tpu/ops/sa_train.py"
# published peaks of one H100 SXM (the bound_ms of every kernel row)
PEAK_BF16 = 989e12              # FLOP/s, dense, tensor cores
PEAK_F32 = 67e12                # FLOP/s, outside the tensor cores
PEAK_INT8 = 1979e12             # OP/s, dense, tensor cores
# OP/s, 32-bit integer: 64 INT32 lanes an SM (NVIDIA's Hopper white paper)
# x 132 SMs x the 1.98 GHz boost clock behind PEAK_F32
PEAK_INT32 = 132 * 64 * 1.98e9
HBM = 3.35e12                   # bytes/s
STEP = "one B=64 train step"
LARGE_STEP = "one B=64 MCAN-large train step (2 micro-batches of 32)"
PRNG_SEED = 1234567             # the in-kernel dropout's seed in the checks
# the integer operations of one Philox4x32-10 counter (ten rounds of two
# 32 x 32 -> 64-bit products and two three-input XORs) and of the dump's
# four compares; the key schedule (a row's) is not counted
PHILOX_OPS, KEEP_OPS = 40, 4
# the seeded (in-kernel dropout) pieces: row, the TPU kernel body, unit
PRNG_ROWS = (
    ("sga_train_fwd_prng", TPU_TRAIN + ":507", STEP),
    ("sga_train_bwd_ffn_prng", TPU_TRAIN + ":617", STEP),
    ("sga_train_bwd_att_prng", TPU_TRAIN + ":812", STEP),
    ("sa_train_fwd_prng", TPU_SA_TRAIN + ":179", STEP),
    ("sa_train_bwd_prng", TPU_SA_TRAIN + ":314", STEP),
    ("sga_train_bwd_att_sav_prng", TPU_TRAIN + ":1202", LARGE_STEP))



def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() in ms, by CUDA events over `iters` eager calls:
    what a caller waits for, host issue time included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph and replayed, so the host's time to issue each launch (tens of
    microseconds of Python per wrapper call, more than a small kernel
    runs) stays out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def gate(name: str, err: float, tol: float) -> None:
    ok = err <= tol and err == err
    say(f"  {name}: max|err| {err:.3e} <= tol {tol:.3e} "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{name}: max|err| {err} over tolerance {tol}")


def pad_mask(torch, B: int, L: int, lengths, dev):
    """bool [B, 1, 1, L], True past each sample's length (0 = all PAD)."""
    idx = torch.arange(L, device=dev)
    lens = torch.tensor(lengths, device=dev)
    return (idx[None, :] >= lens[:, None])[:, None, None, :]


def bound_parts(flops: float, nbytes: float, tensor: bool = True,
                int8_ops: float = 0.0, int_ops: float = 0.0):
    """(ms at the peak operation rates, ms at the memory rate): the least
    time for `flops` operations of their type (bf16 on the tensor cores,
    else f32) plus `int8_ops` int8 tensor-core operations and `int_ops`
    32-bit integer operations, and `nbytes` moved, each input read once
    and each output written once."""
    return ((flops / (PEAK_BF16 if tensor else PEAK_F32)
             + int8_ops / PEAK_INT8 + int_ops / PEAK_INT32) * 1e3,
            nbytes / HBM * 1e3)


class Rows:
    """The kernels' JSON record: per kernel, its launches on the main paths
    and, for the work of one unit of them (``per``), its device time, its
    plain version's, one library call's, and its bound with the operations
    and bytes it counts."""

    def __init__(self):
        self.rows = {}
        self.order = []

    def row(self, name, source, replaces, per):
        if name not in self.rows:
            self.order.append(name)
            self.rows[name] = dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=0, launches_by_path={}, max_abs_err=0.0, ms=0.0,
                plain_ms=0.0, bound_ms=0.0, bound_by=None, library_ms=None,
                per=per, flops=0, bytes=0, _op=0.0, _bytes=0.0, _timed=0,
                _lib=0)
        return self.rows[name]

    def add(self, name, n, ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0,
            library_ms=None, tensor=True, int8_ops=0.0, int_ops=0.0):
        """n calls of one shape per unit: their times and bounds."""
        r = self.rows[name]
        op, by = bound_parts(flops, nbytes, tensor, int8_ops, int_ops)
        r["ms"] += n * ms
        r["plain_ms"] += n * plain_ms
        r["bound_ms"] += n * max(op, by)
        r["flops"] += n * int(flops + int8_ops + int_ops)
        r["bytes"] += n * int(nbytes)
        r["_op"] += n * op
        r["_bytes"] += n * by
        r["_timed"] += n if ms else 0
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + n * library_ms
            r["_lib"] += n

    def unmeasured(self, name):
        """A library call computes the row's function, but a case of it
        went untimed: the row's library_ms is null."""
        self.rows[name]["_unmeasured"] = True

    def err(self, name, e):
        self.rows[name]["max_abs_err"] = max(self.rows[name]["max_abs_err"],
                                             float(e))

    def launches(self, path, counts, names, key=None):
        """Each row's launches on one main path: counts[name], or
        counts[key[name]] where the row stands for one instantiation of a
        wrapper (the Dh = 128 attention on the MCAN-large path)."""
        for name in names:
            r = self.rows[name]
            r["launches_by_path"][path] = counts.get(
                name if key is None else key[name], 0)
            r["launches"] = sum(r["launches_by_path"].values())

    def record(self):
        out = []
        for name in self.order:
            r = dict(self.rows[name])
            timed, lib = r.pop("_timed"), r.pop("_lib")
            if 0 < lib != timed:
                say(f"[rows] {name}: the library call was timed for {lib} "
                    f"of the {timed} calls per unit: library_ms null")
            if r.pop("_unmeasured", False) or 0 < lib != timed:
                r["library_ms"] = None
            r["bound_by"] = "operations" if r.pop("_op") >= r.pop("_bytes") \
                else "bytes"
            out.append(r)
        return out


def plain_path(K, fn):
    """fn with every wrapper forced onto its plain version (the wrappers'
    CPU path on the card's tensors)."""
    def run_plain():
        on_cuda = K.on_cuda
        K.on_cuda = lambda t: False
        try:
            return fn()
        finally:
            K.on_cuda = on_cuda
    return run_plain


def time_pieces(torch, K, rows, pieces, work, n) -> None:
    """Each piece's kernel sequence against the same sequence of plain
    versions: device times, and n of them per unit into its row."""
    for name, fn in pieces.items():
        flops, nbytes = work[name]
        t_k = device_ms(torch, fn, iters=10)
        t_p = device_ms(torch, plain_path(K, fn), iters=5)
        say(f"  {name}: {t_k:.4f} ms vs plain {t_p:.4f} ms per block; bound "
            f"{max(bound_parts(flops, nbytes)):.4f} ms")
        rows.add(name, n, t_k, t_p, flops, nbytes)


def prng_rows(rows) -> None:
    for name, replaces, per in PRNG_ROWS:
        rows.row(name, "mcan_vqa_tpu_torch/ops/" + replaces.split("/")[-1]
                 .split(":")[0], replaces, per)


def run_check(check, argv, doc: str) -> None:
    """A validator's command line: refuse without a CUDA device, build the
    kernels, run ``check(torch, dev, rows)`` (a failed gate exits 1), then
    print the kernels' rows as one JSON line and the card."""
    import argparse
    import json
    import subprocess

    argparse.ArgumentParser(description=doc.split("\n")[0]).parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs the card's kernels and has "
             "no CPU fallback")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mcan_vqa_tpu_torch.ops import _build
    _build.load_library()
    rows = Rows()
    check(torch, torch.device("cuda"), rows)
    say(json.dumps({"kernels": rows.record()}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    say(smi.stdout.strip())
