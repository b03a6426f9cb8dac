"""Device time of the mask dump and the raw Philox words (csrc/prng_masks.cu)
at their units, beside another version of the kernel in the same process.

    python mcan_vqa_tpu_torch/cli/bench_prng.py [--root DIR] [--tag T]

Units: ``sga`` one MCAN-small SGA block's dump at B = 64 (six sites,
16,035,840 keep bytes), ``sa`` one MCAN-small SA block's at B = 64,
``large`` one MCAN-large SGA block's at micro-batch 32, ``words``
``philox_words`` on 16 x 2^17 words (the kernel's uint32; ``words
int64`` with the wrapper's int64 copy, this version only). Each beside
the plain version, the
library yardstick (``torch.rand`` + the compare over the same shapes; for
the words ``torch.randint`` of as many int32) and the bound (44 integer
operations a counter for the masks, 40 for the words, at 16.7 T/s, or
the bytes written at 3.35 TB/s, the larger).

``--root`` names another checkout (an older commit unpacked with ``git
archive``): its ``csrc/prng_masks.cu`` is compiled alone with nvcc and
loaded beside this checkout's library, and each unit runs other, this,
this, other in the one process, every output held bit for bit against
the plain version. A source without ``mcan_prng_kernel_attrs`` is called
through the C entries of the first design (no plan: n_sites, outs,
sites, heads, n, B, seed, thresh, stream; seed, site, B, n, out, stream).

Then the compiled instruction mix of the dump kernel (``cuobjdump
-sass``: opcodes counted over the kernel, each chunk's 4 counters x 10
rounds once through the loop) and its registers and local bytes. Each
time: 50 calls in one CUDA graph, replayed 5 times, the median per call.
Prints one JSON line per unit and version, then the card. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PEAK_INT32 = 132 * 64 * 1.98e9      # INT32 lanes x SMs x boost clock
HBM = 3.35e12
PHILOX_OPS, COMPARE_OPS = 40, 4     # a counter: ten rounds; the keep bytes
SEED, RATE = 1234567, 0.1


def dump_specs(units):
    """unit -> (B, [(site code, heads, n)]) of sga_train / sa_train's
    dumps."""
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    from mcan_vqa_tpu_torch.ops import sga_train as st
    table = {
        "sga": (64, st.mask_sites(st.mask_shapes(64, 60, 14, 512, 2048, 8),
                                  st.SITES)),
        "sa": (64, st.mask_sites(sa.mask_shapes(64, 14, 512, 2048, 8),
                                 sa.SA_SITES)),
        "large": (32, st.mask_sites(st.mask_shapes(32, 60, 14, 1024, 4096, 8),
                                    st.SITES))}
    return {u: table[u] for u in units if u in table}


def load_other(root: Path):
    """The other checkout's prng_masks.cu built alone -> (ctypes library,
    True where it takes a plan)."""
    from mcan_vqa_tpu_torch.ops import _build
    csrc = root / "mcan_vqa_tpu_torch" / "csrc"
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=_build.BUILD_ROOT))
    lib_path = out / "libprng_other.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(csrc), str(csrc / "prng_masks.cu"), "-o",
                    str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    planned = hasattr(lib, "mcan_prng_kernel_attrs")
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    if planned:
        lib.mcan_prng_masks.argtypes = [I, P, P, P, P, I, U, U, P, I, P]
        lib.mcan_philox_words.argtypes = [U, U, I, I, P, P, I, P]
    else:
        lib.mcan_prng_masks.argtypes = [I, P, P, P, P, I, U, U, P]
        lib.mcan_philox_words.argtypes = [U, U, I, I, P, P]
    return lib, planned


def other_dump(torch, K, lib, planned, seed, thresh, B, sites):
    """The other version's dump: uint8 [B, heads, n] per site."""
    dev = torch.device("cuda")
    k = len(sites)
    outs = [torch.empty((B, h, n), dtype=torch.uint8, device=dev)
            for _, h, n in sites]
    arrays = ((ctypes.c_void_p * k)(*[t.data_ptr() for t in outs]),
              (ctypes.c_uint * k)(*[s for s, _, _ in sites]),
              (ctypes.c_int * k)(*[h for _, h, _ in sites]),
              (ctypes.c_int * k)(*[n for _, _, n in sites]))
    args = [k, *(ctypes.cast(a, ctypes.c_void_p) for a in arrays), B, seed,
            thresh]
    if planned:
        f = K.prng_plan(B, tuple((h, n) for _, h, n in sites),
                        K.GEMM_SMS).fields()
        args += [(ctypes.c_uint * len(f))(*f), len(f)]
    rc = lib.mcan_prng_masks(*args, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"the other dump: CUDA error {rc}"
    return outs


def other_words(torch, K, lib, planned, seed, site, B, n):
    """The other version's words, uint32 [B, n] as its kernel writes them."""
    dev = torch.device("cuda")
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    args = [seed, site, B, n, out.data_ptr()]
    if planned:
        f = K.prng_plan(B, ((1, n),), K.GEMM_SMS, 4).fields()
        args += [(ctypes.c_uint * len(f))(*f), len(f)]
    rc = lib.mcan_philox_words(*args, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, f"the other words: CUDA error {rc}"
    return out.view(torch.uint32)


def bound_ms(counters: int, ops: int, nbytes: int):
    """(ms, "operations" or "bytes")."""
    t_op, t_by = counters * ops / PEAK_INT32 * 1e3, nbytes / HBM * 1e3
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def sass_mix(build, lib_file: Path) -> dict:
    """Opcode counts of prng_kernel<false> (the dump) in the library."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib_file)],
                         capture_output=True, text=True).stdout
    counts, inside = collections.Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "prng_kernel" in line and "ILb0E" in line
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if inside and m:
            counts[m.group(1)] += 1
    return dict(counts.most_common())


def time_unit(torch, graph_ms, tag, unit, plan, ops, tree, other, same,
              plain, library) -> None:
    """One unit: this version (and the other) in the order other, this,
    this, other, each output held against the plain version's; then the
    plain version, the library yardstick and the bound. One JSON line a
    version."""
    versions = [("tree", tree)] + ([("other", other)] if other else [])
    times = collections.defaultdict(list)
    for name, fn in versions[::-1] + versions:
        got = fn()
        torch.cuda.synchronize()
        assert same(got), f"{unit} {name}: differs from the plain version"
        times[name].append(graph_ms(torch, fn))
    plain_ms = graph_ms(torch, plain, calls=3, rounds=3)
    library_ms = graph_ms(torch, library)
    bound, by = bound_ms(plan.counters, ops, plan.out_bytes)
    for name, ts in times.items():
        print(json.dumps({
            "unit": unit, "version": tag if name == "tree" else "other",
            "ms": ts, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by, "bytes": plan.out_bytes,
            "counters": plan.counters, "grid": plan.grid,
            "width": plan.width, "equal_to_plain": True}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="another checkout whose prng_masks.cu to time "
                         "beside this one")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--units", default="sga,sa,large,words")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_prng: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from mcan_vqa_tpu_torch.cli.bench_layernorm import graph_ms
    from mcan_vqa_tpu_torch.ops import _build
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sga_train as st
    lib = _build.load_library()
    other = load_other(Path(args.root).resolve()) if args.root else None
    dev = torch.device("cuda")
    thresh, _ = st.prng_keep_params(RATE)
    units = args.units.split(",")
    for unit, (B, sites) in dump_specs(units).items():
        plan = K.prng_plan(B, tuple((h, n) for _, h, n in sites), K.GEMM_SMS)
        ref = K.dump_prng_masks_plain(SEED, thresh, B, sites, dev)
        shapes = [(B, h, n) for _, h, n in sites]
        time_unit(torch, graph_ms, args.tag, unit, plan,
                  PHILOX_OPS + COMPARE_OPS,
                  lambda: K.dump_prng_masks(SEED, thresh, B, sites, dev),
                  other and (lambda: other_dump(torch, K, *other, SEED,
                                                thresh, B, sites)),
                  lambda got: all(map(torch.equal, got, ref)),
                  lambda: K.dump_prng_masks_plain(SEED, thresh, B, sites,
                                                  dev),
                  lambda: [torch.rand(s, device=dev) >= RATE
                           for s in shapes])
    if "words" in units:
        B, n, site = 16, 1 << 17, 0x303
        ref = K.philox_words_plain(SEED, site, B, n, dev)
        plan = K.prng_plan(B, ((1, n),), K.GEMM_SMS, 4)
        time_unit(torch, graph_ms, args.tag, "words", plan, PHILOX_OPS,
                  lambda: K.philox_words(SEED, site, B, n, dev, raw=True),
                  other and (lambda: other_words(torch, K, *other, SEED,
                                                 site, B, n)),
                  lambda got: torch.equal(got.to(torch.int64), ref),
                  lambda: K.philox_words_plain(SEED, site, B, n, dev),
                  lambda: torch.randint(-2 ** 31, 2 ** 31, (B, n),
                                        dtype=torch.int32, device=dev))
        time_unit(torch, graph_ms, args.tag, "words int64", plan, PHILOX_OPS,
                  lambda: K.philox_words(SEED, site, B, n, dev), None,
                  lambda got: torch.equal(got, ref),
                  lambda: K.philox_words_plain(SEED, site, B, n, dev),
                  lambda: torch.randint(-2 ** 31, 2 ** 31, (B, n),
                                        dtype=torch.int32, device=dev))
    info = (ctypes.c_int * 3)()
    for words in (0, 1):
        lib.mcan_prng_kernel_attrs(words, info)
        print(json.dumps({"kernel": "prng_kernel<%s>" % bool(words),
                          "registers": info[0], "local_bytes": info[1]}))
    mix = sass_mix(_build, _build.BUILD_ROOT / _build.build_key()
                   / _build.LIB_NAME)
    print(json.dumps({"sass_prng_kernel_masks": mix}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}))


if __name__ == "__main__":
    main()
