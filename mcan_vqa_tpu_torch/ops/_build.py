"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

One nvcc per source, all started together, compiles each .cu file to an
object; one more nvcc links the objects into a shared library with a plain
C interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). The library lands in ``_kernels_build/<hash>/`` inside the
package, keyed by a hash of the sources and the nvcc flags, so an edit to
any source rebuilds and an unchanged tree reuses the last build. The
directory is listed in .gitignore.

Nothing here runs at import: ``load_library()`` compiles on the first call
and caches the handle for the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_kernels_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "libmcan_kernels.so"

_P, _I, _LL, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float, ctypes.c_uint
_KEEP = [_I, _U, _U, _U]      # a seeded keep source: on, seed, site, thresh
# argtypes of every exported C function (csrc/*.cu, MCAN_API)
SIGNATURES = {
    "mcan_gemm_sm90": [_I, _P, _LL, _P, _LL, _I, _I, _I, _I, _I, _I, _P, _LL,
                       _F, _P, _LL, _P, _I, _P, _LL, *_KEEP, _I, _P, _P, _P,
                       _P, _P],
    "mcan_gemm_sm90_s8": [_P, _LL, _P, _LL, _I, _I, _I, _I, _I, _P, _F, _P,
                          _P, _I, _P, _P, _P],
    "mcan_gemm_sm90_smem": [_I, _I],
    "mcan_masked_attention": [_P, _I, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL,
                              _I, _P, _P, _F, *_KEEP, _P, _I, _LL, _LL, _I,
                              _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    "mcan_masked_attention_bwd": [_P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL,
                                  _I, _P, _P, _F, *_KEEP, _P, _LL, _LL,
                                  _P, _P, _LL, _LL, _LL,
                                  _P, _P, _LL, _LL, _LL,
                                  _P, _P, _LL, _LL, _LL,
                                  _P, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "mcan_residual_layernorm": [_P, _I, _P, _P, _P, _F, *_KEEP, _I, _P, _P,
                                _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "mcan_residual_layernorm_bwd": [_P, _I, _P, _I, _P, _P, _P, _F, *_KEEP,
                                    _I, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "mcan_col_sum": [_I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "mcan_quantize_rows": [_P, _I, _LL, _I, _I, _I, _F, _P, _P, _P],
    "mcan_gemm_s4": [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                     _P, _I, _P, _P, _P, _P, _P],
    "mcan_gemm_w4bf16": [_P, _LL, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I,
                         _P, _I, _P, _P, _P, _P, _P],
    "mcan_gemm_int4_smem": [_I, _I],
    "mcan_gemm_ln": [_P, _I, _LL, _P, _LL, _P, _P, _I, _LL, _P, _P, _P, _LL,
                     _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P],
    "mcan_gemm_ln_smem": [_I, _I, _I],
    "mcan_gemm_ln_max_clusters": [_I, _I, _I, _I],
    "mcan_attflat_pool": [_P, _LL, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _P],
    "mcan_prng_masks": [_I, _P, _P, _P, _P, _I, _U, _U, _P, _I, _P],
    "mcan_philox_words": [_U, _U, _I, _I, _P, _P, _I, _P],
    "mcan_prng_kernel_attrs": [_I, _P],
    "mcan_sga_decoder": [_P, _I, _P, _I, _P, _P, _I, _LL, _LL, _LL, _LL, _P,
                         _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                         _F, _P, _P, _P, _I, _P, _P],
    "mcan_sa_encoder": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _P, _P, _P, _I, _P, _P],
    "mcan_ffn_ln_blocked": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _F, _P, _I, _P],
    "mcan_ffn_ln_wstationary": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _F, _P, _I, _P, _P],
    "mcan_ffn_ln_wstationary_max_clusters": [_I, _I, _I, _I, _I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log: str = ""                     # nvcc's output (-Xptxas -v)
step_seconds: dict = {}                 # wall seconds per source, and link


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels are built "
            "from source at first use and need the CUDA toolkit")
    return path


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the nvcc commands in parallel -> (their combined output, each
    command's wall seconds); raises with the output of every command that
    failed."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, secs = [None] * len(procs), [0.0] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()[0]
        secs[i] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(i,))
               for i in range(len(procs))]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = [f"{' '.join(c)}\n{o}" for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs), secs


def _compile(out: Path) -> str:
    """Build ``out`` (atomically: objects and the library in a temporary
    directory beside it, then a rename) -> nvcc's output; each step's wall
    seconds into ``step_seconds``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        cus = [s for s in sources() if s.suffix == ".cu"]
        objs = [os.path.join(tmp, f"{s.stem}.o") for s in cus]
        log, secs = _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s),
                           "-o", o] for s, o in zip(cus, objs)])
        step_seconds.update(zip((s.name for s in cus), secs))
        lib = os.path.join(tmp, LIB_NAME)
        link, secs = _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        step_seconds["link"] = secs[0]
        os.replace(lib, out)
    return log + link


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out = BUILD_ROOT / build_key() / LIB_NAME
        if not out.exists():
            t0 = time.perf_counter()
            build_log = _compile(out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
