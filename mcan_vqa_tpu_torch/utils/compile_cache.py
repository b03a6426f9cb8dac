"""The JAX CLIs' persistent compilation cache switch, kept as a documented
no-op (mcan_vqa_tpu/utils/compile_cache.py).

JAX compiles every program through XLA and caches the executables in a
directory that ``enable`` points it at. The port compiles nothing per
process: its CUDA kernels are built once by nvcc into
``mcan_vqa_tpu_torch/_kernels_build/<key>/`` (``ops/_build.py``), a
directory keyed by the hash of the sources, which every later process on
the same checkout reuses, and the engines run eagerly. So ``enable``
resolves its argument as JAX's does -- the argument, then
``MCAN_COMPILE_CACHE``, then ``~/.cache/mcan_vqa_tpu/xla``; a value in
{"off", "none", "0", "disable", "disabled"} (any case) turns it off -- and
returns None whatever it resolves to, creating no directory. ``run_vqa``,
``run_mimic``, ``run_classify`` and ``serve`` take ``--compile_cache`` and
pass it here.
"""

from __future__ import annotations

import os
from typing import Optional

_OFF = ("off", "none", "0", "disable", "disabled")


def default_cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "mcan_vqa_tpu", "xla")


def resolve(cache_dir: Optional[str] = None) -> Optional[str]:
    """The directory JAX's ``enable`` would use for ``cache_dir`` (absolute),
    or None where the value turns the cache off."""
    if cache_dir is None:
        cache_dir = os.environ.get("MCAN_COMPILE_CACHE") or \
            default_cache_dir()
    if cache_dir.strip().lower() in _OFF:
        return None
    return os.path.abspath(os.path.expanduser(cache_dir))


def enable(cache_dir: Optional[str] = None,
           min_compile_secs: float = 1.0) -> None:
    """Accept JAX's arguments and do nothing: no cache is needed (see the
    module docstring). Returns None, where JAX's returns the directory it
    set."""
    del min_compile_secs
    resolve(cache_dir)
    return None
