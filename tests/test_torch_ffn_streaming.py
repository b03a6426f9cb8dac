"""The port's streaming FFN + LayerNorm variants
(mcan_vqa_tpu_torch/ops/fused_ffn.py ``fused_ffn_ln_blocked`` and
``fused_ffn_ln_weight_stationary``) on the CPU, i.e. their kernels' plain
version ``kernels.ffn_ln_plain``, against the JAX package's functions in
interpret mode: at M = 32 rows with tile_m 16 and tile_f 64 the Pallas
kernels run a 2 x 2 grid (``_ffn_ln_blocked_kernel`` M outer,
``_ffn_ln_wstationary_kernel`` F outer); at M = 21 no row tile divides the
rows and JAX takes its XLA branch (fused_ffn.py:163-170, :252-259), which
the port does not have: it computes every row the same way at both. The
CUDA kernels are held against the plain version on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py ``[last sites]``).

Tolerance: the output is f32 either side, the products are the same exact
bf16 products summed in another order (JAX over its F tiles, the plain
version in one product), then an LN of O(1) values: 1e-4, as
tests/test_torch_fused_ffn.py holds the f32 stream.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import fused_ffn as jffn
from mcan_vqa_tpu_torch.ops import fused_ffn as tffn
from mcan_vqa_tpu_torch.ops import kernels

D, F = 64, 128
TOL = 1e-4
VARIANTS = {"blocked": (jffn.fused_ffn_ln_blocked,
                        tffn.fused_ffn_ln_blocked),
            "weight_stationary": (jffn.fused_ffn_ln_weight_stationary,
                                  tffn.fused_ffn_ln_weight_stationary)}
# case: (rows, tile_m, tile_f, weight dtype, x dtype)
CASES = {"tiled-M32": (32, 16, 64, "float32", "float32"),
         "xla-branch-M21": (21, 16, 64, "float32", "float32"),
         "one-F-tile": (32, 16, F, "float32", "float32"),
         "bf16-weights": (32, 16, 64, "bfloat16", "float32"),
         "bf16-x": (32, 16, 64, "bfloat16", "bfloat16")}


def _operands(seed, rows, wdt, xdt):
    """The same values for both sides: JAX arrays and torch tensors, the
    weights in ``wdt`` and x in ``xdt``."""
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.normal(size=(F, D)) / np.sqrt(F)).astype(np.float32)
    vecs = [(0.1 * rng.normal(size=n) + base).astype(np.float32)
            for n, base in ((F, 0.0), (D, 0.0), (D, 1.0), (D, 0.0))]
    x = rng.normal(size=(1, rows, D)).astype(np.float32)

    def pair(a, dt):
        return (jnp.asarray(a, jnp.dtype(dt)),
                torch.from_numpy(a).to(getattr(torch, dt)))

    (jx, tx), (jw1, tw1), (jw2, tw2) = (pair(x, xdt), pair(w1, wdt),
                                        pair(w2, wdt))
    jb1, jb2, js, jb = (jnp.asarray(v) for v in vecs)
    tb1, tb2, ts, tb = (torch.from_numpy(v) for v in vecs)
    return ((jx, jw1, jb1, jw2, jb2, js, jb),
            (tx, tw1, tb1, tw2, tb2, ts, tb))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_streaming_ffn_ln_matches_jax(variant, case):
    rows, tile_m, tile_f, wdt, xdt = CASES[case]
    jfn, tfn = VARIANTS[variant]
    jargs, targs = _operands(rows, rows, wdt, xdt)
    ref = np.asarray(jfn(*jargs, tile_m=tile_m, tile_f=tile_f,
                         interpret=True))
    before = kernels.launch_counts()
    out = tfn(*targs, tile_m=tile_m, tile_f=tile_f)
    assert kernels.launch_counts() == before
    # the output is f32 whatever x's dtype, in x's shape, as JAX's
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert tuple(out.shape) == ref.shape == (1, rows, D)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_both_variants_compute_the_plain_function():
    """Both wrappers are one function on the CPU: ``ffn_ln_plain`` of the
    rows, whatever tile_m / tile_f say (they pick no path on either
    device)."""
    _, targs = _operands(7, 21, "bfloat16", "float32")
    x, w1, b1, w2, b2, s, b = targs
    want = kernels.ffn_ln_plain(x.reshape(-1, D), w1, b1, w2, b2, s, b)
    for _, tfn in VARIANTS.values():
        for tm, tf in ((256, 1024), (8, 128)):
            got = tfn(*targs, tile_m=tm, tile_f=tf)
            assert torch.equal(got.reshape(-1, D), want)

