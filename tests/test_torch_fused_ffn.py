"""The port's per-sub-op residual + LayerNorm sub-blocks
(mcan_vqa_tpu_torch/ops/fused_ffn.py) on the CPU, i.e. the plain versions of
``gemm_ln`` and ``gemm_bias_act``, against the JAX package's
``fused_proj_ln`` / ``fused_ffn_ln`` in interpret mode, with an f32 and a
bf16 stream: at M = 16 rows the Pallas kernels run (``_proj_ln_kernel``,
``_ffn_ln_kernel``), at M = 24 they run over three row tiles of 8 (rows
that no power-of-two tile over 8 divides, as the card's 64-row blocks
leave a ragged last block), at M = 14 no tile divides the rows and JAX
takes its XLA branch (fused_ffn.py:83-90, :313-315); the port computes
every row the same way at all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import fused_ffn as jffn
from mcan_vqa_tpu_torch.ops import fused_ffn as tffn
from mcan_vqa_tpu_torch.ops import kernels

D, F = 64, 256
BF16 = torch.bfloat16


def _weights(seed):
    rng = np.random.default_rng(seed)

    def w(k, n):
        return (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)

    def vec(n, s=0.1, base=0.0):
        return (base + s * rng.normal(size=n)).astype(np.float32)

    return dict(w1=w(D, F), b1=vec(F), w2=w(F, D), b2=vec(D), wm=w(D, D),
                bm=vec(D), scale=vec(D, base=1.0), bias=vec(D))


def _pair(x, dtype):
    """The same values for both sides: a JAX array (the kernels' bf16
    weights cast as the serving trees hold them) and a torch tensor."""
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch,
                                                                   dtype)))


def _close(out, ref, stream):
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    # f32 stream: the same exact bf16 products summed in another order,
    # then an LN of O(1) values: 1e-4. bf16 stream: plus one rounding of
    # the output, which may land a step (2^-8 relative) apart: 2e-2 on
    # |out| < 4
    tol = 1e-4 if stream == "float32" else 2e-2
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("rows", [16, 14, 24])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_fused_proj_ln_matches_jax(rows, stream):
    p = _weights(1)
    rng = np.random.default_rng(rows)
    res = rng.normal(size=(2, rows // 2, D)).astype(np.float32)
    a = rng.normal(size=(2, rows // 2, D)).astype(np.float32)
    jres, tres = _pair(res, stream)
    ja, ta = _pair(a, "float32")          # the f32 attention output
    jw, tw = _pair(p["wm"], "bfloat16")
    vecs = [_pair(p[k], "float32") for k in ("bm", "scale", "bias")]
    ref = jffn.fused_proj_ln(jres, ja, jw, *[j for j, _ in vecs],
                             interpret=True)
    before = kernels.launch_counts()
    out = tffn.fused_proj_ln(tres, ta, tw, *[t for _, t in vecs])
    assert out.dtype == tres.dtype and kernels.launch_counts() == before
    _close(out, ref, stream)


@pytest.mark.parametrize("rows", [16, 14, 24])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_fused_ffn_ln_matches_jax(rows, stream):
    p = _weights(2)
    x = np.random.default_rng(rows + 7).normal(
        size=(2, rows // 2, D)).astype(np.float32)
    jx, tx = _pair(x, stream)
    jw1, tw1 = _pair(p["w1"], "bfloat16")
    jw2, tw2 = _pair(p["w2"], "bfloat16")
    vecs = [_pair(p[k], "float32") for k in ("b1", "b2", "scale", "bias")]
    (jb1, tb1), (jb2, tb2), (js, ts), (jb, tb) = vecs
    ref = jffn.fused_ffn_ln(jx, jw1, jb1, jw2, jb2, js, jb, interpret=True)
    out = tffn.fused_ffn_ln(tx, tw1, tb1, tw2, tb2, ts, tb)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, ref, stream)


def test_gemm_ln_plain_is_the_residual_layernorm_of_the_product():
    """gemm_ln's plain version: LN(res + bf16(a) . w + b), the residual
    LayerNorm of one product, in the residual's dtype, at a width (72)
    that only the 8-column rule admits."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5, 40, generator=g)
    w = torch.randn(40, 72, generator=g).to(BF16)
    b, res = torch.randn(72, generator=g), torch.randn(5, 72, generator=g)
    gamma, beta = torch.ones(72), torch.zeros(72)
    out = kernels.gemm_ln(a, w, b, res.to(BF16), gamma, beta)
    ref = kernels.residual_layernorm_plain(
        res.to(BF16), a.to(BF16).float() @ w.float(), b, gamma, beta,
        (BF16,))[0]
    assert out.dtype == BF16 and torch.equal(out, ref)
