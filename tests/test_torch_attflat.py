"""The port's AttFlat through the kernels (mcan_vqa_tpu_torch/ops/attflat.py
``attflat_pallas``: ``gemm_bias_act``, ``attflat_pool``, ``gemm_bias_act``)
on the CPU, i.e. their plain versions, against the JAX package's
``attflat_pallas`` in interpret mode: the pooled output and the attention
weights, with one glimpse and two, an f32 and a bf16 stream, and a fully
padded sample (its logits + -1e9 on both sides: a uniform softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops.attflat import attflat_pallas as jax_attflat
from mcan_vqa_tpu_torch.ops import kernels
from mcan_vqa_tpu_torch.ops.attflat import attflat_pallas
from mcan_vqa_tpu_torch.ops.serving import _attflat

B, L, D, FM, O = 4, 9, 32, 24, 40
LENGTHS = [9, 0, 4, 1]           # sample 1 fully padded


def _inputs(G, stream, seed=0):
    rng = np.random.default_rng(seed + G)

    def w(k, n):
        return (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)

    x = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = (np.arange(L)[None, :] >= np.asarray(LENGTHS)[:, None])[
        :, None, None, :]
    x[mask[:, 0, 0, :]] = 0.0           # PAD rows are zero, as make_mask reads
    p = dict(w1=w(D, FM), b1=0.1 * rng.normal(size=FM), w2=w(FM, G),
             b2=0.1 * rng.normal(size=G), wm=w(G * D, O),
             bm=0.1 * rng.normal(size=O))
    jargs = [jnp.asarray(x, jnp.dtype(stream)), jnp.asarray(mask)] + [
        jnp.asarray(p[k], jnp.bfloat16 if k[0] == "w" else jnp.float32)
        for k in ("w1", "b1", "w2", "b2", "wm", "bm")]
    targs = [torch.from_numpy(x).to(getattr(torch, stream)),
             torch.from_numpy(mask)] + [
        torch.tensor(p[k], dtype=torch.bfloat16 if k[0] == "w"
                     else torch.float32)
        for k in ("w1", "b1", "w2", "b2", "wm", "bm")]
    return jargs, targs


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_attflat_pallas_matches_jax(G, stream):
    jargs, targs = _inputs(G, stream)
    jout, jatt = jax_attflat(*jargs, interpret=True)
    before = kernels.launch_counts()
    out, att = attflat_pallas(*targs)
    assert kernels.launch_counts() == before
    assert out.shape == (B, O) and att.shape == (B, L, G)
    assert out.dtype == att.dtype == torch.float32
    # att: the same f32 logits of exact bf16 products, summed in another
    # order, through one softmax: 1e-5. out: the pooled vector rounded to
    # bf16 (a step is 2^-8 relative) before the merge: 1e-2 on |out| < 2
    np.testing.assert_allclose(att.numpy(), np.asarray(jatt), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-2,
                               atol=1e-2)
    # the fully padded sample: a uniform softmax over its own tokens
    np.testing.assert_allclose(att[1].numpy(), 1.0 / L, rtol=1e-6)


def test_attflat_switch_matches_the_plain_attflat():
    """``_attflat(use_pallas=True)`` (the kernels) against the plain
    AttFlat of the serving engine (``where`` in place of the additive
    -1e9): the same function, the fully padded sample included."""
    _, (x, mask, w1, b1, w2, b2, wm, bm) = _inputs(1, "float32", seed=5)
    p = {"mlp": {"FCLayer_0": {"Dense_0": {"kernel": w1, "bias": b1}},
                 "Dense_0": {"kernel": w2, "bias": b2}},
         "linear_merge": {"kernel": wm, "bias": bm}}
    ref = _attflat(p, x, mask)
    out = _attflat(p, x, mask, use_pallas=True)
    # the same bf16 hidden, logits and pooled vector into the same merge
    # (-1e9 + a logit under 32 is -1e9 in f32): equal up to the order of
    # the f32 sums, 1e-5
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
