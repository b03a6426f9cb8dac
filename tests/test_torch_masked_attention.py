"""The port's stand-alone masked attention (mcan_vqa_tpu_torch/ops/
masked_attention.py) on the CPU, i.e. the plain version of the attention
kernel, against the JAX package:

  * each of ``masked_attention_pallas`` / ``_batched`` / ``_packed``
    against its Pallas kernel in interpret mode, q, k, v f32 as the
    per-sub-op engine's projections give them;
  * the fully padded sample under ``_packed``: JAX at group 2 lets it
    attend to its neighbours (scores + (off_block + pad) * -1e9,
    masked_attention.py:245), the port attends to its own keys as
    ``model.apply`` and the per-sample kernel do; at group 1 both agree;
  * the widened envelope (head width 192 / 256, 160 / 300 rows) against
    ``masked_attention_xla``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import masked_attention as jatt
from mcan_vqa_tpu_torch.ops import kernels
from mcan_vqa_tpu_torch.ops import masked_attention as tatt

# f32 outputs of bf16 probabilities: one probability's rounding may land a
# step (2^-8 relative) apart, on values |v| < 4
TOL = 2 ** -7


def _inputs(lengths, Lq=5, Lk=6, Dh=8, H=2, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q, k, v = (rng.normal(size=(B, H, L, Dh)).astype(np.float32)
               for L in (Lq, Lk, Lk))
    mask = (np.arange(Lk)[None, :] >= np.asarray(lengths)[:, None])[
        :, None, None, :]
    return (q, k, v, mask), tuple(torch.from_numpy(a) for a in (q, k, v,
                                                                mask))


VARIANTS = {"pallas": (jatt.masked_attention_pallas,
                       tatt.masked_attention_pallas),
            "batched": (jatt.masked_attention_pallas_batched,
                        tatt.masked_attention_pallas_batched),
            "packed": (jatt.masked_attention_pallas_packed,
                       tatt.masked_attention_pallas_packed)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_its_pallas_kernel(variant):
    jfn, tfn = VARIANTS[variant]
    jin, tin = _inputs([6, 3, 1, 5])
    ref = np.asarray(jfn(*[jnp.asarray(a) for a in jin], interpret=True))
    before = kernels.launch_counts()
    out = tfn(*tin)
    assert kernels.launch_counts() == before
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_packed_all_pad_sample_differs_from_jax_at_group_2():
    jin, tin = _inputs([6, 0, 4, 2], seed=1)
    jargs = [jnp.asarray(a) for a in jin]
    packed = np.asarray(jatt.masked_attention_pallas_packed(
        *jargs, group=2, interpret=True))
    per_sample = np.asarray(jatt.masked_attention_pallas(*jargs,
                                                         interpret=True))
    out = tatt.masked_attention_pallas_packed(*tin, group=2).numpy()
    # the port: every sample as the per-sample kernel, the padded one too
    np.testing.assert_allclose(out, per_sample, atol=TOL, rtol=TOL)
    # JAX: the same on the samples with real keys, not on the padded one
    keep = [0, 2, 3]
    np.testing.assert_allclose(packed[keep], per_sample[keep], atol=TOL,
                               rtol=TOL)
    assert np.abs(packed[1] - per_sample[1]).max() > 0.1


def test_packed_all_pad_sample_agrees_with_jax_at_group_1():
    jin, tin = _inputs([6, 0, 4, 2], seed=1)
    ref = np.asarray(jatt.masked_attention_pallas_packed(
        *[jnp.asarray(a) for a in jin], group=1, interpret=True))
    out = tatt.masked_attention_pallas_packed(*tin, group=1).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    # a uniform softmax over its own 6 keys: bf16(1/6) x the sum of its
    # values
    v = tin[2][1].to(torch.bfloat16).float()
    p = torch.tensor(1 / 6).to(torch.bfloat16).float()
    np.testing.assert_allclose(out[1], (p * v.sum(1, keepdim=True)).expand(
        -1, 5, -1).numpy(), atol=1e-6)


def test_no_mask_is_no_padding():
    jin, tin = _inputs([6, 6, 6])
    ref = np.asarray(jatt.masked_attention_pallas(
        *[jnp.asarray(a) for a in jin[:3]], None, interpret=True))
    out = tatt.masked_attention_pallas(*tin[:3], None)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("Dh,Lq,Lk", [(192, 160, 160), (256, 7, 300)])
def test_wide_heads_and_long_sequences_match_xla(Dh, Lq, Lk):
    """The shapes past the one-block kernels (Dh > 128, L > 128), which the
    card runs on the long kernels, against the XLA attention."""
    jin, tin = _inputs([Lk, Lk // 3, 0], Lq=Lq, Lk=Lk, Dh=Dh, H=1, seed=Dh)
    ref = np.asarray(jatt.masked_attention_xla(*[jnp.asarray(a)
                                                 for a in jin]))
    out = tatt.masked_attention_pallas(*tin)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    assert kernels.attention_bwd_plan(1, 1, Lq, Lk, Dh).instance == 1
