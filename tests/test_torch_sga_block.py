"""The port's serving blocks (mcan_vqa_tpu_torch/ops/sga_block.py) on the
CPU, i.e. their plain versions, against the JAX package:

  * the Pallas block kernels in interpret mode (``fused_sa_block``,
    ``fused_sga_block(fused_proj=True)``) on the same weights and inputs,
    with partial padding only: on a fully padded sample the Pallas kernels
    pack G samples under one collapsed mask and mix in the neighbours' keys
    (sga_block.py:263-264, :985-988);
  * the op-by-op composition (``_mhatt`` + ``_std_layer_norm`` + ``_mlp``,
    the model.apply semantics) on the fully padded edge: an all-PAD
    question and all-zero regions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JaxConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.ops import serving as jserving
from mcan_vqa_tpu.ops import sga_block as jblock
from mcan_vqa_tpu_torch.ops import serving as tserving
from mcan_vqa_tpu_torch.ops import sga_block as tblock
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params

H, D, LQ, LV, B = 4, 32, 7, 12, 4
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def weights():
    """(raw JAX params, JAX prepared tree, port prepared tree)."""
    cfg = JaxConfig(hidden_size=D, layer=1, multi_head=H, img_feat_size=16,
                    img_feat_pad_size=LV, max_token=LQ, flat_out_size=24,
                    flat_mlp_size=16, use_glove=False).finalize()
    model = build_mcan(cfg, token_size=30, answer_size=10)
    img = np.ones((1, LV, 16), np.float32)
    ques = np.ones((1, LQ), np.int32)
    params = jax.device_get(model.init({"params": jax.random.PRNGKey(3)},
                                       img, ques)["params"])
    jprep = jserving.prepare_params(params, 1, num_heads=H, alllayer=False)
    tprep = tserving.prepare_params(state_dict_from_params(params), 1,
                                    device="cpu")
    return params, jprep["backbone"], tprep["backbone"]


def _mask(lengths, L):
    m = np.arange(L)[None, :] >= np.asarray(lengths)[:, None]
    return m[:, None, None, :]


def _stream(seed, L, dtype):
    x = np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# Tolerance against the Pallas kernels: the same steps at the same
# precision, summed in another order by XLA and by torch; a bf16 rounding
# (of qkv, h1 or the output, |x| < 4) can land one step apart: 2^-6.
TOL = 2 ** -6


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sa_block_matches_pallas_kernel(weights, dtype):
    _, jbb, tbb = weights
    xj, xt = _stream(1, LQ, dtype)
    mask = _mask([7, 4, 7, 2], LQ)
    ref = jblock.fused_sa_block(xj, jnp.asarray(mask), jbb["enc_0"]["_mk"],
                                num_heads=H, interpret=True)
    out = tblock.fused_sa_block(xt, torch.from_numpy(mask),
                                tbb["enc_0"]["_mk"], num_heads=H)
    assert out.dtype == xt.dtype and out.shape == (B, LQ, D)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sga_block_matches_pallas_kernel(weights, dtype):
    _, jbb, tbb = weights
    vj, vt = _stream(2, LV, dtype)
    qj, qt = _stream(3, LQ, "bfloat16")
    v_mask, q_mask = _mask([12, 9, 12, 5], LV), _mask([7, 7, 3, 6], LQ)
    kq, vq = jserving._cross_kv(jbb["dec_0"]["mhatt2"], qj, H)
    ref = jblock.fused_sga_block(vj, kq, vq, jnp.asarray(v_mask),
                                 jnp.asarray(q_mask), jbb["dec_0"]["_mk"],
                                 num_heads=H, group=4, fused_proj=True,
                                 interpret=True)
    tkq, tvq = tserving._cross_kv(tbb["dec_0"]["mhatt2"], qt, H)
    np.testing.assert_allclose(tkq.numpy(), _np(kq), rtol=1e-5, atol=1e-5)
    out = tblock.fused_sga_block(vt, tkq, tvq, torch.from_numpy(v_mask),
                                 torch.from_numpy(q_mask),
                                 tbb["dec_0"]["_mk"], num_heads=H)
    assert out.dtype == vt.dtype and out.shape == (B, LV, D)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


def _sa_composition(p, x, mask):
    att = jserving._mhatt(p["mhatt"], x, x, x, jnp.asarray(mask), H,
                          False, False)
    x1 = jserving._std_layer_norm(p["norm1"], x + att)
    return jserving._std_layer_norm(p["norm2"],
                                    x1 + jserving._mlp(p["ffn"]["mlp"], x1))


def _sga_composition(p, v, q, v_mask, q_mask):
    att = jserving._mhatt(p["mhatt1"], v, v, v, jnp.asarray(v_mask), H,
                          False, False)
    v1 = jserving._std_layer_norm(p["norm1"], v + att)
    att = jserving._mhatt(p["mhatt2"], q, q, v1, jnp.asarray(q_mask), H,
                          False, False)
    v2 = jserving._std_layer_norm(p["norm2"], v1 + att)
    return jserving._std_layer_norm(p["norm3"],
                                    v2 + jserving._mlp(p["ffn"]["mlp"], v2))


# Tolerance against the composition (f32 stream on both sides): the same
# bf16 matmul operands; bias additions ordered differently move f32 sums
# by an ulp, which can move a later bf16 rounding one step: 2^-6.


def test_sa_block_all_pad_question_matches_composition(weights):
    params, jbb, tbb = weights
    xj, xt = _stream(4, LQ, "float32")
    mask = _mask([7, 0, 5, 0], LQ)          # samples 1 and 3: all PAD
    ref = _np(_sa_composition(params["backbone"]["enc_0"], xj, mask))
    out = _np(tblock.fused_sa_block(xt, torch.from_numpy(mask),
                                    tbb["enc_0"]["_mk"], num_heads=H))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    # at group 1 the Pallas kernel holds one sample per step, and agrees
    pallas = _np(jblock.fused_sa_block(xj, jnp.asarray(mask),
                                       jbb["enc_0"]["_mk"], num_heads=H,
                                       group=1, interpret=True))
    np.testing.assert_allclose(out, pallas, rtol=TOL, atol=TOL)


def test_sga_block_fully_padded_samples_match_composition(weights):
    params, jbb, tbb = weights
    vj, vt = _stream(5, LV, "float32")
    qj, qt = _stream(6, LQ, "float32")
    v_mask = _mask([12, 0, 7, 12], LV)      # sample 1: all-zero regions
    q_mask = _mask([7, 5, 0, 0], LQ)        # samples 2, 3: all-PAD question
    ref = _np(_sga_composition(params["backbone"]["dec_0"], vj, qj, v_mask,
                               q_mask))
    tkq, tvq = tserving._cross_kv(tbb["dec_0"]["mhatt2"], qt, H)
    out = _np(tblock.fused_sga_block(vt, tkq, tvq, torch.from_numpy(v_mask),
                                     torch.from_numpy(q_mask),
                                     tbb["dec_0"]["_mk"], num_heads=H))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_pallas_kernel_mixes_a_fully_padded_sample_at_group_2(weights):
    """The fault the port does not copy: at group 2 the Pallas SA kernel
    gives a fully padded sample its neighbour's keys; at group 1, and in
    the port, the sample attends uniformly to its own."""
    params, jbb, tbb = weights
    xj, xt = _stream(7, LQ, "float32")
    mask = _mask([7, 0, 6, 3], LQ)
    ref = _np(_sa_composition(params["backbone"]["enc_0"], xj, mask))
    g2 = _np(jblock.fused_sa_block(xj, jnp.asarray(mask),
                                   jbb["enc_0"]["_mk"], num_heads=H,
                                   group=2, interpret=True))
    port = _np(tblock.fused_sa_block(xt, torch.from_numpy(mask),
                                     tbb["enc_0"]["_mk"], num_heads=H))
    assert np.abs(g2[1] - ref[1]).max() > 0.1
    np.testing.assert_allclose(port[1], ref[1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g2[[0, 2, 3]], ref[[0, 2, 3]], rtol=TOL,
                               atol=TOL)
