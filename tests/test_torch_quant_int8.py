"""The port's full-int8 engine (``Predictor(engine="int8")``):
``quantize_params``, ``fused_quant_sa_block`` / ``fused_quant_sga_block``
(mcan_vqa_tpu_torch/ops/quant.py, plain versions on the CPU) and
``make_quant_serving_fn`` (ops/serving.py) against the JAX package's
``quantize_params(megakernel=True)``, its Pallas kernels ``_qsa_kernel`` /
``_qsga_kernel`` in interpret mode and ``make_quant_serving_fn(
megakernel=True, interpret=True)``:

  * every int8 weight and scale, bit for bit;
  * the blocks at group 1, within 2^-7, f32 stream in and out;
  * the fully padded sample at group 2, where the JAX kernels mix in a
    neighbour (ROADMAP §3);
  * the whole forward, within 1e-2 on logits.

Tiny shapes: hidden 64, 4 heads of 16, FF 256, 6 tokens, 10 regions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JaxConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.ops import quant as jquant
from mcan_vqa_tpu_torch.ops import quant as tquant
from mcan_vqa_tpu_torch.ops import serving as tserving
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params

H, D, LQ, LV, B = 4, 64, 6, 10, 4
LAYERS = 2
TOL = 2 ** -7      # as tests/test_torch_quant.py: one bf16 / int8 step


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _same_bits(a, b):
    a = a.contiguous().numpy()
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.fixture(scope="module")
def model():
    """(raw JAX params, JAX int8 tree, port int8 tree, img, ques): partial
    padding in both streams, no fully padded sample."""
    cfg = JaxConfig(hidden_size=D, layer=LAYERS, multi_head=H,
                    img_feat_size=16, img_feat_pad_size=LV, max_token=LQ,
                    flat_out_size=32, flat_mlp_size=16,
                    use_glove=False).finalize()
    net = build_mcan(cfg, token_size=30, answer_size=10)
    rng = np.random.default_rng(7)
    img = np.abs(rng.normal(size=(6, LV, 16))).astype(np.float32)
    img[1, 7:] = 0.0
    img[4, 3:] = 0.0
    ques = rng.integers(1, 30, size=(6, LQ)).astype(np.int32)
    ques[2, 4:] = 0
    ques[5, 2:] = 0
    params = jax.device_get(net.init({"params": jax.random.PRNGKey(4)},
                                     img, ques)["params"])
    jtree = jquant.quantize_params(params, LAYERS, megakernel=True)
    ttree = tserving.quantize_params(state_dict_from_params(params), LAYERS,
                                     device="cpu")
    return params, jtree, ttree, img, ques


def test_quantize_params_bit_equal_to_jax(model):
    _, jtree, ttree, _, _ = model
    for name in ("enc_0", "dec_1"):
        ref, out = jtree["backbone"][name]["_mk"], \
            ttree["backbone"][name]["_mk"]
        assert set(out) == set(ref)
        for key in ref:
            _same_bits(out[key], ref[key])
    sites = [("backbone", "dec_0", "mhatt2", "linear_kv"),
             ("img_feat_linear",), ("proj",),
             ("attflat_lang", "linear_merge"),
             ("attflat_img", "mlp", "FCLayer_0", "Dense_0"),
             ("attflat_img", "mlp", "Dense_0")]
    for path in sites:
        ref, out = jtree, ttree
        for k in path:
            ref, out = ref[k], out[k]
        assert set(out) == set(ref) == {"w_q", "w_scale", "bias"}
        for key in ref:
            _same_bits(out[key], ref[key])
    # every int8 weight is stored K-major for gemm_s8, no padding: the
    # AttFlat logit (one glimpse) with K contiguous, the head one column
    # of K after another
    assert ttree["attflat_img"]["mlp"]["Dense_0"]["w_q"].stride(0) == 1
    head = ttree["proj"]["w_q"]
    assert head.stride() == (1, head.shape[0])


def _mask(lengths, L):
    m = np.arange(L)[None, :] >= np.asarray(lengths)[:, None]
    return m[:, None, None, :]


def _stream(seed, L):
    x = np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _sa(model, x_len, group, seed):
    _, jtree, ttree, _, _ = model
    jmk, tmk = jtree["backbone"]["enc_1"]["_mk"], \
        ttree["backbone"]["enc_1"]["_mk"]
    xj, xt = _stream(seed, LQ)
    mask = _mask(x_len, LQ)
    out = tquant.fused_quant_sa_block(xt, torch.from_numpy(mask), tmk,
                                      num_heads=H)
    ref = jquant.fused_quant_sa_block(xj, jnp.asarray(mask), jmk,
                                      num_heads=H, group=group,
                                      interpret=True)
    assert out.dtype == torch.float32 and out.shape == (B, LQ, D)
    return _np(out), _np(ref)


def _sga(model, v_len, q_len, group, seed):
    _, jtree, ttree, _, _ = model
    jb, tb = jtree["backbone"]["dec_0"], ttree["backbone"]["dec_0"]
    vj, vt = _stream(seed, LV)
    qj, qt = _stream(seed + 1, LQ)
    kv = jquant._qdense(jb["mhatt2"]["linear_kv"], qj)
    kq, vq = (t.reshape(B, LQ, H, D // H).transpose(0, 2, 1, 3)
              for t in jnp.split(kv, 2, axis=-1))
    tkq, tvq = tserving._split_kv(
        tserving._qdense(tb["mhatt2"]["linear_kv"], qt), H)
    v_mask, q_mask = _mask(v_len, LV), _mask(q_len, LQ)
    out = tquant.fused_quant_sga_block(vt, tkq, tvq, torch.from_numpy(v_mask),
                                       torch.from_numpy(q_mask), tb["_mk"],
                                       num_heads=H)
    ref = jquant.fused_quant_sga_block(vj, kq, vq, jnp.asarray(v_mask),
                                       jnp.asarray(q_mask), jb["_mk"],
                                       num_heads=H, group=group,
                                       interpret=True)
    assert out.dtype == torch.float32 and out.shape == (B, LV, D)
    return _np(out), _np(ref)


def test_quant_sa_block_matches_pallas_kernel(model):
    out, ref = _sa(model, [6, 4, 6, 2], 1, 1)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_quant_sga_block_matches_pallas_kernel(model):
    out, ref = _sga(model, [10, 7, 10, 4], [6, 6, 3, 5], 1, 2)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_quant_sa_block_all_pad_question_at_group_2(model):
    """``_qsa_kernel`` masks G packed questions with one collapsed mask,
    (off + pad) * -1e9 (quant.py:481-485): at group 2 a fully padded
    question attends to its neighbour's tokens. At group 1, and in the
    port (per-sample attention), uniformly to its own."""
    out, g1 = _sa(model, [6, 0, 5, 3], 1, 3)
    _, g2 = _sa(model, [6, 0, 5, 3], 2, 3)
    np.testing.assert_allclose(out, g1, rtol=TOL, atol=TOL)
    assert np.abs(g2[1] - out[1]).max() > 0.1
    np.testing.assert_allclose(g2[[0, 2, 3]], out[[0, 2, 3]], rtol=TOL,
                               atol=TOL)


def test_quant_sga_block_all_pad_question_at_group_2(model):
    """The cross mask (vq_off + qpad) * -1e9 (quant.py:409-412): at group 2
    a decoder sample with an all-PAD question reads its neighbour's
    question keys; at group 1 and in the port, its own (uniformly)."""
    out, g1 = _sga(model, [10, 10, 6, 8], [6, 0, 4, 6], 1, 4)
    _, g2 = _sga(model, [10, 10, 6, 8], [6, 0, 4, 6], 2, 4)
    np.testing.assert_allclose(out, g1, rtol=TOL, atol=TOL)
    assert np.abs(g2[1] - out[1]).max() > 0.1
    np.testing.assert_allclose(g2[[0, 2, 3]], out[[0, 2, 3]], rtol=TOL,
                               atol=TOL)


def test_quant_serving_fn_matches_jax(model):
    """The whole engine: JAX packs up to 6 questions / 3 samples per grid
    step here, which changes nothing for a sample with a real token and a
    real region. Both sides quantize the same f32 activations with the
    same steps but for f32 sums in another order; an int8 code on a
    rounding boundary moves its product by one step, carried through 4
    blocks and the heads: 1e-2 on the logits (|logit| ~ 1)."""
    _, jtree, ttree, img, ques = model
    jfwd = jquant.make_quant_serving_fn(LAYERS, H, megakernel=True,
                                        interpret=True)
    ref = np.asarray(jax.jit(jfwd)(jtree, img, ques))
    with torch.no_grad():
        out = tserving.make_quant_serving_fn(LAYERS, H)(
            ttree, torch.from_numpy(img), torch.from_numpy(ques)).numpy()
    assert out.shape == ref.shape == (6, 10) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
