"""The port's int4 qffn levels 4-7 and the static-int8 aux sites
(mcan_vqa_tpu_torch/ops/quant.py, the plain versions of ``gemm_s4`` /
``gemm_w4bf16`` in ops/kernels.py) on the CPU against the JAX package
(mcan_vqa_tpu/ops/quant.py, its Pallas block kernels in interpret mode):

  * ``_quant_w4`` / ``_unpack_w4``: byte for byte, with zero slabs, .5
    ties and saturation;
  * ``gemm_s4_plain`` against ``_qdot_static4`` and ``gemm_w4bf16_plain``
    against ``_qdot_w4bf16``;
  * ``prepare_qffn_params`` at levels 4-7 and ``prepare_q8aux_params``: bit
    for bit;
  * ``fused_qffn_sa_block`` / ``fused_qffn_sga_block`` at levels 4-7
    against the JAX wrappers at group 1, with the block's calibrated
    scales;
  * ``calibrate_qffn_act_scales`` with the int4 replays (``w4dq``) and the
    aux replay, against JAX on the same model and batch.

Tiny shapes: hidden 64, 4 heads of 16, FF 256, 6 tokens, 10 regions (the
int4 groups: 64 rows at K = 64, two of 128 at K = 256).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JaxConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.ops import quant as jquant
from mcan_vqa_tpu.ops import serving as jserving
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import quant as tquant
from mcan_vqa_tpu_torch.ops import serving as tserving
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params

H, D, LQ, LV, B = 4, 64, 6, 10, 4
LAYERS = 2
# the blocks' tolerance, that of tests/test_torch_quant.py: the same steps
# at the same precision, f32 sums in another order; a bf16 rounding or an
# int8 code on a rounding boundary lands one step apart
TOL = 2 ** -7


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _same_bits(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _w4_matrix(K_, N, seed):
    """Normal weights with the edges: a zero column, an all-zero group of
    another column (scale 1), a column whose group max puts values on .5
    ties of w / s, and a value past 7 s that saturates."""
    w = np.random.default_rng(seed).normal(size=(K_, N)).astype(np.float32)
    w[:, 1] = 0.0
    w[:K_ // 2, 2] = 0.0
    w[:, 3] = 0.0
    w[:6, 3] = [7.0, 0.5, 1.5, 2.5, -3.5, -6.5]
    return w


@pytest.mark.parametrize("K_,N", [(256, 24), (64, 16), (1024, 8)])
def test_quant_w4_byte_equal_to_jax(K_, N):
    w = _w4_matrix(K_, N, K_)
    ref = jquant._quant_w4(jnp.asarray(w))
    out = tquant._quant_w4(torch.from_numpy(w))
    _same_bits(out["w_p"], ref["w_p"])
    _same_bits(out["w_gscale"], ref["w_gscale"])
    assert out["w_gscale"].shape == (max(K_ // 128, 1), N)
    _same_bits(tquant._unpack_w4(out["w_p"]), jquant._unpack_w4(ref["w_p"]))
    unpacked = tquant._unpack_w4(out["w_p"])
    assert unpacked[:, 1].abs().max() == 0 and unpacked.abs().max() == 7
    # the .5 ties round half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    assert unpacked[:6, 3].tolist() == [7, 0, 2, 2, -4, -6]


def _w4_operands(seed, M, K_, N):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(M, K_))).astype(np.float32)
    x[1] = 0.0
    q = jquant._quant_w4(jnp.asarray(_w4_matrix(K_, N, seed) * 0.05))
    bias = rng.normal(size=N).astype(np.float32)
    return x, q, bias, (torch.from_numpy(np.array(q["w_p"])),
                        torch.from_numpy(np.array(q["w_gscale"])),
                        torch.from_numpy(bias))


@pytest.mark.parametrize("M,K_,N,a", [(9, 256, 48, 0.02), (5, 1024, 16, 0.004)])
def test_gemm_s4_plain_matches_qdot_static4(M, K_, N, a):
    x, q, bias, (wp, s4, b) = _w4_operands(M, M, K_, N)
    ref = jquant._qdot_static4(jnp.asarray(x), a, q["w_p"], q["w_gscale"],
                               jnp.asarray(bias))
    xq, _ = K.quantize_rows_plain(torch.from_numpy(x), 1.0 / a)
    out = K.gemm_s4_plain(xq, wp, s4, b, a=a)[0]
    # exact int32 sums per group and the same correctly rounded steps in
    # the same order: at most 1 ulp (XLA may fuse the scale product)
    np.testing.assert_array_max_ulp(out.numpy(), np.asarray(ref), maxulp=1)


@pytest.mark.parametrize("M,K_,N", [(9, 256, 48), (5, 64, 32)])
def test_gemm_w4bf16_plain_matches_qdot_w4bf16(M, K_, N):
    x, q, bias, (wp, s4, b) = _w4_operands(M + 1, M, K_, N)
    ref = jquant._qdot_w4bf16(jnp.asarray(x), 0.0, q["w_p"], q["w_gscale"],
                              jnp.asarray(bias))
    wf = jquant._unpack_w4(q["w_p"]).astype(jnp.float32)
    _same_bits(K.dequant_w4(wp, s4).float(), (
        wf.reshape(s4.shape[0], -1, N) * q["w_gscale"][:, None, :]
    ).reshape(K_, N).astype(jnp.bfloat16).astype(jnp.float32))
    out = K.gemm_w4bf16_plain(torch.from_numpy(x).to(torch.bfloat16), wp, s4,
                              b)
    # the same bf16 operands, exact products, f32 sums in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# prepared weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """(raw JAX params, port state_dict, img, ques): 2 layers, partial
    padding in both streams, no fully padded sample."""
    cfg = JaxConfig(hidden_size=D, layer=LAYERS, multi_head=H,
                    img_feat_size=16, img_feat_pad_size=LV, max_token=LQ,
                    flat_out_size=32, flat_mlp_size=16,
                    use_glove=False).finalize()
    net = build_mcan(cfg, token_size=30, answer_size=10)
    rng = np.random.default_rng(5)
    img = np.abs(rng.normal(size=(6, LV, 16))).astype(np.float32)
    img[1, 7:] = 0.0
    img[4, 3:] = 0.0
    ques = rng.integers(1, 30, size=(6, LQ)).astype(np.int32)
    ques[2, 4:] = 0
    ques[5, 2:] = 0
    params = jax.device_get(net.init({"params": jax.random.PRNGKey(3)},
                                     img, ques)["params"])
    return params, state_dict_from_params(params), img, ques


def _preps(model, level):
    params, sd, _, _ = model
    jprep = jserving.prepare_params(params, LAYERS, num_heads=H,
                                    alllayer=False, qffn=level)
    tprep = tserving.prepare_params(sd, LAYERS, device="cpu", qffn=level)
    return jprep, tprep


@pytest.mark.parametrize("level", [4, 5, 6, 7])
def test_prepare_qffn_params_int4_bit_equal_to_jax(model, level):
    jprep, tprep = _preps(model, level)
    for name in ("enc_1", "dec_0"):
        ref = jprep["backbone"][name]["_qffn"]
        out = tprep["backbone"][name]["_qffn"]
        assert set(out) == set(ref)
        for key in ref:
            _same_bits(out[key], jax.device_get(ref[key]))
    keys = set(tprep["backbone"]["dec_0"]["_qffn"])
    assert "w1_p" in keys and "w1_q" not in keys
    assert ("wqkv_p" in keys) == (level in (5, 7))
    assert "wm1_q" in keys and "wq2_q" in keys


def test_prepare_q8aux_params_bit_equal_to_jax(model):
    jprep, tprep = _preps(model, 3)
    ref = jquant.prepare_q8aux_params(jprep, LAYERS)
    out = tquant.prepare_q8aux_params(tprep, LAYERS)
    assert set(out) == set(ref) == {"dec_0_kv", "dec_1_kv", "lang_merge",
                                    "img_merge", "proj"}
    for site in ref:
        assert set(out[site]) == set(ref[site])
        for key in ref[site]:
            _same_bits(out[site][key].contiguous(),
                       jax.device_get(ref[site][key]))
    # the head (10 answers) is stored K-major for gemm_s8: [K, N] with K
    # contiguous, one column after another, no padding
    w = out["proj"]["w_q"]
    assert w.stride() == (1, w.shape[0])


# ---------------------------------------------------------------------------
# the blocks against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _mask(lengths, L):
    m = np.arange(L)[None, :] >= np.asarray(lengths)[:, None]
    return m[:, None, None, :]


def _stream(seed, L):
    x = np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("level", [4, 5, 6, 7])
def test_qffn_sa_block_int4_matches_pallas_kernel(model, level):
    jprep, tprep = _preps(model, level)
    jb, tb = jprep["backbone"]["enc_0"], tprep["backbone"]["enc_0"]
    xj, xt = _stream(level, LQ)
    mask = _mask([6, 4, 6, 2], LQ)
    w4dq = level >= 6
    sc = tuple(float(a) for a in tquant._cal_sa_block(
        tb, xt, torch.from_numpy(mask), H, 1.1, w4dq)[1])
    assert len(sc) == 4
    ref = jquant.fused_qffn_sa_block(xj, jnp.asarray(mask), jb["_mk"],
                                     jb["_qffn"], num_heads=H, group=1,
                                     interpret=True, act_scales=sc,
                                     w4dq=w4dq)
    out = tquant.fused_qffn_sa_block(xt, torch.from_numpy(mask), tb["_mk"],
                                     tb["_qffn"], num_heads=H, act_scales=sc,
                                     w4dq=w4dq)
    assert out.dtype == xt.dtype and out.shape == (B, LQ, D)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("level", [4, 5, 6, 7])
def test_qffn_sga_block_int4_matches_pallas_kernel(model, level):
    jprep, tprep = _preps(model, level)
    jb, tb = jprep["backbone"]["dec_1"], tprep["backbone"]["dec_1"]
    vj, vt = _stream(level + 10, LV)
    qj, qt = _stream(level + 20, LQ)
    v_mask, q_mask = _mask([10, 7, 10, 4], LV), _mask([6, 6, 3, 5], LQ)
    kq, vq = jserving._cross_kv(jb["mhatt2"], qj, H)
    tkq, tvq = tserving._cross_kv(tb["mhatt2"], qt, H)
    w4dq = level >= 6
    sc = tuple(float(a) for a in tquant._cal_sga_block(
        tb, vt, qt, torch.from_numpy(v_mask), torch.from_numpy(q_mask), H,
        1.1, w4dq)[1])
    assert len(sc) == 6
    ref = jquant.fused_qffn_sga_block(vj, kq, vq, jnp.asarray(v_mask),
                                      jnp.asarray(q_mask), jb["_mk"],
                                      jb["_qffn"], num_heads=H, group=1,
                                      interpret=True, act_scales=sc,
                                      w4dq=w4dq)
    out = tquant.fused_qffn_sga_block(vt, tkq, tvq, torch.from_numpy(v_mask),
                                      torch.from_numpy(q_mask), tb["_mk"],
                                      tb["_qffn"], num_heads=H,
                                      act_scales=sc, w4dq=w4dq)
    assert out.dtype == vt.dtype and out.shape == (B, LV, D)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _scales_close(out, ref):
    assert set(out) == set(ref)
    for key in ref:
        assert len(out[key]) == len(ref[key])
        assert all(isinstance(a, float) for a in out[key])
        # each scale is a max over the batch of an activation both sides
        # compute with the same steps in another summation order (as in
        # tests/test_torch_quant.py): 1e-2
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-2)


@pytest.mark.parametrize("level,aux", [(5, False), (7, False), (3, True),
                                       (6, True)])
def test_calibration_int4_and_aux_match_jax(model, level, aux):
    """Levels 5 and 7 replay the int4 sites (w4dq at 7); with the aux sites
    the decoder runs on the static-int8 cross k/v and "aux" holds (a_kv,
    a_lang, a_img, a_head)."""
    _, _, img, ques = model
    jprep, tprep = _preps(model, level)
    if aux:
        jprep["_q8aux"] = jquant.prepare_q8aux_params(jprep, LAYERS)
        tprep["_q8aux"] = tquant.prepare_q8aux_params(tprep, LAYERS)
    w4dq = level >= 6
    ref = jquant.calibrate_qffn_act_scales(jprep, img, ques, LAYERS, H,
                                           w4dq=w4dq)
    out = tquant.calibrate_qffn_act_scales(tprep, img, ques, LAYERS, H,
                                           w4dq=w4dq)
    _scales_close(out, ref)
    assert ("aux" in out) == aux and len(out["dec_0"]) == 6
