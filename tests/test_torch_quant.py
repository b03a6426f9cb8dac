"""The port's int8 quantization and int8 serving blocks
(mcan_vqa_tpu_torch/ops/quant.py and the plain versions of
``quantize_rows`` / ``gemm_s8`` in ops/kernels.py) on the CPU against the
JAX package (mcan_vqa_tpu/ops/quant.py, its Pallas block kernels in
interpret mode):

  * ``_quant_w`` / ``_qrow`` / the static codes: bit-equal, with zero rows,
    exact .5 ties (half to even) and saturation at +-127;
  * ``_qdot`` / ``_qdot_static`` against ``gemm_s8_plain`` fed the same
    int8 operands: equal int32 accumulators, f32 within 1 ulp;
  * ``prepare_qffn_params`` at levels 1-3 against the ``_qffn`` entries of
    JAX ``prepare_params(qffn=level)``: bit-equal; ``decode_qffn_level``;
  * ``fused_qffn_sa_block`` / ``fused_qffn_sga_block`` against the JAX
    wrappers at group 1, dynamic and static scales, and the fully padded
    sample at group 2, where the JAX kernels mix in a neighbour;
  * ``calibrate_qffn_act_scales`` against JAX on the same model and batch.

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
from mcan_vqa_tpu.ops import serving as jserving
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import quant as tquant
from mcan_vqa_tpu_torch.ops import serving as tserving
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params

H, D, LQ, LV, B = 4, 64, 6, 10, 4
LAYERS = 2


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _same_bits(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# weights and activations
# ---------------------------------------------------------------------------

def _tie_matrix():
    """Normal values plus the edges: a zero column / row, a column / row
    whose scale is 1 or 2 with values on exact .5 ties, and the max
    element on +-127."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(40, 24)).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = 0.0
    w[:8, 5] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5, -126.5]
    w[:, 7] = 0.0
    w[:6, 7] = [-254.0, 1.0, 3.0, 5.0, -7.0, 253.0]
    return w


def test_quant_w_bit_equal_to_jax():
    w = _tie_matrix()
    ref = jquant._quant_w(jnp.asarray(w))
    out = tquant._quant_w(torch.from_numpy(w))
    _same_bits(out["w_q"], ref["w_q"])
    _same_bits(out["w_scale"], ref["w_scale"])
    # the edges did what they are there for
    assert out["w_scale"][3] == 1.0 and out["w_scale"][5] == 1.0
    assert out["w_q"][:8, 5].tolist() == [127, 0, 2, 2, 0, -4, 126, -126]
    assert out["w_q"][:6, 7].tolist() == [-127, 0, 2, 2, -4, 126]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qrow_and_quantize_rows_bit_equal_to_jax(dtype):
    x = np.ascontiguousarray(_tie_matrix().T)          # rows: the columns
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ref_q, ref_s = jquant._qrow(xj.astype(jnp.float32))
    q, s = tquant._qrow(xt.float())
    _same_bits(q, ref_q)
    _same_bits(s, ref_s)
    q, s = K.quantize_rows_plain(xt)
    _same_bits(q, ref_q)
    _same_bits(s, ref_s[:, 0])


@pytest.mark.parametrize("a", [0.5, 0.0005, 3.7])
def test_static_codes_bit_equal_to_jax(a):
    """The first line of ``_qdot_static``: a = 0.5 puts x = 0.25, 0.75 on
    ties; a small a saturates most codes at +-127."""
    x = _tie_matrix() / 8.0
    x[0, :4] = [0.25, 0.75, -0.25, -1.25]
    ref = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / a)), -127,
                   127).astype(jnp.int8)
    q, s = K.quantize_rows_plain(torch.from_numpy(x), 1.0 / a)
    assert s is None
    _same_bits(q, ref)
    if a == 0.0005:
        assert (q.abs() == 127).float().mean() > 0.5


def _dot_operands(seed, M, Kd, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, Kd)).astype(np.float32)
    w = (rng.normal(size=(Kd, N)) * 0.05).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    return x, jquant._quant_w(jnp.asarray(w)), bias


def _acc(xq, wq):
    return np.asarray(jax.lax.dot_general(
        xq, wq, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)).astype(np.int64)


@pytest.mark.parametrize("M,Kd,N", [(37, 256, 96), (5, 2048, 64)])
def test_qdot_matches_gemm_s8_plain(M, Kd, N):
    x, q, bias = _dot_operands(M, M, Kd, N)
    if Kd == 2048:
        x[0] = 1.0               # 127 x 127 x 2048 = 3.3e7 > 2^24
        q["w_q"] = q["w_q"].at[:, 0].set(127)
    ref = jquant._qdot(jnp.asarray(x), q["w_q"], q["w_scale"],
                       jnp.asarray(bias))
    jxq, _ = jquant._qrow(jnp.asarray(x))
    xq, sx = K.quantize_rows_plain(torch.from_numpy(x))
    wq = torch.from_numpy(np.array(q["w_q"]))
    sw = torch.from_numpy(np.array(q["w_scale"]))
    acc = (xq.double() @ wq.double()).numpy().astype(np.int64)
    np.testing.assert_array_equal(acc, _acc(jxq, q["w_q"]))
    if Kd == 2048:
        assert acc[0, 0] == 127 * 127 * 2048
    out = K.gemm_s8_plain(xq, wq, sw, torch.from_numpy(bias), sx=sx)[0]
    # the same correctly rounded steps in the same order: at most 1 ulp
    # (XLA may fuse the scale product differently)
    np.testing.assert_array_max_ulp(out.numpy(), np.asarray(ref), maxulp=1)


@pytest.mark.parametrize("a", [0.02, 0.004])
def test_qdot_static_matches_gemm_s8_plain(a):
    x, q, bias = _dot_operands(11, 29, 512, 128)
    ref = jquant._qdot_static(jnp.asarray(x), a, q["w_q"], q["w_scale"],
                              jnp.asarray(bias))
    xq, _ = K.quantize_rows_plain(torch.from_numpy(x), 1.0 / a)
    wq = torch.from_numpy(np.array(q["w_q"]))
    jxq = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / a)), -127,
                   127).astype(jnp.int8)
    acc = (xq.double() @ wq.double()).numpy().astype(np.int64)
    np.testing.assert_array_equal(acc, _acc(jxq, q["w_q"]))
    out = K.gemm_s8_plain(xq, wq, torch.from_numpy(np.array(q["w_scale"])),
                          torch.from_numpy(bias), a=a)[0]
    np.testing.assert_array_max_ulp(out.numpy(), np.asarray(ref), maxulp=1)
    # and the module's own _qdot_static is the same function
    again = tquant._qdot_static(torch.from_numpy(x), a, wq,
                                torch.from_numpy(np.array(q["w_scale"])),
                                torch.from_numpy(bias))
    np.testing.assert_array_equal(again.numpy(), out.numpy())


# ---------------------------------------------------------------------------
# prepared weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    """(JAX model, raw params, port state_dict, img, ques): 2 layers,
    partial padding in both streams, no fully padded sample."""
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
    return net, params, state_dict_from_params(params), img, ques


def _preps(model, level):
    _, params, sd, _, _ = model
    jprep = jserving.prepare_params(params, LAYERS, num_heads=H,
                                    alllayer=False, qffn=level)
    tprep = tserving.prepare_params(sd, LAYERS, device="cpu", qffn=level)
    return jprep, tprep


@pytest.mark.parametrize("level", [1, 2, 3])
def test_prepare_qffn_params_bit_equal_to_jax(model, level):
    jprep, tprep = _preps(model, level)
    for name in ("enc_0", "dec_1"):
        ref = jprep["backbone"][name]["_qffn"]
        out = tprep["backbone"][name]["_qffn"]
        assert set(out) == set(ref)
        for key in ref:
            _same_bits(out[key], jax.device_get(ref[key]))
    keys = set(tprep["backbone"]["dec_0"]["_qffn"])
    assert ("wqkv_q" in keys) == (level >= 2)
    assert ("wm1_q" in keys and "wq2_q" in keys) == (level == 3)


@pytest.mark.parametrize("level", range(8))
def test_decode_qffn_level_matches_jax(level):
    for width in (512, 1024):
        assert tserving.decode_qffn_level(level, width) == \
            jserving.decode_qffn_level(level, width)


def test_int4_levels_raise(model):
    """The int4 levels have no dynamic-scale path: without a calibration
    source both builders refuse them (serving.py:653-658), and a block
    given no scales refuses too (quant.py:1297)."""
    _, params, sd, _, _ = model
    for level in (4, 5, 6, 7):
        with pytest.raises(ValueError, match="int4"):
            jserving.build_production_engine(params, LAYERS, H, qffn=level)
        with pytest.raises(ValueError, match="int4"):
            tserving.build_production_engine(sd, LAYERS, H, qffn=level,
                                             device="cpu")
    blk = tserving.prepare_params(sd, LAYERS, device="cpu",
                                  qffn=5)["backbone"]["enc_0"]
    with pytest.raises(ValueError, match="int4"):
        tquant.fused_qffn_sa_block(torch.zeros(1, LQ, D), torch.zeros(
            1, 1, 1, LQ, dtype=torch.bool), blk["_mk"], blk["_qffn"],
            num_heads=H)


# ---------------------------------------------------------------------------
# the blocks against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _mask(lengths, L):
    m = np.arange(L)[None, :] >= np.asarray(lengths)[:, None]
    return m[:, None, None, :]


def _stream(seed, L):
    x = np.random.default_rng(seed).normal(size=(B, L, D)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _sa_case(model, level, seed, lengths):
    jprep, tprep = _preps(model, level)
    xj, xt = _stream(seed, LQ)
    mask = _mask(lengths, LQ)
    return jprep["backbone"]["enc_0"], tprep["backbone"]["enc_0"], xj, xt, mask


def _sga_case(model, level, seed, v_len, q_len):
    jprep, tprep = _preps(model, level)
    vj, vt = _stream(seed, LV)
    qj, qt = _stream(seed + 1, LQ)
    jb, tb = jprep["backbone"]["dec_0"], tprep["backbone"]["dec_0"]
    kq, vq = jserving._cross_kv(jb["mhatt2"], qj, H)
    tkq, tvq = tserving._cross_kv(tb["mhatt2"], qt, H)
    return jb, tb, vj, vt, kq, vq, tkq, tvq, qt, _mask(v_len, LV), \
        _mask(q_len, LQ)


def _calibrated(block, fn, *args):
    """The static scales of this block on these inputs, by the port's own
    replay (margin 1.1): most codes in range, the max at +-116."""
    _, scales = fn(block, *args, H, 1.1)
    return tuple(float(a) for a in scales)


# Tolerance against the Pallas kernels: both sides take the same steps at
# the same precision, with f32 sums in another order; a bf16 rounding (of
# qkv, q, the probabilities or the output, |x| < 4) or an int8 code whose
# f32 input sits on a rounding boundary can land one step apart. One code
# step moves its product by s_x * |w| on one of 64-256 terms, below a bf16
# step of the output: 2^-7 (one bf16 step at |x| < 2) bounds both. Measured
# here: 0 in 9 of the 11 cases, 1.2e-4 in the other two.
TOL = 2 ** -7

SA_CASES = [(1, None), (2, None), (3, None), (2, "own"), (3, "own"),
            (2, "proj")]


@pytest.mark.parametrize("level,scales", SA_CASES)
def test_qffn_sa_block_matches_pallas_kernel(model, level, scales):
    """level 3 without scales keeps the bf16 merges (dynamic); "own" are
    the block's calibrated scales (a 4-tuple at level 3, a 3-tuple
    below); "proj" is a level-3 4-tuple on a level-2 block, cut to 3."""
    jb, tb, xj, xt, mask = _sa_case(model, level, 1, [6, 4, 6, 2])
    sc = None
    if scales is not None:
        _, t3 = _preps(model, 3) if scales == "proj" else (None, None)
        cal_block = t3["backbone"]["enc_0"] if scales == "proj" else tb
        sc = _calibrated(cal_block, tquant._cal_sa_block, xt,
                         torch.from_numpy(mask))
        assert len(sc) == (4 if level == 3 or scales == "proj" else 3)
    ref = jquant.fused_qffn_sa_block(xj, jnp.asarray(mask), jb["_mk"],
                                     jb["_qffn"], num_heads=H, group=1,
                                     interpret=True, act_scales=sc)
    out = tquant.fused_qffn_sa_block(xt, torch.from_numpy(mask), tb["_mk"],
                                     tb["_qffn"], num_heads=H, act_scales=sc)
    assert out.dtype == xt.dtype and out.shape == (B, LQ, D)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


SGA_CASES = [(1, None), (2, None), (3, "own"), (2, "own"), (1, "proj")]


@pytest.mark.parametrize("level,scales", SGA_CASES)
def test_qffn_sga_block_matches_pallas_kernel(model, level, scales):
    """"own" at level 3 is a 6-tuple; "proj" is a level-3 6-tuple on a
    level-1 block (no proj weights), cut to 3 on both sides."""
    jb, tb, vj, vt, kq, vq, tkq, tvq, qt, v_mask, q_mask = _sga_case(
        model, level, 2, [10, 7, 10, 4], [6, 6, 3, 5])
    sc = None
    if scales is not None:
        cal_block = _preps(model, 3)[1]["backbone"]["dec_0"] \
            if scales == "proj" else tb
        sc = _calibrated(cal_block, tquant._cal_sga_block, vt, qt,
                         torch.from_numpy(v_mask), torch.from_numpy(q_mask))
        assert len(sc) == (6 if level == 3 or scales == "proj" else 3)
    ref = jquant.fused_qffn_sga_block(vj, kq, vq, jnp.asarray(v_mask),
                                      jnp.asarray(q_mask), jb["_mk"],
                                      jb["_qffn"], num_heads=H, group=1,
                                      interpret=True, act_scales=sc)
    out = tquant.fused_qffn_sga_block(vt, tkq, tvq, torch.from_numpy(v_mask),
                                      torch.from_numpy(q_mask), tb["_mk"],
                                      tb["_qffn"], num_heads=H,
                                      act_scales=sc)
    assert out.dtype == vt.dtype and out.shape == (B, LV, D)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL, atol=TOL)


def test_qffn_sa_block_all_pad_question_at_group_2(model):
    """The JAX qffn kernels pack G samples under one collapsed mask,
    (off + pad) * -1e9 (quant.py:1208-1211): at group 2 a fully padded
    question attends to its neighbour's tokens. At group 1, and in the
    port (per-sample attention), it attends uniformly to its own."""
    jb, tb, xj, xt, mask = _sa_case(model, 1, 7, [6, 0, 5, 3])
    out = _np(tquant.fused_qffn_sa_block(xt, torch.from_numpy(mask),
                                         tb["_mk"], tb["_qffn"],
                                         num_heads=H))
    g1, g2 = (_np(jquant.fused_qffn_sa_block(
        xj, jnp.asarray(mask), jb["_mk"], jb["_qffn"], num_heads=H,
        group=g, interpret=True)) for g in (1, 2))
    np.testing.assert_allclose(out, g1, rtol=TOL, atol=TOL)
    assert np.abs(g2[1] - out[1]).max() > 0.1
    np.testing.assert_allclose(g2[[0, 2, 3]], out[[0, 2, 3]], rtol=TOL,
                               atol=TOL)


def test_qffn_sga_block_all_pad_question_at_group_2(model):
    """The cross mask (vq_off + qpad) * -1e9 (quant.py:1096-1099): at group
    2 a decoder sample with an all-PAD question reads its neighbour's
    question keys; at group 1 and in the port, its own (uniformly)."""
    jb, tb, vj, vt, kq, vq, tkq, tvq, _, v_mask, q_mask = _sga_case(
        model, 1, 9, [10, 10, 6, 8], [6, 0, 4, 6])
    out = _np(tquant.fused_qffn_sga_block(
        vt, tkq, tvq, torch.from_numpy(v_mask), torch.from_numpy(q_mask),
        tb["_mk"], tb["_qffn"], num_heads=H))
    g1, g2 = (_np(jquant.fused_qffn_sga_block(
        vj, kq, vq, jnp.asarray(v_mask), jnp.asarray(q_mask), jb["_mk"],
        jb["_qffn"], num_heads=H, group=g, interpret=True)) for g in (1, 2))
    np.testing.assert_allclose(out, g1, rtol=TOL, atol=TOL)
    assert np.abs(g2[1] - out[1]).max() > 0.1
    np.testing.assert_allclose(g2[[0, 2, 3]], out[[0, 2, 3]], rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [1, 3])
def test_calibration_matches_jax(model, level):
    _, _, _, img, ques = model
    jprep, tprep = _preps(model, level)
    ref = jquant.calibrate_qffn_act_scales(jprep, img, ques, LAYERS, H)
    out = tquant.calibrate_qffn_act_scales(tprep, img, ques, LAYERS, H)
    assert set(out) == set(ref) == {f"{s}_{i}" for s in ("enc", "dec")
                                    for i in range(LAYERS)}
    for key in ref:
        assert len(out[key]) == len(ref[key]) == (
            3 if level == 1 else 4 if key.startswith("enc") else 6)
        assert all(isinstance(a, float) for a in out[key])
        # each scale is a max over the batch of an activation that both
        # sides compute with the same steps in another summation order;
        # the maxima move by f32 / bf16 rounding steps, and through the
        # layers by an int8 code flipped at a rounding boundary: 1e-2
        # (measured: 1.9e-3 at level 1, 2.3e-7 at level 3)
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-2)
    if level == 1:                      # hidden < 1024: the qkv stays bf16
        assert all(out[k][0] == 1.0 for k in out)


def test_calibration_rejects_a_non_finite_row(model):
    _, _, _, img, ques = model
    _, tprep = _preps(model, 3)
    bad = img.copy()
    bad[2, 1, 3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tquant.calibrate_qffn_act_scales(tprep, bad, ques, LAYERS, H)
    with pytest.raises(ValueError, match="non-finite"):
        tquant._check_scales({"enc_0": (0.1, float("inf"), 0.2)})
