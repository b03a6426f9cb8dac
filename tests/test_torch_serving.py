"""The port's serving forward and plain engine against the JAX package at a
small size (2 layers, hidden 64, 4 heads):

  * ``build_production_engine(qffn=0)`` of the port (on the CPU: the plain
    versions of the block kernels) against the JAX
    ``build_production_engine(params, 2, 4, qffn=0, interpret=True)``;
  * ``MCANet`` (the "plain" engine) against ``model.apply``.

The int8 levels of the same builder: tests/test_torch_serving_int8.py; the
int4 levels, q8aux and the full-int8 engine: tests/test_torch_serving_int4.py.
"""

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JaxConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.ops.serving import \
    build_production_engine as jax_production_engine
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops import kernels
from mcan_vqa_tpu_torch.ops.serving import build_production_engine
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params

DIMS = dict(hidden_size=64, layer=2, multi_head=4, img_feat_size=32,
            img_feat_pad_size=12, max_token=7, flat_out_size=48,
            flat_mlp_size=24)
TOKENS, ANSWERS, B = 50, 20, 6


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(use_glove=False, **DIMS).finalize()
    cfg = Config(ff_size=4 * DIMS["hidden_size"], **DIMS)
    model = build_mcan(jcfg, token_size=TOKENS, answer_size=ANSWERS)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, 12, 32)).astype(np.float32)
    img[0, 8:] = 0.0
    img[3, 2:] = 0.0
    ques = rng.integers(1, TOKENS, size=(B, 7)).astype(np.int32)
    ques[1, 4:] = 0
    ques[4, 1:] = 0
    params = jax.device_get(model.init({"params": jax.random.PRNGKey(0)},
                                       img, ques)["params"])
    return cfg, model, params, img, ques


def _torch(img, ques):
    return torch.from_numpy(img), torch.from_numpy(ques)


def test_serving_forward_matches_jax_production_engine(setup):
    cfg, _, params, img, ques = setup
    jfwd, jprep = jax_production_engine(params, cfg.layer, cfg.multi_head,
                                        qffn=0, interpret=True)
    ref = np.asarray(jfwd(jprep, img, ques))
    fwd, prep = build_production_engine(state_dict_from_params(params),
                                        cfg.layer, cfg.multi_head, qffn=0,
                                        device="cpu")
    with torch.no_grad():
        out = fwd(prep, *_torch(img, ques)).numpy()
    assert out.shape == (B, ANSWERS) and out.dtype == np.float32
    # same steps at the same precision on both sides (bf16 stream); sums
    # ordered differently can move a bf16 rounding one step (2^-8) and
    # that carries through 4 blocks to the logits: 1e-2 on |logit| ~ 1
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_plain_engine_matches_model_apply(setup):
    cfg, model, params, img, ques = setup
    ref = np.asarray(model.apply({"params": params}, img, ques)["logits"])
    net = MCANet(cfg, TOKENS, ANSWERS)
    net.load_state_dict(state_dict_from_params(params), strict=True)
    with torch.no_grad():
        out = net(*_torch(img, ques)).numpy()
    # f32 stream, bf16 matmul operands on both sides; a bf16 rounding one
    # step apart in some block moves the logits by ~1e-3
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_serving_forward_runs_the_block_wrappers(setup, monkeypatch):
    """In the all-bf16 engine (qffn=0) every encoder block goes through
    fused_sa_block and every decoder block through fused_sga_block (on the
    CPU they run their plain versions, so the kernels' launch counts stay
    put)."""
    cfg, _, params, img, ques = setup
    from mcan_vqa_tpu_torch.ops import serving as tserving
    calls = {"sa": 0, "sga": 0}
    real_sa, real_sga = tserving.fused_sa_block, tserving.fused_sga_block

    def sa(*a, **k):
        calls["sa"] += 1
        return real_sa(*a, **k)

    def sga(*a, **k):
        calls["sga"] += 1
        return real_sga(*a, **k)

    monkeypatch.setattr(tserving, "fused_sa_block", sa)
    monkeypatch.setattr(tserving, "fused_sga_block", sga)
    before = kernels.launch_counts()
    fwd, prep = build_production_engine(state_dict_from_params(params),
                                        cfg.layer, cfg.multi_head, qffn=0,
                                        device="cpu")
    with torch.no_grad():
        fwd(prep, *_torch(img, ques))
    assert calls == {"sa": cfg.layer, "sga": cfg.layer}
    assert kernels.launch_counts() == before


def test_prepared_tree_is_the_pruned_mode2_layout(setup):
    cfg, _, params, _, _ = setup
    _, prep = build_production_engine(state_dict_from_params(params),
                                      cfg.layer, cfg.multi_head, device="cpu")
    D = cfg.hidden_size
    enc, dec = prep["backbone"]["enc_0"], prep["backbone"]["dec_0"]
    # the default engine (level 1) keeps the bf16 layout beside the int8
    # weights: a dynamic-scale block past QFFN_MAX_BATCH runs bf16
    assert set(enc) == {"_mk", "_qffn"}
    assert set(dec) == {"_mk", "_qffn", "mhatt2"}
    assert set(dec["_qffn"]) == {"w1_q", "s1", "b1", "w2_q", "s2", "b2"}
    assert enc["_mk"]["wqkv"].shape == (D, 3 * D)
    assert enc["_mk"]["wqkv"].dtype == torch.bfloat16
    assert dec["_mk"]["wqkv1"].shape == (D, 3 * D)
    assert dec["mhatt2"]["linear_kv"]["kernel"].shape == (D, 2 * D)
    assert dec["_mk"]["ln3_s"].dtype == torch.float32
    # the fused qkv is W_q | W_k | W_v in the JAX [in, out] layout
    w_k = params["backbone"]["enc_0"]["mhatt"]["linear_k"]["kernel"]
    assert torch.equal(enc["_mk"]["wqkv"][:, D:2 * D],
                       torch.from_numpy(np.array(w_k, np.float32))
                       .to(torch.bfloat16))


@pytest.mark.parametrize("kwargs", [
    dict(q8aux=True), dict(qffn=4), dict(qffn=7),
    dict(q8aux=True, qffn=0, act_scales={"aux": (1.0,) * 4}),
    dict(q8aux=True, act_scales={"enc_0": (1.0,) * 3}),
    dict(q8aux=True, sga_mode=3, act_scales={"aux": (1.0,) * 4})])
def test_unported_engine_arguments_raise(setup, kwargs):
    """The JAX builder's refusals (serving.py:653-677), each a ValueError on
    both sides: an int4 level or q8aux with no calibration source, stored
    scales without the "aux" tuple, q8aux with qffn=0 or another decoder
    mode than the per-block megakernels."""
    cfg, _, params, _, _ = setup
    with pytest.raises(ValueError):
        jax_production_engine(params, cfg.layer, cfg.multi_head, **kwargs)
    with pytest.raises(ValueError):
        build_production_engine(state_dict_from_params(params), cfg.layer,
                                cfg.multi_head, device="cpu", **kwargs)
