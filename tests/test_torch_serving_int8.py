"""The port's default serving engine (int8 levels 1-3 of
``build_production_engine``) and the Predictor's online calibration, on the
CPU (plain versions of the block kernels) against the JAX package:

  * ``build_production_engine`` with qffn=None (level 1), qffn=2, a
    calibration batch (level 3) and stored scales, against the JAX builder
    in interpret mode on the same weights;
  * the ``QFFN_MAX_BATCH`` gate (serving.py:859-871, :926-941);
  * ``Predictor`` with its defaults: level 1 from the first request, the
    online calibration state machine (api.py:564-722) and the level-3
    engine it swaps in, against the JAX Predictor on one bucket.

Small size: 2 layers, hidden 64, 4 heads of 16, FF 256.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.api import Predictor as JaxPredictor
from mcan_vqa_tpu.configs import Config as JaxConfig
from mcan_vqa_tpu.data import text
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.ops.serving import \
    build_production_engine as jax_production_engine
from mcan_vqa_tpu_torch import api
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.ops import serving as tserving
from mcan_vqa_tpu_torch.ops.quant import calibrate_qffn_act_scales
from mcan_vqa_tpu_torch.ops.serving import (build_production_engine,
                                            prepare_production_params)
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params

DIMS = dict(hidden_size=64, layer=2, multi_head=4, img_feat_size=32,
            img_feat_pad_size=12, max_token=7, flat_out_size=48,
            flat_mlp_size=24)
CFG = Config(ff_size=4 * DIMS["hidden_size"], **DIMS)
L, H, B = DIMS["layer"], DIMS["multi_head"], 6
QUESTIONS = ["what color is the cat", "how many people are there",
             "is this a kitchen", "what is on the table",
             "is the man wearing a hat", "what sport is this"]
IX_TO_ANS = {str(i): f"answer{i}" for i in range(20)}


@pytest.fixture(scope="module")
def setup():
    """JAX params of the small model with its vocabulary, the port's state
    dict of the same weights, and a batch with partial padding in both
    streams (no fully padded sample: the JAX kernels pack samples, ROADMAP
    §3)."""
    vocab, _ = text.build_vocab(QUESTIONS, embed_dim=300)
    jcfg = JaxConfig(use_glove=False, **DIMS).finalize()
    model = build_mcan(jcfg, token_size=len(vocab), answer_size=20)
    rng = np.random.default_rng(0)
    img = np.abs(rng.normal(size=(B, 12, 32))).astype(np.float32)
    img[0, 8:] = 0.0
    img[3, 2:] = 0.0
    ques = rng.integers(1, len(vocab), size=(B, 7)).astype(np.int32)
    ques[1, 4:] = 0
    ques[4, 1:] = 0
    params = jax.device_get(model.init({"params": jax.random.PRNGKey(0)},
                                       img, ques)["params"])
    return jcfg, vocab, params, state_dict_from_params(params), img, ques


def _torch(img, ques):
    return torch.from_numpy(img), torch.from_numpy(ques)


# ---------------------------------------------------------------------------
# the builder against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["dynamic", "level2", "batch", "scales"])
def test_int8_engine_matches_jax_production_engine(setup, source):
    """dynamic: qffn=None, no calibration (level 1); level2: qffn=2;
    batch: a calibration batch (level 3, each side calibrates); scales:
    the port's calibrated scales given to both (level 3)."""
    _, _, params, sd, img, ques = setup
    kw = {"level2": dict(qffn=2), "batch": dict(act_scale_inputs=(img, ques))
          }.get(source, {})
    if source == "scales":
        prep = prepare_production_params(sd, L, qffn=3, device="cpu")
        kw = dict(act_scales=calibrate_qffn_act_scales(prep, img, ques, L, H))
    jfwd, jprep = jax_production_engine(params, L, H, interpret=True, **kw)
    ref = np.asarray(jfwd(jprep, img, ques))
    fwd, prep = build_production_engine(sd, L, H, device="cpu", **kw)
    with torch.no_grad():
        out = fwd(prep, *_torch(img, ques)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert (fwd.act_scales is None) == (source in ("dynamic", "level2"))
    # the same int8 decisions on both sides but where an f32 input sits on
    # a rounding boundary (blocks: within 2^-7, tests/test_torch_quant.py),
    # carried through 4 blocks and the heads to |logit| ~ 1: 1e-2
    # (measured: 3.3e-3 dynamic, 2.6e-3 level 2, 4.6e-3 from a batch, where
    # the two sides' scales differ by ~1e-3, 6e-8 from the same scales)
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def _count_blocks(monkeypatch):
    calls = {name: 0 for name in ("fused_sa_block", "fused_sga_block",
                                  "fused_qffn_sa_block",
                                  "fused_qffn_sga_block")}
    for name in calls:
        real = getattr(tserving, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tserving, name, counted)
    return calls


def test_qffn_gate_routes_to_bf16_past_the_threshold(setup, monkeypatch):
    """As tests/test_quant.py:661-717: past QFFN_MAX_BATCH a dynamic-scale
    engine runs the all-bf16 blocks (bitwise the qffn=0 engine); under it
    the int8 blocks; static scales lift the gate."""
    _, _, _, sd, img, ques = setup
    inputs = _torch(img, ques)
    with torch.no_grad():
        bf16_fwd, bf16_prep = build_production_engine(sd, L, H, qffn=0,
                                                      device="cpu")
        ref = bf16_fwd(bf16_prep, *inputs)
        fwd, prep = build_production_engine(sd, L, H, device="cpu")
        static_fwd, static_prep = build_production_engine(
            sd, L, H, act_scale_inputs=(img, ques), device="cpu")
        calls = _count_blocks(monkeypatch)

        monkeypatch.setattr(tserving, "QFFN_MAX_BATCH", B - 1)
        assert torch.equal(fwd(prep, *inputs), ref)
        assert calls == {"fused_sa_block": L, "fused_sga_block": L,
                         "fused_qffn_sa_block": 0, "fused_qffn_sga_block": 0}

        monkeypatch.setattr(tserving, "QFFN_MAX_BATCH", B)
        assert (fwd(prep, *inputs) - ref).abs().max() > 0
        assert calls["fused_qffn_sa_block"] == calls[
            "fused_qffn_sga_block"] == L

        static_under = static_fwd(static_prep, *inputs)
        monkeypatch.setattr(tserving, "QFFN_MAX_BATCH", B - 1)
        static_over = static_fwd(static_prep, *inputs)
    assert torch.equal(static_over, static_under)
    assert (static_over - ref).abs().max() > 0
    assert calls["fused_qffn_sa_block"] == 3 * L
    assert calls["fused_sa_block"] == L


def test_builder_argument_errors(setup):
    _, _, _, sd, img, ques = setup
    with pytest.raises(ValueError, match="not both"):
        build_production_engine(sd, L, H, act_scale_inputs=(img, ques),
                                act_scales={"enc_0": (1.0, 1.0, 1.0)},
                                device="cpu")
    bad = {f"{s}_{i}": (0.1, 0.1, 0.1) for s in ("enc", "dec")
           for i in range(L)}
    bad["dec_1"] = (0.1, float("nan"), 0.1)
    with pytest.raises(ValueError, match="non-finite"):
        build_production_engine(sd, L, H, act_scales=bad, device="cpu")
    # qffn=0 ignores scales, as in JAX
    fwd, _ = build_production_engine(sd, L, H, qffn=0, act_scales=bad,
                                     device="cpu")
    assert fwd.act_scales is None


# ---------------------------------------------------------------------------
# the Predictor and its online calibration
# ---------------------------------------------------------------------------

def _features(n, seed=0):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.normal(size=(int(r), CFG.img_feat_size)))
            .astype(np.float32) for r in rng.integers(3, 13, n)]


def _predictor(setup, **kw):
    _, vocab, _, sd, _, _ = setup
    kw.setdefault("latency_buckets", (1, 4))
    kw.setdefault("max_batch", 8)
    return api.Predictor(CFG, sd, vocab, IX_TO_ANS, device="cpu", **kw)


def _questions(n):
    return [QUESTIONS[i % len(QUESTIONS)] for i in range(n)]


def _probe(p, request):
    """Probabilities of a request without feeding the calibration."""
    return p.forward_padded(*p.pad_batch(*request))[:len(request[0])] \
        .cpu().numpy()


def test_default_predictor_calibrates_online(setup):
    """Level 1 from the first request; real rows buffered (bucket padding
    never); at the target a background rebuild swaps in level 3, which
    equals a Predictor built from the same rows (act_calibration) and one
    built from its scales (act_scales), bit for bit."""
    p = _predictor(setup, auto_calibrate=10)
    assert p.engine == "fused" and p.act_scales is None
    assert p.calibration == {"state": "collecting", "samples": 0,
                             "target": 10}
    assert p.routes == {1: "base", 4: "base", 8: "base"}
    reqs = [(_questions(1), _features(1, 1)), (_questions(3), _features(3, 2)),
            (_questions(8), _features(8, 3))]
    p.predict_probs(*reqs[0])
    p.predict_probs(*reqs[1])              # padded to bucket 4
    assert p.calibration["samples"] == 4
    probe = (_questions(4), _features(4, 9))
    before = _probe(p, probe)
    assert p.calibration["samples"] == 4   # pad_batch collects nothing
    p.predict_probs(*reqs[2])              # crosses 10: the rebuild starts
    assert p.wait_calibrated(timeout=300)
    cal = p.calibration
    assert cal["state"] == "calibrated" and "error" not in cal
    assert p.routes == {1: "base", 4: "base", 8: "base"}
    assert set(p.act_scales) == {f"{s}_{i}" for s in ("enc", "dec")
                                 for i in range(L)}
    assert len(p.act_scales["enc_0"]) == 4 and len(p.act_scales["dec_0"]) == 6
    after = _probe(p, probe)
    assert np.abs(after - before).max() > 0          # the swap is live
    rows = [r for q, f in reqs for r in zip(q, f)][:10]
    explicit = _predictor(setup, act_calibration=(
        [q for q, _ in rows], [f for _, f in rows]))
    stored = _predictor(setup, act_scales=p.act_scales)
    for other in (explicit, stored):
        assert other.calibration["state"] == "calibrated"
        assert other.act_scales == p.act_scales
        np.testing.assert_array_equal(_probe(other, probe), after)


def test_non_finite_rows_are_not_collected(setup):
    p = _predictor(setup, auto_calibrate=50)
    feats = _features(3, 4)
    feats[1][0, 0] = np.nan
    p.predict_probs(_questions(3), feats)
    assert p.calibration["samples"] == 2


def test_calibration_paused_and_calibrate_now(setup):
    p = _predictor(setup, auto_calibrate=50)
    with p.calibration_paused():
        assert p.calibration["state"] == "paused"
        p.predict_probs(_questions(2), _features(2, 5))
    assert p.calibration == {"state": "collecting", "samples": 0,
                             "target": 50}
    assert not p.wait_calibrated(timeout=0)
    with pytest.raises(RuntimeError, match="no calibration samples"):
        p.calibrate_now()
    p.predict_probs(_questions(3), _features(3, 6))
    p.calibrate_now()
    assert p.calibration["state"] == "calibrated" and p.wait_calibrated()
    assert p.act_scales is not None
    with pytest.raises(RuntimeError, match="not collecting"):
        p.calibrate_now()


def test_failed_calibration_retries_with_a_doubled_target(setup,
                                                          monkeypatch):
    p = _predictor(setup, auto_calibrate=4)
    real = api.build_production_engine

    def broken(*a, **k):
        if k.get("act_scale_inputs") is not None:
            raise RuntimeError("injected build failure")
        return real(*a, **k)

    monkeypatch.setattr(api, "build_production_engine", broken)
    with pytest.warns(UserWarning, match="online calibration failed"):
        p.predict_probs(_questions(5), _features(5, 7))
        assert p.wait_calibrated(timeout=300)
    cal = p.calibration
    assert cal["state"] == "collecting" and cal["target"] == 8
    assert cal["samples"] == 4 and "injected" in cal["error"]
    assert p.act_scales is None                # level 1 still serves
    monkeypatch.setattr(api, "build_production_engine", real)
    p.calibrate_now()
    assert p.calibration["state"] == "calibrated"
    assert "error" not in p.calibration


def test_auto_without_a_calibration_source_warns(setup):
    with pytest.warns(UserWarning, match="no calibration source"):
        p = _predictor(setup, auto_calibrate=0)
    assert p.calibration["state"] == "off" and p.act_scales is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _predictor(setup, engine="fused", auto_calibrate=0)
        q = _predictor(setup, act_scales=False)   # False means None
    assert q.calibration["state"] == "collecting"


@pytest.mark.parametrize("kwargs", [
    dict(act_calibration=(["q"], [np.ones((2, 32), np.float32)]),
         act_scales={"enc_0": (1.0, 1.0, 1.0)}),
    dict(engine="plain", act_scales={"enc_0": (1.0, 1.0, 1.0)}),
    dict(auto_calibrate=-1)])
def test_refused_calibration_arguments(setup, kwargs):
    with pytest.raises(ValueError):
        _predictor(setup, **kwargs)


def test_level3_predictor_matches_jax_predictor(setup):
    """Both Predictors calibrated on the same batch, one bucket of 4."""
    jcfg, vocab, params, _, _, _ = setup
    cal = (_questions(6), _features(6, 11))
    req = (QUESTIONS[2:6], _features(4, 12))
    jp = JaxPredictor(jcfg, params, vocab, IX_TO_ANS, max_batch=4,
                      engine="fused", act_calibration=cal, auto_calibrate=0)
    tp = _predictor(setup, max_batch=4, latency_buckets=None,
                    act_calibration=cal)
    ref = jp.predict_probs(*req)
    out = tp.predict_probs(*req)
    # both calibrate their scales on the batch (within 1e-2 of each other,
    # tests/test_torch_quant.py) and quantize with them: probabilities
    # within 1e-2 (measured 7.3e-4)
    np.testing.assert_allclose(out, ref, atol=1e-2)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))
