"""The per-sub-op serving path (``sga_mode=0``) of the port on the CPU, i.e.
the plain versions of its kernels, against the JAX package:

  * ``build_production_engine(qffn=0, sga_mode=0)`` against the JAX one
    (interpret mode) at 2 layers and hidden 64, for each ``use_pallas``
    (False, True, "batched", "packed") x ``use_pallas_attflat`` and both
    stream dtypes, and the sub-ops each forward goes through;
  * ``megakernel_vmem_ok`` against JAX's over a grid of widths, and a
    mode-2 forward past the gate taking mode 0;
  * a 1-layer hidden-1536 ``Predictor`` against the JAX one: both route
    to mode 0 and both drop their calibration with JAX's warning;
  * the refusal of q8aux with the Pallas AttFlat.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.api import Predictor as JaxPredictor
from mcan_vqa_tpu.configs import Config as JaxConfig
from mcan_vqa_tpu.ops import serving as jserving
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops import serving as tserving

# as many image rows as question tokens: the JAX kernels compile one row
# count for the encoder and the decoder
DIMS = dict(hidden_size=64, layer=2, multi_head=4, img_feat_size=32,
            img_feat_pad_size=8, max_token=8, flat_out_size=48,
            flat_mlp_size=24)
TOKENS, ANSWERS, B = 50, 20, 6
WARNING = "activation-scale calibration ignored"


def _weights(dims, tokens, seed):
    """Seeded weights as the port's MCANet draws them, and the same values
    as the JAX tree (the JAX package's importer): no model.init compile."""
    cfg = Config(ff_size=4 * dims["hidden_size"], **dims)
    sd = MCANet(cfg, tokens, ANSWERS, generator=torch.Generator()
                .manual_seed(seed)).state_dict()
    return cfg, sd, jax.device_get(import_torch_state_dict(sd))


@pytest.fixture(scope="module")
def setup():
    _, sd, params = _weights(DIMS, TOKENS, 0)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, 8, 32)).astype(np.float32)
    img[0, 5:] = 0.0
    img[3, 2:] = 0.0
    ques = rng.integers(1, TOKENS, size=(B, 8)).astype(np.int32)
    ques[1, 4:] = 0
    ques[4, 1:] = 0
    return params, sd, img, ques


def _forward(fwd, prep, img, ques):
    with torch.no_grad():
        return fwd(prep, torch.from_numpy(img), torch.from_numpy(ques))


@pytest.mark.parametrize("bf16_stream", [True, False])
@pytest.mark.parametrize("use_pallas_attflat", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True, "batched", "packed"])
def test_mode0_engine_matches_jax(setup, use_pallas, use_pallas_attflat,
                                  bf16_stream):
    params, sd, img, ques = setup
    kw = dict(qffn=0, sga_mode=0, use_pallas=use_pallas,
              use_pallas_attflat=use_pallas_attflat, bf16_stream=bf16_stream)
    jfwd, jprep = jserving.build_production_engine(
        params, DIMS["layer"], DIMS["multi_head"], interpret=True, **kw)
    ref = np.asarray(jfwd(jprep, img, ques))
    fwd, prep = tserving.build_production_engine(
        sd, DIMS["layer"], DIMS["multi_head"], device="cpu", **kw)
    out = _forward(fwd, prep, img, ques).numpy()
    assert out.shape == (B, ANSWERS) and out.dtype == np.float32
    # the same steps at the same precision on both sides; a bf16 rounding
    # of a matmul operand a step apart (a sum in another order) carries
    # through 4 blocks to the logits: 1e-2 on |logit| ~ 1, as for the
    # mode-2 engine (tests/test_torch_serving.py), on either stream
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


def test_mode0_engine_runs_its_sub_ops(setup, monkeypatch):
    """With use_pallas_ffn (build_production_engine's default) and the
    Pallas switches on, a forward makes per encoder layer one
    fused_proj_ln, one fused_ffn_ln and one attention, per decoder layer
    two of the first and the last and one of the second, and two AttFlats
    through the kernels (on the card: 3 L gemm_ln merges, 2 L + 2 L FFN
    launches, 3 L attentions, 2 attflat_pool)."""
    _, sd, img, ques = setup
    calls = dict(proj=0, ffn=0, att=0, attflat=0)

    def counting(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    for name, attr in (("proj", "fused_proj_ln"), ("ffn", "fused_ffn_ln"),
                       ("att", "masked_attention_pallas"),
                       ("attflat", "attflat_pallas")):
        monkeypatch.setattr(tserving, attr,
                            counting(name, getattr(tserving, attr)))
    fwd, prep = tserving.build_production_engine(
        sd, DIMS["layer"], DIMS["multi_head"], qffn=0, sga_mode=0,
        use_pallas=True, device="cpu")
    _forward(fwd, prep, img, ques)
    L = DIMS["layer"]
    assert calls == dict(proj=3 * L, ffn=2 * L, att=3 * L, attflat=2)
    # the per-sub-op path reads the raw entries: the tree is not pruned
    assert {"mhatt", "norm1", "norm2", "ffn", "_mk"} <= set(
        prep["backbone"]["enc_0"])
    assert set(prep["backbone"]["dec_0"]["mhatt2"]) == {
        "linear_q", "linear_kv", "linear_merge"}


@pytest.mark.parametrize("D", [64, 512, 1024, 1280, 1336, 1344, 1536, 2048])
def test_megakernel_vmem_ok_matches_jax(D):
    for F in (2 * D, 4 * D, 4096, 8192):
        assert tserving.megakernel_vmem_ok(D, F) == \
            jserving.megakernel_vmem_ok(D, F)


def test_mode2_past_the_gate_takes_mode0(setup, monkeypatch):
    """A width that fails the gate (here: a gate that fails every width)
    has no ``_mk`` layouts, and its mode-2 forward is the mode-0 one, bit
    for bit (serving.py:841-842)."""
    _, sd, img, ques = setup
    L, H = DIMS["layer"], DIMS["multi_head"]
    mode0, prep0 = tserving.build_production_engine(sd, L, H, qffn=0,
                                                    sga_mode=0, device="cpu")
    monkeypatch.setattr(tserving, "megakernel_vmem_ok", lambda D, F: False)
    mode2, prep2 = tserving.build_production_engine(sd, L, H, qffn=0,
                                                    device="cpu")
    assert "_mk" not in prep2["backbone"]["enc_0"]
    assert torch.equal(_forward(mode2, prep2, img, ques),
                       _forward(mode0, prep0, img, ques))


def test_q8aux_does_not_compose_with_the_pallas_attflat(setup):
    """serving.py:802-803, an assert on both sides."""
    params, sd, img, ques = setup
    L, H = DIMS["layer"], DIMS["multi_head"]
    kw = dict(q8aux=True, qffn=1, act_scales={"aux": (1.0,) * 4},
              use_pallas=True)
    jfwd, jprep = jserving.build_production_engine(params, L, H,
                                                   interpret=True, **kw)
    with pytest.raises(AssertionError, match="q8aux"):
        jfwd(jprep, img, ques)
    fwd, prep = tserving.build_production_engine(sd, L, H, device="cpu",
                                                 **kw)
    with pytest.raises(AssertionError, match="q8aux"):
        _forward(fwd, prep, img, ques)


def test_wide_predictor_serves_mode0_as_jax_does():
    """Hidden 1536 fails the gate (28 D^2 bytes at F = 4D): the default
    fused engine of both Predictors serves the per-sub-op path in bf16 and
    drops its calibration batch with JAX's warning."""
    dims = dict(hidden_size=1536, layer=1, multi_head=8, img_feat_size=16,
                img_feat_pad_size=10, max_token=6, flat_out_size=48,
                flat_mlp_size=24)
    vocab = {"PAD": 0, "UNK": 1, "what": 2, "color": 3, "is": 4, "it": 5}
    answers = {str(i): f"a{i}" for i in range(ANSWERS)}
    jcfg = JaxConfig(use_glove=False, **dims).finalize()
    cfg, sd, params = _weights(dims, len(vocab), 1)
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(n, 16)).astype(np.float32) for n in (10, 4)]
    questions = ["what color is it", "what is it"]
    assert not jserving.megakernel_vmem_ok(1536, jcfg.ff_size)
    kw = dict(max_batch=2, latency_buckets=(1,), engine="fused",
              act_calibration=(questions, feats))
    with pytest.warns(UserWarning, match=WARNING):
        jp = JaxPredictor(jcfg, params, vocab, answers, **kw)
    with pytest.warns(UserWarning, match=WARNING):
        tp = Predictor(cfg, sd, vocab, answers, device="cpu", **kw)
    for p in (jp.params, tp.params):
        assert "_mk" not in p["backbone"]["enc_0"]
        assert "mhatt" in p["backbone"]["enc_0"]
    assert tp.act_scales is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = jp.predict_probs(questions, feats)
        out = tp.predict_probs(questions, feats)
    # both bf16-stream mode-0 engines, sums in other orders: PERF.md's
    # bf16 bound on the probabilities
    np.testing.assert_allclose(out, ref, atol=1e-2)
