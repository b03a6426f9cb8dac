"""The port's Predictor on the CPU (mcan_vqa_tpu_torch/api.py): ragged
requests padded to latency buckets, answer / topk, the engines, the
reference-pickle entry point, and the arguments it refuses."""

import numpy as np
import pytest
import torch

from mcan_vqa_tpu.data import text
from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.parallel import make_mesh

CFG = Config(hidden_size=64, layer=2, multi_head=4, ff_size=256,
             img_feat_size=32, img_feat_pad_size=12, max_token=7,
             flat_mlp_size=24, flat_out_size=48)
QUESTIONS = ["what color is the cat", "how many people are there",
             "is this a kitchen", ""]
IX_TO_ANS = {str(i): f"answer{i}" for i in range(20)}


@pytest.fixture(scope="module")
def weights():
    vocab, emb = text.build_vocab(QUESTIONS, embed_dim=CFG.word_embed_size)
    net = MCANet(CFG, len(vocab), len(IX_TO_ANS), pretrained_emb=emb,
                 generator=torch.Generator().manual_seed(0))
    return net.state_dict(), vocab


def _features(n, seed=0):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.normal(size=(int(r), CFG.img_feat_size)))
            .astype(np.float32) for r in rng.integers(3, 13, n)]


def _predictor(weights, **kw):
    sd, vocab = weights
    kw.setdefault("latency_buckets", (1, 4))
    return Predictor(CFG, sd, vocab, IX_TO_ANS, max_batch=8, device="cpu",
                     **kw)


def test_buckets(weights):
    p = _predictor(weights)
    assert p.buckets == (1, 4, 8)
    assert [p.bucket_for(n) for n in (1, 2, 4, 5, 8)] == [1, 4, 4, 8, 8]
    assert p.engine == "fused"          # "auto" is the fused engine


@pytest.mark.parametrize("n", [1, 3, 6])
def test_answer_and_topk_ragged_requests(weights, n):
    p = _predictor(weights, engine="fused")
    qs = [QUESTIONS[i % len(QUESTIONS)] for i in range(n)]
    feats = _features(n, seed=n)
    probs = p.predict_probs(qs, feats)
    assert probs.shape == (n, len(IX_TO_ANS))
    assert np.isfinite(probs).all() and (probs >= 0).all() \
        and (probs <= 1).all()
    ans = p.answer(qs, feats)
    top = p.topk(qs, feats, k=3)
    for row, (a, s), t in zip(probs, ans, top):
        assert a == IX_TO_ANS[str(int(row.argmax()))]
        assert s == pytest.approx(float(row.max()))
        assert len(t) == 3 and t[0][0] == a
        assert t[0][1] >= t[1][1] >= t[2][1]


def test_bucket_padding_does_not_change_a_row(weights):
    """A request padded to bucket 8 gives the same row as alone in
    bucket 1: the padded samples never reach the real ones (a leak would
    move a row by ~1e-1; other GEMM blockings for another batch size may
    move a bf16 rounding, ~1e-3)."""
    p = _predictor(weights)
    feats = _features(5, seed=9)
    qs = QUESTIONS + ["what is it"]
    batch = p.predict_probs(qs, feats)
    for i in (0, 3):                       # 3: the empty question
        alone = p.predict_probs([qs[i]], [feats[i]])
        np.testing.assert_allclose(alone[0], batch[i], rtol=0, atol=2e-3)


def test_fused_and_plain_engines_agree(weights):
    fused = _predictor(weights, engine="fused")
    plain = _predictor(weights, engine="plain")
    assert isinstance(plain.params, MCANet)
    feats = _features(4, seed=4)
    pf = fused.predict_probs(QUESTIONS, feats)
    pp = plain.predict_probs(QUESTIONS, feats)
    # the default fused engine is int8 level 1 (dynamic per-row scales:
    # each code within half a step, max|x| / 254, of its input) with a
    # bf16 residual stream, the plain one f32 throughout: 1.8e-3 apart on
    # these inputs (2.2e-3 at level 3); the JAX package bounds the same
    # engine against model.apply by 2e-2 (tests/test_quant.py:564). 1e-2
    # keeps 5x the measured gap
    np.testing.assert_allclose(pf, pp, atol=1e-2)
    np.testing.assert_array_equal(pf.argmax(-1), pp.argmax(-1))


def test_from_checkpoint_reference_pickle(weights, tmp_path):
    sd, vocab = weights
    path = str(tmp_path / "epoch13.pkl")
    torch.save({"state_dict": sd, "lr_base": 1e-4}, path)
    p = Predictor.from_checkpoint(path, CFG, vocab, IX_TO_ANS, max_batch=4,
                                  device="cpu")
    feats = _features(2, seed=2)
    np.testing.assert_array_equal(
        p.predict_probs(QUESTIONS[:2], feats),
        _predictor(weights).predict_probs(QUESTIONS[:2], feats))
    with pytest.raises(NotImplementedError, match="reference pickles"):
        Predictor.from_checkpoint(str(tmp_path / "orbax_dir"), CFG, vocab)


@pytest.mark.parametrize("kwargs,err", [
    (dict(engine="int8", q8aux=True), ValueError),
    (dict(engine="int4", auto_calibrate=0), ValueError),
    (dict(engine="bogus"), ValueError),
    (dict(mesh=make_mesh({"data": 1, "model": 2}, devices=["cpu"] * 2)),
     ValueError),
    (dict(q8aux=True, auto_calibrate=0), ValueError),
    (dict(latency_buckets=(16,)), ValueError),
    (dict(engine="plain", q8aux=True), ValueError),
    (dict(engine="int8", act_scales={"enc_0": (1.0, 1.0, 1.0)}), ValueError)])
def test_refused_arguments(weights, kwargs, err):
    """The JAX Predictor's construction errors (api.py:244-279): q8aux on
    an engine without calibrated sites, int4 or q8aux with every
    calibration source off, scales for an engine that has none; a serving
    mesh with a model axis (api.py:308-309: pure data parallelism)."""
    with pytest.raises(err):
        _predictor(weights, **kwargs)


def test_request_size_is_checked(weights):
    p = _predictor(weights)
    with pytest.raises(ValueError):
        p.predict_probs(["q"] * 9, _features(9))
    with pytest.raises(ValueError):
        p.predict_probs(["q", "r"], _features(1))
