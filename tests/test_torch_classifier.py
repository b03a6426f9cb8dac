"""The classify task of the port against the JAX package on the CPU:
``ClassifierNet`` (models/net.py), ``make_fused_classifier_forward``
(train/fused_engine.py), the classifier serving engine at levels 0-7 and
``calibrate_classifier_act_scales`` (ops/serving.py, ops/quant.py),
``Trainer(task="classify")``, ``run_classify`` and the synthetic MIMIC
set (data/mimic.py).

Small size: 2 layers, hidden 64, 4 heads of 16, FF 256, 10 regions of 32
features, 14 labels. The JAX weights come from ``import_torch_state_dict``
of a seeded port model. The batch has a sample with trailing zero rows
(0) and one with no regions at all (2): every JAX Pallas kernel packs
samples (``fused_sa_block`` / the qffn block: 128 // 10 per group), so the
JAX engines are compared on the batch without sample 2, and sample 2 is
held to ``ClassifierNet.apply`` (test_fully_padded_image_follows_apply).
"""

import json
import warnings

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.data import mimic as jmimic
from mcan_vqa_tpu.evals.roc_auc import multilabel_roc_auc as jroc
from mcan_vqa_tpu.models.net import ClassifierNet as JClassifierNet
from mcan_vqa_tpu.ops import serving as jserving
from mcan_vqa_tpu.ops.quant import \
    calibrate_classifier_act_scales as jcalibrate
from mcan_vqa_tpu.train.checkpoint import (export_torch_state_dict,
                                           import_torch_state_dict)
from mcan_vqa_tpu.train.fused_engine import \
    make_fused_classifier_forward as jmake_forward
from mcan_vqa_tpu.train.step import bce_with_logits_sum as jbce
from mcan_vqa_tpu_torch.cli import run_classify
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import mimic
from mcan_vqa_tpu_torch.models.net import ClassifierNet
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import serving
from mcan_vqa_tpu_torch.ops.quant import calibrate_classifier_act_scales
from mcan_vqa_tpu_torch.train import trainer as trainer_mod
from mcan_vqa_tpu_torch.train.checkpoint import (classifier_param_keys,
                                                 load_act_scales,
                                                 state_dict_from_params)
from mcan_vqa_tpu_torch.train.fused_engine import \
    make_fused_classifier_forward
from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
from mcan_vqa_tpu_torch.train.trainer import Trainer

L, H, D, R, FEAT, A, B = 2, 4, 64, 10, 32, 14, 6
ARCH = dict(hidden_size=D, layer=L, multi_head=H, ff_size=4 * D,
            img_feat_size=FEAT, img_feat_pad_size=R, flat_mlp_size=24,
            flat_out_size=48)
CFG = Config(**ARCH)
REAL = [0, 1, 3, 4, 5]          # the samples with at least one region


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file's tests run: the suite runs
    files in parallel worker processes, and torch's default pool of a
    thread per core oversubscribes the cores (six concurrent runs of
    test_torch_trainer.py's large-shaped test took 378 s of wall time at
    the default count, 25 s at one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


@pytest.fixture(scope="module")
def setup():
    """The seeded port model, its state_dict, the JAX model and its
    params from that state_dict, and the batch."""
    net = ClassifierNet(CFG, A, generator=torch.Generator().manual_seed(7))
    sd = net.state_dict()
    jmodel = JClassifierNet(answer_size=A, hidden_size=D, num_layers=L,
                            num_heads=H, ff_size=4 * D, img_feat_size=FEAT,
                            flat_mlp_size=24, flat_out_size=48)
    params = import_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, R, FEAT)).astype(np.float32)
    img[0, 6:] = 0.0                             # trailing zero rows
    img[2] = 0.0                                 # no regions at all
    target = (rng.random((B, A)) < 0.3).astype(np.float32)
    return net, sd, jmodel, params, img, target


@pytest.fixture(scope="module")
def apply_logits(setup):
    _, _, jmodel, params, img, _ = setup
    return np.asarray(jax.jit(lambda p: jmodel.apply(
        {"params": p}, img)["logits"])(params))


# ---------------------------------------------------------------------------
# weights and the plain model
# ---------------------------------------------------------------------------

def test_weights_round_trip_in_registration_order(setup):
    """port -> JAX (``import_torch_state_dict``) -> port
    (``state_dict_from_params``) and JAX's export, exact, in
    ``classifier_param_keys`` order, loading with strict=True."""
    net, sd, _, params, _, _ = setup
    assert list(sd) == classifier_param_keys(L)
    back = state_dict_from_params(params)
    assert list(back) == classifier_param_keys(L)
    exported = export_torch_state_dict(params)
    for got in (back, exported):
        assert set(got) == set(sd)
        for k in sd:
            np.testing.assert_array_equal(np.asarray(got[k]), sd[k].numpy(),
                                          err_msg=k)
    again = ClassifierNet(CFG, A)
    again.load_state_dict(back, strict=True)


def test_plain_classifier_matches_apply(setup, apply_logits):
    """The plain engine against ``ClassifierNet.apply``, the fully padded
    image included: 1e-2 of the largest |logit| (bf16 products summed in
    another order; tests/test_torch_serving.py's gate)."""
    net, _, _, _, img, _ = setup
    with torch.no_grad():
        out = net(torch.from_numpy(img)).numpy()
    assert out.shape == (B, A) and np.isfinite(out).all()
    np.testing.assert_allclose(out, apply_logits, rtol=0,
                               atol=1e-2 * np.abs(apply_logits).max())


# ---------------------------------------------------------------------------
# the train forward
# ---------------------------------------------------------------------------

def _flat_grads(grads):
    return {k: v.numpy() for k, v in
            state_dict_from_params(jax.device_get(grads)).items()}


@pytest.fixture(scope="module")
def jax_engine(setup):
    """JAX's fused classifier forward at rate 0 in interpret mode, group 1
    (the port attends per sample): logits, loss and gradients."""
    _, _, _, params, img, target = setup
    fwd = jmake_forward(L, H, dropout_rate=0.0, interpret=True, group=1)

    def loss_fn(p):
        logits = fwd(p, img, jax.random.PRNGKey(1))
        return jbce(logits, target), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return np.asarray(logits), float(loss), _flat_grads(grads)


@pytest.fixture(scope="module")
def jax_apply_real(setup):
    """``ClassifierNet.apply`` autodiff on the samples with regions: with
    an image of no regions the train kernels' additive pad mask and
    apply's replaced scores differ in the score gradient
    (tests/test_torch_fused_engine.py, the all-PAD question)."""
    _, _, jmodel, params, img, target = setup
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jbce(jmodel.apply(
        {"params": p}, img[REAL])["logits"], target[REAL])))(params)
    return float(loss), _flat_grads(grads)


def _port_loss_grads(setup, rows=slice(None), sa_block="fused", rate=0.0,
                     seed=0, in_kernel_dropout=False):
    net, _, _, _, img, target = setup
    fwd = make_fused_classifier_forward(L, H, dropout_rate=rate,
                                        sa_block=sa_block,
                                        in_kernel_dropout=in_kernel_dropout)
    net.zero_grad()
    logits = fwd(net, torch.from_numpy(img[rows]),
                 torch.Generator().manual_seed(seed))
    loss = bce_with_logits_sum(logits, torch.from_numpy(target[rows]))
    loss.backward()
    return (float(loss.detach()),
            {k: p.grad.clone().numpy() for k, p in net.named_parameters()},
            logits.detach().numpy())


def _close(got, want):
    """The loss within 1e-3 relative; per tensor max|a - b| over
    max(max|ref|, 1% of the largest gradient) within 4e-2
    (tests/test_torch_fused_engine.py's gate)."""
    (lg, gg), (lw, gw) = got[:2], want
    assert abs(lg - lw) / max(1.0, abs(lw)) < 1e-3
    assert set(gg) == set(gw)
    top = max(float(np.abs(v).max()) for v in gw.values())
    for name, a in gg.items():
        b = gw[name]
        assert np.isfinite(a).all(), name
        scale = max(1e-2 * top, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=4e-2,
                                   err_msg=name)


@pytest.mark.parametrize("sa_block", ["fused", "plain"])
def test_train_forward_matches_the_jax_engine(setup, jax_engine, sa_block):
    """Rate 0, the no-region image included: logits within 1e-2 of the
    largest |logit|, the loss and every gradient within ``_close``."""
    logits, loss, grads = jax_engine
    got = _port_loss_grads(setup, sa_block=sa_block)
    np.testing.assert_allclose(got[2], logits, rtol=0,
                               atol=1e-2 * np.abs(logits).max())
    _close(got, (loss, grads))


@pytest.mark.parametrize("sa_block", ["fused", "plain"])
def test_train_forward_matches_apply_autodiff(setup, jax_apply_real,
                                              sa_block):
    _close(_port_loss_grads(setup, REAL, sa_block=sa_block), jax_apply_real)


@pytest.mark.parametrize("seeded", [False, True],
                         ids=["generator-masks", "in-kernel-dropout"])
def test_fused_and_plain_blocks_see_the_same_masks(setup, seeded):
    """Rate 0.1 from one generator state: the kernel sequence and the
    plain blocks read the same masks (or draw the same Philox bits from
    the same seeds), so the losses agree to 1e-5 relative; another seed
    moves them."""
    kw = dict(rate=0.1, in_kernel_dropout=seeded)
    fused = _port_loss_grads(setup, seed=5, **kw)
    plain = _port_loss_grads(setup, sa_block="plain", seed=5, **kw)
    other = _port_loss_grads(setup, seed=6, **kw)
    assert abs(fused[0] - plain[0]) <= 1e-5 * abs(plain[0])
    assert fused[0] != other[0]


def test_cpu_train_forward_launches_no_kernel_and_refuses_rate_one(setup):
    before = K.launch_counts()
    _port_loss_grads(setup, rate=0.1)
    assert K.launch_counts() == before
    with pytest.raises(ValueError):
        make_fused_classifier_forward(L, H, dropout_rate=1.0)
    with pytest.raises(ValueError):
        make_fused_classifier_forward(L, H, sa_block="other")


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_scales(setup):
    _, sd, _, _, img, _ = setup
    prep = serving.prepare_production_classifier_params(sd, L, qffn=3,
                                                        device="cpu")
    return calibrate_classifier_act_scales(prep, img[REAL], L, H)


def _port_engine(sd, img, **kw):
    fwd, prep = serving.build_production_classifier_engine(
        sd, L, H, device="cpu", **kw)
    with torch.no_grad():
        return fwd(prep, torch.from_numpy(img)).numpy(), fwd


def test_calibrated_scales_match_jax(setup, port_scales):
    """The replay on both sides: every scale within 1e-2 relative (bf16
    roundings of the stream; measured ~1e-3)."""
    _, _, _, params, img, _ = setup
    jprep = jserving.prepare_production_classifier_params(params, L, qffn=3)
    want = jcalibrate(jprep, img[REAL], L, H)
    assert set(port_scales) == set(want) == {f"enc_{i}" for i in range(L)}
    for k in want:
        assert len(port_scales[k]) == len(want[k]) == 4
        np.testing.assert_allclose(port_scales[k], want[k], rtol=1e-2,
                                   err_msg=k)


@pytest.mark.parametrize("level", [0, 1, 3])
def test_engine_matches_jax(setup, port_scales, level):
    """qffn 0 (bf16), 1 (dynamic int8 FFN) and 3 (static scales, the
    port's given to both) against JAX's ``make_classifier_serving_fn`` in
    interpret mode on the samples with regions: logits within 1e-2
    (tests/test_torch_serving_int8.py's gate)."""
    _, sd, _, params, img, _ = setup
    kw = dict(qffn=level)
    if level == 3:
        kw["act_scales"] = port_scales
    jfwd, jprep = jserving.build_production_classifier_engine(
        params, L, H, interpret=True, **kw)
    ref = np.asarray(jfwd(jprep, img[REAL]))
    out, fwd = _port_engine(sd, img[REAL], **kw)
    assert out.shape == ref.shape == (len(REAL), A)
    assert (fwd.act_scales is None) == (level != 3)
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def level3_probs(setup, port_scales):
    _, sd, _, _, img, _ = setup
    return _sigmoid(_port_engine(sd, img, act_scales=port_scales)[0])


@pytest.mark.parametrize("level", [4, 5, 6, 7])
def test_int4_levels_against_level3(setup, port_scales, level3_probs,
                                    level):
    """Levels 4-7 against level 3 on the sigmoid within 0.04 (JAX's
    classifier int4 gate, tests/test_quant.py:790); a count of their
    blocks' int4 launches on the CPU is 0."""
    _, sd, _, _, img, _ = setup
    out, fwd = _port_engine(sd, img, qffn=level, act_scales=port_scales)
    assert np.abs(_sigmoid(out) - level3_probs).max() <= 0.04


def test_construction_errors(setup, port_scales):
    """JAX's: levels 4-7 without a calibration source raise naming int4;
    a batch and stored scales together are refused."""
    _, sd, _, _, img, _ = setup
    for level in (4, 7):
        with pytest.raises(ValueError, match="int4"):
            serving.build_production_classifier_engine(sd, L, H, qffn=level,
                                                       device="cpu")
    with pytest.raises(ValueError, match="not both"):
        serving.build_production_classifier_engine(
            sd, L, H, act_scale_inputs=img, act_scales=port_scales,
            device="cpu")


def test_engine_from_a_batch_equals_engine_from_its_scales(setup,
                                                           port_scales):
    _, sd, _, _, img, _ = setup
    a, fa = _port_engine(sd, img, act_scale_inputs=img[REAL])
    b, _ = _port_engine(sd, img, act_scales=port_scales)
    assert fa.act_scales == port_scales
    np.testing.assert_array_equal(a, b)


def test_fully_padded_image_follows_apply(setup, apply_logits):
    """Sample 2 has no regions. The port attends per sample, as
    ``ClassifierNet.apply``: level 1 and the bf16 engine give its
    probabilities within 2e-2 / 1e-2 of apply's (INT8_BOUND / the bf16
    gate). JAX's engine packs samples 2 and 3 into one score matrix, so
    its sample 2 takes its neighbours' attention: pinned at more than 5x
    the port's gap."""
    _, sd, _, params, img, _ = setup
    want = _sigmoid(apply_logits[2])
    for level, tol in ((1, 2e-2), (0, 1e-2)):
        out, _ = _port_engine(sd, img, qffn=level)
        gap = np.abs(_sigmoid(out[2]) - want).max()
        assert gap <= tol, (level, gap)
        jfwd, jprep = jserving.build_production_classifier_engine(
            params, L, H, qffn=level, interpret=True)
        jgap = np.abs(_sigmoid(np.asarray(jfwd(jprep, img))[2]) - want).max()
        assert jgap > 5 * gap, (level, jgap, gap)


def test_qffn_max_batch_gate(setup, port_scales, monkeypatch):
    """Past ``QFFN_MAX_BATCH`` a block with dynamic scales runs the bf16
    block, one with static scales stays int8 (serving.py:444-461)."""
    _, sd, _, _, img, _ = setup
    calls = {"fused_sa_block": 0, "fused_qffn_sa_block": 0}
    for name in calls:
        real = getattr(serving, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(serving, name, spy)
    monkeypatch.setattr(serving, "QFFN_MAX_BATCH", 4)
    _port_engine(sd, img)
    assert calls == {"fused_sa_block": L, "fused_qffn_sa_block": 0}
    _port_engine(sd, img, act_scales=port_scales)
    assert calls == {"fused_sa_block": L, "fused_qffn_sa_block": L}
    _port_engine(sd, img[:4])
    assert calls == {"fused_sa_block": L, "fused_qffn_sa_block": 2 * L}


def test_past_the_envelope_matches_jax_fallback(setup, port_scales,
                                               monkeypatch):
    """With ``megakernel_vmem_ok`` false (hidden 1536 / 2048 on the card)
    both construction paths drop the int8 sites, with JAX's warning, and
    run per sub-op: the port's mode-0 encoder against JAX's plain fallback
    within the bf16 gate 1e-2."""
    _, sd, _, params, img, _ = setup
    monkeypatch.setattr(serving, "megakernel_vmem_ok", lambda d, f: False)
    monkeypatch.setattr(jserving, "megakernel_vmem_ok", lambda d, f: False)
    jfwd, jprep = jserving.build_production_classifier_engine(
        params, L, H, interpret=True)
    ref = np.asarray(jfwd(jprep, img))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out, fwd = _port_engine(sd, img, act_scales=port_scales)
    assert any("outside the megakernel" in str(w.message) for w in seen)
    assert fwd.act_scales is None
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# the synthetic MIMIC set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run_mode", ["train", "val"])
def test_synthetic_mimic_matches_the_original(run_mode):
    from mcan_vqa_tpu.configs import Config as JConfig
    jcfg = JConfig(img_feat_pad_size=12, img_feat_size=8, max_token=6,
                   word_embed_size=16, use_glove=False).finalize()
    cfg = Config(img_feat_pad_size=12, img_feat_size=8, max_token=6,
                 word_embed_size=16)
    kw = dict(size=5, answer_size=14, run_mode=run_mode, seed=3)
    ours = mimic.SyntheticMIMICDataset(cfg, **kw)
    theirs = jmimic.SyntheticMIMICDataset(jcfg, **kw)
    assert len(ours) == len(theirs) and ours.ix_to_ans == theirs.ix_to_ans
    np.testing.assert_array_equal(ours.pretrained_emb, theirs.pretrained_emb)
    for i in range(len(ours)):
        a, b = ours.example(i), theirs.example(i)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    x = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_array_equal(mimic.l2_normalize_rows(x),
                                  jmimic.l2_normalize_rows(x))
    np.testing.assert_array_equal(
        mimic.feature_row_dropout(x, np.random.default_rng(4)),
        jmimic.feature_row_dropout(x, np.random.default_rng(4)))


# ---------------------------------------------------------------------------
# the Trainer and the CLI
# ---------------------------------------------------------------------------

TINY = dict(hidden_size=32, layer=1, multi_head=4, ff_size=128,
            img_feat_size=16, img_feat_pad_size=8, flat_mlp_size=16,
            flat_out_size=32, batch_size=4, max_epoch=1, eval_interval=2,
            verbose=False)


def _datasets(cfg):
    return (mimic.SyntheticMIMICDataset(cfg, size=16, answer_size=A,
                                        run_mode="train"),
            mimic.SyntheticMIMICDataset(cfg, size=12, answer_size=A,
                                        run_mode="val", seed=1))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A fused classifier Trainer after one epoch of 4 steps, the scales
    its end-of-train calibration computed, its log."""
    tmp = tmp_path_factory.mktemp("classify")
    cfg = Config(**TINY, train_engine="fused", eval_engine="fused",
                 reg_factor=1e-3, ckpts_dir=str(tmp / "ck"),
                 log_path=str(tmp / "log"))
    train_ds, val_ds = _datasets(cfg)
    seen = {}
    real = trainer_mod.calibrate_classifier_act_scales

    def spy(*a, **kw):
        seen["scales"] = real(*a, **kw)
        return seen["scales"]

    trainer_mod.calibrate_classifier_act_scales = spy
    try:
        tr = Trainer(cfg, train_ds, eval_datasets={"val": val_ds},
                     task="classify", device="cpu")
        tr.train()
    finally:
        trainer_mod.calibrate_classifier_act_scales = real
    log = (tmp / "log" / f"log_run_{cfg.run_version}.txt").read_text()
    return tr, val_ds, seen["scales"], log, tmp


def test_trainer_trains_and_logs_the_classifier_flow(trained):
    tr, _, _, log, _ = trained
    assert isinstance(tr.model, ClassifierNet) and tr.state.step == 4
    assert "train engine: fused SA blocks (classifier, " \
           "in_kernel_dropout=False)" in log
    assert "build_production_classifier_engine" in log
    steps = [ln for ln in log.splitlines() if ln.startswith("  [step ")]
    assert [ln.split("]")[0] for ln in steps] == ["  [step 2", "  [step 4"]
    assert all(" val: {'roc_micro': " in ln for ln in steps)


def test_trainer_evaluate_gives_jax_roc_auc(trained):
    tr, val_ds, _, _, _ = trained
    out = tr.predict(val_ds)
    res = tr.evaluate(val_ds)
    want = jroc(out["targets"] > 0.5, out["probs"])
    assert res["roc_micro"] == want["micro"]
    assert res["roc_macro"] == want["macro"]
    assert out["probs"].shape == (len(val_ds), A)


def test_fused_and_plain_predict_agree(trained):
    """The level-1 engine against the plain eval step: 5e-3 on the
    probabilities (JAX's own, tests/test_serving.py:181)."""
    tr, val_ds, _, _, _ = trained
    fused = tr.predict(val_ds)["probs"]
    tr.fused_eval = False
    try:
        plain = tr.predict(val_ds)["probs"]
    finally:
        tr.fused_eval = True
    assert np.abs(fused - plain).max() <= 5e-3


def test_calibration_side_file_round_trips(trained):
    """The end-of-train scales beside the last pickle load back equal and
    build the level-3 engine bit for bit with the engine given them."""
    tr, val_ds, scales, log, tmp = trained
    ckpt = tmp / "ck" / f"ckpt_{tr.cfg.run_version}" / "epoch1.pkl"
    stored = load_act_scales(str(ckpt))
    assert stored == scales and "serving calibration scales ->" in log
    raw = json.loads(ckpt.with_name("epoch1.act_scales.json").read_text())
    assert set(raw) == {"enc_0"}
    sd = tr.model.state_dict()
    img = torch.from_numpy(np.stack([val_ds.example(i)["img"]
                                     for i in range(4)]))
    outs = []
    for source in (stored, scales):
        fwd, prep = serving.build_production_classifier_engine(
            sd, 1, 4, act_scales=source, device="cpu")
        with torch.no_grad():
            outs.append(fwd(prep, img))
    assert torch.equal(*outs)


def test_plain_trainer_uses_smooth_l1(tmp_path, monkeypatch):
    """The classifier's step penalises with SmoothL1 (trainer.py:309) and
    reads no question."""
    seen = {}
    real = trainer_mod.make_train_step

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(trainer_mod, "make_train_step", spy)
    cfg = Config(**TINY, ckpts_dir=str(tmp_path), log_path=str(tmp_path))
    tr = Trainer(cfg, _datasets(cfg)[0], task="classify", device="cpu")
    assert not tr.fused and seen["reg_mode"] == "smooth_l1"
    assert seen["image_only"] is True


def test_run_classify_synthetic_trains_and_prints_val(tmp_path, capsys):
    rc = run_classify.main([
        "--run", "train", "--synthetic", "--device", "cpu",
        "--train_engine", "fused", "--hidden_size", "32", "--layer", "1",
        "--multi_head", "4", "--img_feat_size", "16",
        "--img_feat_pad_size", "8", "--flat_out_size", "32",
        "--flat_mlp_size", "16", "--batch_size", "4", "--synthetic_size",
        "16", "--max_epoch", "1", "--ckpts_dir", str(tmp_path / "ck"),
        "--log_path", str(tmp_path / "log"), "--verbose", "false"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "val: {'roc_micro': " in out


def test_run_classify_without_synthetic_names_item_7(tmp_path, capsys):
    """Without --synthetic the command reads the MIMIC-CXR files: with
    none there it lists the missing paths on stderr, as the JAX CLI does,
    and exits 1 (training on the files: tests/test_torch_mimic.py)."""
    prefix = str(tmp_path / "mimic_")
    rc = run_classify.main(["--run", "train", "--device", "cpu",
                            "--cxr_data_path", prefix])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("missing MIMIC paths:\n")
    listed = [ln.strip() for ln in err.splitlines()[1:]]
    assert listed == [Config().cxr_img_feat_path] + [
        f"{prefix}dataset_{s}_full.pkl" for s in ("train", "val", "test")]


def test_classify_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config(**TINY, ckpts_dir=str(tmp_path), log_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, _datasets(cfg)[0], task="classify")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_classify.main(["--run", "train", "--synthetic", "--layer", "1",
                           "--ckpts_dir", str(tmp_path)])
