"""The training run's checkpoint lifecycle in the port
(mcan_vqa_tpu_torch/train/{checkpoint,trainer}.py, api.py) on the CPU at
a tiny width (hidden 32, 2 layers), against the JAX package where it has
the same function (mcan_vqa_tpu/train/checkpoint.py, trainer.py):

  * the AdamW moments cross exactly both ways: the port's pickle through
    JAX's ``import_torch_opt_state`` and JAX's ``export_torch_opt_state``
    through the port's ``resume_state``;
  * a run resumed after epoch 1 equals the unbroken 2-epoch run bit for
    bit (weights, moments, step, lr), on the plain engine and on the fused
    one (the kernels' plain versions), at dropout 0.1;
  * pickles without moments, moments with no home, ``merge_compatible``;
  * preemption by SIGTERM; the async saver; pruning;
  * the end-of-train calibration side file and ``Predictor.
    from_checkpoint`` serving it;
  * the log header a fresh run writes.

Every comparison here is exact: the same arithmetic runs on both sides.
"""

import json
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.train import checkpoint as jckpt
from mcan_vqa_tpu.train import optim as joptim
from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
from mcan_vqa_tpu_torch.ops import serving
from mcan_vqa_tpu_torch.ops.quant import (calibrate_qffn_act_scales,
                                          prepare_q8aux_params)
from mcan_vqa_tpu_torch.train import checkpoint as ckpt
from mcan_vqa_tpu_torch.train.trainer import Trainer

ARCH = dict(hidden_size=32, ff_size=128, layer=2, multi_head=4,
            img_feat_size=16, img_feat_pad_size=8, max_token=6,
            flat_out_size=32, flat_mlp_size=16, batch_size=4)
N, ANSWERS, TOKENS = 16, 40, 50           # 4 steps an epoch


def _cfg(tmp_path, **kw):
    base = dict(ARCH, train_engine="fused", ckpts_dir=str(tmp_path / "ck"),
                log_path=str(tmp_path / "log"), verbose=False,
                eval_every_epoch=False, version="v")
    base.update(kw)
    return Config(**base)


def _dataset(cfg):
    return SyntheticVQADataset(cfg, size=N, token_size=TOKENS,
                               answer_size=ANSWERS, seed=3)


def _train(cfg, wrap=None):
    trainer = Trainer(cfg, _dataset(cfg), device="cpu")
    if wrap is not None:
        trainer.step_fn = wrap(trainer.step_fn)
    trainer.train()
    return trainer


def _pkl(cfg, epoch, version="v"):
    return ckpt.checkpoint_path(cfg.ckpts_dir, version, epoch)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same_pickles(a, b):
    a, b = _load(a), _load(b)
    assert list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb) and sa
    for i in sa:
        for m in ("step", "exp_avg", "exp_avg_sq"):
            assert sa[i][m].dtype == sb[i][m].dtype
            assert torch.equal(sa[i][m], sb[i][m]), (i, m)


class Lines:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines = []

    def write(self, line):
        self.lines.append(line)


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """Unbroken 2-epoch runs of each engine (and the bf16 first moment)."""
    out = {}
    for key in (("fused", ""), ("plain", ""), ("fused", "bfloat16")):
        root = tmp_path_factory.mktemp(f"u_{key[0]}{key[1]}")
        cfg = _cfg(root, train_engine=key[0], opt_mu_dtype=key[1],
                   max_epoch=2)
        out[key] = (cfg, _train(cfg))
    return out


# ---------------------------------------------------------------------------
# moments across the packages
# ---------------------------------------------------------------------------

def _jax_adam(opt_state):
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for x in opt_state:
            found = _jax_adam(x)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("mu_dtype", ["", "bfloat16"])
def test_port_moments_cross_into_jax(unbroken, mu_dtype):
    """The port's epoch pickle through JAX's ``import_torch_checkpoint`` +
    ``import_torch_opt_state`` into a template ``make_optimizer(...)
    .init(params)``: mu / nu equal the port's exp_avg / exp_avg_sq
    (transposed where the weight is), the count equals the port's step.
    The JAX weights come from the port's own MCANet."""
    cfg, trainer = unbroken[("fused", mu_dtype)]
    path = _pkl(cfg, 2)
    blob = _load(path)
    assert all(s["exp_avg"].dtype == torch.float32
               for s in blob["optimizer"]["state"].values())
    jparams = jckpt.import_torch_state_dict(trainer.model.state_dict())
    jcfg = JConfig(lr_base=cfg.lr_base, batch_size=cfg.batch_size,
                   opt_mu_dtype=mu_dtype)
    template = joptim.make_optimizer(jcfg, N).init(jparams)
    _, meta = jckpt.import_torch_checkpoint(path)
    opt_state, step = jckpt.import_torch_opt_state(
        meta["optimizer"], meta["param_keys"], template)
    assert step == trainer.state.step == 2 * N // cfg.batch_size
    adam = _jax_adam(opt_state)
    assert int(adam.count) == step
    mu, nu = jckpt.flatten_params(adam.mu), jckpt.flatten_params(adam.nu)
    names = list(trainer.model.state_dict())
    live = trainer.state.optimizer.state
    for p, key in zip(trainer.model.parameters(), names):
        path_, transpose = jckpt.torch_key_to_flax(key)
        m = np.asarray(mu[path_], np.float32)
        v = np.asarray(nu[path_], np.float32)
        if transpose:
            m, v = m.T, v.T
        np.testing.assert_array_equal(m, live[p]["exp_avg"].float().numpy(),
                                      err_msg=key)
        np.testing.assert_array_equal(v, live[p]["exp_avg_sq"].numpy(),
                                      err_msg=key)


def test_jax_moments_cross_into_the_port(tmp_path):
    """``export_torch_opt_state`` of a JAX AdamW state with non-zero
    moments, in a pickle beside the matching weights, through the port's
    ``resume_state``: the port's optimizer holds the same moments and
    step."""
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, _dataset(cfg), device="cpu")
    sd = trainer.model.state_dict()
    jparams = jckpt.import_torch_state_dict(sd)
    tx = joptim.make_optimizer(JConfig(lr_base=cfg.lr_base,
                                       batch_size=cfg.batch_size), N)
    rng = np.random.default_rng(0)

    def moment(x):
        return np.abs(rng.normal(size=np.shape(x))).astype(np.float32)

    opt_state = jckpt._map_opt_state(
        tx.init(jparams),
        lambda n: n._replace(count=np.int32(3), mu=jax.tree.map(moment, n.mu),
                             nu=jax.tree.map(moment, n.nu)),
        lambda n: n._replace(count=np.int32(3)))
    exported = jckpt.export_torch_opt_state(opt_state, cfg.layer)
    path = tmp_path / "jax.pkl"
    torch.save({"state_dict": {k: v.clone() for k, v in sd.items()},
                "optimizer": exported, "lr_base": cfg.lr_base}, path)
    ckpt.resume_state(trainer.state, cfg.with_overrides(ckpt_path=str(path)),
                      N)
    assert trainer.state.step == 3
    live = trainer.state.optimizer.state
    for i, p in enumerate(trainer.model.parameters()):
        for m in ("exp_avg", "exp_avg_sq"):
            want = exported["state"][i][m]
            assert float(want.abs().max()) > 0
            assert torch.equal(live[p][m], want), (i, m)
        assert float(live[p]["step"]) == 3.0


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,mu_dtype", [("plain", ""), ("fused", ""),
                                             ("fused", "bfloat16")])
def test_resume_after_epoch_one_equals_the_unbroken_run(
        unbroken, tmp_path, engine, mu_dtype):
    """Epoch 1, then a new Trainer resumed from its pickle trains epoch 2:
    the weights, moments, step and lr equal the unbroken run's bit for bit
    (dropout 0.1; each step's masks follow from the seed and the step)."""
    ucfg, utrainer = unbroken[(engine, mu_dtype)]
    cfg = _cfg(tmp_path, train_engine=engine, opt_mu_dtype=mu_dtype,
               max_epoch=1)
    assert cfg.dropout_rate == 0.1
    _train(cfg)
    resumed = _train(cfg.with_overrides(max_epoch=2, resume=True,
                                        ckpt_epoch=1))
    _assert_same_pickles(_pkl(cfg, 2), _pkl(ucfg, 2))
    assert resumed.state.step == utrainer.state.step
    assert resumed.state.optimizer.param_groups[0]["lr"] == \
        utrainer.state.optimizer.param_groups[0]["lr"]
    for p, q in zip(resumed.model.parameters(), utrainer.model.parameters()):
        assert torch.equal(p, q)
    records = [json.loads(x) for x in
               open(resumed.logger.jsonl_path).read().splitlines()]
    theirs = [json.loads(x) for x in
              open(utrainer.logger.jsonl_path).read().splitlines()]
    assert records[-1]["epoch"] == 1
    assert records[-1]["lr"] == theirs[-1]["lr"]
    assert records[-1]["loss"] == theirs[-1]["loss"]


def test_a_pickle_without_moments_takes_the_epoch_step(tmp_path):
    """No "optimizer" entry: the weights load, the moments stay fresh and
    the step is int(len(train) / batch_size x ckpt_epoch)."""
    cfg = _cfg(tmp_path)
    trainer = Trainer(cfg, _dataset(cfg), device="cpu")
    sd = {k: v + 1.0 for k, v in trainer.model.state_dict().items()}
    path = tmp_path / "weights.pkl"
    torch.save({"state_dict": sd, "lr_base": 1e-4}, path)
    fresh = Trainer(cfg, _dataset(cfg), device="cpu")
    lines = Lines()
    ckpt.resume_state(fresh.state, cfg.with_overrides(
        ckpt_path=str(path), ckpt_epoch=3), 18, lines)
    assert fresh.state.step == int(18 / cfg.batch_size * 3) == 13
    assert not fresh.state.optimizer.state
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert "weights only, step 13" in lines.lines[0]


@pytest.mark.parametrize("change", ["renamed", "reshaped"])
def test_a_moment_with_no_home_raises(unbroken, tmp_path, change):
    cfg, _ = unbroken[("fused", "")]
    blob = _load(_pkl(cfg, 2))
    sd = blob["state_dict"]
    key = "backbone.dec_list.1.ffn.mlp.linear.bias"
    if change == "renamed":
        blob["state_dict"] = {(k + "_gone" if k == key else k): v
                              for k, v in sd.items()}
    else:
        i = list(sd).index(key)
        moment = blob["optimizer"]["state"][i]
        moment["exp_avg"] = torch.zeros(7)
        moment["exp_avg_sq"] = torch.zeros(7)
    path = tmp_path / "bad.pkl"
    torch.save(blob, path)
    trainer = Trainer(cfg, _dataset(cfg), device="cpu")
    with pytest.raises(ValueError, match="no home"):
        ckpt.resume_state(trainer.state,
                          cfg.with_overrides(ckpt_path=str(path)), N)


def test_merge_compatible_keeps_the_template_for_a_new_vocabulary(
        unbroken, tmp_path):
    """A checkpoint of another vocabulary size: every weight but the
    embedding is taken, the embedding keeps the template, one log line
    says so; ``Trainer.warm_start`` does the same with a fresh optimizer
    at step 0."""
    cfg, old = unbroken[("fused", "")]
    other = SyntheticVQADataset(cfg, size=N, token_size=TOKENS + 7,
                                answer_size=ANSWERS, seed=3)
    trainer = Trainer(cfg, other, device="cpu")
    template = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    incoming = old.model.state_dict()
    lines = Lines()
    merged = ckpt.merge_compatible(template, incoming, lines)
    assert lines.lines == [f"warm-start skip embedding.weight: "
                           f"{(TOKENS, 300)} vs {(TOKENS + 7, 300)}"]
    for k, v in merged.items():
        assert torch.equal(v, template[k] if k == "embedding.weight"
                           else incoming[k]), k
    trainer.warm_start(_pkl(cfg, 2))
    assert trainer.state.step == 0 and not trainer.state.optimizer.state
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, merged[k]), k
    assert trainer.ensure_state() is trainer.state


# ---------------------------------------------------------------------------
# preemption, the async saver, pruning
# ---------------------------------------------------------------------------

def test_sigterm_saves_the_epoch_and_the_run_resumes(tmp_path):
    """SIGTERM raised inside step 2 of epoch 0: train() returns after that
    step with epoch1.pkl written, the log shows preempted_at_step=2, the
    old handlers are back; a run resumed from the pickle trains on."""
    def marker(signum, frame):
        raise AssertionError("the Trainer's handler was not installed")

    old_term = signal.signal(signal.SIGTERM, marker)
    old_int = signal.getsignal(signal.SIGINT)
    try:
        cfg = _cfg(tmp_path, max_epoch=2)
        seen = []

        def wrap(step_fn):
            def step(state, batch):
                out = step_fn(state, batch)
                seen.append(state.step)
                if len(seen) == 2:
                    signal.raise_signal(signal.SIGTERM)
                return out
            return step

        trainer = _train(cfg, wrap)
        assert seen == [1, 2] and trainer.state.step == 2
        assert signal.getsignal(signal.SIGTERM) is marker
        assert signal.getsignal(signal.SIGINT) is old_int
    finally:
        signal.signal(signal.SIGTERM, old_term)
    saved = _load(_pkl(cfg, 1))
    assert all(float(s["step"]) == 2.0
               for s in saved["optimizer"]["state"].values())
    assert not (tmp_path / "ck" / "ckpt_v" / "epoch2.pkl").exists()
    log = open(trainer.logger.path).read()
    assert f"signal {int(signal.SIGTERM)}: checkpoint-and-exit" in log
    records = [json.loads(x) for x in
               open(trainer.logger.jsonl_path).read().splitlines()]
    assert records == [records[0]] and records[0]["preempted_at_step"] == 2
    resumed = _train(cfg.with_overrides(resume=True, ckpt_epoch=1))
    assert resumed.state.step == 2 + N // cfg.batch_size
    assert ckpt.latest_epoch(cfg.ckpts_dir, "v") == 2


@pytest.fixture
def held_blob(monkeypatch):
    """``checkpoint._blob`` held on the saver's worker until released."""
    release = threading.Event()
    entered = threading.Event()
    real = ckpt._blob

    def blob(*args):
        if threading.current_thread() is not threading.main_thread():
            entered.set()
            release.wait(10)
        return real(*args)

    monkeypatch.setattr(ckpt, "_blob", blob)
    return entered, release


def test_async_pickle_equals_the_sync_one_and_is_a_snapshot(
        unbroken, tmp_path, held_blob):
    """The saver's pickle equals ``save_checkpoint``'s byte for byte, and a
    tensor changed after ``save()`` returns does not reach the file."""
    entered, release = held_blob
    _, trainer = unbroken[("fused", "bfloat16")]
    state = trainer.state
    sync = ckpt.save_checkpoint(state, str(tmp_path / "a"), "v", 7, 1e-4)
    saver = ckpt.AsyncCheckpointSaver()
    path = saver.save(state, str(tmp_path / "b"), "v", 7, 1e-4)
    assert entered.wait(10)
    p = next(state.model.parameters())
    moment = state.optimizer.state[p]["exp_avg"]
    with torch.no_grad():
        p.add_(1.0)
        moment.add_(1.0)
    release.set()
    saver.close()
    with torch.no_grad():
        p.sub_(1.0)
        moment.sub_(1.0)
    with open(sync, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()


def test_async_saver_raises_a_failed_write_on_the_next_call(
        unbroken, tmp_path, monkeypatch):
    _, trainer = unbroken[("fused", "")]

    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_blob", broken)
    saver = ckpt.AsyncCheckpointSaver()
    saver.save(trainer.state, str(tmp_path), "v", 1, 1e-4)
    saver._q.join()
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.save(trainer.state, str(tmp_path), "v", 2, 1e-4)
    saver.save(trainer.state, str(tmp_path), "v", 3, 1e-4)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.close()
    assert not saver._worker.is_alive()


def test_train_raises_the_saver_error_on_a_clean_exit(tmp_path,
                                                      monkeypatch):
    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_blob", broken)
    before = signal.getsignal(signal.SIGTERM)
    cfg = _cfg(tmp_path, max_epoch=1, ckpt_async=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        _train(cfg)
    assert signal.getsignal(signal.SIGTERM) is before


def test_async_saver_holds_one_pending_snapshot(unbroken, tmp_path,
                                                held_blob):
    """With the worker busy on the first snapshot and the second queued, a
    third ``save`` waits until the worker takes the second."""
    entered, release = held_blob
    _, trainer = unbroken[("fused", "")]
    saver = ckpt.AsyncCheckpointSaver()
    saver.save(trainer.state, str(tmp_path), "v", 1, 1e-4)
    assert entered.wait(10)
    saver.save(trainer.state, str(tmp_path), "v", 2, 1e-4)
    third = threading.Thread(target=saver.save, args=(
        trainer.state, str(tmp_path), "v", 3, 1e-4))
    third.start()
    time.sleep(0.2)
    assert third.is_alive()
    release.set()
    third.join(10)
    assert not third.is_alive()
    saver.close()
    assert ckpt.latest_epoch(str(tmp_path), "v") == 3


def test_prune_keeps_the_newest_epochs_and_their_side_files(tmp_path):
    for e in range(1, 5):
        path = ckpt.checkpoint_path(str(tmp_path), "v", e)
        tmp_path.joinpath("ckpt_v").mkdir(exist_ok=True)
        open(path, "wb").close()
        ckpt.save_act_scales(path, {"enc_0": (1.0, 2.0, 3.0)})
    assert ckpt.prune_checkpoints(str(tmp_path), "v", 2) == 2
    assert sorted(p.name for p in (tmp_path / "ckpt_v").iterdir()) == [
        "epoch3.act_scales.json", "epoch3.pkl", "epoch4.act_scales.json",
        "epoch4.pkl"]
    assert ckpt.prune_checkpoints(str(tmp_path), "v", 0) == 0
    assert ckpt.latest_epoch(str(tmp_path), "v") == 4
    assert ckpt.latest_epoch(str(tmp_path), "none") is None


def test_async_trainer_with_pruning_keeps_the_sync_run_last_pickle(
        tmp_path):
    """``ckpt_async=True, keep_last_ckpts=2`` over 4 epochs: epochs 3-4
    remain with the last one's side file, and the last pickle equals a
    sync run's byte for byte."""
    cfg = _cfg(tmp_path, max_epoch=4, ckpt_async=True, keep_last_ckpts=2)
    _train(cfg)
    sync = _cfg(tmp_path, max_epoch=4, version="s")
    _train(sync)
    names = sorted(p.name for p in (tmp_path / "ck" / "ckpt_v").iterdir())
    assert names == ["epoch3.pkl", "epoch4.act_scales.json", "epoch4.pkl"]
    with open(_pkl(cfg, 4), "rb") as f, open(_pkl(sync, 4, "s"), "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# the end-of-train calibration and the served checkpoint
# ---------------------------------------------------------------------------

def _last_batch(trainer):
    loader = trainer.loader()
    loader.set_epoch(trainer.cfg.max_epoch - 1)
    return list(loader)[-1]


def test_calibration_side_file_is_served_by_from_checkpoint(unbroken):
    """The side file holds ``calibrate_qffn_act_scales`` of a level-3 tree
    on the last train batch, and "aux" from the replay with the aux sites
    attached; ``from_checkpoint`` serves those scales at once, and
    ``act_scales=False`` declines them."""
    cfg, trainer = unbroken[("fused", "")]
    path = _pkl(cfg, 2)
    stored = ckpt.load_act_scales(path)
    batch = _last_batch(trainer)
    prepared = serving.prepare_production_params(
        trainer.model.state_dict(), cfg.layer, qffn=3, device="cpu",
        num_heads=cfg.multi_head)
    want = calibrate_qffn_act_scales(prepared, batch["img"], batch["ques"],
                                     cfg.layer, cfg.multi_head)
    prepared["_q8aux"] = prepare_q8aux_params(prepared, cfg.layer)
    want["aux"] = calibrate_qffn_act_scales(
        prepared, batch["img"], batch["ques"], cfg.layer,
        cfg.multi_head)["aux"]
    assert stored == want and len(stored["aux"]) == 4
    assert f"serving calibration scales -> {ckpt.act_scales_path(path)}" in \
        open(trainer.logger.path).read()
    vocab = {"PAD": 0, "UNK": 1, **{f"t{i}": i for i in range(2, TOKENS)}}
    ix_to_ans = {str(i): str(i) for i in range(ANSWERS)}
    kw = dict(max_batch=4, device="cpu")
    served = Predictor.from_checkpoint(path, cfg, vocab, ix_to_ans, **kw)
    assert served.act_scales == stored
    assert served.calibration["state"] == "calibrated"
    aux = Predictor.from_checkpoint(path, cfg, vocab, ix_to_ans, q8aux=True,
                                    **kw)
    assert aux.act_scales == stored
    declined = Predictor.from_checkpoint(path, cfg, vocab, ix_to_ans,
                                         act_scales=False, **kw)
    assert declined.act_scales is None
    assert declined.calibration["state"] == "collecting"
    feats = [np.ones((5, cfg.img_feat_size), np.float32)]
    assert np.isfinite(served.predict_probs(["t3 t4"], feats)).all()


def test_calibration_is_skipped_where_the_width_has_no_int8_site(
        tmp_path, monkeypatch):
    monkeypatch.setattr(serving, "megakernel_vmem_ok", lambda D, F: False)
    cfg = _cfg(tmp_path, max_epoch=1)
    trainer = _train(cfg)
    assert not (tmp_path / "ck" / "ckpt_v" / "epoch1.act_scales.json")\
        .exists()
    assert "serving calibration skipped: model dims are outside the " \
        "megakernel VMEM envelope" in open(trainer.logger.path).read()


def test_fresh_run_log_keeps_its_header_and_grad_norm_sums(tmp_path):
    """After a fresh train() the log's first lines are the time and the
    config JSON (the constructor's header written again after the clear);
    ``grad_norm_log_every`` writes per-parameter sums every K steps and at
    the epoch's end; the epoch record carries step_ema_s."""
    cfg = _cfg(tmp_path, max_epoch=1, grad_norm_log_every=2,
               ckpt_calibrate=False)
    trainer = _train(cfg)
    lines = open(trainer.logger.path).read().splitlines()
    assert lines[0].startswith("NOW TIME: ")
    assert json.loads(lines[1]) == json.loads(json.dumps(cfg.to_dict(),
                                                         default=str))
    records = [json.loads(x) for x in
               open(trainer.logger.jsonl_path).read().splitlines()]
    sums = [r for r in records if "grad_norm_sums" in r]
    assert [(r["step"], r.get("final", False)) for r in sums] == \
        [(2, False), (4, False), (4, True)]
    names = [n for n, _ in trainer.model.named_parameters()]
    assert list(sums[-1]["grad_norm_sums"]) == names
    assert all(v > 0 for v in sums[-1]["grad_norm_sums"].values())
    assert records[-1]["epoch"] == 0 and records[-1]["step_ema_s"] > 0
