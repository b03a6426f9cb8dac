"""Evaluation in the port against the JAX package, on the CPU at a tiny
width over a miniature dataset in VQA-v2's own file formats
(``data/vqa_files.write_vqa_files``): ``make_eval_step`` against JAX's on
the same weights (carried across by ``import_torch_state_dict``);
``Trainer.evaluate`` with the plain and the fused eval engine (the
kernels' plain versions here) against the JAX ``Trainer.evaluate`` with
``eval_engine="plain"``: equal accuracy, per-answer-type accuracy and
EvalAI dump, the fused probabilities within 1e-2; the per-epoch
evaluation and its cadence; ``run_vqa --run train|val|test|parity`` on the
files; the accuracy canary's scoring against the official evaluator, and
a CPU run of it."""

import json

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.data.vqa_dataset import VQADataset as JVQADataset
from mcan_vqa_tpu.evals import vqa_eval as jeval
from mcan_vqa_tpu.parallel import sharding as jshd
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu.train.step import make_eval_step as jmake_eval_step
from mcan_vqa_tpu.train.train_state import TrainState as JTrainState
from mcan_vqa_tpu.train.trainer import Trainer as JTrainer
from mcan_vqa_tpu_torch.cli import run_vqa
from mcan_vqa_tpu_torch.cli import validate_serving_accuracy as canary
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.answers import load_answer_dict
from mcan_vqa_tpu_torch.data.vqa_dataset import (SyntheticVQADataset,
                                                 VQADataset)
from mcan_vqa_tpu_torch.data.vqa_files import write_vqa_files
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.train.step import make_eval_step
from mcan_vqa_tpu_torch.train.trainer import (Trainer, eval_engine_line,
                                              use_fused_eval)

DIMS = dict(hidden_size=32, layer=1, multi_head=4, img_feat_size=16,
            img_feat_pad_size=10, max_token=8, flat_out_size=32,
            flat_mlp_size=16, use_glove=False,
            batch_size=8, train_split="train")
TINY = ["--hidden_size", "32", "--layer", "1", "--multi_head", "4",
        "--img_feat_size", "16", "--img_feat_pad_size", "10",
        "--max_token", "8", "--flat_out_size", "32", "--flat_mlp_size",
        "16", "--batch_size", "8", "--split", "train"]
# the fused engine's probabilities against the plain ones: int8 level 1
# (tests/test_torch_serving_int8.py holds the engine to 1e-2)
FUSED_TOL = 1e-2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The files, the port's Config over them, a port Trainer trained 6
    epochs (plain train engine) with the val split evaluated after each
    epoch, and the JAX Trainer on the same weights."""
    root = tmp_path_factory.mktemp("eval")
    paths = write_vqa_files(str(root), images={"train": 24, "val": 9,
                                               "test": 5},
                            feat_dim=16, regions=(3, 9))
    where = dict(paths, vocab_cache_path=str(root / "vocab.npz"),
                 feature_cache_path=str(root / "cache") + "/",
                 ckpts_dir=str(root / "ckpts"), log_path=str(root / "log"),
                 result_path=str(root / "results") + "/",
                 pred_path=str(root / "pred") + "/", version="tiny")
    cfg = Config(**DIMS, **where, ff_size=128, lr_base=5e-3, max_epoch=6,
                 lr_decay_list=(), train_engine="plain",
                 eval_engine="plain", verbose=False)
    train_ds, val_ds = VQADataset(cfg, "train"), VQADataset(cfg, "val")
    trainer = Trainer(cfg, train_ds, eval_datasets={"val": val_ds,
                                                    "train": train_ds},
                      eval_cadence={"train": 4}, device="cpu")
    trainer.train()
    sd = {k: v.detach().clone() for k, v in
          trainer.model.state_dict().items()}
    jcfg = JConfig(**DIMS, **where, eval_engine="plain",
                   verbose=False).finalize()
    jval = JVQADataset(jcfg, "val")
    jtrainer = JTrainer(jcfg, eval_datasets={"val": jval})
    jtrainer.state = jshd.shard_state(jtrainer.mesh, JTrainState.create(
        import_torch_state_dict(sd), jtrainer.tx, seed=jcfg.seed))
    return dict(root=root, cfg=cfg, jcfg=jcfg, trainer=trainer, sd=sd,
                val=val_ds, jval=jval, jtrainer=jtrainer)


@pytest.fixture(scope="module")
def jax_val(env):
    """The JAX Trainer's evaluation of val, with its EvalAI dump."""
    dump = str(env["root"] / "jax_val.json")
    return env["jtrainer"].evaluate(env["jval"], dump_path=dump), dump


def _evaluator(env, engine):
    cfg = env["cfg"].with_overrides(eval_engine=engine)
    t = Trainer(cfg, eval_datasets={"val": env["val"]}, device="cpu")
    t.model.load_state_dict(env["sd"])
    return t


def test_eval_step_matches_jax(env):
    """The plain model's sigmoid probabilities, dropout off."""
    batch = [env["val"].example(i) for i in range(len(env["val"]))]
    img = np.stack([e["img"] for e in batch])
    ques = np.stack([e["ques"] for e in batch])
    jstep = jmake_eval_step(env["jtrainer"].model)
    ref = np.asarray(jax.jit(jstep)(env["jtrainer"].state.params, img, ques))
    out = make_eval_step(env["trainer"].model)(torch.from_numpy(img),
                                               torch.from_numpy(ques))
    assert out.dtype == torch.float32 and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_evaluate_matches_jax(env, jax_val, engine):
    jres, jdump = jax_val
    t = _evaluator(env, engine)
    assert t.fused_eval == (engine == "fused")
    dump = str(env["root"] / f"port_{engine}.json")
    before = K.launch_counts()
    res = t.evaluate(env["val"], dump_path=dump)
    assert K.launch_counts() == before       # the CPU launches no kernel
    assert res["accuracy"] == jres["accuracy"]
    assert res["perAnswerType"] == jres["perAnswerType"]
    assert set(res) == set(jres)
    with open(dump) as f, open(jdump) as g:
        assert json.load(f) == json.load(g)
    probs = t.predict(env["val"])["probs"]
    ref = env["jtrainer"].predict(env["jval"])["probs"]
    np.testing.assert_allclose(probs, ref, rtol=0,
                               atol=FUSED_TOL if engine == "fused" else 1e-5)


def test_predict_covers_every_question_once(env):
    out = env["trainer"].predict(env["val"])
    n = len(env["val"])
    assert n % env["cfg"].eval_batch_size       # a padded last batch
    assert out["probs"].shape == (n, 3129) and out["probs"].dtype == \
        np.float32
    assert list(out["qids"]) == [q["question_id"]
                                 for q in env["val"].ques_list]
    assert "targets" not in out


def test_trainer_evaluated_each_epoch_on_its_cadence(env):
    log = (env["root"] / "log" / "log_run_tiny.txt").read_text()
    assert eval_engine_line(False) in log
    lines = [ln for ln in log.splitlines() if " eval " in ln]
    assert [ln.split(":")[0] for ln in lines] == \
        [f"epoch {e} eval {name}" for e in range(6)
         for name in (("val", "train") if e % 4 == 0 else ("val",))]
    records = [json.loads(ln) for ln in
               (env["root"] / "log" / "log_run_tiny.jsonl").read_text()
               .splitlines()]
    assert all("val/accuracy" in r for r in records)
    assert [("train/accuracy" in r) for r in records] == \
        [e % 4 == 0 for e in range(6)]
    last = env["trainer"].evaluate(env["val"])
    assert records[-1]["val/accuracy"] == last["accuracy"]


def test_roc_and_prediction_dump_on_targets(env, tmp_path, monkeypatch):
    """A dataset whose examples carry targets (the synthetic val set):
    ROC micro / macro as the JAX Trainer's ``evaluate`` computes them from
    the same predictions, and the prediction dump under test_save_pred."""
    dims = {k: DIMS[k] for k in ("img_feat_size", "img_feat_pad_size",
                                 "max_token")}
    ds = SyntheticVQADataset(Config(**dims), size=19, answer_size=3129,
                             seed=1)
    cfg = env["cfg"].with_overrides(test_save_pred=True,
                                    pred_path=str(tmp_path) + "/")
    t = Trainer(cfg, eval_datasets={"val": ds}, device="cpu")
    res = t.evaluate(ds)
    out = t.predict(ds)
    np.testing.assert_array_equal(out["targets"],
                                  [ds.example(i)["target"]
                                   for i in range(19)])
    monkeypatch.setattr(env["jtrainer"], "predict", lambda _: out)
    monkeypatch.setattr(env["jtrainer"], "ix_to_ans", ds.ix_to_ans)
    jres = env["jtrainer"].evaluate(ds)
    for k in ("roc_micro", "roc_macro"):
        assert abs(res[k] - jres[k]) <= 1e-12, k
    assert 0.0 < res["roc_micro"] < 1.0
    saved = np.load(res["pred_path"])
    np.testing.assert_array_equal(saved["qids"], np.arange(19))
    np.testing.assert_array_equal(saved["probs"], out["probs"])


def test_partial_coverage_warns_or_raises(env):
    ds = VQADataset(env["cfg"], "val")
    ds.ans_list = ds.ans_list + [dict(ds.ans_list[0], question_id=10 ** 6)]
    t = _evaluator(env, "plain")
    res = t.evaluate(ds)
    n = len(ds.ques_list)
    assert "accuracy" in res
    log = open(t.logger.path).read()
    assert f"WARNING: evaluate: predictions cover {n}/{n + 1}" in log
    t.cfg = t.cfg.with_overrides(eval_strict=True)
    with pytest.raises(ValueError, match="predictions cover"):
        t.evaluate(ds)


def test_use_fused_eval_rule():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for engine, want in (("plain", (False, False)), ("fused", (True, True)),
                         ("auto", (True, False))):
        cfg = Config(eval_engine=engine)
        assert (use_fused_eval(cfg, cuda), use_fused_eval(cfg, cpu)) == want
    with pytest.raises(ValueError, match="eval_engine"):
        Config(eval_engine="xla")
    assert "int8 level 1" in eval_engine_line(True)


def _cli(env, *argv):
    return ["--device", "cpu", *TINY,
            "--dataset_path", env["cfg"].dataset_path,
            "--feature_path", env["cfg"].feature_path,
            "--feature_cache_path", env["cfg"].feature_cache_path,
            "--vocab_cache_path", env["cfg"].vocab_cache_path,
            "--ckpts_dir", env["cfg"].ckpts_dir,
            "--log_path", env["cfg"].log_path, *argv]


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_run_vqa_val_test_parity(env, jax_val, tmp_path, engine, capsys):
    """--run val / test / parity from the epoch pickle: the val dump and
    accuracy equal the in-process evaluation; every test question once in
    the test dump."""
    ck = ["--version", "cli", "--ckpt_version", "tiny", "--ckpt_epoch", "6",
          "--eval_engine", engine, "--result_path", str(tmp_path) + "/"]
    for mode in ("val", "test", "parity"):
        assert run_vqa.main(_cli(env, "--run", mode, *ck)) == 0
    out = capsys.readouterr().out
    jres, jdump = jax_val
    with open(jdump) as f:
        want = json.load(f)
    assert json.loads((tmp_path / "result_run_cli_val.json").read_text()) \
        == want
    test = json.loads((tmp_path / "result_run_cli.json").read_text())
    test_qids = [q["question_id"] for q in VQADataset(env["cfg"], "test")
                 .ques_list]
    assert [r["question_id"] for r in test] == test_qids
    assert json.loads((tmp_path / "result_run_cli_testdev.json")
                      .read_text()) == test
    assert f"'accuracy': {jres['accuracy']}" in out
    assert "parity val accuracy (official evaluator)" in out


def test_run_vqa_by_path_and_missing_files(env, tmp_path, capsys):
    ckpt = str(env["root"] / "ckpts" / "ckpt_tiny" / "epoch6.pkl")
    assert run_vqa.main(_cli(env, "--run", "val", "--eval_engine", "plain",
                             "--ckpt_path", ckpt, "--version", "p",
                             "--result_path", str(tmp_path) + "/")) == 0
    assert f"'accuracy': {env['trainer'].evaluate(env['val'])['accuracy']}" \
        in capsys.readouterr().out
    with pytest.raises(ValueError, match="ckpt_epoch"):
        run_vqa.main(_cli(env, "--run", "val"))
    with pytest.raises(FileNotFoundError):
        run_vqa.main(_cli(env, "--run", "val", "--ckpt_epoch", "99"))
    assert run_vqa.main(["--run", "val", "--device", "cpu",
                         "--dataset_path", str(tmp_path / "none") + "/"]) \
        == 1
    assert "missing dataset paths" in capsys.readouterr().err


def test_run_vqa_trains_on_the_files(env, tmp_path, capsys):
    argv = _cli(env, "--run", "train", "--max_epoch", "1", "--eval_ee",
                "true", "--version", "files", "--train_engine", "fused",
                "--eval_engine", "fused", "--verbose", "false")
    argv[argv.index("--ckpts_dir") + 1] = str(tmp_path / "ckpts")
    argv[argv.index("--log_path") + 1] = str(tmp_path / "log")
    assert run_vqa.main(argv) == 0
    assert "final val: {'accuracy'" in capsys.readouterr().out
    log = (tmp_path / "log" / "log_run_files.txt").read_text()
    assert eval_engine_line(True) in log and "epoch 0 eval val" in log
    assert (tmp_path / "ckpts" / "ckpt_files" / "epoch1.pkl").exists()


def test_run_vqa_synthetic_val_set_prints_roc(tmp_path, capsys):
    argv = ["--run", "train", "--synthetic", "--device", "cpu", *TINY,
            "--synthetic_size", "16", "--max_epoch", "1", "--version", "s",
            "--ckpts_dir", str(tmp_path), "--log_path", str(tmp_path)]
    assert run_vqa.main(argv) == 0
    out = capsys.readouterr().out
    assert "final val: {'roc_micro'" in out and "roc_macro" in out


def test_canary_scoring_matches_the_official_evaluator():
    """The canary's accuracy of fixed top-1 vectors equals the JAX tool's
    scoring (validate_serving_accuracy.py:210-215) through the JAX
    evaluator."""
    _, ix_to_ans = load_answer_dict()
    classes = 16
    class_ix = np.array([7 + 181 * c for c in range(classes)], np.int64)
    np.testing.assert_array_equal(canary.class_answers(classes), class_ix)
    rng = np.random.default_rng(0)
    cls = rng.integers(0, classes, 64)
    gts = {i: {"answers": [ix_to_ans[str(class_ix[c])]] * 10}
           for i, c in enumerate(cls)}
    for top in (class_ix[cls], rng.integers(0, 3129, 64),
                np.where(rng.random(64) < 0.3, 5, class_ix[cls])):
        res = {i: ix_to_ans[str(int(t))] for i, t in enumerate(top)}
        assert canary.official_accuracy(top, cls, ix_to_ans, classes) == \
            jeval.evaluate(gts, res)["overall"]
    assert canary.official_accuracy(class_ix[cls], cls, ix_to_ans,
                                    classes) == 100.0


def test_canary_runs_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--hidden", "32", "--layers", "1",
            "--steps", "3", "--batch", "4", "--eval_batch", "8"]
    rc = canary.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert set(canary.ENGINES) <= set(report)
    assert report["train_engine"] == "plain" and report["steps"] == 3
    assert rc == (0 if report["ok"] else 1)
    assert report["ok"] == all(report[e]["gate"] == "PASS"
                               for e in canary.ENGINES)
    assert "max_softmax_delta" in report["int4"]
    for e in canary.ENGINES:
        assert 0.0 <= report[e]["agreement"] <= 1.0
        assert any(ln.startswith(f"{e}: agreement=") for ln in lines)
    with pytest.raises(SystemExit):
        canary.main(argv + ["--engines", "fused,xla"])
