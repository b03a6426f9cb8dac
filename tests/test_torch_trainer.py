"""The port's training entry points on the CPU at a tiny size: the CLI
train mode (``python -m mcan_vqa_tpu_torch.cli.run_vqa --run train
--synthetic --device cpu [--model large]``), the Trainer's loss on a
repeated batch, its choice of train engine by width, and the per-epoch
reference pickle, read back by the JAX package's ``import_torch_checkpoint``
and by the port's ``Predictor``."""

import json

import numpy as np
import pytest
import torch

from mcan_vqa_tpu.train.checkpoint import import_torch_checkpoint
from mcan_vqa_tpu_torch.api import Predictor
from mcan_vqa_tpu_torch.cli import run_vqa
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.train.checkpoint import (load_reference_checkpoint,
                                                 state_dict_from_params)
from mcan_vqa_tpu_torch.train import trainer as trainer_mod
from mcan_vqa_tpu_torch.train.trainer import Trainer, engine_line

# train_engine "fused": the fused engine on the CPU (its kernels' plain
# versions), which "auto" takes only on a CUDA device
TINY = ["--hidden_size", "32", "--layer", "1", "--multi_head", "4",
        "--img_feat_size", "16", "--img_feat_pad_size", "8",
        "--max_token", "6", "--flat_out_size", "32", "--flat_mlp_size", "16",
        "--batch_size", "4", "--synthetic_size", "16",
        "--train_engine", "fused"]
TINY_CFG = dict(hidden_size=32, ff_size=128, layer=1, multi_head=4,
                img_feat_size=16, img_feat_pad_size=8, max_token=6,
                flat_out_size=32, flat_mlp_size=16, batch_size=4,
                train_engine="fused")


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


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    argv = ["--run", "train", "--synthetic", "--device", "cpu",
            "--max_epoch", "2", "--version", "tiny",
            "--ckpts_dir", str(out / "ckpts"), "--log_path", str(out / "log"),
            *TINY]
    before = K.launch_counts()
    assert run_vqa.main(argv) == 0
    assert K.launch_counts() == before          # the CPU runs no kernel
    return out, run_vqa.build_config(run_vqa.parse_args(argv))


def test_cli_trains_and_logs_every_epoch(cli_run):
    out, cfg = cli_run
    log = (out / "log" / "log_run_tiny.txt").read_text()
    assert engine_line(cfg.hidden_size) in log
    assert "fused SA encoder" in log
    records = [json.loads(line) for line in
               (out / "log" / "log_run_tiny.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["steps"] == 4 for r in records)
    assert records[1]["loss"] < records[0]["loss"]
    for epoch in (1, 2):
        assert (out / "ckpts" / "ckpt_tiny" / f"epoch{epoch}.pkl").exists()


def test_epoch_pickle_loads_into_jax_and_the_port(cli_run):
    out, cfg = cli_run
    path = str(out / "ckpts" / "ckpt_tiny" / "epoch2.pkl")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert set(blob) == {"state_dict", "optimizer", "lr_base"}
    saved = blob["state_dict"]
    params, meta = import_torch_checkpoint(path)
    assert meta["lr_base"] == cfg.lr_base
    assert meta["param_keys"] == list(saved)
    assert len(meta["optimizer"]["state"]) == len(saved)
    back = state_dict_from_params(params)
    assert list(back) == list(saved)
    for k, v in saved.items():
        assert torch.equal(back[k], v), k
    assert set(load_reference_checkpoint(path)) == set(saved)
    # the synthetic set's 200 token ids and 3129 answer names
    vocab = {"PAD": 0, "UNK": 1, **{f"t{i}": i for i in range(2, 200)}}
    ix_to_ans = {str(i): str(i) for i in range(3129)}
    pred = Predictor.from_checkpoint(path, cfg, vocab, ix_to_ans,
                                     max_batch=4, device="cpu")
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(r, 16)).astype(np.float32) for r in (8, 3)]
    answers = pred.answer(["t3 t4", ""], feats)
    assert [a in ix_to_ans.values() for a, _ in answers] == [True, True]
    assert all(0.0 <= p <= 1.0 for _, p in answers)


def test_loss_falls_on_a_fixed_batch(tmp_path):
    cfg = Config(**TINY_CFG, lr_base=1e-3, ckpts_dir=str(tmp_path),
                 log_path=str(tmp_path), verbose=False)
    ds = SyntheticVQADataset(cfg, size=8, answer_size=3129)
    trainer = Trainer(cfg, ds, device="cpu")
    batch = next(iter(trainer.loader()))
    losses = [float(trainer.step_fn(trainer.state, batch)["loss"])
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < 0.95 * losses[0]
    assert all(b < a for a, b in zip(losses, losses[1:]))


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**TINY_CFG, ckpts_dir=str(tmp_path), log_path=str(tmp_path))
    ds = SyntheticVQADataset(cfg, size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, ds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_vqa.main(["--run", "train", "--synthetic", *TINY])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, {}, {"PAD": 0})


@pytest.mark.parametrize("argv", [["--run", "visualize", "--synthetic"]])
def test_unported_cli_modes_raise(argv, tmp_path):
    """--run visualize runs (tests/test_torch_visualize.py), and without a
    checkpoint named it raises before it renders anything."""
    with pytest.raises(ValueError, match="name the checkpoint to load"):
        run_vqa.main(argv + ["--device", "cpu", *TINY,
                             "--log_path", str(tmp_path / "log"),
                             "--ckpts_dir", str(tmp_path / "ck"),
                             "--result_path", str(tmp_path / "res") + "/"])
    assert not (tmp_path / "res").exists()


def _pickle(path):
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _same_pickles(a, b):
    """Weights, AdamW moments and step counts equal bit for bit."""
    a, b = _pickle(a), _pickle(b)
    assert list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb) and sa
    for i in sa:
        for m in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][m], sb[i][m]), (i, m)


@pytest.mark.parametrize("by", ["ckpt_epoch", "ckpt_path"])
def test_cli_resume_trains_on_as_the_unbroken_run(cli_run, tmp_path, by):
    """``run_vqa --run train --resume true``: one epoch, then a second run
    that resumes from its pickle (named by ``--ckpt_epoch`` in the same
    version, or by ``--ckpt_path`` into another) writes the unbroken
    2-epoch run's epoch-2 pickle bit for bit."""
    out, _ = cli_run
    common = ["--run", "train", "--synthetic", "--device", "cpu",
              "--ckpts_dir", str(tmp_path / "ckpts"),
              "--log_path", str(tmp_path / "log"), *TINY]
    assert run_vqa.main(common + ["--max_epoch", "1",
                                  "--version", "tiny"]) == 0
    first = tmp_path / "ckpts" / "ckpt_tiny" / "epoch1.pkl"
    version = "tiny" if by == "ckpt_epoch" else "again"
    source = ["--ckpt_epoch", "1"] if by == "ckpt_epoch" else \
        ["--ckpt_path", str(first), "--ckpt_epoch", "1"]
    assert run_vqa.main(common + ["--max_epoch", "2", "--version", version,
                                  "--resume", "true", *source]) == 0
    _same_pickles(tmp_path / "ckpts" / f"ckpt_{version}" / "epoch2.pkl",
                  out / "ckpts" / "ckpt_tiny" / "epoch2.pkl")
    log = (tmp_path / "log" / f"log_run_{version}.txt").read_text()
    assert "resume: restored AdamW moments @ step 4" in log
    records = [json.loads(line) for line in
               (tmp_path / "log" / f"log_run_{version}.jsonl").read_text()
               .splitlines()]
    assert [r["epoch"] for r in records][-1] == 1


def test_unported_trainer_options_raise(tmp_path):
    """Only "vqa" and "classify" are tasks: MIMIC trains as task "vqa" on
    a MIMICDataset (tests/test_torch_mimic.py), as in the JAX package, so
    "mimic" is refused as any unknown task is (task "classify":
    tests/test_torch_classifier.py)."""
    cfg = Config(**TINY_CFG, ckpts_dir=str(tmp_path), log_path=str(tmp_path))
    ds = SyntheticVQADataset(cfg, size=8)
    for task in ("mimic", "other"):
        with pytest.raises(ValueError, match="task must be 'vqa' or "
                                             "'classify'"):
            Trainer(cfg, ds, task=task, device="cpu")


@pytest.mark.parametrize("hidden,heads,route", [
    (512, 8, dict(fused_encoder=True, att_saves=False, bf16_saves=False)),
    (640, 5, dict(fused_encoder=False, att_saves=True, bf16_saves=True))])
def test_trainer_routes_by_width(tmp_path, monkeypatch, hidden, heads,
                                 route):
    """As the JAX Trainer (trainer.py:264-281): the fused SA encoder at
    hidden <= 512, att_saves and bf16_saves above."""
    seen = {}
    real = trainer_mod.make_fused_train_forward

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    monkeypatch.setattr(trainer_mod, "make_fused_train_forward", spy)
    cfg = Config(**{**TINY_CFG, "hidden_size": hidden, "ff_size": 64,
                    "multi_head": heads}, ckpts_dir=str(tmp_path),
                 log_path=str(tmp_path), verbose=False)
    Trainer(cfg, SyntheticVQADataset(cfg, size=8), device="cpu")
    assert {k: seen[k] for k in route} == route
    assert ("fused SA encoder" in engine_line(hidden)) == \
        route["fused_encoder"]


def test_model_large_parses_to_the_large_preset():
    args = run_vqa.parse_args(["--run", "train", "--synthetic", "--model",
                               "large"])
    cfg = run_vqa.build_config(args)
    assert cfg == Config.for_model("large")
    assert (cfg.hidden_size, cfg.ff_size, cfg.flat_out_size, cfg.lr_base,
            cfg.grad_accu_steps) == (1024, 4096, 2048, 5e-5, 2)
    small = run_vqa.build_config(run_vqa.parse_args(
        ["--run", "train", "--synthetic"]))
    assert small == Config()
    narrow = run_vqa.build_config(run_vqa.parse_args(
        ["--run", "train", "--synthetic", "--model", "large",
         "--hidden_size", "640"]))
    assert (narrow.hidden_size, narrow.ff_size, narrow.flat_out_size) == \
        (640, 2560, 2048)
    with pytest.raises(SystemExit):
        run_vqa.parse_args(["--run", "train", "--model", "huge"])
    with pytest.raises(SystemExit):
        run_vqa.parse_args(["--run", "train", "--train_engine", "xla"])
    with pytest.raises(ValueError, match="model"):
        Config.for_model("huge")


def test_large_shaped_tiny_model_trains_and_carries_weights(tmp_path):
    """``--model large`` at a tiny large-shaped width (hidden 640 > 512,
    5 heads of 128, the large preset's two micro-batches): the att_saves
    decoder route trains, and its epoch pickle keeps the reference Net2
    keys, so the JAX ``import_torch_checkpoint`` reads it with no new
    mapping."""
    argv = ["--run", "train", "--synthetic", "--device", "cpu",
            "--model", "large", "--max_epoch", "1", "--version", "wide",
            "--ckpts_dir", str(tmp_path / "ckpts"),
            "--log_path", str(tmp_path / "log"),
            *TINY, "--hidden_size", "640", "--multi_head", "5"]
    cfg = run_vqa.build_config(run_vqa.parse_args(argv))
    assert cfg.hidden_size // cfg.multi_head == 128
    assert cfg.grad_accu_steps == 2
    assert run_vqa.main(argv) == 0
    log = (tmp_path / "log" / "log_run_wide.txt").read_text()
    assert engine_line(640) in log and "att_saves" in log
    path = str(tmp_path / "ckpts" / "ckpt_wide" / "epoch1.pkl")
    saved = torch.load(path, map_location="cpu",
                       weights_only=True)["state_dict"]
    assert saved["backbone.dec_list.0.ffn.mlp.fc.linear.weight"].shape == \
        (2560, 640)
    params, meta = import_torch_checkpoint(path)
    back = state_dict_from_params(params)
    assert list(back) == list(saved) == meta["param_keys"]
    assert all(torch.equal(back[k], v) for k, v in saved.items())
    records = [json.loads(line) for line in
               (tmp_path / "log" / "log_run_wide.jsonl").read_text()
               .splitlines()]
    assert np.isfinite(records[0]["loss"]) and records[0]["steps"] == 4
