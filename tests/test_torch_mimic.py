"""The MIMIC-CXR medical VQA flow of the port against the JAX package on
the CPU: the config's MIMIC fields and preflight (configs.py),
``MIMICDataset`` over the HDF5 banks and over the ``.npy`` banks, with
every feature source (data/mimic.py), ``filter_train_data``, the plain
eval engine's probabilities and ROC-AUC on the val split, ``run_mimic``,
``run_classify`` on the files and ``sweep``.

Tiny size, as tests/test_mimic_end_to_end.py builds the files: 48 images
of 10 region rows and 4 anatomy rows of 16 features, 6 labels, each with a
signature in its feature column; 40 / 8 / 8 train / val / test questions;
hidden 32, 1 layer, 4 heads. The JAX weights come from
``import_torch_state_dict`` of the port's seeded model. No JAX Trainer is
started.
"""

import argparse
import json
import pickle
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.cli import run_mimic as jrun_mimic
from mcan_vqa_tpu.cli import sweep as jsweep
from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.data import filter_train_data as jfilter
from mcan_vqa_tpu.data import mimic as jmimic
from mcan_vqa_tpu.evals.roc_auc import multilabel_roc_auc as jroc
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu_torch.cli import run_classify, run_mimic, sweep
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import filter_train_data, mimic
from mcan_vqa_tpu_torch.data.mimic_files import image_labels, \
    write_mimic_files
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.train.checkpoint import save_checkpoint
from mcan_vqa_tpu_torch.train.optim import make_optimizer
from mcan_vqa_tpu_torch.train.train_state import TrainState
from mcan_vqa_tpu_torch.train.trainer import Trainer

N_IMG, N_LABELS, FEAT, REGIONS, ANATOMY = 48, 6, 16, 10, 4
PAD = {"regions": REGIONS, "anatomy": ANATOMY, "both": REGIONS + ANATOMY}
SOURCES = tuple(PAD)
SPLITS = ("train", "val", "test")
ARCH = dict(img_feat_size=FEAT, max_token=8, hidden_size=32, ff_size=128,
            layer=1, multi_head=4, flat_out_size=32, flat_mlp_size=16,
            batch_size=8, use_glove=False, verbose=False)
TINY_FLAGS = ["--hidden_size", "32", "--layer", "1", "--multi_head", "4",
              "--img_feat_size", str(FEAT), "--img_feat_pad_size",
              str(REGIONS), "--max_token", "8", "--flat_out_size", "32",
              "--flat_mlp_size", "16", "--batch_size", "8", "--max_epoch",
              "1", "--device", "cpu", "--verbose", "false"]


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
def env(tmp_path_factory):
    """The miniature MIMIC-CXR files: both banks as HDF5 and as .npy (the
    writer's), the answer dictionaries and the three QA pickles (one train
    question without labels)."""
    root = tmp_path_factory.mktemp("mimic")
    rng = np.random.default_rng(0)
    feats = rng.normal(0, 0.1, size=(N_IMG, REGIONS, FEAT)).astype(
        np.float32)
    labels = [sorted({i % N_LABELS, (i * 7) % N_LABELS})
              for i in range(N_IMG)]
    for i, ls in enumerate(labels):
        feats[i, :, ls] += 4.0
    ana = rng.normal(9.0, 1.0, size=(N_IMG, ANATOMY, FEAT)).astype(
        np.float32)
    banks = {}
    for name, data in (("regions", feats), ("anatomy", ana)):
        h5 = str(root / f"{name}.hdf5")
        with h5py.File(h5, "w") as f:
            f.create_dataset("image_features", data=data)
            if name == "regions":
                f.create_dataset("image_bb",
                                 data=rng.uniform(0, 1, (N_IMG, REGIONS, 4)))
        npy = str(root / f"{name}.npy")
        assert mimic.write_npy_bank(h5, npy, block_rows=5) == data.shape
        banks[name] = (h5, npy, data)
    prefix = str(root / "mimic_")
    with open(prefix + "ans2label_full.pkl", "wb") as f:
        pickle.dump({f"finding{i}": i for i in range(N_LABELS)}, f)
    with open(prefix + "label2ans_full.pkl", "wb") as f:
        pickle.dump({i: f"finding{i}" for i in range(N_LABELS)}, f)
    words = ["is there", "any sign of", "what findings are in", "does the"]

    def qa(indices):
        return [{"question": f"{words[i % 4]} image {i} left lung?",
                 "image": int(i), "answer": {"labels": labels[i]}}
                for i in indices]

    splits = {"train": qa(range(40)), "val": qa(range(40, 48)),
              "test": qa(range(40, 48))[::-1]}
    splits["train"][3]["answer"]["labels"] = []
    for split, rows in splits.items():
        with open(f"{prefix}dataset_{split}_full.pkl", "wb") as f:
            pickle.dump(rows, f)
    return dict(root=root, prefix=prefix, banks=banks, splits=splits)


def _where(env, form=0, **kw):
    """The MIMIC path fields: the HDF5 banks (form 0) or the .npy ones."""
    return {"cxr_data_path": env["prefix"],
            "cxr_img_feat_path": env["banks"]["regions"][form],
            "ana_pool_finding_path": env["banks"]["anatomy"][form], **kw}


def _configs(env, source="regions", form=0, **kw):
    """The port's Config and the JAX one over the same files."""
    root = env["root"]
    where = _where(env, form, mimic_feat_source=source,
                   img_feat_pad_size=PAD[source], **kw)
    dirs = dict(ckpts_dir=str(root / "ckpts"), log_path=str(root / "log"),
                result_path=str(root / "results"))
    cfg = Config(**ARCH, **where, **dirs)
    jcfg = JConfig(**ARCH, **where, **dirs, pred_path=str(root / "pred"),
                   cache_path=str(root / "cache")).finalize()
    return cfg, jcfg


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("present", [True, False], ids=["present", "missing"])
@pytest.mark.parametrize("source", SOURCES)
def test_check_mimic_paths_matches_jax(env, tmp_path, source, present):
    kw = {} if present else dict(
        cxr_data_path=str(tmp_path / "m_"),
        cxr_img_feat_path=str(tmp_path / "bank.hdf5"),
        ana_pool_finding_path=str(tmp_path / "ana.hdf5"))
    cfg, jcfg = _configs(env, source, **kw)
    assert cfg.check_mimic_paths() == jcfg.check_mimic_paths()
    assert bool(cfg.check_mimic_paths()) != present
    jcfg.ana_pool_finding_path = ""
    cfg = cfg.with_overrides(ana_pool_finding_path="")
    assert cfg.check_mimic_paths() == jcfg.check_mimic_paths()


def test_mimic_path_tables_match_jax(env):
    cfg, jcfg = _configs(env)
    assert cfg.mimic_qa_path == jcfg.mimic_qa_path
    assert cfg.mimic_ans_dict_path == jcfg.mimic_ans_dict_path
    default, jdefault = Config(), JConfig().finalize()
    for name in ("cxr_data_path", "cxr_img_feat_path",
                 "ana_pool_finding_path", "mimic_feat_source",
                 "mutan_gamma"):
        assert getattr(default, name) == getattr(jdefault, name), name
    assert default.check_mimic_paths() == jdefault.check_mimic_paths()


def test_unknown_feat_source_is_refused():
    with pytest.raises(ValueError, match="mimic_feat_source"):
        Config(mimic_feat_source="pixels")
    with pytest.raises(ValueError, match="mimic_feat_source"):
        Config().with_overrides(mimic_feat_source="")


# ---------------------------------------------------------------------------
# MIMICDataset
# ---------------------------------------------------------------------------

def _same_examples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a.example(i), b.example(i)
        assert x.keys() == y.keys() == {"img", "ques", "target", "qid"}
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{i} {k}")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("source", SOURCES)
def test_dataset_matches_jax(env, source, split):
    """Every example in order (the train split's augmentation draws from
    the seeded generator in call order), the sizes, the answer
    dictionaries and the train split's vocabulary, bit for bit."""
    cfg, jcfg = _configs(env, source)
    ours = mimic.MIMICDataset(cfg, split, seed=3)
    theirs = jmimic.MIMICDataset(jcfg, split, seed=3)
    assert (len(ours), ours.ans_size, ours.token_size) == \
        (len(theirs), theirs.ans_size, theirs.token_size)
    assert ours.ix_to_ans == theirs.ix_to_ans
    assert ours.ans_to_ix == theirs.ans_to_ix
    assert ours.token_to_ix == theirs.token_to_ix
    np.testing.assert_array_equal(ours.pretrained_emb, theirs.pretrained_emb)
    _same_examples(ours, theirs)
    ex = ours.example(0)
    assert ex["img"].shape == (PAD[source], FEAT)
    if split == "train":
        assert (np.linalg.norm(ex["img"], axis=1) == 0).sum() == \
            int(PAD[source] * 0.3)


def test_splits_share_the_train_vocabulary(env):
    cfg, jcfg = _configs(env)
    train = mimic.MIMICDataset(cfg, "train")
    shared = mimic.MIMICDataset(cfg, "test", vocab=(
        train.token_to_ix, train.pretrained_emb))
    assert shared.token_to_ix is train.token_to_ix
    jtest = jmimic.MIMICDataset(jcfg, "test")
    assert shared.token_to_ix == jtest.token_to_ix
    _same_examples(shared, jtest)
    np.testing.assert_array_equal(mimic.MIMICDataset(cfg, "val").anatomy_features(
        5), env["banks"]["anatomy"][2][5])


def test_both_needs_room_for_the_anatomy_rows(env):
    """Fewer pad rows than regions + anatomy rows would truncate the
    anatomy rows away: refused (JAX asserts; the port raises ValueError,
    which ``python -O`` keeps)."""
    cfg, jcfg = _configs(env, "both")
    jcfg.img_feat_pad_size = REGIONS + ANATOMY - 1
    with pytest.raises(AssertionError, match="img_feat_pad_size"):
        jmimic.MIMICDataset(jcfg, "val")
    with pytest.raises(ValueError, match="img_feat_pad_size"):
        mimic.MIMICDataset(cfg.with_overrides(
            img_feat_pad_size=REGIONS + ANATOMY - 1), "val")


@pytest.mark.parametrize("source", ["anatomy", "both"])
def test_missing_anatomy_bank_raises(env, tmp_path, source):
    cfg, _ = _configs(env, source)
    for path in (str(tmp_path / "none.hdf5"), ""):
        with pytest.raises(FileNotFoundError, match="ana_pool_finding_path"):
            mimic.MIMICDataset(cfg.with_overrides(
                ana_pool_finding_path=path), "val")
    regions = cfg.with_overrides(mimic_feat_source="regions",
                                 img_feat_pad_size=REGIONS,
                                 ana_pool_finding_path="")
    with pytest.raises(FileNotFoundError):
        mimic.MIMICDataset(regions, "val").anatomy_features(0)


@pytest.mark.parametrize("source", SOURCES)
def test_npy_banks_give_the_hdf5_examples(env, source):
    for split in SPLITS:
        _same_examples(
            mimic.MIMICDataset(_configs(env, source, form=1)[0], split),
            mimic.MIMICDataset(_configs(env, source, form=0)[0], split))


def test_npy_writer_round_trips_and_maps_rows(env):
    for h5, npy, data in env["banks"].values():
        bank = mimic.open_feature_bank(npy)
        assert isinstance(bank, np.memmap) and bank.shape == data.shape
        np.testing.assert_array_equal(np.asarray(bank), data)
        with h5py.File(h5) as f:
            np.testing.assert_array_equal(f["image_features"][:], data)
        np.testing.assert_array_equal(mimic.open_feature_bank(h5)[7],
                                      data[7])


def test_hdf5_without_h5py_names_the_npy_form(env, monkeypatch):
    """Without h5py an HDF5 bank is refused with the .npy form named (it
    never turns into anything else), and the .npy banks need no h5py."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    h5, npy, data = env["banks"]["regions"]
    with pytest.raises(ImportError, match=r"\.npy"):
        mimic.open_feature_bank(h5)
    with pytest.raises(ImportError, match="write_npy_bank"):
        mimic.write_npy_bank(h5, h5 + ".npy")
    np.testing.assert_array_equal(mimic.open_feature_bank(npy)[3], data[3])
    ds = mimic.MIMICDataset(_configs(env, "both", form=1)[0], "train")
    assert ds.example(2)["img"].shape == (REGIONS + ANATOMY, FEAT)


def test_write_mimic_files_gives_a_learnable_set(tmp_path):
    """The miniature set of the card runs: the formats MIMICDataset reads,
    .npy banks, disjoint split images, each label's signature in its
    feature column of both banks."""
    paths = write_mimic_files(str(tmp_path), images=40, labels=5,
                              regions=6, anatomy=3, feat_dim=8,
                              questions={"train": 24, "val": 8, "test": 8})
    cfg = Config(img_feat_size=8, img_feat_pad_size=9, max_token=14,
                 mimic_feat_source="both", use_glove=False, **paths)
    assert cfg.check_mimic_paths() == []
    images = {}
    for split in SPLITS:
        ds = mimic.MIMICDataset(cfg, split)
        assert ds.ans_size == 5 and len(ds) == {"train": 24}.get(split, 8)
        images[split] = {q["image"] for q in ds.qa}
        for i in range(len(ds)):
            ex, image = ds.example(i), ds.qa[i]["image"]
            want = image_labels(image, 5)
            np.testing.assert_array_equal(np.nonzero(ex["target"])[0], want)
            if split != "train":
                cols = ex["img"].mean(axis=0)
                assert set(np.argsort(cols)[-len(want):]) == set(want)
    assert not (images["train"] & images["val"]) and \
        not (images["val"] & images["test"])


# ---------------------------------------------------------------------------
# filter_train_data
# ---------------------------------------------------------------------------

def _qa_for_filter():
    rng = np.random.default_rng(11)
    qa = [{"answer": {"labels": sorted(set(rng.integers(0, 5, rng.integers(
        1, 4)).tolist()))}} for _ in range(60)]
    qa += [{"answer": {"labels": [0]}}] * 30 + [{"answer": {"labels": []}}]
    return qa


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cap", [1, 3, 1500])
def test_filter_matches_jax(cap, seed):
    qa = _qa_for_filter()
    kept = filter_train_data.filter_indices_by_answer_cap(qa, cap, seed)
    assert kept == jfilter.filter_indices_by_answer_cap(qa, cap, seed)
    assert len(qa) - 1 not in kept
    if cap == 1500:
        assert kept == list(range(len(qa) - 1))


def test_filter_dump_load_round_trip(tmp_path):
    qa = _qa_for_filter()
    path = str(tmp_path / "kept.pkl")
    kept = filter_train_data.dump_filtered_indices(qa, path, cap=4, seed=2)
    assert filter_train_data.load_filtered_indices(path) == kept
    assert jfilter.load_filtered_indices(path) == \
        jfilter.filter_indices_by_answer_cap(qa, cap=4, seed=2)


# ---------------------------------------------------------------------------
# the flow: the plain eval engine and ROC-AUC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["regions", "both"])
def test_predict_matches_jax_apply_and_roc(env, source):
    """``Trainer.predict`` on val (the plain engine) against
    ``sigmoid(model.apply)`` of the same weights (JAX's default bf16
    compute, whose roundings the plain engine repeats) within 1e-5; ROC-AUC
    against JAX's on JAX's probabilities within 1e-6."""
    cfg, jcfg = _configs(env, source, eval_engine="plain")
    train = mimic.MIMICDataset(cfg, "train")
    val = mimic.MIMICDataset(cfg, "val", vocab=(train.token_to_ix,
                                                 train.pretrained_emb))
    trainer = Trainer(cfg, train, device="cpu")
    out = trainer.predict(val)
    res = trainer.evaluate(val)
    sd = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    jmodel = build_mcan(jcfg, train.token_size, train.ans_size)
    img = np.stack([val.example(i)["img"] for i in range(len(val))])
    ques = np.stack([val.example(i)["ques"] for i in range(len(val))])
    logits = jax.jit(lambda p: jmodel.apply({"params": p}, img, ques)[
        "logits"])(import_torch_state_dict(sd))
    probs = np.asarray(jax.nn.sigmoid(logits))
    np.testing.assert_allclose(out["probs"], probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["qids"], np.arange(len(val)))
    want = jroc(out["targets"] > 0.5, probs)
    assert abs(res["roc_micro"] - want["micro"]) <= 1e-6
    assert abs(res["roc_macro"] - want["macro"]) <= 1e-6


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def _file_flags(env, form=1):
    return [x for k, v in _where(env, form).items() for x in (f"--{k}", v)]


@pytest.fixture(scope="module")
def warm_pickle(env):
    """A VQA epoch pickle of another vocabulary (30 tokens), answer count
    (20) and image width (24)."""
    cfg = Config(**{**ARCH, "img_feat_size": 24})
    net = MCANet(cfg, 30, 20, generator=torch.Generator().manual_seed(5))
    state = TrainState.create(net, make_optimizer(net.parameters(), cfg))
    return save_checkpoint(state, str(env["root"] / "vqa"), "vqa", 1, 1e-4)


@pytest.fixture(scope="module")
def cli_train(env, warm_pickle, tmp_path_factory):
    """``run_mimic --run train`` on the .npy banks, warm-started, the train
    split evaluated every epoch -> its stdout, log and flags."""
    out = tmp_path_factory.mktemp("cli")
    flags = TINY_FLAGS + _file_flags(env) + [
        "--version", "cli", "--seed", "1", "--train_engine", "fused",
        "--ckpts_dir", str(out / "ck"), "--log_path", str(out / "log")]
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_mimic.main(["--run", "train", "--warm_start", warm_pickle,
                             "--train_eval_every", "1"] + flags)
    assert rc == 0
    log = (out / "log" / "log_run_cli.txt").read_text()
    return buf.getvalue(), log, flags, out


def _printed(stdout, name):
    line = [ln for ln in stdout.splitlines() if ln.startswith(f"{name}: ")]
    assert len(line) == 1, stdout
    return line[0]


def test_run_mimic_train_prints_val_and_test(cli_train):
    stdout, log, _, out = cli_train
    for name in ("val", "test"):
        assert _printed(stdout, name).startswith(
            f"{name}: {{'roc_micro': ")
        assert "'roc_macro': " in _printed(stdout, name)
    for name in ("train", "val", "test"):
        assert f"epoch 0 eval {name}: {{'roc_micro'" in log
    assert "train engine: fused SGA train blocks + fused SA encoder" in log
    # the end-of-train calibration at a head of 6 labels
    assert "serving calibration scales ->" in log
    assert (out / "ck" / "ckpt_cli" / "epoch1.act_scales.json").exists()


def test_run_mimic_val_resumes_the_train_run(cli_train, capsys):
    stdout, _, flags, _ = cli_train
    assert run_mimic.main(["--run", "val", "--ckpt_epoch", "1"] + flags) == 0
    assert capsys.readouterr().out.strip() == _printed(stdout, "val")


def test_run_mimic_warm_start_logs_its_skips(cli_train):
    _, log, _, _ = cli_train
    skips = sorted(ln.split()[2].rstrip(":") for ln in log.splitlines()
                   if ln.startswith("warm-start skip "))
    assert skips == ["embedding.weight", "img_feat_linear.weight",
                     "proj.bias", "proj.weight"]


def test_run_mimic_synthetic(tmp_path, capsys):
    assert run_mimic.main(["--run", "train", "--synthetic",
                           "--synthetic_size", "16", "--train_eval_every",
                           "0", "--ckpts_dir", str(tmp_path / "ck"),
                           "--log_path", str(tmp_path / "log")]
                          + TINY_FLAGS) == 0
    stdout = capsys.readouterr().out
    assert "'roc_micro'" in _printed(stdout, "val")
    assert "'roc_macro'" in _printed(stdout, "test")


@pytest.mark.parametrize("source", ["regions", "anatomy"])
def test_run_mimic_missing_paths_match_jax(tmp_path, monkeypatch, capsys,
                                           source):
    monkeypatch.chdir(tmp_path)
    assert run_mimic.main(["--run", "train", "--device", "cpu",
                           "--mimic_feat_source", source]) == 1
    err = capsys.readouterr().err
    want = JConfig(mimic_feat_source=source).finalize().check_mimic_paths()
    assert err == "missing MIMIC paths:\n  " + "\n  ".join(want) + "\n"


def _jax_parser(monkeypatch):
    """The JAX run_mimic's argparse parser."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, *a, **kw):
        seen["parser"] = self
        return real(self, *a, **kw)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    jrun_mimic.parse_args(["--run", "train"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return seen["parser"]


def test_run_mimic_takes_every_jax_flag_with_its_default(monkeypatch):
    """Each flag of the JAX CLI parses to the JAX value, and the defaults
    agree; --compute_dtype (an XLA option) is refused, --compile_cache
    accepted and ignored (utils/compile_cache.py); img_feat_size defaults
    to 1024 in both."""
    parser = _jax_parser(monkeypatch)
    base = ["--run", "train"]
    jdefaults, defaults = vars(jrun_mimic.parse_args(base)), vars(
        run_mimic.parse_args(base))
    refused = {"compute_dtype"}
    for act in parser._actions:
        if not act.option_strings or act.dest in ("help", "run_mode"):
            continue
        flag = act.option_strings[0]
        if act.nargs == 0:
            argv = [flag]
        elif act.choices:
            argv = [flag, list(act.choices)[-1]]
        else:
            argv = [flag, {int: "3", float: "0.25"}.get(act.type, "true")]
        if act.dest in refused:
            with pytest.raises(SystemExit):
                run_mimic.parse_args(base + argv)
            continue
        assert defaults[act.dest] == jdefaults[act.dest], flag
        got = vars(run_mimic.parse_args(base + argv))[act.dest]
        assert got == vars(jrun_mimic.parse_args(base + argv))[act.dest], \
            flag
    cfg = run_mimic.build_config(run_mimic.parse_args(base))
    assert cfg.img_feat_size == 1024 and defaults["device"] == "cuda"


def test_run_classify_trains_on_the_files(env, tmp_path, capsys):
    rc = run_classify.main(
        ["--run", "train", "--train_engine", "fused", "--ckpts_dir",
         str(tmp_path / "ck"), "--log_path", str(tmp_path / "log"),
         "--mimic_feat_source", "anatomy", "--eval_interval", "0"]
        + TINY_FLAGS + _file_flags(env))
    assert rc == 0
    line = _printed(capsys.readouterr().out, "val")
    assert "'roc_micro'" in line and "'roc_macro'" in line
    log = (tmp_path / "log" / "log_run_444.txt").read_text()
    assert "train engine: fused SA blocks (classifier, " in log


def test_sweep_mimic_writes_jax_records(env, tmp_path, monkeypatch):
    """A 2 x 1 grid through the port's run_mimic on the files; the JAX
    sweep over the same grid with its task stubbed forwards the same argv
    and writes the same records."""
    base = TINY_FLAGS + _file_flags(env) + [
        "--run", "train", "--train_eval_every", "0",
        "--ckpts_dir", str(tmp_path / "ck"),
        "--log_path", str(tmp_path / "log")]
    grid = ["--task", "mimic", "--layers", "1", "2", "--lrs", "1e-3"]
    ours = tmp_path / "ours.json"
    assert sweep.main(grid + ["--out", str(ours), "--"] + base) == 0
    seen = []

    def stub(argv):
        seen.append(argv)
        return 0

    monkeypatch.setattr(jrun_mimic, "main", stub)
    theirs = tmp_path / "theirs.json"
    assert jsweep.main(grid + ["--out", str(theirs), "--"] + base) == 0
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    assert [r["version"] for r in json.loads(ours.read_text())] == [
        "sweep_l1_lr0.001", "sweep_l2_lr0.001"]
    assert seen[1][-3:] == ["--layer=2", "--lr_base=0.001",
                            "--version=sweep_l2_lr0.001"]
    for v in ("sweep_l1_lr0.001", "sweep_l2_lr0.001"):
        assert (tmp_path / "ck" / f"ckpt_{v}" / "epoch1.pkl").exists()


def test_sweep_records_a_bad_forwarded_flag(tmp_path, capsys):
    out = tmp_path / "s.json"
    assert sweep.main(["--task", "mimic", "--layers", "1", "--lrs", "1e-3",
                       "--out", str(out), "--run", "train",
                       "--no_such_flag", "1"]) == 1
    (rec,) = json.loads(out.read_text())
    assert rec == {"layer": 1, "lr_base": 1e-3, "version": "sweep_l1_lr0.001",
                   "returncode": 2,
                   "error": "SystemExit (bad forwarded flag?)"}
    assert "(0/1 points ok)" in capsys.readouterr().out
