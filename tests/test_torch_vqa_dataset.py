"""The port's VQA-v2 data path against the JAX package's on a miniature
dataset in VQA-v2's own file formats (``data/vqa_files.write_vqa_files``,
built in a temporary directory): the path tables, the vocabulary and its
cache, ``VQADataset`` example by example (int32 questions, f32 features,
soft-score targets), from the npz files, preloaded and from the packed
fp16 cache (equal bytes on disk, ``cli/pack_features.py``), and the
evaluation form of ``BatchLoader`` (batches, ``valid``, ``n_valid``). All
exact: the copies are the same numpy code."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from mcan_vqa_tpu.cli import pack_features as jpack
from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.data import features as jfeatures
from mcan_vqa_tpu.data import text as jtext
from mcan_vqa_tpu.data.pipeline import BatchLoader as JBatchLoader
from mcan_vqa_tpu.data.vqa_dataset import SyntheticVQADataset as JSynthetic
from mcan_vqa_tpu.data.vqa_dataset import VQADataset as JVQADataset
from mcan_vqa_tpu_torch.cli import pack_features as tpack
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import features as tfeatures
from mcan_vqa_tpu_torch.data import text as ttext
from mcan_vqa_tpu_torch.data.pipeline import BatchLoader
from mcan_vqa_tpu_torch.data.vqa_dataset import (SyntheticVQADataset,
                                                 VQADataset)
from mcan_vqa_tpu_torch.data.vqa_files import write_vqa_files

FEAT = 16
DIMS = dict(img_feat_size=FEAT, img_feat_pad_size=6, max_token=8,
            word_embed_size=8, use_glove=False)
MODES = ("train", "val", "test")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqa_files")
    paths = write_vqa_files(str(root), feat_dim=FEAT, regions=(3, 9))
    return root, paths


def _configs(root, paths, tag, **kw):
    """The port's and the JAX package's Config over the same files, each
    with its own vocabulary cache and feature cache directory."""
    common = dict(paths, **DIMS, **kw)
    t = Config(**common, vocab_cache_path=str(root / f"t_{tag}.npz"),
               feature_cache_path=str(root / f"t_cache_{tag}") + "/")
    j = JConfig(**common, vocab_cache_path=str(root / f"j_{tag}.npz"),
                feature_cache_path=str(root / f"j_cache_{tag}") + "/")
    return t, j.finalize()


def _same_examples(tds, jds):
    assert len(tds) == len(jds) > 0
    for i in range(len(tds)):
        te, je = tds.example(i), jds.example(i)
        assert set(te) == set(je)
        for k in te:
            assert te[k].dtype == je[k].dtype, k
            np.testing.assert_array_equal(te[k], je[k], err_msg=k)
        assert tds.question_tokens(i) == jds.question_tokens(i)
        assert tds.image_id(i) == jds.image_id(i)
        np.testing.assert_array_equal(tds.bboxes(i), jds.bboxes(i))


def test_config_paths_match(files):
    root, paths = files
    t, j = _configs(root, paths, "paths", batch_size=12, grad_accu_steps=3)
    assert t.img_feat_path == j.img_feat_path
    assert t.question_path == j.question_path
    assert t.answer_path == j.answer_path
    assert t.check_vqa_paths() == j.check_vqa_paths() == []
    assert t.eval_batch_size == j.eval_batch_size == 4
    t2, j2 = _configs(root / "nowhere", {"dataset_path": "x/",
                                         "feature_path": "y/"}, "none")
    assert t2.check_vqa_paths() == j2.check_vqa_paths()
    assert len(t2.check_vqa_paths()) == 10
    fields = ("eval_every_epoch", "eval_engine", "eval_strict",
              "test_save_pred", "train_split", "use_glove", "preload",
              "ckpt_epoch", "ckpt_path", "dataset_path", "feature_path",
              "feature_cache_path", "vocab_cache_path", "result_path",
              "pred_path")
    assert {f: getattr(Config(), f) for f in fields} == \
        {f: getattr(JConfig(), f) for f in fields}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("split", ["train", "train+val+vg"])
def test_vqa_dataset_matches_from_npz(files, mode, split):
    root, paths = files
    t, j = _configs(root, paths, f"npz_{mode}_{split}", train_split=split)
    tds, jds = VQADataset(t, mode), JVQADataset(j, mode)
    assert tds.split_list == jds.split_list
    assert tds.token_to_ix == jds.token_to_ix and tds.token_size > 10
    np.testing.assert_array_equal(tds.pretrained_emb, jds.pretrained_emb)
    assert tds.ans_list == jds.ans_list and tds.ques_list == jds.ques_list
    assert (tds.ans_to_ix, tds.ix_to_ans) == (jds.ans_to_ix, jds.ix_to_ans)
    assert tds.ans_size == 3129
    _same_examples(tds, jds)
    # the vocabulary cache: equal files, reread by both packages
    tz, jz = np.load(t.vocab_cache_path, allow_pickle=True), \
        np.load(j.vocab_cache_path, allow_pickle=True)
    assert list(tz["tokens"]) == list(jz["tokens"])
    np.testing.assert_array_equal(tz["emb"], jz["emb"])
    assert ttext.load_vocab_meta(t.vocab_cache_path) == \
        jtext.load_vocab_meta(j.vocab_cache_path) == \
        {"sources": ["train", "val", "test", "vg"], "glove": False}
    assert VQADataset(t, mode).token_to_ix == tds.token_to_ix


def test_targets_are_soft_scores(files):
    root, paths = files
    t, _ = _configs(root, paths, "soft", train_split="train")
    ds = VQADataset(t, "train")
    targets = np.stack([ds.example(i)["target"] for i in range(len(ds))])
    assert set(np.unique(targets)) >= {0.0, 1.0} and \
        set(np.unique(targets)) - {0.0, 1.0}   # some 0.3 / 0.6 / 0.9
    assert (targets.sum(1) > 0).all()


def test_preloaded_features_match(files):
    root, paths = files
    t, j = _configs(root, paths, "preload", preload=True,
                    train_split="train+val")
    tds, jds = VQADataset(t, "train"), JVQADataset(j, "train")
    assert set(tds._preloaded) == set(jds._preloaded) and tds._preloaded
    _same_examples(tds, jds)


def test_packed_cache_same_bytes_and_examples(files):
    root, paths = files
    t, j = _configs(root, paths, "packed", train_split="train")
    for argv, main, cache in ((["--split", "train"], tpack.main, "t"),
                              (["--split", "train"], jpack.main, "j")):
        out = root / f"{cache}_cache_packed"
        assert main(argv + ["--feature_path", paths["feature_path"],
                            "--cache_path", str(out),
                            "--feat_dim", str(FEAT)]) == 0
    for name in ("features.bin", "index.json", "bbox.bin"):
        assert (root / "t_cache_packed" / "train" / name).read_bytes() == \
            (root / "j_cache_packed" / "train" / name).read_bytes()
    tc = tfeatures.PackedFeatureCache(str(root / "t_cache_packed" / "train"))
    jc = jfeatures.PackedFeatureCache(str(root / "j_cache_packed" / "train"))
    for iid in tc.index:
        np.testing.assert_array_equal(tc.get(iid), jc.get(iid))
        np.testing.assert_array_equal(tc.get_padded(iid, 5),
                                      jc.get_padded(iid, 5))
        np.testing.assert_array_equal(tc.get_bboxes(iid, 7),
                                      jc.get_bboxes(iid, 7))
    tds, jds = VQADataset(t, "train"), JVQADataset(j, "train")
    assert set(tds._packed) == set(jds._packed) == {"train"}
    _same_examples(tds, jds)
    assert tpack.main(["--split", "val", "--feature_path",
                       str(root / "missing"), "--cache_path",
                       str(root / "unused")]) == 1


def test_feature_files_match(files):
    root, paths = files
    d = Config(**paths).img_feat_path["val"]
    tp, jp = tfeatures.glob_feature_paths(d), jfeatures.glob_feature_paths(d)
    assert tp == jp and len(tp) == 6
    for iid, p in tp.items():
        assert tfeatures.iid_from_path(p) == jfeatures.iid_from_path(p) \
            == iid
        np.testing.assert_array_equal(tfeatures.load_npz_feature(p),
                                      jfeatures.load_npz_feature(p))
    with pytest.raises(ValueError, match="duplicate image id"):
        tfeatures.PackedFeatureCache.build(
            [next(iter(tp.values()))] * 2, str(root / "dup"), feat_dim=FEAT)


def test_vocab_cache_functions_match(tmp_path):
    vocab, emb = ttext.build_vocab(["what is it", "is it red"], embed_dim=4)
    for path in ("v", "v.npz"):
        ttext.save_vocab(str(tmp_path / f"t_{path}"), vocab, emb, {"a": 1})
        jtext.save_vocab(str(tmp_path / f"j_{path}"), vocab, emb, {"a": 1})
        assert ttext.vocab_cache_file(path) == jtext.vocab_cache_file(path)
        tv, te = ttext.load_vocab(str(tmp_path / f"t_{path}"))
        jv, je = jtext.load_vocab(str(tmp_path / f"j_{path}"))
        assert tv == jv == vocab
        np.testing.assert_array_equal(te, je)
        assert ttext.load_vocab_meta(str(tmp_path / f"t_{path}")) == \
            {"a": 1}
    ttext.save_vocab(str(tmp_path / "bare"), vocab, emb)
    assert ttext.load_vocab_meta(str(tmp_path / "bare")) is None


def test_spacy_lookup_falls_back_with_a_warning():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = ttext.spacy_glove_lookup()
    if got is None:
        assert any("spaCy GloVe lookup unavailable" in str(w.message)
                   for w in seen)
    else:
        assert np.asarray(got("cat")).shape == (300,)


@pytest.mark.parametrize("model_found", [False, True],
                         ids=["spacy-without-its-model", "spacy-and-model"])
def test_fallback_vocab_cache_kept_without_the_spacy_model(
        files, monkeypatch, model_found):
    """A cache of fallback vectors under use_glove=True is kept where spaCy
    imports but en_core_web_lg does not (a rebuild gives the same vectors),
    and rebuilt only where both are importable."""
    import importlib.util

    root, paths = files
    t, _ = _configs(root, paths, f"glove_{model_found}")
    t = dataclasses.replace(t, use_glove=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first = VQADataset(t, "val")
    assert ttext.load_vocab_meta(t.vocab_cache_path)["glove"] is False
    real = importlib.util.find_spec
    present = {"spacy"} | ({ttext.GLOVE_MODEL} if model_found else set())
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        object() if name in present else real(name, *a)))
    saved = []
    monkeypatch.setattr(ttext, "save_vocab",
                        lambda *a, **k: saved.append(a[0]))
    monkeypatch.setattr(ttext, "spacy_glove_lookup", lambda: None)
    again = VQADataset(t, "val")
    assert saved == ([t.vocab_cache_path] if model_found else [])
    assert again.token_to_ix == first.token_to_ix
    np.testing.assert_array_equal(again.pretrained_emb, first.pretrained_emb)


def _loader_batches(loader, keys):
    out = []
    for batch in loader:
        out.append({k: (batch[k].numpy() if isinstance(batch[k],
                                                       torch.Tensor)
                        else np.asarray(batch[k])) for k in keys})
    return out


@pytest.mark.parametrize("mode,bs", [("val", 5), ("train", 7), ("test", 8)])
def test_eval_batch_loader_matches(files, mode, bs):
    """shuffle=False, drop_last=False, pad_final=True: every example once
    in order, the last batch repeat-padded, valid / n_valid on the host."""
    root, paths = files
    t, j = _configs(root, paths, f"loader_{mode}", train_split="train")
    tds, jds = VQADataset(t, mode), JVQADataset(j, mode)
    kw = dict(shuffle=False, drop_last=False, pad_final=True)
    tl = BatchLoader(tds, bs, "cpu", **kw)
    jl = JBatchLoader(jds, bs, num_workers=1, **kw)
    keys = ("img", "ques", "qid", "valid", "n_valid") + (
        ("target",) if mode == "train" else ())
    tb, jb = _loader_batches(tl, keys), _loader_batches(jl, keys)
    assert len(tb) == len(jb) == len(tl) == -(-len(tds) // bs)
    for a, b in zip(tb, jb):
        for k in keys:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(int(b["n_valid"]) for b in tb) == len(tds)
    assert all(b["img"].shape[0] == bs for b in tb)
    qids = np.concatenate([b["qid"][b["valid"]] for b in tb])
    assert list(qids) == [tds.example(i)["qid"] for i in range(len(tds))]


def test_eval_batch_loader_on_the_synthetic_val_set():
    """The JAX CLI's synthetic val set (seed 1, run_mode "train": targets),
    in the evaluation form; the train form yields only the device keys."""
    t, j = Config(**DIMS), JConfig(**DIMS)
    tds = SyntheticVQADataset(t, size=11, answer_size=9, seed=1)
    jds = JSynthetic(j.finalize(), size=11, answer_size=9, seed=1,
                     run_mode="train")
    kw = dict(shuffle=False, drop_last=False, pad_final=True)
    keys = ("img", "ques", "target", "qid", "valid", "n_valid")
    tb = _loader_batches(BatchLoader(tds, 4, "cpu", **kw), keys)
    jb = _loader_batches(JBatchLoader(jds, 4, num_workers=1, **kw), keys)
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        for k in keys:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert [int(b["n_valid"]) for b in tb] == [4, 4, 3]
    train = next(iter(BatchLoader(tds, 4, "cpu")))
    assert set(train) == {"img", "ques", "target"}
