"""The MIMIC-CXR medical VQA data (the port's copy of
mcan_vqa_tpu/data/mimic.py): ``MIMICDataset`` over the real file formats,
the synthetic set of the classify task, and the train-time augmentation.

``MIMICDataset`` keeps the reference's MIMICDatasetBase / Split semantics
(core/data/load_data.py:157-264) as the JAX package keeps them:

  * the region feature bank ``image_features`` [N, 60, 1024] and the pooled
    anatomy bank [N, 26, 1024] (load_data.py:175-179), either of them the
    model's image rows, or both, regions first (``cfg.mimic_feat_source``
    "regions" | "anatomy" | "both");
  * the answer dictionaries from the ans2label / label2ans pickles,
    multi-hot targets from each example's ``answer.labels``;
  * the QA pairs from one pickle per split, and one vocabulary built over
    the TRAIN split's questions for every split;
  * in the train split only, each row L2-normalized, then a random 30% of
    the rows zeroed (load_data.py:239-247), each example with a child
    generator drawn from the dataset's seeded one.

Not reproduced, as in the JAX package: the reference folds the test pickle
into the train split (load_data.py:204-210, test-set leakage); the splits
stay separate. The banks' ``image_bb`` / ``spatial_features``, which no
model reads, are not opened.

A bank is HDF5 (the reference's form, read through ``h5py``) or, where
``h5py`` is not installed, the ``image_features`` array itself as a
``.npy`` file (``write_npy_bank`` writes one from an HDF5 bank). Either is
read one example's rows at a time: a real region bank is ~92.7 GB
(377,110 x 60 x 1024 f32).

``SyntheticMIMICDataset`` stands in for the files: per example [R, F]
random region rows, augmented as above in the train split, random question
ids (unread by the classifier) and a multi-hot target of up to two labels.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, Optional

import numpy as np

from mcan_vqa_tpu_torch.data import answers as ans_mod
from mcan_vqa_tpu_torch.data import features as feat_mod
from mcan_vqa_tpu_torch.data import text as text_mod

FEATURE_DROPOUT_FRAC = 0.3
BANK_KEY = "image_features"      # the HDF5 dataset a bank's rows are in


def l2_normalize_rows(x: np.ndarray) -> np.ndarray:
    """Row-wise L2 normalization (sklearn.preprocessing.normalize(axis=1)
    semantics: zero rows stay zero)."""
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.where(norms == 0, 1.0, norms)


def feature_row_dropout(feat: np.ndarray, rng: np.random.Generator,
                        frac: float = FEATURE_DROPOUT_FRAC) -> np.ndarray:
    """Zero a random ``frac`` of region rows (train augmentation,
    reference: core/data/load_data.py:239-243)."""
    n = feat.shape[0]
    drop = rng.choice(n, size=int(n * frac), replace=False)
    out = feat.copy()
    out[drop] = 0.0
    return out


def _h5py(path: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path} is an HDF5 feature bank and h5py is not installed: "
            f"write the bank's {BANK_KEY!r} array once as a .npy file "
            f"(mcan_vqa_tpu_torch.data.mimic.write_npy_bank, on a machine "
            f"with h5py) and pass the .npy path") from e
    return h5py


def open_feature_bank(path: str):
    """A feature bank's [N, rows, F] array, opened for reading one example
    at a time: a ``.npy`` path is the array itself, memory-mapped; any other
    path is an HDF5 file whose ``image_features`` dataset is returned
    (h5py is imported only here)."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    return _h5py(path).File(path, "r")[BANK_KEY]


def write_npy_bank(h5_path: str, npy_path: str,
                   block_rows: int = 4096) -> tuple:
    """The HDF5 bank's ``image_features`` written as the ``.npy`` bank
    ``open_feature_bank`` reads, ``block_rows`` examples at a time (never
    the whole bank in memory). -> the array's shape."""
    src = _h5py(h5_path).File(h5_path, "r")
    try:
        rows = src[BANK_KEY]
        out = np.lib.format.open_memmap(npy_path, mode="w+",
                                        dtype=rows.dtype, shape=rows.shape)
        for i in range(0, rows.shape[0], block_rows):
            out[i:i + block_rows] = rows[i:i + block_rows]
        out.flush()
        shape = tuple(out.shape)
        del out
    finally:
        src.close()
    return shape


class MIMICDataset:
    def __init__(self, cfg, run_mode: Optional[str] = None, seed: int = 0,
                 vocab: Optional[tuple] = None):
        """cfg: a ``Config`` (its ``cxr_*`` paths, ``mimic_feat_source``,
        ``img_feat_pad_size``, ``max_token``, ``use_glove``); run_mode:
        "train" (augmented), "val" or "test" (any other mode reads val);
        seed: the augmentation's generator; vocab: (token_to_ix,
        pretrained_emb) of the train split, shared by the other splits (one
        build instead of three), else built here over the train split's
        questions."""
        self.cfg = cfg
        self.run_mode = run_mode or getattr(cfg, "run_mode", "train")
        # example() draws a child generator from this one under the lock,
        # one draw per call, so the same seed and call order give the same
        # bits in any thread
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

        self.image_features = open_feature_bank(cfg.cxr_img_feat_path)
        self.feat_source = cfg.mimic_feat_source    # Config checked it
        self.ana_pooled_feats = None
        ana_path = cfg.ana_pool_finding_path
        if ana_path and os.path.exists(ana_path):
            self.ana_pooled_feats = open_feature_bank(ana_path)
        elif self.feat_source != "regions":
            raise FileNotFoundError(
                f"mimic_feat_source={self.feat_source!r} needs "
                f"ana_pool_finding_path, not found: {ana_path!r}")
        if self.feat_source == "both":
            # the padding truncates: with fewer pad rows than regions +
            # anatomy rows, "both" would drop the anatomy rows
            need = (self.image_features.shape[1]
                    + self.ana_pooled_feats.shape[1])
            if cfg.img_feat_pad_size < need:
                raise ValueError(
                    f'mimic_feat_source="both" emits {need} rows per image '
                    f"but img_feat_pad_size={cfg.img_feat_pad_size} would "
                    f"truncate the anatomy rows away -- raise it to >= "
                    f"{need}")

        with open(cfg.mimic_ans_dict_path["ans2idx"], "rb") as f:
            self.ans_to_ix = pickle.load(f)
        with open(cfg.mimic_ans_dict_path["idx2ans"], "rb") as f:
            self.ix_to_ans = pickle.load(f)
        self.ans_size = len(self.ans_to_ix)

        split = self.run_mode if self.run_mode in ("train", "val", "test") \
            else "val"
        with open(cfg.mimic_qa_path[split], "rb") as f:
            self.qa = pickle.load(f)
        self.data_size = len(self.qa)

        if vocab is not None:
            self.token_to_ix, self.pretrained_emb = vocab
        else:
            if split == "train":
                vocab_qa = self.qa
            else:
                with open(cfg.mimic_qa_path["train"], "rb") as f:
                    vocab_qa = pickle.load(f)
            self.token_to_ix, self.pretrained_emb = text_mod.build_vocab(
                [q["question"] for q in vocab_qa],
                glove_lookup=(text_mod.spacy_glove_lookup()
                              if cfg.use_glove else None),
                embed_dim=cfg.word_embed_size)
        self.token_size = len(self.token_to_ix)

    def anatomy_features(self, image_id: int) -> np.ndarray:
        """The [26, F] pooled anatomical-finding rows of one image."""
        if self.ana_pooled_feats is None:
            raise FileNotFoundError("ana_pool_finding_path not loaded")
        return np.asarray(self.ana_pooled_feats[image_id], np.float32)

    def _raw_features(self, image_id: int) -> np.ndarray:
        if self.feat_source == "regions":
            return np.asarray(self.image_features[image_id], np.float32)
        if self.feat_source == "anatomy":
            return self.anatomy_features(image_id)
        return np.concatenate(
            [np.asarray(self.image_features[image_id], np.float32),
             self.anatomy_features(image_id)], axis=0)

    def example(self, idx: int) -> Dict[str, np.ndarray]:
        qa = self.qa[idx]
        ques = text_mod.encode_question(
            qa["question"], self.token_to_ix, self.cfg.max_token)
        target = ans_mod.multi_hot(qa["answer"]["labels"], self.ans_size)
        feat = self._raw_features(qa["image"])
        if self.run_mode == "train":
            with self._rng_lock:
                child = np.random.default_rng(self._rng.integers(2**63))
            feat = feature_row_dropout(l2_normalize_rows(feat), child)
        img = feat_mod.pad_img_feat(feat, self.cfg.img_feat_pad_size)
        return {"img": img.astype(np.float32), "ques": ques,
                "target": target, "qid": np.int64(idx)}

    def __len__(self) -> int:
        return self.data_size


class SyntheticMIMICDataset:
    """In-memory stand-in with the MIMICDataset interface (15 labels by
    default; the classify CLI asks for 14). run_mode "train" applies the
    train augmentation."""

    def __init__(self, cfg, size: int = 128, answer_size: int = 15,
                 token_size: int = 120, seed: int = 0,
                 run_mode: Optional[str] = None):
        self.cfg = cfg
        self.run_mode = run_mode or getattr(cfg, "run_mode", "train")
        self.data_size = size
        self.ans_size = answer_size
        self.token_size = token_size
        self.token_to_ix = {"PAD": 0, "UNK": 1}
        self.ans_to_ix = {f"label{i}": i for i in range(answer_size)}
        self.ix_to_ans = {i: f"label{i}" for i in range(answer_size)}
        self.pretrained_emb = np.random.default_rng(seed).normal(
            0, 1, (token_size, cfg.word_embed_size)).astype(np.float32)
        self._seed = seed

    def example(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self._seed * 7919 + idx)
        R, F = self.cfg.img_feat_pad_size, self.cfg.img_feat_size
        feat = rng.normal(size=(R, F)).astype(np.float32)
        if self.run_mode == "train":
            feat = feature_row_dropout(l2_normalize_rows(feat), rng)
        ques = np.zeros(self.cfg.max_token, np.int32)
        n = rng.integers(3, self.cfg.max_token + 1)
        ques[:n] = rng.integers(1, self.token_size, n)
        target = np.zeros(self.ans_size, np.float32)
        target[rng.integers(0, self.ans_size, 2)] = 1.0
        return {"img": feat, "ques": ques, "target": target,
                "qid": np.int64(idx)}

    def __len__(self) -> int:
        return self.data_size
