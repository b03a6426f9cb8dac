"""The synthetic MIMIC-CXR set of the classify task and its feature
augmentation (the port's copy of mcan_vqa_tpu/data/mimic.py:37-53,
:173-206).

``SyntheticMIMICDataset`` stands in for the MIMIC-CXR region features
(reference core/data/load_data.py:157-264): per example [R, F] random
region rows, L2-normalized and with a random 30% of them zeroed in the
train split (load_data.py:239-247), random question ids (unread by the
classifier) and a multi-hot target of up to two labels. The real
HDF5-backed ``MIMICDataset`` is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

FEATURE_DROPOUT_FRAC = 0.3


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
