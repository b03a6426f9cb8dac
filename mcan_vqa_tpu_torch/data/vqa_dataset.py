"""The synthetic VQA training set (the port's copy of
mcan_vqa_tpu/data/vqa_dataset.py::SyntheticVQADataset).

Deterministic, in memory, numpy only: example ``i`` is drawn from a numpy
generator seeded with ``seed * 100003 + i``, so the port and the JAX
package see the same examples for the same arguments.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticVQADataset:
    """Random region features with a ragged number of real rows, random
    question token ids with a ragged length, and (for training) a one-hot
    target tied to the first token, so that a model can learn it."""

    def __init__(self, cfg, size: int = 256, token_size: int = 200,
                 answer_size: int = 64, seed: int = 0,
                 run_mode: str = "train"):
        self.cfg = cfg
        self.run_mode = run_mode
        self.data_size = size
        self.token_size = token_size
        self.ans_size = answer_size
        self.token_to_ix = {"PAD": 0, "UNK": 1}
        self.ans_to_ix = {str(i): i for i in range(answer_size)}
        self.ix_to_ans = {str(i): str(i) for i in range(answer_size)}
        self.pretrained_emb = np.random.default_rng(seed).normal(
            0, 1, (token_size, cfg.word_embed_size)).astype(np.float32)
        self._rng_seed = seed

    def example(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self._rng_seed * 100003 + idx)
        R, F = self.cfg.img_feat_pad_size, self.cfg.img_feat_size
        img = rng.normal(size=(R, F)).astype(np.float32)
        img[rng.integers(max(1, R // 2), R + 1):] = 0.0
        ques = np.zeros(self.cfg.max_token, np.int32)
        n = rng.integers(3, self.cfg.max_token + 1)
        ques[:n] = rng.integers(1, self.token_size, n)
        out = {"img": img, "ques": ques, "qid": np.int64(idx)}
        if self.run_mode == "train":
            target = np.zeros(self.ans_size, np.float32)
            target[int(ques[0]) % self.ans_size] = 1.0
            out["target"] = target
        return out

    def __len__(self) -> int:
        return self.data_size
