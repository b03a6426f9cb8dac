"""The answer dictionary and top-k answer strings (the port's copy of the
parts of mcan_vqa_tpu/data/answers.py it uses).

``answer_dict.json`` beside this file is the frozen published 3129-answer
VQA-v2 dictionary (reference core/data/load_data.py:84-96), a copy of the
JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

_FROZEN_DICT = os.path.join(os.path.dirname(__file__), "answer_dict.json")


def load_answer_dict(path: str = _FROZEN_DICT
                     ) -> Tuple[Dict[str, int], Dict[str, str]]:
    """-> (ans_to_ix, ix_to_ans), the keys of ix_to_ans being strings."""
    with open(path) as f:
        ans_to_ix, ix_to_ans = json.load(f)
    return ans_to_ix, ix_to_ans


def topk_answers(probs_row: np.ndarray, ix_to_ans: Dict, k: int) -> list:
    """Top-k (answer, probability) pairs of one probability row, highest
    first; k is clamped to [1, answer_size]. ix_to_ans keys may be str or
    int. k == 1 takes the plain argmax, so ties break as the evaluators
    break them."""
    row = np.asarray(probs_row)
    k = max(1, min(int(k), row.shape[-1]))
    if k == 1:
        order = [int(row.argmax())]
    else:
        part = np.argpartition(row, -k)[-k:]
        order = part[np.argsort(row[part])[::-1]]

    def name(i):
        return ix_to_ans.get(str(int(i)), ix_to_ans.get(int(i), str(int(i))))

    return [(name(i), float(row[int(i)])) for i in order]
