"""Offline train-data filter: cap the examples per answer label (the
port's copy of mcan_vqa_tpu/data/filter_train_data.py; the reference's
balancing script, core/data/filter_train_data.py:19-89).

Walk the QA list in a seeded random order, keep at most ``cap`` examples
per answer label, and dump the kept indices to a pickle that training can
load to subset the QA list.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Sequence

import numpy as np


def filter_indices_by_answer_cap(qa_list: Sequence[dict], cap: int = 1500,
                                 seed: int = 0) -> List[int]:
    """The sorted indices kept after capping each answer label at ``cap``.
    A multi-label example counts toward, and is gated by, its rarest label
    so far, so caps on frequent co-labels never starve a rare one; an
    example without labels is skipped."""
    counts: Dict[int, int] = {}
    order = np.random.default_rng(seed).permutation(len(qa_list))
    kept = []
    for idx in order:
        labels = qa_list[int(idx)]["answer"]["labels"]
        if not labels:
            continue
        rarest = min(labels, key=lambda label: counts.get(label, 0))
        if counts.get(rarest, 0) >= cap:
            continue
        kept.append(int(idx))
        for label in labels:
            counts[label] = counts.get(label, 0) + 1
    return sorted(kept)


def dump_filtered_indices(qa_list: Sequence[dict], path: str,
                          cap: int = 1500, seed: int = 0) -> List[int]:
    """``filter_indices_by_answer_cap``, pickled to ``path``."""
    kept = filter_indices_by_answer_cap(qa_list, cap=cap, seed=seed)
    with open(path, "wb") as f:
        pickle.dump(kept, f)
    return kept


def load_filtered_indices(path: str) -> List[int]:
    with open(path, "rb") as f:
        return pickle.load(f)
