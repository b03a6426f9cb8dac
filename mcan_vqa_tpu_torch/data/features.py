"""Region-feature padding (the port's copy of
mcan_vqa_tpu/data/features.py::pad_img_feat)."""

from __future__ import annotations

import numpy as np


def pad_img_feat(img_feat: np.ndarray, pad_size: int) -> np.ndarray:
    """Truncate to, or zero-pad rows up to, ``pad_size`` (reference
    core/data/data_utils.py:119-130). Pad rows stay all zero: the model
    recovers the pad mask from them."""
    if img_feat.shape[0] > pad_size:
        img_feat = img_feat[:pad_size]
    out = np.zeros((pad_size,) + img_feat.shape[1:], dtype=img_feat.dtype)
    out[: img_feat.shape[0]] = img_feat
    return out
