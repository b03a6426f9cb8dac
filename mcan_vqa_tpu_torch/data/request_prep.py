"""Request preparation: tokenise, pad ragged region features, pad a batch
to its bucket (the port's copy of mcan_vqa_tpu/request_prep.py)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from mcan_vqa_tpu_torch.data.features import pad_img_feat
from mcan_vqa_tpu_torch.data.text import encode_questions


def prep_request_inputs(questions: Sequence[str], image_features,
                        token_to_ix: Dict[str, int], max_token: int,
                        pad_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (ques [N, T] int32, img [N, pad_size, F] f32): each per-image
    [R_i, F] block truncated or zero-padded to ``pad_size`` rows."""
    ques = encode_questions(questions, token_to_ix, max_token)
    img = np.stack([pad_img_feat(np.asarray(f, np.float32), pad_size)
                    for f in image_features])
    return ques, img


def pad_to_bucket(img: np.ndarray, ques: np.ndarray,
                  target: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad a prepared batch up to the bucket size ``target``."""
    n = img.shape[0]
    if n < target:
        pad = target - n
        img = np.concatenate([img, np.zeros((pad,) + img.shape[1:],
                                            np.float32)])
        ques = np.concatenate([ques, np.zeros((pad,) + ques.shape[1:],
                                              np.int32)])
    return img, ques
