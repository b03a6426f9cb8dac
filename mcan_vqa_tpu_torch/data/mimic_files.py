"""A miniature MIMIC-CXR medical VQA dataset in the real file formats, for
runs that cannot read the real one (it is not in the repository and is not
downloaded).

``write_mimic_files(root)`` writes what ``MIMICDataset`` reads
(reference core/data/load_data.py:157-264):

  * ``mimic_ans2label_full.pkl`` / ``mimic_label2ans_full.pkl``: {finding:
    label} and {label: finding} over ``labels`` findings;
  * ``mimic_dataset_{train,val,test}_full.pkl``: lists of {"question",
    "image" (the bank row), "answer": {"labels": [...]}}, the splits on
    disjoint images, each image asked ``len(TEMPLATES)`` questions round
    the splits' images;
  * ``cmb_bbox_features_full.npy`` [images, regions, feat_dim] f32 and
    ``bbox_disease_features_by_coords.npy`` [images, anatomy, feat_dim]
    f32: the banks as ``.npy`` arrays, written a block of images at a time.

Image i carries labels {i % labels, 7i % labels}, and every row of both
its banks carries a signature for each of them (4.0 added to the label's
feature column over N(0, 0.1) noise), so a model can learn every label
from either bank.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

TEMPLATES = ("is there evidence of a finding in the {} lung?",
             "what abnormalities are seen in the {} lung field?",
             "does the {} hemithorax show any finding?",
             "which findings does this image show near the {} base?")
SIDES = ("left", "right", "upper", "lower")
BLOCK = 64                      # images generated and written at a time


def image_labels(i: int, labels: int):
    return sorted({i % labels, (7 * i) % labels})


def _write_bank(path: str, images: int, rows: int, feat_dim: int,
                labels: int, rng: np.random.Generator) -> None:
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                    shape=(images, rows, feat_dim))
    for start in range(0, images, BLOCK):
        n = min(BLOCK, images - start)
        block = rng.normal(0, 0.1, size=(n, rows, feat_dim)).astype(
            np.float32)
        for j in range(n):
            block[j, :, image_labels(start + j, labels)] += 4.0
        out[start:start + n] = block
    out.flush()
    del out


def write_mimic_files(root: str, images: int = 640,
                      questions: Dict[str, int] = None, labels: int = 15,
                      regions: int = 60, anatomy: int = 26,
                      feat_dim: int = 1024, seed: int = 0) -> Dict[str, str]:
    """Write the miniature set under ``root``. questions: {split: count}
    (default 512 / 128 / 128); the images are shared out to the splits in
    proportion, in order. -> the Config's path fields
    (``cxr_data_path``, ``cxr_img_feat_path``, ``ana_pool_finding_path``)."""
    questions = questions or {"train": 512, "val": 128, "test": 128}
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    prefix = os.path.join(root, "mimic_")
    names = [f"finding{label:02d}" for label in range(labels)]
    with open(prefix + "ans2label_full.pkl", "wb") as f:
        pickle.dump({n: i for i, n in enumerate(names)}, f)
    with open(prefix + "label2ans_full.pkl", "wb") as f:
        pickle.dump(dict(enumerate(names)), f)
    total = sum(questions.values())
    start = 0
    for split, n in questions.items():
        share = max(1, images * n // total)
        pool = np.arange(start, min(start + share, images))
        start += len(pool)
        qa = []
        for q in range(n):
            image = int(pool[q % len(pool)])
            text = TEMPLATES[q % len(TEMPLATES)].format(
                SIDES[(q // len(TEMPLATES)) % len(SIDES)])
            qa.append({"question": text, "image": image,
                       "answer": {"labels": image_labels(image, labels)}})
        with open(f"{prefix}dataset_{split}_full.pkl", "wb") as f:
            pickle.dump(qa, f)
    paths = {"cxr_data_path": prefix,
             "cxr_img_feat_path": os.path.join(
                 root, "cmb_bbox_features_full.npy"),
             "ana_pool_finding_path": os.path.join(
                 root, "bbox_disease_features_by_coords.npy")}
    _write_bank(paths["cxr_img_feat_path"], images, regions, feat_dim,
                labels, rng)
    _write_bank(paths["ana_pool_finding_path"], images, anatomy, feat_dim,
                labels, rng)
    return paths
