"""A miniature VQA-v2 dataset in VQA-v2's own file formats, made from a
seed: what the evaluation tests and chip_smoke.py read in place of the
real files, which nothing here downloads.

``write_vqa_files(root)`` writes under ``root``:

  vqa/v2_OpenEnded_mscoco_{train2014,val2014,test2015}_questions.json
  vqa/v2_mscoco_{train2014,val2014}_annotations.json
  vqa/VG_questions.json, vqa/VG_annotations.json   (over train images)
  coco_extract/{train2014,val2014,test2015}/COCO_<split>_<id:012d>.jpg.npz
      BUTD features: "x" [feat_dim, n_regions] f32, "bbox" [n_regions, 4]

Image i of a split belongs to class i % len(ANSWERS): its feature column
``class`` is boosted by 5 on every region, so a model can learn the answer
from the image. Each question's 10 annotators mostly give the class's
answer (in varied spellings the official normalisation folds together)
and a few give another one, so soft scores, question types and answer
types all vary. Every answer is in the frozen 3129-answer dictionary.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

# (answer, its spellings by annotators, answer type)
ANSWERS = (("red", ("red", "Red", "red."), "other"),
           ("2", ("2", "two", "2 "), "number"),
           ("yes", ("yes", "Yes", "yes!"), "yes/no"),
           ("blue", ("blue", "the blue", "blue"), "other"))
QUESTIONS = (("what color is the signature here?", "what color"),
             ("How many marks are in the picture?", "how many"),
             ("Is the class shown?", "is the"),
             ("what is on the table-top/desk?", "what is"))
SPLITS = (("train", "train2014", 0), ("val", "val2014", 100000),
          ("test", "test2015", 200000))


def write_vqa_files(root: str, images: Dict[str, int] = None,
                    questions_per_image: int = 2, feat_dim: int = 2048,
                    regions=(10, 60), seed: int = 0) -> Dict[str, str]:
    """Write the files; images: {"train" / "val" / "test": images in that
    split} (default 8 / 6 / 4). -> the ``Config`` path fields that read
    them (dataset_path, feature_path)."""
    images = dict({"train": 8, "val": 6, "test": 4}, **(images or {}))
    rng = np.random.default_rng(seed)
    vqa_dir = os.path.join(root, "vqa")
    feat_dir = os.path.join(root, "coco_extract")
    os.makedirs(vqa_dir, exist_ok=True)
    qid = 1
    payload = {}
    for split, name, first_id in SPLITS:
        os.makedirs(os.path.join(feat_dir, name), exist_ok=True)
        questions, annotations = [], []
        for i in range(images[split]):
            iid = first_id + i + 1
            cls = i % len(ANSWERS)
            n = int(rng.integers(regions[0], regions[1] + 1))
            feats = rng.normal(0, 0.1, size=(n, feat_dim)).astype(np.float32)
            feats[:, cls] += 5.0
            np.savez(os.path.join(feat_dir, name,
                                  f"COCO_{name}_{iid:012d}.jpg.npz"),
                     x=feats.T, bbox=rng.uniform(0, 1, (n, 4))
                     .astype(np.float32))
            for k in range(questions_per_image):
                text, qtype = QUESTIONS[(i + k) % len(QUESTIONS)]
                questions.append({"question_id": qid, "image_id": iid,
                                  "question": text})
                answer, spellings, atype = ANSWERS[cls]
                n_other = int(rng.integers(0, 4))
                given = [spellings[j % len(spellings)]
                         for j in range(10 - n_other)]
                given += [ANSWERS[(cls + 1) % len(ANSWERS)][0]] * n_other
                annotations.append({
                    "question_id": qid, "image_id": iid,
                    "question_type": qtype, "answer_type": atype,
                    "multiple_choice_answer": answer,
                    "answers": [{"answer": a, "answer_id": j + 1}
                                for j, a in enumerate(given)]})
                qid += 1
        payload[split] = (questions, annotations)
        _dump(os.path.join(vqa_dir, f"v2_OpenEnded_mscoco_{name}"
                                    f"_questions.json"),
              {"questions": questions})
        if split != "test":
            _dump(os.path.join(vqa_dir, f"v2_mscoco_{name}_annotations.json"),
                  {"annotations": annotations})
    # Visual Genome's extra questions, over the train images, new ids
    questions, annotations = payload["train"]
    shift = qid
    _dump(os.path.join(vqa_dir, "VG_questions.json"), {"questions": [
        dict(q, question_id=q["question_id"] + shift) for q in questions]})
    _dump(os.path.join(vqa_dir, "VG_annotations.json"), {"annotations": [
        dict(a, question_id=a["question_id"] + shift) for a in annotations]})
    return {"dataset_path": vqa_dir + "/", "feature_path": feat_dir + "/"}


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
