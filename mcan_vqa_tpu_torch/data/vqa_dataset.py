"""VQA-v2 from its own files, and the synthetic training set (the port's
copy of mcan_vqa_tpu/data/vqa_dataset.py).

``VQADataset`` has the reference's CustomDataset semantics
(core/data/load_data.py:21-154): split lists such as "train+val+vg";
training indexed by annotation, evaluation by question; the vocabulary over
the union of the four question files in corpus order, cached on disk; the
frozen 3129-answer dictionary and soft-score targets; features from the
packed fp16 cache of a split where it has been built
(``cli/pack_features.py``), else from the per-image npz files, optionally
read into memory up front (``cfg.preload``).

``SyntheticVQADataset`` is deterministic, in memory, numpy only: example
``i`` is drawn from a numpy generator seeded with ``seed * 100003 + i``, so
the port and the JAX package see the same examples for the same arguments.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from mcan_vqa_tpu_torch.data import answers as ans_mod
from mcan_vqa_tpu_torch.data import features as feat_mod
from mcan_vqa_tpu_torch.data import text as text_mod

# the split list each run mode reads
SPLITS = {"val": "val", "test": "test", "visualize": "val"}


class VQADataset:
    def __init__(self, cfg, run_mode: str = "train"):
        """cfg: a ``Config`` (its paths, ``train_split``, ``use_glove``,
        ``preload``, ``max_token``, ``img_feat_pad_size``); run_mode:
        "train" (examples carry soft-score targets), "val", "test" or
        "visualize"."""
        self.cfg = cfg
        self.run_mode = run_mode
        splits = cfg.train_split if run_mode == "train" else SPLITS[run_mode]
        self.split_list = splits.split("+")

        self.ques_list: List[dict] = []
        self.ans_list: List[dict] = []
        for split in self.split_list:
            self.ques_list += _load_json(cfg.question_path[split])["questions"]
            if split in cfg.answer_path and os.path.exists(
                    cfg.answer_path[split]):
                self.ans_list += _load_json(
                    cfg.answer_path[split])["annotations"]
        self.qid_to_ques = {str(q["question_id"]): q for q in self.ques_list}
        # train indexes by annotation, evaluation by question
        # (core/data/load_data.py:58-61)
        self.data_size = (len(self.ans_list) if run_mode == "train"
                          else len(self.ques_list))

        self.token_to_ix, self.pretrained_emb = self._build_or_load_vocab()
        self.token_size = len(self.token_to_ix)
        self.ans_to_ix, self.ix_to_ans = ans_mod.load_answer_dict()
        self.ans_size = len(self.ans_to_ix)

        self._packed: Dict[str, feat_mod.PackedFeatureCache] = {}
        self._npz_paths: Dict[str, str] = {}
        self._preloaded: Dict[str, np.ndarray] = {}
        for split in self.split_list:
            if split not in cfg.img_feat_path:
                continue
            cache_dir = os.path.join(cfg.feature_cache_path, split)
            if os.path.exists(os.path.join(cache_dir, "index.json")):
                self._packed[split] = feat_mod.PackedFeatureCache(cache_dir)
            elif os.path.isdir(cfg.img_feat_path[split]):
                self._npz_paths.update(
                    feat_mod.glob_feature_paths(cfg.img_feat_path[split]))
        if cfg.preload:
            for iid, p in self._npz_paths.items():
                self._preloaded[iid] = feat_mod.load_npz_feature(p)

    def _build_or_load_vocab(self) -> Tuple[Dict[str, int], np.ndarray]:
        """The cached vocabulary where the cache was built from the same
        question files with the same embedding source, else a new one over
        the question files present (written to the cache). A cache of
        fallback vectors counts as fresh while spaCy or its
        ``en_core_web_lg`` model is not installed: a rebuild would give
        the same fallback vectors (``text.spacy_glove_lookup``)."""
        cfg = self.cfg
        cache = cfg.vocab_cache_path
        sources = [key for key in ("train", "val", "test", "vg")
                   if os.path.exists(cfg.question_path[key])]
        want_glove = bool(cfg.use_glove)
        if cache and os.path.exists(text_mod.vocab_cache_file(cache)):
            tok, emb = text_mod.load_vocab(cache)
            meta = text_mod.load_vocab_meta(cache)
            fresh = emb.shape[1] == cfg.word_embed_size
            if fresh and meta is not None:
                fresh = meta.get("sources") == sources
                if fresh and want_glove and not meta.get("glove", False):
                    fresh = not text_mod.glove_available()
            if fresh:
                return tok, emb
        stat_qs = []
        for key in sources:
            stat_qs += [q["question"] for q in _load_json(
                cfg.question_path[key])["questions"]]
        if not stat_qs:
            stat_qs = [q["question"] for q in self.ques_list]
        lookup = text_mod.spacy_glove_lookup() if want_glove else None
        tok, emb = text_mod.build_vocab(stat_qs, glove_lookup=lookup,
                                        embed_dim=cfg.word_embed_size)
        if cache:
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            text_mod.save_vocab(cache, tok, emb,
                                meta={"sources": sources,
                                      "glove": lookup is not None})
        return tok, emb

    def _record(self, idx: int) -> dict:
        return (self.ans_list[idx] if self.run_mode == "train"
                else self.ques_list[idx])

    def image_feature(self, image_id) -> np.ndarray:
        """[img_feat_pad_size, feat_dim]: from memory, else a packed cache,
        else the image's npz."""
        iid = str(image_id)
        feat = self._preloaded.get(iid)
        if feat is None:
            for cache in self._packed.values():
                if iid in cache:
                    return cache.get_padded(iid, self.cfg.img_feat_pad_size)
            feat = feat_mod.load_npz_feature(self._npz_paths[iid])
        return feat_mod.pad_img_feat(feat, self.cfg.img_feat_pad_size)

    def example(self, idx: int) -> Dict[str, np.ndarray]:
        """{"img" f32, "ques" int32, "qid" int64}, and in train mode the
        soft-score "target" (core/data/load_data.py:99-150)."""
        rec = self._record(idx)
        ques = (self.qid_to_ques[str(rec["question_id"])]
                if self.run_mode == "train" else rec)
        out = {
            "img": self.image_feature(rec["image_id"]).astype(np.float32),
            "ques": text_mod.encode_question(
                ques["question"], self.token_to_ix, self.cfg.max_token),
        }
        if self.run_mode == "train":
            out["target"] = ans_mod.soft_scores(rec["answers"],
                                                self.ans_to_ix)
        out["qid"] = np.int64(rec["question_id"])
        return out

    def __len__(self) -> int:
        return self.data_size

    def bboxes(self, idx: int):
        """The regions' boxes [R, 4], or None where the features have
        none."""
        iid = str(self._record(idx)["image_id"])
        for cache in self._packed.values():
            if iid in cache:
                return cache.get_bboxes(iid, self.cfg.img_feat_pad_size)
        path = self._npz_paths.get(iid)
        if path:
            with np.load(path) as z:
                if "bbox" in z.files:
                    return feat_mod.pad_img_feat(
                        z["bbox"][:, :4].astype(np.float32),
                        self.cfg.img_feat_pad_size)
        return None

    def question_tokens(self, idx: int) -> List[str]:
        rec = self._record(idx)
        if self.run_mode == "train":
            rec = self.qid_to_ques[str(rec["question_id"])]
        return text_mod.clean_question(rec["question"])

    def image_id(self, idx: int):
        """The COCO image id of example ``idx``."""
        return self._record(idx)["image_id"]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


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
