"""Serving API: weights in, answer strings out (mcan_vqa_tpu/api.py).

    from mcan_vqa_tpu_torch.api import Predictor
    p = Predictor.from_checkpoint("epoch13.pkl", Config(), token_to_ix)
    answers = p.answer(["what color is the cat?"], image_features)

Engines:
  * "fused" (and "auto"): ``ops/serving.build_production_engine(qffn=0)``,
    every backbone block through the hand-written block kernels on the
    card (their plain versions on the CPU);
  * "plain": ``models/net.MCANet`` op by op, the numerics of the JAX
    ``model.apply``.

A request batch pads to the smallest compiled bucket that fits
(``latency_buckets`` plus ``max_batch``), as in the JAX Predictor, so the
kernels always see the shapes they were measured at. The int8 / int4
engines, activation calibration and multi-device meshes are not ported
yet: asking for them raises.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import (load_answer_dict, pad_to_bucket,
                                     prep_request_inputs, topk_answers)
from mcan_vqa_tpu_torch.device import resolve_device
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops.serving import build_production_engine
from mcan_vqa_tpu_torch.train.checkpoint import load_reference_checkpoint

ENGINES = ("fused", "plain")
NOT_PORTED = ("int8", "int4")


class Predictor:
    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 token_to_ix: Dict[str, int],
                 ix_to_ans: Optional[Dict[str, str]] = None,
                 max_batch: int = 64, engine: str = "auto",
                 latency_buckets: Optional[Sequence[int]] = None,
                 device="cuda", mesh=None, act_calibration=None,
                 act_scales=None, auto_calibrate: int = 0,
                 q8aux: bool = False):
        """state_dict: reference-shaped MCANet weights
        (``MCANet.state_dict()``, ``train/checkpoint.py``).

        max_batch / latency_buckets: the batch shapes served; a request of
        n rows pads to the smallest bucket >= n.

        engine: "fused" | "plain" | "auto" (= "fused" on every device).
        device: where the engine runs, "cuda" by default; with no CUDA
        device it raises unless the caller passes device="cpu".

        mesh, act_calibration, act_scales, auto_calibrate, q8aux: the JAX
        Predictor's int8 / calibration / multi-chip arguments; not ported,
        so anything but their defaults raises."""
        if (mesh is not None or act_calibration is not None
                or act_scales is not None or auto_calibrate or q8aux):
            raise NotImplementedError(
                "mesh, act_calibration, act_scales, auto_calibrate and "
                "q8aux: calibration, the int8 sites and meshes are not "
                "ported yet")
        if engine == "auto":
            engine = "fused"
        if engine in NOT_PORTED:
            raise NotImplementedError(
                f"engine={engine!r} is not ported yet; use 'fused' or "
                f"'plain'")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}: expected one of "
                             f"{ENGINES + ('auto',)}")
        buckets = sorted(set(latency_buckets or ()))
        if not all(0 < b <= max_batch for b in buckets):
            raise ValueError(
                f"latency_buckets must be in (0, max_batch]: {buckets}")
        self.cfg = cfg
        self.engine = engine
        self.device = resolve_device(device)
        self.token_to_ix = token_to_ix
        if ix_to_ans is None:
            _, ix_to_ans = load_answer_dict()
        self.ix_to_ans = ix_to_ans
        self.max_batch = max_batch
        self.buckets = tuple(b for b in buckets if b < max_batch) \
            + (max_batch,)

        if engine == "fused":
            self._forward, self.params = build_production_engine(
                state_dict, cfg.layer, cfg.multi_head, qffn=0,
                device=self.device)
        else:
            model = MCANet(cfg, token_size=len(token_to_ix),
                           answer_size=len(self.ix_to_ans))
            model.load_state_dict(state_dict, strict=True)
            self.params = model.to(self.device).eval()
            self._forward = lambda m, img, ques: m(img, ques)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Config,
                        token_to_ix: Dict[str, int],
                        ix_to_ans: Optional[Dict[str, str]] = None,
                        **kwargs) -> "Predictor":
        """path: a reference pickle (.pkl / .pt / .pth). kwargs as for
        ``Predictor``."""
        if not path.endswith((".pkl", ".pt", ".pth")):
            raise NotImplementedError(
                f"{path}: only reference pickles load into the port so far "
                f"(orbax checkpoints: convert with state_dict_from_params)")
        return cls(cfg, load_reference_checkpoint(path), token_to_ix,
                   ix_to_ans, **kwargs)

    def bucket_for(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def pad_batch(self, questions: Sequence[str], image_features
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenise and pad a request batch to its bucket -> (img
        [bucket, pad, F] f32, ques [bucket, T] int32), the inputs of
        ``forward_padded``."""
        n = len(questions)
        if len(image_features) != n:
            raise ValueError(f"{n} questions but {len(image_features)} "
                             f"feature blocks")
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} outside (0, {self.max_batch}]")
        ques, img = prep_request_inputs(questions, image_features,
                                        self.token_to_ix, self.cfg.max_token,
                                        self.cfg.img_feat_pad_size)
        return pad_to_bucket(img, ques, self.bucket_for(n))

    def forward_padded(self, img: np.ndarray, ques: np.ndarray
                       ) -> torch.Tensor:
        """One forward on an already padded batch -> probabilities
        [bucket, A] on the engine's device (not synchronised)."""
        with torch.inference_mode():
            img_t = torch.from_numpy(img).to(self.device)
            ques_t = torch.from_numpy(ques).to(self.device)
            logits = self._forward(self.params, img_t, ques_t)
            return torch.sigmoid(logits.float())

    def predict_probs(self, questions: Sequence[str],
                      image_features) -> np.ndarray:
        """questions: N strings; image_features: [N, R<=pad, F] or N
        per-image [R_i, F] arrays (zero rows are padding).
        Returns probabilities [N, answer_size]."""
        img, ques = self.pad_batch(questions, image_features)
        return self.forward_padded(img, ques)[:len(questions)].cpu().numpy()

    def answer(self, questions: Sequence[str],
               image_features) -> List[Tuple[str, float]]:
        """Top-1 answer string and its probability per question."""
        probs = self.predict_probs(questions, image_features)
        return [topk_answers(row, self.ix_to_ans, 1)[0]
                for row in probs]

    def topk(self, questions: Sequence[str], image_features,
             k: int = 5) -> List[List[Tuple[str, float]]]:
        """Top-k (answer, probability) pairs per question, highest first."""
        probs = self.predict_probs(questions, image_features)
        return [topk_answers(row, self.ix_to_ans, k)
                for row in probs]
