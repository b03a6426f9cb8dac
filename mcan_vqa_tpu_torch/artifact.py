"""Serving artifacts (mcan_vqa_tpu/artifact.py): a Predictor's engine frozen
into a directory that ``ArtifactPredictor`` serves without the model code.

``save_artifact`` traces the live engine's forward with ``torch.export``,
one program per latency bucket. The serving kernels enter the programs as
``torch.ops.mcan.*`` custom ops (ops/library.py), so a loaded program
launches the same hand-written kernels as the live engine, on the shapes
it was traced at, and gives its probabilities bit for bit. The weights are
the programs' inputs, not constants: each bucket's program takes the
prepared tree's tensor leaves, stored once in ``params.npz`` (bf16 as
uint16 views, as JAX's ``_VIEW_DTYPES``; int8 and the nibble-packed int4
words as they are), so three buckets are not three copies of the weights.
Every other leaf (static scales, flags) is baked into the programs.
Python side effects run once, at trace time: the block-level launch
counters of ops/quant.py and ops/sga_block.py count nothing when a program
runs, while the kernel-level ones (inside the ops) count every launch.

Layout of an artifact directory::

    meta.json           format_version 1, engine, buckets, forwards, shapes,
                        leaf dtypes and strides, program, device
    vocab.json          token_to_ix
    answers.json        ix_to_ans
    params.npz          the tensor leaves p0..pN (bf16 stored as uint16)
    forward_b{B}.pt2    torch.export.save of bucket B's program:
                        (leaves, img [B, R, F] f32, ques [B, T] int32) ->
                        probabilities [B, answers] f32

An exported program is tied to the device it was traced on, so meta.json
records it ("cuda" or "cpu") and the loader refuses another. Every bucket
of the port routes to "base" (ROADMAP §3: the port has no router yet), so
it writes format 1; format 2 (one param set per routed engine) comes with
the router.

Loading imports the op registry (ops/library.py, which
``torch.export.load`` needs before it reads a program that calls the
ops), the request helpers of ``data`` and ``device``, and nothing of the
model code: not ``api``, ``models.net``, ``ops.serving``, ``ops.quant``
or ``ops.sga_block``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mcan_vqa_tpu_torch.data import (pad_to_bucket, prep_request_inputs,
                                     topk_answers)
from mcan_vqa_tpu_torch.device import (PinnedStager, mark_ready,
                                       resolve_device, to_host)
from mcan_vqa_tpu_torch.ops import library  # noqa: F401 (registers the ops)

FORMAT_VERSION = 1
PROGRAM = "torch.export"

# npz has no bfloat16: such leaves are stored as same-width integer views
_VIEW_DTYPES = {torch.bfloat16: (torch.int16, np.uint16)}


class _Leaf:
    """The place of a tensor leaf in the flattened tree: its input index."""

    def __init__(self, index: int):
        self.index = index


class _Program(torch.nn.Module):
    """forward(leaves, img, ques) -> sigmoid(engine(tree, img, ques)): the
    tree rebuilt from its spec, the tensor inputs in the tensors' places
    and the baked non-tensor leaves in theirs. The engine is held in a
    tuple, so no module of it registers here: its weights stay inputs."""

    def __init__(self, engine, spec, slots):
        super().__init__()
        self._engine = (engine,)
        self._spec = spec
        self._slots = slots

    def forward(self, leaves: List[torch.Tensor], img: torch.Tensor,
                ques: torch.Tensor) -> torch.Tensor:
        tree = pytree.tree_unflatten(
            [leaves[s.index] if isinstance(s, _Leaf) else s
             for s in self._slots], self._spec)
        return torch.sigmoid(self._engine[0](tree, img, ques).float())


def _flatten(forward, prepared):
    """The live engine -> (engine(tree, img, ques), tree spec, slots, the
    distinct tensor leaves in input order). The plain engine's prepared
    object is the MCANet module: its tree is its parameters and buffers,
    run by ``functional_call``."""
    if isinstance(prepared, torch.nn.Module):
        module = prepared
        tree = {k: v.detach() for k, v in module.state_dict(
            keep_vars=True).items()}

        def engine(t, img, ques):
            return torch.func.functional_call(module, t, (img, ques))
    else:
        tree, engine = prepared, forward
    flat, spec = pytree.tree_flatten(tree)
    slots, leaves, seen = [], [], {}
    for leaf in flat:
        if isinstance(leaf, torch.Tensor):
            if id(leaf) not in seen:
                seen[id(leaf)] = len(leaves)
                leaves.append(leaf)
            slots.append(_Leaf(seen[id(leaf)]))
        else:
            slots.append(leaf)
    return engine, spec, slots, leaves


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _leaves_to_npz(leaves) -> Dict[str, np.ndarray]:
    arrays = {}
    for i, leaf in enumerate(leaves):
        t = leaf.detach().cpu()
        view = _VIEW_DTYPES.get(t.dtype)
        arrays[f"p{i}"] = (t.view(view[0]).numpy().view(view[1]) if view
                           else t.numpy())
    return arrays


def _leaves_from_npz(npz, dtypes: Sequence[str], strides, device
                     ) -> List[torch.Tensor]:
    """Each leaf on the device in the dtype, shape and strides it was
    traced with (the kernels read some weights K-major: their strides are
    part of what the program was traced on)."""
    out = []
    for i, (name, stride) in enumerate(zip(dtypes, strides)):
        a = npz[f"p{i}"]
        dt = getattr(torch, name)
        src = torch.from_numpy(np.array(a))
        if dt in _VIEW_DTYPES:
            src = src.view(_VIEW_DTYPES[dt][0]).view(dt)
        dst = torch.empty_strided(tuple(a.shape), tuple(stride), dtype=dt,
                                  device=device)
        out.append(dst.copy_(src))
    return out


def _example(leaf: torch.Tensor) -> torch.Tensor:
    """An input of the leaf's dtype, shape, strides and device to trace
    with (a calibrated tree's leaves may be inference tensors)."""
    return torch.empty_strided(tuple(leaf.shape), tuple(leaf.stride()),
                               dtype=leaf.dtype, device=leaf.device)


def save_artifact(predictor, path: str) -> None:
    """Export ``predictor``'s live engine to a self-describing directory:
    one program per bucket (``predictor.buckets``, ``max_batch`` last), so
    the loaded artifact routes requests as the live Predictor does. The
    (engines, routes) handle is read once, so an online-calibration swap
    during the export cannot tear the artifact across two engines."""
    if predictor.mesh is not None:
        raise ValueError(
            "cannot export a mesh-built Predictor: artifacts are "
            "single-device programs (the loader runs on any one-card "
            "host). Build a Predictor without mesh= for export; deploy "
            "the artifact per card and shard requests at the frontend")
    live, routes = predictor._live
    (forward, prepared), = live["base"]
    engine, spec, slots, leaves = _flatten(forward, prepared)
    program = _Program(engine, spec, slots)
    examples = [_example(leaf) for leaf in leaves]
    cfg, dev = predictor.cfg, predictor.device
    os.makedirs(path, exist_ok=True)
    forwards = {}
    for bucket in predictor.buckets:
        img = torch.zeros((bucket, cfg.img_feat_pad_size, cfg.img_feat_size),
                          dtype=torch.float32, device=dev)
        ques = torch.zeros((bucket, cfg.max_token), dtype=torch.int32,
                           device=dev)
        exported = torch.export.export(program, (examples, img, ques))
        name = f"forward_b{bucket}.pt2"
        torch.export.save(exported, os.path.join(path, name))
        forwards[str(bucket)] = name
    np.savez(os.path.join(path, "params.npz"), **_leaves_to_npz(leaves))
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(predictor.token_to_ix, f)
    with open(os.path.join(path, "answers.json"), "w") as f:
        json.dump({str(k): v for k, v in predictor.ix_to_ans.items()}, f)
    meta = {
        "format_version": FORMAT_VERSION,
        "engine": predictor.engine,
        "buckets": [int(b) for b in predictor.buckets],
        "forwards": forwards,
        "max_token": int(cfg.max_token),
        "img_feat_pad_size": int(cfg.img_feat_pad_size),
        "img_feat_size": int(cfg.img_feat_size),
        "leaf_dtypes": [_dtype_name(l.dtype) for l in leaves],
        "leaf_strides": [list(l.stride()) for l in leaves],
        "routes": {str(b): r for b, r in routes.items()},
        "program": PROGRAM,
        "device": dev.type,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _read_meta(path: str) -> dict:
    if glob.glob(os.path.join(path, "forward_b*.shlo")):
        raise ValueError(
            f"{path} is a JAX artifact (jax.export StableHLO programs): "
            f"load it with mcan_vqa_tpu.artifact; the port loads the "
            f"torch.export artifacts of Predictor.export_artifact")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"artifact format {meta.get('format_version')} "
                         f"not in supported ({FORMAT_VERSION},)")
    if meta.get("program") != PROGRAM:
        raise ValueError(f"artifact program {meta.get('program')!r}: "
                         f"expected {PROGRAM!r}")
    return meta


class ArtifactPredictor:
    """Serve from an artifact directory, without the model code: the
    request API of ``Predictor`` (``predict_probs`` / ``predict_probs_async``
    / ``answer`` / ``topk``, latency-bucket padding), each bucket's forward
    the loaded program. ``device`` ("cuda" by default) must be the device
    the artifact was exported on."""

    def __init__(self, path: str, device="cuda"):
        meta = _read_meta(path)
        dev = resolve_device(device)
        if meta["device"] != dev.type:
            raise ValueError(
                f"the artifact at {path} was exported on {meta['device']!r} "
                f"and runs only there: it cannot be loaded on "
                f"{dev.type!r}")
        self.meta = meta
        self.device = dev
        with open(os.path.join(path, "vocab.json")) as f:
            self.token_to_ix = json.load(f)
        with open(os.path.join(path, "answers.json")) as f:
            self.ix_to_ans = json.load(f)
        with np.load(os.path.join(path, "params.npz")) as npz:
            self._leaves = _leaves_from_npz(npz, meta["leaf_dtypes"],
                                            meta["leaf_strides"], dev)
        self.buckets: Tuple[int, ...] = tuple(meta["buckets"])
        self.max_batch = self.buckets[-1]
        self.routes = {int(b): r for b, r in meta["routes"].items()}
        self._fns = {
            b: torch.export.load(os.path.join(
                path, meta["forwards"][str(b)])).module()
            for b in self.buckets}
        self._stager = PinnedStager()

    @property
    def img_feat_size(self) -> int:
        """Per-region feature width F a request row must have."""
        return int(self.meta["img_feat_size"])

    def predict_probs(self, questions: Sequence[str],
                      image_features) -> np.ndarray:
        """As ``Predictor.predict_probs``: an [N, R, F] array or N ragged
        [R_i, F] arrays -> probabilities [N, answers]."""
        return to_host(*self.predict_probs_async(questions, image_features))

    def predict_probs_async(self, questions: Sequence[str], image_features
                            ) -> Tuple[torch.Tensor, int]:
        """Host prep and dispatch only -> (device_probs, n), as
        ``Predictor.predict_probs_async``."""
        n = len(questions)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} outside (0, {self.max_batch}]")
        if len(image_features) != n:
            raise ValueError(f"{n} questions but {len(image_features)} "
                             f"feature blocks")
        m = self.meta
        ques, img = prep_request_inputs(
            questions, image_features, self.token_to_ix, m["max_token"],
            m["img_feat_pad_size"])
        bucket = next(b for b in self.buckets if b >= n)
        img, ques = pad_to_bucket(img, ques, bucket)
        return mark_ready(self.forward_padded(img, ques)), n

    def forward_padded(self, img: np.ndarray, ques: np.ndarray
                       ) -> torch.Tensor:
        """The bucket's program on an already padded batch (img [B, R, F]
        f32, ques [B, T] int32, B a bucket) -> probabilities [B, answers]
        on the device, not synchronised; the inputs go to the card
        through pinned buffers without blocking."""
        with torch.inference_mode():
            return self._fns[img.shape[0]](
                self._leaves, self._stager.to_device(img, self.device),
                self._stager.to_device(ques, self.device))

    def answer(self, questions: Sequence[str],
               image_features) -> List[Tuple[str, float]]:
        """Top-1 answer string and its probability per question."""
        probs = self.predict_probs(questions, image_features)
        return [topk_answers(row, self.ix_to_ans, 1)[0] for row in probs]

    def topk(self, questions: Sequence[str], image_features,
             k: int = 5) -> List[List[Tuple[str, float]]]:
        """Top-k (answer, probability) pairs per question, highest first."""
        probs = self.predict_probs(questions, image_features)
        return [topk_answers(row, self.ix_to_ans, k) for row in probs]


def load_artifact(path: str, device="cuda") -> ArtifactPredictor:
    return ArtifactPredictor(path, device=device)
