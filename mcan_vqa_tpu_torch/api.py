"""Serving API: weights in, answer strings out (mcan_vqa_tpu/api.py).

    from mcan_vqa_tpu_torch.api import Predictor
    p = Predictor.from_checkpoint("epoch13.pkl", Config(), token_to_ix)
    answers = p.answer(["what color is the cat?"], image_features)

Engines:
  * "fused" (and "auto"): ``ops/serving.build_production_engine(qffn=None)``,
    the JAX package's shipped engine: int8 level 1 (dynamic activation
    scales) until calibrated, then level 3 (every projection int8, static
    scales); every backbone block through the hand-written quantized block
    kernels on the card (their plain versions on the CPU);
  * "int4": the same, but qffn level 5 once calibrated (the FFN and qkv
    weights nibble-packed int4 with 128-row group scales);
  * "int8": the full-int8 engine (``ops/serving.quantize_params`` +
    ``make_quant_serving_fn``): every product int8 with dynamic per-row
    scales, an f32 stream, no calibration;
  * "plain": ``models/net.MCANet`` op by op, the numerics of the JAX
    ``model.apply``.

At a width outside ``megakernel_vmem_ok`` (hidden ~1340 and past at
F = 4 D) "fused" and "int4" serve the per-sub-op path in bf16 as the JAX
Predictor does (``sga_mode`` 2 falls back to 0): the merges and FFNs on
``gemm_ln``, the attention and AttFlat plain; a calibration source, and
the online calibration's rebuild, are then ignored with JAX's warning.
``q8aux=True`` adds the static-int8 aux sites (cross k/v, AttFlat merges,
answer head) to the calibrated "fused" / "int4" engines. A request batch
pads to the smallest bucket that fits (``latency_buckets`` plus
``max_batch``), as in the JAX Predictor, so the kernels always see the
shapes they were measured at.

``mesh`` (``parallel/mesh.py::make_mesh(shape, devices=[...])``) serves
pure data parallelism in one process, where the JAX Predictor is one
controller over its chips (api.py:296-315, :516-541): every engine is
built once per mesh device, its prepared params on that device; a padded
bucket is split into equal row slices, each slice runs on its device, and
the results are concatenated in order. The online calibration's rebuild
swaps every replica at once.

``predict_probs_async`` dispatches without waiting for the card (the
inputs through pinned buffers, ``device.PinnedStager``), which the
batching frontend (batching.py) pipelines on; ``export_artifact`` freezes
the live engine into a serving artifact (artifact.py).
"""

from __future__ import annotations

import contextlib
import copy
import threading
import warnings
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data import (load_answer_dict, pad_to_bucket,
                                     prep_request_inputs, topk_answers)
from mcan_vqa_tpu_torch.device import (PinnedStager, mark_ready,
                                       resolve_device, to_host)
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops.serving import (build_production_engine,
                                            calibrate_serving_scales,
                                            make_quant_serving_fn,
                                            quantize_params)
from mcan_vqa_tpu_torch.train.checkpoint import (load_act_scales,
                                                 load_reference_checkpoint)

ENGINES = ("fused", "plain", "int8", "int4")


class Predictor:
    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 token_to_ix: Dict[str, int],
                 ix_to_ans: Optional[Dict[str, str]] = None,
                 max_batch: int = 64, engine: str = "auto",
                 latency_buckets: Optional[Sequence[int]] = None,
                 device="cuda", mesh=None, act_calibration=None,
                 act_scales=None, auto_calibrate: int = 256,
                 q8aux: bool = False):
        """state_dict: reference-shaped MCANet weights
        (``MCANet.state_dict()``, ``train/checkpoint.py``).

        max_batch / latency_buckets: the batch shapes served; a request of
        n rows pads to the smallest bucket >= n.

        engine: "fused" | "int4" | "int8" | "plain" | "auto" (= "fused" on
        every device). device: where the engine runs, "cuda" by default;
        with no CUDA device it raises unless the caller passes
        device="cpu".

        act_calibration: optional (questions, image_features) batch for the
        fused / int4 engine: static activation scales are calibrated on it
        and the level-3 (int4: level-5) engine is built at once.
        act_scales: precomputed scales ({"enc_i" / "dec_i": tuple of
        floats}, e.g. a calibrated Predictor's ``act_scales``); False means
        None. The two are mutually exclusive.

        auto_calibrate: online calibration of the fused / int4 engine (the
        default, 256). It serves level 1 from the first request, buffers
        the first ``auto_calibrate`` finite real rows (bucket padding is
        never collected), then a background thread calibrates on them,
        builds the calibrated engine, runs every bucket once and swaps it
        in atomically. A failed attempt returns to collecting with a
        doubled target and reports the error in ``calibration``. 0
        disables it; it is off when a calibration source is given.
        engine="int4" and q8aux=True need a calibration source.

        q8aux: the static-int8 aux sites in the calibrated engine (they
        activate with calibration, as int4 does). Under engine="auto" a
        calibration batch is replayed twice, as the JAX router does
        (api.py:474): the block scales on the bf16 cross k/v, the "aux"
        tuple with the aux sites attached.

        ``routes`` maps every bucket to "base": the JAX router's int4 and
        q8aux buckets (api.py:36-52) rest on TPU measurements, and until
        the port measures its own table ``engine="auto"`` serves its one
        engine in every bucket.

        mesh: a pure data-parallel serving mesh (``make_mesh({"data": n},
        devices=[...])``; a device may repeat): one replica of every
        engine per device, each bucket split over them; every bucket must
        divide by n (JAX's checks, api.py:303-313). ``device`` is then the
        mesh's first device."""
        requested = engine
        if engine == "auto":
            engine = "fused"
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}: expected one of "
                             f"{ENGINES + ('auto',)}")
        if act_scales is False:
            act_scales = None
        if auto_calibrate < 0:
            raise ValueError(
                f"auto_calibrate must be >= 0, got {auto_calibrate}")
        if act_calibration is not None and act_scales is not None:
            raise ValueError(
                "pass a calibration batch OR precomputed scales, not both")
        pre_calibrated = act_calibration is not None or act_scales is not None
        fused = engine in ("fused", "int4")
        if q8aux and not fused:
            raise ValueError(
                f"q8aux applies to the fused/int4 engines (their calibrated "
                f"int8 sites), got engine={engine!r}")
        if engine == "int4" and not pre_calibrated and not auto_calibrate:
            raise ValueError(
                'engine="int4" needs calibration: pass '
                "act_calibration/act_scales or leave auto_calibrate on")
        if q8aux and not pre_calibrated and not auto_calibrate:
            raise ValueError(
                "q8aux needs calibration: pass act_calibration/act_scales "
                '(with an "aux" tuple) or leave auto_calibrate on')
        if pre_calibrated and not fused:
            what = ("act_calibration" if act_calibration is not None
                    else "act_scales")
            raise ValueError(f"{what} requires engine='fused' (or 'auto'), "
                             f"got engine={engine!r}")
        buckets = sorted(set(latency_buckets or ()))
        if not all(0 < b <= max_batch for b in buckets):
            raise ValueError(
                f"latency_buckets must be in (0, max_batch]: {buckets}")
        if mesh is not None:
            if mesh.tp != 1:
                raise ValueError(
                    f"serving mesh must be pure data-parallel: {mesh.shape}")
            if not mesh.devices:
                raise ValueError(
                    "a serving mesh lists its devices: make_mesh(shape, "
                    "devices=[...]) (one process, a replica per device)")
            bad = [b for b in set(buckets) | {max_batch} if b % mesh.size]
            if bad:
                raise ValueError(
                    f"every compiled bucket must divide over the "
                    f"{mesh.size}-device mesh: {sorted(bad)}")
            self.devices = mesh.devices
        else:
            self.devices = (resolve_device(device),)
        self.mesh = mesh
        self._stager = PinnedStager()
        self.cfg = cfg
        self.engine = engine
        self.device = self.devices[0]
        self.token_to_ix = token_to_ix
        if ix_to_ans is None:
            _, ix_to_ans = load_answer_dict()
        self.ix_to_ans = ix_to_ans
        self.max_batch = max_batch
        self.buckets = tuple(b for b in buckets if b < max_batch) \
            + (max_batch,)

        self._auto_routing = requested == "auto"
        self._qffn_level = 5 if engine == "int4" else None
        self._q8aux = bool(q8aux)
        if fused:
            act_inputs = None
            if act_calibration is not None:
                ques, img = self._prep_inputs(*act_calibration)
                act_inputs = (img, ques)
            if requested == "auto" and not pre_calibrated \
                    and not auto_calibrate:
                warnings.warn(
                    "engine='auto' has no calibration source "
                    "(act_calibration/act_scales absent, auto_calibrate "
                    "off): serving stays on the dynamic int8 engine, not "
                    "the calibrated level-3 engine")
            self._install([self._build_engines(state_dict, act_inputs,
                                               act_scales, dev)
                           for dev in self.devices])
        elif engine == "int8":
            self._install([(make_quant_serving_fn(cfg.layer, cfg.multi_head),
                            quantize_params(state_dict, cfg.layer, dev))
                           for dev in self.devices])
        else:
            model = MCANet(cfg, token_size=len(token_to_ix),
                           answer_size=len(self.ix_to_ans))
            model.load_state_dict(state_dict, strict=True)
            model.eval()
            replicas = [model] + [copy.deepcopy(model)
                                  for _ in self.devices[1:]]
            self._install([(lambda m, img, ques: m(img, ques), m.to(dev))
                           for m, dev in zip(replicas, self.devices)])

        # --- online calibration state (api.py:564-722) ------------------
        self._cal_error: Optional[BaseException] = None
        self._cal_thread: Optional[threading.Thread] = None
        self._cal_lock = threading.Lock()
        self._cal_imgs: Optional[list] = []
        self._cal_ques: Optional[list] = []
        self._cal_n = 0
        if fused and not pre_calibrated and auto_calibrate:
            self._auto_cal = int(auto_calibrate)
            self._raw_state = state_dict     # for the calibrated rebuild
            self._cal_state = "collecting"
        else:
            self._auto_cal = 0
            self._raw_state = None
            self._cal_state = "calibrated" if pre_calibrated else "off"

    # ------------------------------------------------------------------
    # engines

    def _build_fused(self, state_dict, act_inputs, act_scales, device):
        """-> (forward, prepared) of the shipped engine on ``device``: level
        1 without calibration; with a calibration batch or scales level 3,
        or the int4 engine's level 5, and the aux sites when asked for."""
        calibrated = act_inputs is not None or act_scales is not None
        return build_production_engine(
            state_dict, self.cfg.layer, self.cfg.multi_head,
            qffn=self._qffn_level if calibrated else None,
            q8aux=self._q8aux and calibrated, act_scale_inputs=act_inputs,
            act_scales=act_scales, device=device)

    def _build_engines(self, state_dict, act_inputs, act_scales, device):
        """The fused path's engine (api.py:420): explicit engines take one
        calibration replay inside ``build_production_engine``; "auto" with
        q8aux derives its scales first from the batch in two passes
        (``calibrate_serving_scales``: the block scales on the bf16 cross
        k/v path of a level-3 tree, then the "aux" tuple), as the JAX
        router's ``_calibrate_scales(need_aux=True)`` does (api.py:474).
        At a width outside the megakernel envelope that gives None: the
        build then warns and serves the per-sub-op path uncalibrated, as
        in JAX. Every bucket routes to the engine. One replica, on
        ``device``: a mesh calls this once per device, each replica
        calibrating on the same batch."""
        if self._auto_routing and self._q8aux and act_inputs is not None:
            img, ques = act_inputs
            shared = calibrate_serving_scales(
                state_dict, img, ques, self.cfg.layer, self.cfg.multi_head,
                device)
            if shared is not None:
                act_scales, act_inputs = shared, None
        return self._build_fused(state_dict, act_inputs, act_scales, device)

    def _install(self, replicas) -> None:
        """Swap an engine in, one (forward, prepared) replica per device:
        one atomic handle holds the replicas and the routes together, so
        a concurrent request never pairs a new route with an old engine
        (or one replica's engine with another's)."""
        self.params = replicas[0][1]
        self._live = ({"base": list(replicas)},
                      {b: "base" for b in self.buckets})

    @property
    def routes(self) -> Dict[int, str]:
        """The live bucket -> engine table (every bucket "base")."""
        return dict(self._live[1])

    @property
    def img_feat_size(self) -> int:
        """Per-region feature width F a request row must have."""
        return int(self.cfg.img_feat_size)

    @property
    def act_scales(self) -> Optional[Dict[str, tuple]]:
        """The static activation scales the live engine bakes in, or None
        (dynamic scales, or the plain engine)."""
        return getattr(self._live[0]["base"][0][0], "act_scales", None)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Config,
                        token_to_ix: Dict[str, int],
                        ix_to_ans: Optional[Dict[str, str]] = None,
                        act_scales=None, **kwargs) -> "Predictor":
        """path: a reference pickle (.pkl / .pt / .pth). act_scales: None
        loads the static activation scales the Trainer calibrated at the
        end of training, from the side file beside the pickle
        (``epoch<N>.act_scales.json``, ``train/checkpoint.py::
        save_act_scales``), when the engine takes them ("fused", "int4", or
        "auto", which is "fused" in the port) and no act_calibration is
        given, so the checkpoint serves its calibrated engine (level 3,
        int4: level 5) from the first request, as the JAX
        ``from_checkpoint`` does for its native checkpoint (api.py:742-786);
        without a side file it serves as ``Predictor`` does (level 1, then
        online calibration). False declines the side file; a dict is used
        as it is. kwargs as for ``Predictor``."""
        if not path.endswith((".pkl", ".pt", ".pth")):
            raise NotImplementedError(
                f"{path}: only reference pickles load into the port so far "
                f"(orbax checkpoints: convert with state_dict_from_params)")
        if act_scales is None and kwargs.get("act_calibration") is None \
                and kwargs.get("engine", "auto") in ("fused", "int4",
                                                     "auto"):
            act_scales = load_act_scales(path)
        return cls(cfg, load_reference_checkpoint(path), token_to_ix,
                   ix_to_ans, act_scales=act_scales, **kwargs)

    # ------------------------------------------------------------------
    # online calibration

    @property
    def calibration(self) -> Dict[str, object]:
        """state in {"off", "collecting", "paused", "calibrating",
        "calibrated"}, the rows buffered and the target; after a failed
        attempt (state "collecting" again) also "error"."""
        out = {"state": self._cal_state, "samples": self._cal_n,
               "target": self._auto_cal}
        if self._cal_error is not None:
            out["error"] = str(self._cal_error)
        return out

    def calibration_paused(self):
        """Context manager that stops collecting calibration rows, for
        traffic that is not representative (warm-up batches)."""
        @contextlib.contextmanager
        def _pause():
            with self._cal_lock:
                resume = self._cal_state == "collecting"
                if resume:
                    self._cal_state = "paused"
            try:
                yield
            finally:
                if resume:
                    with self._cal_lock:
                        if self._cal_state == "paused":
                            self._cal_state = "collecting"
        return _pause()

    def wait_calibrated(self, timeout: Optional[float] = None) -> bool:
        """Block until a started background calibration attempt ends
        (True) or ``timeout`` seconds pass (False). True means the attempt
        ended, not that it succeeded: see ``calibration``."""
        t = self._cal_thread
        if t is not None:
            t.join(timeout)
            return not t.is_alive()
        return self._cal_state == "calibrated"

    def calibrate_now(self) -> None:
        """Calibrate on the rows buffered so far (at least one),
        synchronously; raises if that fails."""
        with self._cal_lock:
            if self._cal_state != "collecting":
                raise RuntimeError(
                    f"calibration is {self._cal_state!r}, not collecting")
            if not self._cal_n:
                raise RuntimeError("no calibration samples buffered yet")
            img, ques = self._drain_buffer_locked()
        self._recalibrate(img, ques, reraise=True)

    def _drain_buffer_locked(self):
        img = np.concatenate(self._cal_imgs)[:self._auto_cal]
        ques = np.concatenate(self._cal_ques)[:self._auto_cal]
        self._cal_imgs = self._cal_ques = None
        self._cal_state = "calibrating"
        return img, ques

    def _collect_calibration(self, ques: np.ndarray, img: np.ndarray):
        """Buffer a request's real, finite rows; start the background
        rebuild once the target is reached."""
        finite = np.isfinite(img).all(axis=tuple(range(1, img.ndim)))
        if not finite.all():
            ques, img = ques[finite], img[finite]
        if not len(img):
            return
        with self._cal_lock:
            if self._cal_state != "collecting":
                return
            self._cal_imgs.append(img)
            self._cal_ques.append(ques)
            self._cal_n += len(img)
            if self._cal_n < self._auto_cal:
                return
            img_cal, ques_cal = self._drain_buffer_locked()
            self._cal_thread = threading.Thread(
                target=self._recalibrate, args=(img_cal, ques_cal),
                name="predictor-calibration", daemon=True)
        self._cal_thread.start()

    def _recalibrate(self, img_cal: np.ndarray, ques_cal: np.ndarray,
                     reraise: bool = False) -> None:
        """Build the calibrated engine, run every bucket once, then swap it
        in. Runs off the serving thread; requests keep the level-1 engine
        until the swap. inference_mode is per thread, so it is entered
        here as well."""
        try:
            with torch.inference_mode():
                replicas = [self._build_engines(
                    self._raw_state, (img_cal, ques_cal), None, dev)
                    for dev in self.devices]
                cfg = self.cfg
                for (fwd, prepared), dev in zip(replicas, self.devices):
                    for b in self.buckets:
                        rows = b // len(self.devices)
                        fwd(prepared,
                            torch.zeros((rows, cfg.img_feat_pad_size,
                                         cfg.img_feat_size), device=dev),
                            torch.zeros((rows, cfg.max_token),
                                        dtype=torch.int32, device=dev))
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
            self._install(replicas)
            self._cal_state = "calibrated"
            self._cal_error = None
            self._raw_state = None
        except Exception as e:  # noqa: BLE001 -- serving goes on
            with self._cal_lock:
                self._cal_error = e
                self._cal_imgs = [img_cal]
                self._cal_ques = [ques_cal]
                self._cal_n = len(img_cal)
                self._auto_cal = max(self._auto_cal * 2, self._cal_n + 1)
                self._cal_state = "collecting"
            if reraise:
                raise
            warnings.warn(f"online calibration failed; serving stays on "
                          f"the dynamic int8 engine (will retry at "
                          f"{self._auto_cal} samples): {e!r}")

    # ------------------------------------------------------------------
    # requests

    def bucket_for(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def _prep_inputs(self, questions: Sequence[str], image_features
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenise and pad the regions -> (ques [N, T] int32, img
        [N, pad, F] f32), the rows that calibration collects."""
        n = len(questions)
        if len(image_features) != n:
            raise ValueError(f"{n} questions but {len(image_features)} "
                             f"feature blocks")
        return prep_request_inputs(questions, image_features,
                                   self.token_to_ix, self.cfg.max_token,
                                   self.cfg.img_feat_pad_size)

    def pad_batch(self, questions: Sequence[str], image_features
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenise and pad a request batch to its bucket -> (img
        [bucket, pad, F] f32, ques [bucket, T] int32), the inputs of
        ``forward_padded``. Collects nothing for calibration."""
        n = len(questions)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} outside (0, {self.max_batch}]")
        ques, img = self._prep_inputs(questions, image_features)
        return pad_to_bucket(img, ques, self.bucket_for(n))

    def forward_padded(self, img: np.ndarray, ques: np.ndarray
                       ) -> torch.Tensor:
        """One forward on an already padded batch -> probabilities
        [bucket, A] on the engine's (the mesh's first) device, not
        synchronised: the inputs go to the card through pinned buffers
        without blocking (``device.PinnedStager``). On a mesh each replica
        takes its equal row slice on its device, the slices launched one
        after the other and concatenated in order. inference_mode is per
        thread, so it is entered here, on the dispatching thread."""
        live, routes = self._live
        replicas = live[routes[self.bucket_for(img.shape[0])]]
        if img.shape[0] % len(replicas):
            raise ValueError(f"{img.shape[0]} rows do not split over the "
                             f"{len(replicas)}-device mesh: pad to a bucket")
        rows = img.shape[0] // len(replicas)
        out = []
        with torch.inference_mode():
            for i, ((forward, params), dev) in enumerate(
                    zip(replicas, self.devices)):
                sl = slice(i * rows, (i + 1) * rows)
                img_t = self._stager.to_device(img[sl], dev)
                ques_t = self._stager.to_device(ques[sl], dev)
                out.append(torch.sigmoid(
                    forward(params, img_t, ques_t).float()))
            if len(out) == 1:
                return out[0]
            return torch.cat([o.to(self.device) for o in out])

    def predict_probs(self, questions: Sequence[str],
                      image_features) -> np.ndarray:
        """questions: N strings; image_features: [N, R<=pad, F] or N
        per-image [R_i, F] arrays (zero rows are padding).
        Returns probabilities [N, answer_size]."""
        return to_host(*self.predict_probs_async(questions, image_features))

    def predict_probs_async(self, questions: Sequence[str], image_features
                            ) -> Tuple[torch.Tensor, int]:
        """Host prep and dispatch only (mcan_vqa_tpu/api.py:798) ->
        (device_probs, n): the bucket's probabilities on the device, not
        synchronised; the calibration rows are collected as by
        ``predict_probs``. The caller
        prepares and dispatches the next batch while the card computes
        this one (the batching frontend pipelines on it);
        ``device.to_host(device_probs, n)`` waits for this forward alone
        and gives what ``predict_probs`` returns."""
        n = len(questions)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} outside (0, {self.max_batch}]")
        ques, img = self._prep_inputs(questions, image_features)
        if self._cal_state == "collecting":
            self._collect_calibration(ques, img)
        img, ques = pad_to_bucket(img, ques, self.bucket_for(n))
        return mark_ready(self.forward_padded(img, ques)), n

    def export_artifact(self, path: str) -> None:
        """Freeze the engine live at the time of the call into a serving
        artifact directory (artifact.py: one ``torch.export`` program per
        bucket, the weights once, vocabulary and answers), which
        ``artifact.load_artifact`` serves without the model code. Export
        after the online calibration swap (``wait_calibrated()`` /
        ``calibrate_now()``) to ship the calibrated engine. A mesh
        Predictor is refused."""
        from mcan_vqa_tpu_torch.artifact import save_artifact
        save_artifact(self, path)

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
