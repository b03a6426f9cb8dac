"""Dynamic micro-batching frontend for online serving
(mcan_vqa_tpu/batching.py).

Real deployments receive single questions from many concurrent callers;
running each alone wastes the card (the serving forward is host-bound at
small batches, PERF.md §5), while static batching adds queueing latency.
``BatchingFrontend`` is the standard middle ground: a collector thread
groups in-flight requests up to ``max_batch`` or ``max_wait_ms``
(whichever first) and runs ONE forward per group through the wrapped
predictor. With ``Predictor(latency_buckets=...)`` underneath, a lone
request still runs at the small bucket and bursts coalesce toward the
large one.

The frontend is itself a two-stage pipeline: the worker thread
validates, pads and *dispatches* each group (``predict_probs_async``
enqueues the input copies and the forward on the card and returns),
while a resolver thread waits for each group's probabilities
(``device.to_host``: that forward alone) and resolves the futures, so
the host-side prep of group N+1 overlaps the card's compute of group N
instead of adding to it, with a depth-2 handoff queue for backpressure.

Works with any object exposing ``predict_probs(questions, feats)`` and
``ix_to_ans``: ``api.Predictor`` and ``artifact.ArtifactPredictor``
both qualify (their ``predict_probs_async`` enables the overlap; a
predictor without it still works, just unpipelined).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Tuple

import numpy as np

from mcan_vqa_tpu_torch.data.answers import topk_answers
from mcan_vqa_tpu_torch.device import to_host


class FrontendOverloaded(RuntimeError):
    """Raised by submit() when the request queue is at max_queue —
    callers (e.g. the HTTP layer) should shed load, not block."""


def _resolve(fut: Future, result=None, exc=None) -> None:
    """Resolve a future a caller may concurrently cancel. A
    done()/cancelled() pre-check is TOCTOU — a cancel() landing between
    the check and the set raises InvalidStateError, which would kill the
    worker/resolver thread and hang every later request — so resolution
    absorbs that one race instead."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass   # cancelled (or already resolved) by the caller


class BatchingFrontend:
    def __init__(self, predictor, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None,
                 max_queue: Optional[int] = None):
        """max_wait_ms: how long the collector holds an open group for
        more arrivals. 0 disables coalescing-by-time (group = whatever is
        already queued). max_batch defaults to the predictor's.
        max_queue: if set, submit() raises FrontendOverloaded once this
        many requests are already waiting (bounds memory and tail latency
        under overload; None = unbounded)."""
        self._p = predictor
        # duck-type contract (module docstring): any predict_probs +
        # ix_to_ans object qualifies — max_batch is only consulted on
        # the predictor when it exposes one
        p_max = getattr(predictor, "max_batch", None)
        self._max_batch = int(max_batch or p_max or 0)
        assert self._max_batch > 0, \
            "pass max_batch= when the predictor has no max_batch attribute"
        assert p_max is None or self._max_batch <= p_max, \
            (self._max_batch, p_max)
        self._max_queue = None if max_queue is None else int(max_queue)
        assert self._max_queue is None or self._max_queue > 0
        self._max_wait_s = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # Serializes submit's closed-check+put against close's closed-set:
        # every accepted request is enqueued BEFORE the shutdown token, so
        # the worker always processes it (no future left hanging).
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.batches_run = 0
        self.requests_served = 0
        # Submit->resolve wall time of the most recent requests (bounded;
        # includes queueing, coalescing wait, and the device forward).
        self._latencies_s: deque = deque(maxlen=2048)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mcan-batching-frontend")
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, question: str, image_feature: np.ndarray,
               top_k: int = 1) -> Future:
        """Enqueue one request. The future resolves to (answer_str, prob)
        for top_k == 1 (default), or to a list of k such pairs (highest
        first) for top_k > 1."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if (self._max_queue is not None
                    and self._q.qsize() >= self._max_queue):
                raise FrontendOverloaded(
                    f"frontend overloaded: {self._q.qsize()} requests "
                    f"already queued (max_queue={self._max_queue})")
            self._q.put((question, image_feature, fut, time.monotonic(),
                         int(top_k)))
        return fut

    def answer(self, question: str, image_feature: np.ndarray,
               timeout: Optional[float] = None) -> Tuple[str, float]:
        """Blocking single-request convenience."""
        return self.submit(question, image_feature).result(timeout=timeout)

    def close(self) -> None:
        """Drain the queue, stop the worker. Idempotent."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # wake the worker; FIFO: after all accepts
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _collect(self) -> Optional[List[tuple]]:
        """Block for the first request, then hold the group open for
        max_wait_ms (or until max_batch)."""
        first = self._q.get()
        if first is None:
            return None
        group = [first]
        t_end = time.monotonic() + self._max_wait_s
        while len(group) < self._max_batch:
            remaining = t_end - time.monotonic()
            try:
                item = self._q.get(block=remaining > 0,
                                   timeout=max(remaining, 0) or None)
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # keep the shutdown token visible
                break
            group.append(item)
        return group

    def _run(self) -> None:
        """Two pipelined stages. This thread validates, pads, and
        DISPATCHES each group (the input copies and the forward enqueued
        on the card); a resolver thread waits for each group's result and
        resolves the futures. While the card computes group N, this
        thread is already preparing group N+1 — host prep overlaps device
        time instead of adding to it. The bounded handoff queue (depth 2)
        is backpressure: dispatch never runs more than two groups ahead of
        resolution."""
        resolve_q: queue.Queue = queue.Queue(maxsize=2)
        dispatch = getattr(self._p, "predict_probs_async", None)
        resolver = threading.Thread(
            target=self._resolve_loop, args=(resolve_q,), daemon=True,
            name="mcan-batching-resolver")
        resolver.start()
        while True:
            group = self._collect()
            if group is None:
                resolve_q.put(None)
                resolver.join()  # every dispatched future resolves first
                # Fail anything that raced past close() rather than hang
                # its caller forever.
                while not self._q.empty():
                    item = self._q.get_nowait()
                    if item is not None:
                        _resolve(item[2],
                                 exc=RuntimeError("frontend closed"))
                return
            # Validate per item so one malformed request fails its own
            # future without dragging down groupmates or the worker. The
            # features stay a ragged LIST — the predictor pads each
            # [R_i, F] to the model's region count itself.
            feat_width = getattr(self._p, "img_feat_size", None)
            valid = []
            for q, f, fut, _, top_k in group:
                try:
                    arr = np.asarray(f, np.float32)
                    if arr.ndim != 2:
                        raise ValueError(
                            f"image feature must be [regions, feat], "
                            f"got shape {arr.shape}")
                    if feat_width is not None and arr.shape[1] != feat_width:
                        raise ValueError(
                            f"feature width {arr.shape[1]} != model's "
                            f"{feat_width}")
                    valid.append((q, arr, fut, top_k))
                except Exception as e:  # noqa: BLE001
                    _resolve(fut, exc=e)
            payload = None
            if valid:
                qs = [v[0] for v in valid]
                fs = [v[1] for v in valid]
                try:
                    if dispatch is not None:
                        payload = dispatch(qs, fs)  # (device_probs, n)
                    else:
                        probs = self._p.predict_probs(qs, fs)
                        payload = (probs, len(valid))
                except Exception as e:  # noqa: BLE001 — fail the callers, not the loop
                    for item in valid:
                        _resolve(item[2], exc=e)
                    valid = []
            resolve_q.put((valid, payload, group))

    def _resolve_loop(self, resolve_q: queue.Queue) -> None:
        while True:
            item = resolve_q.get()
            if item is None:
                return
            valid, payload, group = item
            probs, err = None, None
            if valid:
                try:
                    dev, n = payload
                    probs = to_host(dev, n)  # waits for this forward
                except Exception as e:  # noqa: BLE001
                    err = e
            # Stats before resolution: a caller woken by its future must
            # never observe counters that don't include its own batch.
            t_done = time.monotonic()
            with self._stats_lock:
                self.batches_run += 1
                self.requests_served += len(group)
                self._latencies_s.extend(t_done - g[3] for g in group)
            if probs is not None:
                for (_, _, fut, top_k), row in zip(valid, probs):
                    pairs = topk_answers(row, self._p.ix_to_ans, top_k)
                    _resolve(fut, pairs[0] if top_k <= 1 else pairs)
            elif err is not None:
                for item in valid:
                    _resolve(item[2], exc=err)

    # ------------------------------------------------------------------
    @property
    def mean_occupancy(self) -> float:
        """Requests per executed batch so far (coalescing effectiveness)."""
        with self._stats_lock:
            return (self.requests_served / self.batches_run
                    if self.batches_run else 0.0)

    def reset_stats(self) -> None:
        """Zero the counters and the latency window (e.g. after warmup)."""
        with self._stats_lock:
            self.batches_run = 0
            self.requests_served = 0
            self._latencies_s.clear()

    def latency_ms(self) -> Dict[str, float]:
        """p50/p95/p99/mean submit->resolve latency (ms) over the most
        recent <=2048 requests. Includes queueing, the coalescing wait,
        and the device forward — the number a caller actually sees."""
        with self._stats_lock:
            lat = np.asarray(self._latencies_s, np.float64)
        if lat.size == 0:
            return {"count": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                    "mean": 0.0}
        q50, q95, q99 = np.quantile(lat, (0.5, 0.95, 0.99)) * 1e3
        return {"count": int(lat.size), "p50": float(q50),
                "p95": float(q95), "p99": float(q99),
                "mean": float(lat.mean() * 1e3)}
