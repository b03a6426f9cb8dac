"""Where the port's entry points run: the CUDA device unless the caller
asks for the CPU by name; and how a request batch gets onto the card and
its answers back (``PinnedStager``, ``mark_ready``, ``to_host``)."""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` (None means "cuda") -> a torch.device. Raises when it
    names a CUDA device and none is present: the port never moves to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev


# ---------------------------------------------------------------------------
# request batches onto the card and answers back, without blocking the
# dispatching thread on the device
# ---------------------------------------------------------------------------

class _Slot:
    """One pinned host buffer, the event behind the copy that read it last
    (None before its first copy) and the lock of the dispatch using it."""

    def __init__(self, shape, dtype):
        self.buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.copied: Optional[torch.cuda.Event] = None
        self.lock = threading.Lock()


STAGING_DEPTH = 4   # pinned buffers a shape: two groups in flight, and spare


class PinnedStager:
    """Host-to-device copies of request batches through pinned buffers:
    ``to_device`` copies the array into the next pinned buffer of its
    shape and enqueues the device copy with ``non_blocking=True``, so the
    caller returns before the copy (and the forward behind it) ends. A
    pageable copy would synchronise the stream, making the dispatch of
    batch N + 1 wait for batch N's forward. Each shape has a ring of
    ``STAGING_DEPTH`` buffers, deeper than the batching frontend's handoff
    queue (two groups in flight); a buffer is written again only after
    the event recorded behind its last copy has completed, so a caller
    that runs more copies ahead waits for the oldest one. On the CPU the
    array is wrapped as it is."""

    def __init__(self):
        self._rings = {}
        self._lock = threading.Lock()

    def _next(self, shape, dtype) -> _Slot:
        with self._lock:
            ring = self._rings.setdefault((shape, dtype), [[], 0])
            slots, turn = ring
            if len(slots) < STAGING_DEPTH:
                slots.append(_Slot(shape, dtype))
            ring[1] = turn + 1
            return slots[turn % STAGING_DEPTH]

    def to_device(self, arr: np.ndarray, dev: torch.device) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dev.type != "cuda":
            return t.to(dev)
        slot = self._next(tuple(t.shape), t.dtype)
        with slot.lock:
            if slot.copied is not None:
                slot.copied.synchronize()
            slot.buf.copy_(t)
            with torch.cuda.device(dev):
                out = slot.buf.to(dev, non_blocking=True)
                slot.copied = torch.cuda.Event()
                slot.copied.record()
        return out


def mark_ready(t: torch.Tensor) -> torch.Tensor:
    """Record an event behind the work that produces t on its device's
    current stream, for ``to_host`` to wait on: t's own forward, not the
    ones enqueued after it."""
    if t.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        t._mcan_ready = ready
    return t


_COPY_STREAMS = {}


def to_host(t, n: int) -> np.ndarray:
    """The first n rows of a forward's output as a numpy array: a CUDA
    tensor marked by ``mark_ready`` is copied on a stream of its own once
    its event completes, so the copy waits for that forward alone and not
    for batches dispatched after it on the compute stream. Anything else
    (a CPU tensor, an array-like) is converted as it is."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)[:n]
    ready = getattr(t, "_mcan_ready", None)
    if ready is None:
        return t[:n].cpu().numpy()
    stream = _COPY_STREAMS.get(t.device)
    if stream is None:
        stream = _COPY_STREAMS.setdefault(t.device,
                                          torch.cuda.Stream(t.device))
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        return t[:n].cpu().numpy()
