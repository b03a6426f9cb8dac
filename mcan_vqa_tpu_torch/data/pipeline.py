"""Host -> device batches (mcan_vqa_tpu/data/pipeline.py::BatchLoader).

A worker thread assembles the next batch from ``dataset.example(i)``
while the current one trains; each array is copied into pinned host memory
and on to the device with ``non_blocking=True``, so the copy overlaps the
work already queued on the card. Training semantics of the reference
loader (core/data/load_data.py:267-300): shuffle with a seed per epoch,
drop the last partial batch.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

DEVICE_KEYS = ("img", "ques", "target")


class BatchLoader:
    def __init__(self, dataset, batch_size: int, device, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 444):
        """device: where the batches go (a torch.device or its name)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """The epoch the next ``__iter__`` shuffles with."""
        self._epoch = epoch

    def _index_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    def _assemble(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        examples = [self.dataset.example(int(i)) for i in indices]
        return {k: np.stack([e[k] for e in examples]) for k in DEVICE_KEYS}

    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        pin = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if pin:
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        epoch = self._epoch
        self._epoch = epoch + 1
        order = self._index_order(epoch)
        bs = self.batch_size
        slices = [order[i * bs:(i + 1) * bs] for i in range(len(self))]
        with ThreadPoolExecutor(1) as pool:
            pending = pool.submit(self._assemble, slices[0]) if slices \
                else None
            for i in range(len(slices)):
                batch = pending.result()
                if i + 1 < len(slices):
                    pending = pool.submit(self._assemble, slices[i + 1])
                yield self._to_device(batch)
