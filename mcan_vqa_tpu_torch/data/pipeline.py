"""Host -> device batches (mcan_vqa_tpu/data/pipeline.py::BatchLoader).

A worker thread assembles the next batch from ``dataset.example(i)``
while the current one runs; each array bound for the card is copied into
pinned host memory and on to the device with ``non_blocking=True``, so
the copy overlaps the work already queued there.

Two forms, as in the JAX loader. Training (the reference's loader,
core/data/load_data.py:267-300): shuffled with a seed per epoch, the last
partial batch dropped, batches of "img", "ques" and "target". Evaluation
(``shuffle=False, drop_last=False``; the reference shuffled and dropped
here too, a quirk not kept): every example once, in order; the batches
also carry on the host "qid", the per-row "valid" mask and "n_valid", and
with ``pad_final=True`` the last batch is repeat-padded to full size, its
padding rows marked not valid.

On a mesh each data rank assembles only its slice of every global batch
(JAX's ``process_index`` / ``process_count``, pipeline.py:32-37, :82-97,
:178-183): rows [lo, lo + per) with per = batch_size / process_count and
lo = process_index x per. The port's "process" is the data index (rank //
tp): the model ranks of one data shard load the same rows. The eval form
pads the global batch first, so every rank's slice has per rows, each
marked valid or not.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np
import torch

DEVICE_KEYS = ("img", "ques", "target")


class BatchLoader:
    def __init__(self, dataset, batch_size: int, device, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 444,
                 pad_final: bool = False, process_index: int = 0,
                 process_count: int = 1):
        """device: where the batches go (a torch.device or its name).
        process_index / process_count: this data rank's slice of every
        global batch of ``batch_size`` rows."""
        if batch_size % max(process_count, 1):
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"{process_count} data ranks")
        if process_count > 1 and not (drop_last or pad_final):
            raise ValueError("a partial last batch cannot split evenly over "
                             "data ranks: use drop_last or pad_final")
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.pad_final = pad_final
        self.process_index = process_index
        self.process_count = process_count
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

    def _slice(self, order: np.ndarray, i: int):
        """This rank's indices of batch i and their valid mask (pad_final:
        the global batch repeats its last index up to batch_size before it
        is split)."""
        sl = order[i * self.batch_size:(i + 1) * self.batch_size]
        n = len(sl)
        if self.pad_final and n < self.batch_size:
            sl = np.concatenate([sl, np.repeat(sl[-1], self.batch_size - n)])
        valid = np.arange(len(sl)) < n
        if self.process_count > 1:
            per = self.batch_size // self.process_count
            lo = self.process_index * per
            sl, valid = sl[lo:lo + per], valid[lo:lo + per]
        return sl, valid

    def _assemble(self, indices: np.ndarray, valid: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        examples = [self.dataset.example(int(i)) for i in indices]
        if self.drop_last:
            return {k: np.stack([e[k] for e in examples])
                    for k in DEVICE_KEYS}
        batch = {k: np.stack([e[k] for e in examples]) for k in examples[0]}
        batch["valid"] = valid
        batch["n_valid"] = np.int32(valid.sum())
        return batch

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        pin = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            if k not in DEVICE_KEYS:
                out[k] = v               # qid, valid, n_valid stay here
                continue
            t = torch.from_numpy(v)
            if pin:
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        epoch = self._epoch
        self._epoch = epoch + 1
        order = self._index_order(epoch)
        slices = [self._slice(order, i) for i in range(len(self))]
        with ThreadPoolExecutor(1) as pool:
            pending = pool.submit(self._assemble, *slices[0]) if slices \
                else None
            for i in range(len(slices)):
                batch = pending.result()
                if i + 1 < len(slices):
                    pending = pool.submit(self._assemble, *slices[i + 1])
                yield self._to_device(batch)
