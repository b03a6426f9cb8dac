"""What a train step reads and updates: the model's parameters, the
optimizer, the step count and the dropout generator
(mcan_vqa_tpu/train/train_state.py).

Each step's dropout is a function of the seed and the step count alone,
as JAX's ``fold_in(dropout_rng, step)`` (step.py:118): the step re-seeds
the generator from both (``seed_step``) before it draws, so a run resumed
from a checkpoint, which carries the step count and not the generator,
draws the masks and in-kernel seeds an unbroken run draws.

On a mesh with a data axis > 1 the seed also folds in the rank's data
index, as JAX folds ``axis_index("data")`` into the step's key
(step.py:119-122): the data shards draw different masks, the model ranks
of one data shard the same ones. At data size 1 the seed is the one a
single card draws.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import torch


def step_seed(seed: int, step: int, data_index: Optional[int] = None) -> int:
    """The generator seed of step ``step`` of a run seeded ``seed``: 64
    bits of a hash of both, and of the data index where one is given (a
    data axis > 1)."""
    key = f"{int(seed)}:{int(step)}"
    if data_index is not None:
        key += f":{int(data_index)}"
    digest = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(digest[:8], "little")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int                   # optimizer steps taken (optax count)
    generator: torch.Generator  # draws every dropout mask, on the device
    seed: int = 444

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               seed: int = 444, step: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(model=model, optimizer=optimizer, step=step,
                   generator=generator, seed=seed)

    def seed_step(self, data_index: Optional[int] = None) -> None:
        """Re-seed the generator for the step about to run (idempotent
        until the step count moves); data_index: this rank's on a data
        axis > 1."""
        self.generator.manual_seed(step_seed(self.seed, self.step,
                                             data_index))
