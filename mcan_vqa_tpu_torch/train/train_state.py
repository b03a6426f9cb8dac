"""What a train step reads and updates: the model's parameters, the
optimizer, the step count and the dropout generator
(mcan_vqa_tpu/train/train_state.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int                   # optimizer steps taken (optax count)
    generator: torch.Generator  # draws every dropout mask, on the device

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               seed: int = 444, step: int = 0) -> "TrainState":
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(model=model, optimizer=optimizer, step=step,
                   generator=generator)
