"""The learning-rate schedule and AdamW (mcan_vqa_tpu/train/optim.py).

Reference semantics (core/model/optim.py:11-71, core/exec.py:143-147):
AdamW with weight decay 1e-4 and torch's default betas (0.9, 0.999) and eps
1e-8; a step-function warmup lr_base x 0.25 / 0.5 / 0.75 while the step is
<= int(data_size / batch_size * k) for k = 1, 2, 3; lr_base x decay_rate at
the start of each epoch in decay_epochs. The schedule is a pure function of
the step count, as the JAX one: count c (the optimizer steps already taken)
is reference step c + 1.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch


def steps_per_epoch(data_size: int, batch_size: int) -> int:
    """Optimizer steps per epoch with drop_last (load_data.py:278)."""
    return data_size // batch_size


def make_lr_schedule(lr_base: float, data_size: int, batch_size: int,
                     decay_epochs: Sequence[int] = (8, 12),
                     decay_rate: float = 0.2) -> Callable[[int], float]:
    """-> schedule(count) -> lr, count the 0-based optimizer step."""
    spe = max(steps_per_epoch(data_size, batch_size), 1)
    # int(data_size / batch_size * k), not k * spe: the two differ when
    # data_size % batch_size != 0 (optim.py:40-44)
    t1, t2, t3 = (int(data_size / batch_size * k) for k in (1, 2, 3))
    decay_epochs = tuple(decay_epochs)

    def schedule(count: int) -> float:
        step = int(count) + 1
        warm = 0.25 if step <= t1 else 0.5 if step <= t2 else \
            0.75 if step <= t3 else 1.0
        epoch = (step - 1) // spe
        n_decays = sum(epoch >= e for e in decay_epochs)
        return lr_base * warm * decay_rate ** n_decays

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg
                   ) -> torch.optim.AdamW:
    """AdamW over ``params`` with torch's default betas and eps and weight
    decay 1e-4 (the reference's, core/model/optim.py:58-63); the train step
    sets its learning rate from the schedule."""
    return torch.optim.AdamW(params, lr=cfg.lr_base, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
