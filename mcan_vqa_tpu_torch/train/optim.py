"""The learning-rate schedule and AdamW (mcan_vqa_tpu/train/optim.py).

Reference semantics (core/model/optim.py:11-71, core/exec.py:143-147):
AdamW, by default with weight decay 1e-4 and torch's default betas (0.9,
0.999) and eps 1e-8 (``Config.opt_betas`` / ``opt_eps`` /
``weight_decay`` set them, as in the JAX ``Config``); a step-function warmup lr_base x 0.25 / 0.5 / 0.75 while the step is
<= int(data_size / batch_size * k) for k = 1, 2, 3; lr_base x decay_rate at
the start of each epoch in decay_epochs. The schedule is a pure function of
the step count, as the JAX one: count c (the optimizer steps already taken)
is reference step c + 1.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch

BF16 = torch.bfloat16


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


class AdamWMuBF16(torch.optim.Optimizer):
    """AdamW with its first moment stored in bf16, as optax ``adamw(...,
    mu_dtype=bfloat16)`` (optax ``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate``): each step forms the f32 moment from the
    stored bf16 one, mu = (1 - b1) g + b1 m with b1 m a bf16 product as in
    JAX (the Python float b1 takes the moment's dtype), takes the update
    from it and the f32 second moment, then stores mu rounded to bf16.
    The update is -lr (mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) +
    wd p), the bias corrections in f32. Its ``state_dict`` has torch
    AdamW's layout: per parameter index "step", "exp_avg" (bf16) and
    "exp_avg_sq", one param group; ``load_state_dict`` takes the first
    moment back to bf16 (a checkpoint stores it f32, which is exact)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for s in self.state.values():
            if "exp_avg" in s:
                s["exp_avg"] = s["exp_avg"].to(BF16)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWMuBF16 takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.float()
                s = self.state[p]
                if not s:
                    s["step"] = torch.tensor(0.0)
                    s["exp_avg"] = torch.zeros_like(p, dtype=BF16)
                    s["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                s["step"] += 1
                t = float(s["step"])
                mu = (1 - b1) * g + s["exp_avg"] * torch.tensor(b1, dtype=BF16)
                nu = (1 - b2) * (g * g) + b2 * s["exp_avg_sq"]
                bc1 = float(1 - torch.tensor(b1) ** t)      # f32 values
                bc2 = float(1 - torch.tensor(b2) ** t)
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) + wd * p
                p.add_(-lr * update)
                s["exp_avg"] = mu.to(BF16)
                s["exp_avg_sq"] = nu
        return None


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg
                   ) -> torch.optim.Optimizer:
    """AdamW over ``params`` with the config's betas, eps and weight decay
    (by default torch's (0.9, 0.999) and 1e-8 and the reference's 1e-4,
    core/model/optim.py:58-63); with ``opt_mu_dtype="bfloat16"`` the
    first moment is stored in bf16 (``AdamWMuBF16``). The train step sets
    its learning rate from the schedule."""
    kw = dict(lr=cfg.lr_base, betas=tuple(float(b) for b in cfg.opt_betas),
              eps=float(cfg.opt_eps), weight_decay=float(cfg.weight_decay))
    if cfg.opt_mu_dtype == "bfloat16":
        return AdamWMuBF16(params, **kw)
    return torch.optim.AdamW(params, **kw)
