"""Primitive layers with the reference's parameter names and the JAX
package's numerics (mcan_vqa_tpu/models/layers.py).

  * ``Dense``: bf16 operands, f32 accumulation, f32 bias add. Weights are
    stored f32 in the torch layout ``[out, in]`` so state_dict keys are
    ``.weight`` / ``.bias`` as in the reference ``nn.Linear``.
  * ``StdLayerNorm``: ``a_2 * (x - mean) / (std + eps) + b_2`` with the
    Bessel-corrected std and eps added to the std (reference
    core/model/net_utils.py:48-60).
  * ``make_mask``: True marks a PAD row, i.e. one whose sum of absolute
    values is 0 (reference core/model/net.py:379-381).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

BF16 = torch.bfloat16


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands rounded to bf16 and the sum kept in
    f32: the JAX ``jnp.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=f32)``. Products of two bf16 values are exact
    in f32, so an f32 matmul of the rounded operands gives the same
    result up to summation order (TF32 must stay off on the card)."""
    return x.to(BF16).float() @ w.to(BF16).float()


def init_uniform_(t: torch.Tensor, bound: float,
                  generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Dense(nn.Module):
    """Linear layer with PyTorch-default init and bf16 compute."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        bound = 1.0 / in_features ** 0.5
        init_uniform_(self.weight, bound, generator)
        init_uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bf16_matmul(x, self.weight.t()) + self.bias


def std_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6, reciprocal: bool = False
                   ) -> torch.Tensor:
    """The reference LayerNorm in f32 (one implementation shared by the
    module, the serving path and the kernels' plain versions).
    reciprocal: scale * (c * (1 / (std + eps))) + bias, the rounding of the
    JAX train kernels' ``_ln_fwd`` (mcan_vqa_tpu/ops/sga_train.py:100);
    otherwise scale * c / (std + eps) + bias, that of ``model.apply`` and
    the serving kernels."""
    x32 = x.float()
    dim = x32.shape[-1]
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).sum(dim=-1, keepdim=True) / (dim - 1)
    if reciprocal:
        return scale * (centered * (1.0 / (var.sqrt() + eps))) + bias
    return scale * centered / (var.sqrt() + eps) + bias


class StdLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(dim))
        self.b_2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return std_layer_norm(x, self.a_2, self.b_2, self.eps)


class FC(nn.Module):
    """Linear -> ReLU (reference core/model/net_utils.py:11-34; dropout is
    a no-op at inference: training applies it in
    train/fused_engine.py)."""

    def __init__(self, in_size: int, out_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = Dense(in_size, out_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.linear(x))


class MLP(nn.Module):
    """FC -> Linear (reference core/model/net_utils.py:37-45)."""

    def __init__(self, in_size: int, mid_size: int, out_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = FC(in_size, mid_size, generator)
        self.linear = Dense(mid_size, out_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.fc(x))


def make_mask(feature: torch.Tensor) -> torch.Tensor:
    """Pad mask from all-zero feature rows: [B, L, D] -> bool [B, 1, 1, L].
    For integer token ids pass ``ids.unsqueeze(-1)``."""
    return (feature.abs().sum(dim=-1) == 0)[:, None, None, :]
