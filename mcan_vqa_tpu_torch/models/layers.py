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
  * ``operand``: a matmul operand of the plain engine rounded to its
    operand dtype, bf16 (JAX's ``compute_dtype`` default), or f32 inside
    ``operand_dtype(torch.float32)`` (JAX's ``compute_dtype="float32"``,
    config.py:93, the regime of the JAX sharding tests, which the port's
    parity checks run in): the plain engine's products, attention and
    AttFlat pooling then keep every f32 bit, and their gradients are f32
    sums, not bf16 roundings of partial sums. The hand-written kernels
    and their plain versions are not affected.
  * ``copy_to_model`` / ``reduce_from_model``: Megatron's f and g for
    tensor parallelism over a model group (``parallel/``): f is the
    identity forward and an all-reduce of the input gradient backward, in
    front of a column-parallel product; g is an all-reduce forward and the
    identity backward, behind a row-parallel product (``row_parallel``,
    whose bias is added after the reduce). With no group both are the
    identity and nothing is called.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
from torch import nn

from mcan_vqa_tpu_torch.parallel.sharding import all_reduce_

BF16 = torch.bfloat16
_OPERAND = contextvars.ContextVar("plain_operand_dtype", default=BF16)


@contextlib.contextmanager
def operand_dtype(dtype: torch.dtype):
    """The plain engine's operand dtype (bf16 or f32) inside the block,
    in this thread."""
    if dtype not in (BF16, torch.float32):
        raise ValueError(f"operand dtype must be bf16 or f32, got {dtype}")
    token = _OPERAND.set(dtype)
    try:
        yield
    finally:
        _OPERAND.reset(token)


def operand(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the plain engine's operand dtype, as f32."""
    dtype = _OPERAND.get()
    return x.float() if dtype == torch.float32 else x.to(dtype).float()


def bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands rounded to bf16 and the sum kept in
    f32: the JAX ``jnp.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=f32)``. Products of two bf16 values are exact
    in f32, so an f32 matmul of the rounded operands gives the same
    result up to summation order (TF32 must stay off on the card)."""
    return operand(x) @ operand(w)


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


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the input gradient
    summed over the model group (each rank holds the part of it that its
    column shard produced)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial products of a row-parallel layer summed
    over the model group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromModel.apply(x, group)


def copy_inputs_to_model(group, *xs: torch.Tensor):
    """f once per distinct input (self-attention passes one tensor as v, k
    and q: its gradient is reduced once, not three times)."""
    seen = {}
    return tuple(seen.setdefault(id(x), copy_to_model(x, group))
                 for x in xs)


def row_parallel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 group) -> torch.Tensor:
    """``x @ weight`` ([in, out] layout) reduced over the model group,
    then the (replicated) bias; without a group the ``Dense`` product."""
    return reduce_from_model(bf16_matmul(x, weight), group) + bias


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
