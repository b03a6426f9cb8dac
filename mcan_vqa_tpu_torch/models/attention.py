"""Multi-head attention (mcan_vqa_tpu/models/attention.py,
ops/masked_attention.py::masked_attention_xla; reference
core/model/mca.py:18-78).

Scores are ``q k^T / sqrt(Dh)`` from bf16 operands in f32, PAD keys are
replaced by -1e9 per sample, the softmax is f32, the probabilities are
rounded to bf16 and ``P V`` accumulates in f32. Attention is computed per
sample, so a fully padded sample sees a uniform softmax over its own keys
only.

Under tensor parallelism (``parallel/sharding.py::shard_module_``) an
``MHAtt`` holds num_heads / tp heads: q / k / v column-parallel behind
Megatron's f, the merge row-parallel, its partial products summed over the
model group by g before the bias.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mcan_vqa_tpu_torch.models.layers import (Dense, copy_inputs_to_model,
                                              operand, row_parallel)

NEG_INF = -1e9


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, H, Lq, Dh], k/v [B, H, Lk, Dh], mask bool [B, 1, 1, Lk]
    (True = PAD) -> [B, H, Lq, Dh] f32."""
    scale = 1.0 / q.shape[-1] ** 0.5
    scores = (operand(q) @ operand(k).transpose(-1, -2)) \
        * scale
    if mask is not None:
        scores = scores.masked_fill(mask, NEG_INF)
    att = torch.softmax(scores, dim=-1)
    return operand(att) @ operand(v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, D] -> [B, H, L, Dh] (a view)."""
    B, L, D = x.shape
    return x.view(B, L, num_heads, D // num_heads).transpose(1, 2)


class MHAtt(nn.Module):
    """Reference MHAtt with separate q/k/v projections. Registration order
    (v, k, q, merge) is the reference's, so state_dict keys come out in
    Net2's order. ``model_group``: set by ``shard_module_`` (the heads and
    projections then local to this model rank)."""

    model_group = None

    def __init__(self, hidden_size: int, num_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.linear_v = Dense(hidden_size, hidden_size, generator)
        self.linear_k = Dense(hidden_size, hidden_size, generator)
        self.linear_q = Dense(hidden_size, hidden_size, generator)
        self.linear_merge = Dense(hidden_size, hidden_size, generator)

    def forward(self, v: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        H, group = self.num_heads, self.model_group
        if group is not None:
            v, k, q = copy_inputs_to_model(group, v, k, q)
        atted = masked_attention(split_heads(self.linear_q(q), H),
                                 split_heads(self.linear_k(k), H),
                                 split_heads(self.linear_v(v), H), mask)
        B, _, Lq, _ = atted.shape
        atted = atted.transpose(1, 2).reshape(B, Lq, -1)
        if group is None:
            return self.linear_merge(atted)
        m = self.linear_merge
        return row_parallel(atted, m.weight.t(), m.bias, group)
