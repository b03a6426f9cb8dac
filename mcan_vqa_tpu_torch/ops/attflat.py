"""AttFlat through the kernels (mcan_vqa_tpu/ops/attflat.py): the MLP
logits over the tokens, the PAD mask, the softmax over the sequence, the
glimpse-weighted sum and the merge projection.

``_attflat_kernel`` (call :72) keeps one sample's whole chain in VMEM. On
the card it is three launches: the MLP's first product on
``gemm_bias_act`` (ReLU, bf16 hidden, every token of the batch in one
product), ``attflat_pool`` (csrc/attflat_pool.cu: the 512-wide logit
product, the mask, the softmax and the pooling, per sample, the logits in
shared memory), and the merge on ``gemm_bias_act``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mcan_vqa_tpu_torch.models.layers import BF16
from mcan_vqa_tpu_torch.ops import kernels


def attflat_pallas(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   wm: torch.Tensor, bm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, D] (f32 or bf16 stream), mask bool [B, 1, 1, L], the
    AttFlat weights in the JAX layout (bf16 kernels [in, out], f32 biases)
    -> (out [B, O] f32, att [B, L, G] f32)."""
    B, L, D = x.shape
    h = kernels.gemm_bias_act(x.reshape(B * L, D).to(BF16), w1, b1,
                              relu=True, out_dtype=BF16)
    pooled, att = kernels.attflat_pool(h, w2, b2, mask, x.contiguous())
    return kernels.gemm_bias_act(pooled, wm, bm), att
