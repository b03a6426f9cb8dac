"""The stand-alone masked attention of the per-sub-op serving path
(mcan_vqa_tpu/ops/masked_attention.py): softmax(q k^T / sqrt(Dh), PAD keys
-> -1e9) v per (sample, head), q, k, v [B, H, L, Dh] -> f32 [B, H, Lq, Dh].

The three Pallas kernels differ in how a TPU grid step is cut:
``_attn_kernel`` one (sample, head), ``_attn_kernel_batched`` 8 samples x
every head, ``_attn_kernel_packed`` G samples block-diagonally in one MXU
tile. All three compute one per-sample function, and all three go to the
port's ``kernels.masked_attention`` (csrc/masked_attention.cu, one block
per (sample, head), f32 output). They return JAX's [B, H, Lq, Dh] as a
view of the kernel's [B, Lq, H*Dh]; ``block_b`` and ``group`` are accepted
and have no effect.

The one difference: a fully padded sample under ``_packed`` at G > 1.
There JAX adds (off_block + pad) * -1e9 to the scores (:245), so the
sample's own pads and its neighbours' real keys both sit at -1e9 (only its
neighbours' pads at -2e9), and the sample attends to its neighbours. The
port follows ``model.apply``: a uniform softmax over the sample's own keys
(tests/test_torch_masked_attention.py pins both sides).
"""

from __future__ import annotations

from typing import Optional

import torch

from mcan_vqa_tpu_torch.ops import kernels


def _key_pad(mask: Optional[torch.Tensor], k: torch.Tensor) -> torch.Tensor:
    """The bool [B, 1, 1, Lk] PAD mask, all False for None."""
    if mask is not None:
        return mask
    return torch.zeros((k.shape[0], 1, 1, k.shape[2]), dtype=torch.bool,
                       device=k.device)


def _attention(q, k, v, mask) -> torch.Tensor:
    B, H, Lq, Dh = q.shape
    out = kernels.masked_attention(q, k, v, _key_pad(mask, k),
                                   out_dtype=torch.float32)
    return out.view(B, Lq, H, Dh).transpose(1, 2)


def masked_attention_pallas(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: Optional[torch.Tensor]
                            ) -> torch.Tensor:
    """``_attn_kernel`` (call :118): q, k, v [B, H, L, Dh] (bf16 or f32,
    rounded to bf16), mask bool [B, 1, 1, Lk] or None -> f32
    [B, H, Lq, Dh]."""
    return _attention(q, k, v, mask)


def masked_attention_pallas_batched(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor,
                                    mask: Optional[torch.Tensor],
                                    block_b: int = 8) -> torch.Tensor:
    """``_attn_kernel_batched`` (call :196): the same function."""
    return _attention(q, k, v, mask)


def masked_attention_pallas_packed(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   mask: Optional[torch.Tensor],
                                   group: int = 0) -> torch.Tensor:
    """``_attn_kernel_packed`` (call :292): the same function per sample;
    a fully padded sample attends to its own keys, not its neighbours'."""
    return _attention(q, k, v, mask)
