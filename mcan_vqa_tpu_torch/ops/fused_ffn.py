"""The projection / FFN + residual + LayerNorm sub-blocks of the per-sub-op
serving path (mcan_vqa_tpu/ops/fused_ffn.py):

  fused_proj_ln   StdLayerNorm(res + a . W + b)                one gemm_ln
  fused_ffn_ln    StdLayerNorm(x + relu(x . W1 + b1) . W2 + b2)
                                              gemm_bias_act, then gemm_ln

``_proj_ln_kernel`` (call :100) is one ``gemm_ln`` launch: the product,
the residual and the LN of a row never leave the SM. ``_ffn_ln_kernel``
(call :340) keeps a row tile's hidden h [TM, F] in VMEM with both weights
resident. An H100 SM cannot hold the 2 x D x F bf16 weights (4 MB at
MCAN-small, 16 MB at MCAN-large, against 227 KB of shared memory), so
fusing both products per row tile would re-read both weights from L2 once
per tile. Here h makes one round trip through HBM in bf16 instead:
15.7 MB at MCAN-small B=64 (3840 x 2048 x 2 bytes written, then read),
about 5 us at 3.35 TB/s.

JAX falls back to XLA for a row count that divides no tile and for weights
over its 12 MB VMEM budget (fused_ffn.py:313-335). The port has no such
guards: the kernels write every row at every M, and take MCAN-large's
1024 x 4096 weights.

On a CPU tensor each kernel wrapper runs its plain version
(ops/kernels.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from mcan_vqa_tpu_torch.models.layers import BF16
from mcan_vqa_tpu_torch.ops import kernels


def fused_proj_ln(residual: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], ln_scale: torch.Tensor,
                  ln_bias: torch.Tensor) -> torch.Tensor:
    """residual [..., D] (the stream, f32 or bf16), a [..., K] (the
    pre-merge attention output, f32 or bf16; rounded to bf16 in the
    kernel), w [K, D] bf16 -> StdLayerNorm(residual + a . w + b) in the
    residual's dtype and shape."""
    D = residual.shape[-1]
    out = kernels.gemm_ln(a.reshape(-1, a.shape[-1]), w, b,
                          residual.reshape(-1, D), ln_scale, ln_bias)
    return out.view(residual.shape)


def fused_ffn_ln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, ln_scale: torch.Tensor,
                 ln_bias: torch.Tensor) -> torch.Tensor:
    """x [..., D] (the stream, f32 or bf16), w1 [D, F], w2 [F, D] bf16 ->
    StdLayerNorm(x + relu(x . w1 + b1) . w2 + b2) in x's dtype and shape;
    the hidden is bf16, as the TPU kernel's h.astype(bfloat16) (:51). An
    f32 stream is cast to bf16 for the first product (one PyTorch launch;
    the production stream is bf16)."""
    D = x.shape[-1]
    xm = x.reshape(-1, D)
    h = kernels.gemm_bias_act(xm.to(BF16), w1, b1, relu=True, out_dtype=BF16)
    return kernels.gemm_ln(h, w2, b2, xm, ln_scale, ln_bias).view(x.shape)
