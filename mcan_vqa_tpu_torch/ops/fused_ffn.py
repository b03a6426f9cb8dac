"""The projection / FFN + residual + LayerNorm sub-blocks of the per-sub-op
serving path (mcan_vqa_tpu/ops/fused_ffn.py), and the two streaming FFN
variants the JAX package exports for weights past its VMEM budget:

  fused_proj_ln   StdLayerNorm(res + a . W + b)                one gemm_ln
  fused_ffn_ln    StdLayerNorm(x + relu(x . W1 + b1) . W2 + b2)
                                              gemm_bias_act, then gemm_ln
  fused_ffn_ln_blocked            the same function, f32 out, one
                                  ffn_ln_blocked launch (M outer)
  fused_ffn_ln_weight_stationary  the same, one ffn_ln_wstationary launch
                                  (F outer)

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

The streaming variants (``_ffn_ln_blocked_kernel`` :121, call :174;
``_ffn_ln_wstationary_kernel`` :201, call :263) keep each property of
their TPU kernel: the blocked kernel never writes the hidden to device
memory (a thread-block cluster per 64-row block walks the F tiles, each
rank forming a slice of h that crosses the cluster through distributed
shared memory, its output columns' sums in registers); the
weight-stationary kernel reads every weight byte from device memory once
(a cluster holds an F range of both weights in its CTAs' shared memory and
walks every row tile, the output carrying the running sum from range to
range in F order). No engine calls them, in JAX or here: ``fused_ffn_ln``
is the serving path's FFN.

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


def _streaming_operands(x, w1, w2):
    """x as [M, D] f32 or bf16, contiguous and 16-byte aligned (the kernels
    read either as f32; another float dtype is cast to f32, as JAX's
    x.astype(float32)), the weights as bf16 (the products run in bf16
    whatever the weights' dtype)."""
    D = x.shape[-1]
    xm = x.reshape(-1, D)
    if xm.dtype not in (torch.float32, BF16):
        xm = xm.float()
    xm = xm.contiguous()
    if xm.data_ptr() % 16:
        xm = xm.clone()
    return xm, w1.to(BF16).contiguous(), w2.to(BF16).contiguous()


def fused_ffn_ln_blocked(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                         tile_m: int = 256, tile_f: int = 1024
                         ) -> torch.Tensor:
    """x [..., D] -> StdLayerNorm(x + relu(x . w1 + b1) . w2 + b2), f32, in
    x's shape (fused_ffn.py:150): one launch of csrc/ffn_ln_blocked.cu, the
    hidden never in device memory. w1 [D, F], w2 [F, D] bf16 or f32 (the
    products run in bf16). tile_m / tile_f are JAX's tiles, taken for its
    signature: on the card the tiles are ``kernels.ffn_ln_plan``'s (64
    rows, F tiles of 64 hidden units a cluster rank), and every row is
    written at any M, where JAX falls back to XLA for untileable M or F
    (:163-170). Takes D a multiple of 128 up to 2048 and F a multiple of
    the F step (``kernels.ffn_f_step``); raises for another shape on the
    card."""
    del tile_m, tile_f
    xm, w1b, w2b = _streaming_operands(x, w1, w2)
    out = kernels.ffn_ln_blocked(xm, w1b, b1, w2b, b2, ln_scale, ln_bias)
    return out.view(x.shape)


def fused_ffn_ln_weight_stationary(x: torch.Tensor, w1: torch.Tensor,
                                   b1: torch.Tensor, w2: torch.Tensor,
                                   b2: torch.Tensor, ln_scale: torch.Tensor,
                                   ln_bias: torch.Tensor, tile_m: int = 256,
                                   tile_f: int = 1024) -> torch.Tensor:
    """The same function as ``fused_ffn_ln_blocked`` (fused_ffn.py:242), in
    one cluster launch of csrc/ffn_ln_wstationary.cu: each weight byte is
    read from device memory once, the F ranges' sums are added in F order.
    tile_m / tile_f are taken for JAX's signature: on the card the tiles
    are ``kernels.ffn_ln_plan``'s (64 rows, 32 hidden units a cluster rank,
    16 past D 1024). Takes D a multiple of 128 up to 2048 and F a multiple
    of the F step (``kernels.ffn_f_step``); raises for another shape on
    the card."""
    del tile_m, tile_f
    xm, w1b, w2b = _streaming_operands(x, w1, w2)
    out = kernels.ffn_ln_wstationary(xm, w1b, b1, w2b, b2, ln_scale, ln_bias)
    return out.view(x.shape)
