"""The serving kernels as ``torch.library`` custom ops (``torch.ops.mcan.*``),
so that ``torch.export`` can trace a serving forward into a program that
still launches the hand-written kernels (artifact.py).

Every wrapper of ops/kernels.py calls its kernel through ctypes with the
tensors' data pointers and the current stream. ``torch.export`` traces
with fake tensors, which have no data pointer, so each serving wrapper
turns to its op here while ``torch.compiler.is_exporting()``:

  mcan::gemm_bias_act        kernels.gemm_bias_act      gemm_sm90.cu, NN
  mcan::gemm_ln              kernels.gemm_ln            gemm_ln.cu
  mcan::quantize_rows        kernels.quantize_rows      quantize.cu
  mcan::gemm_s8              kernels.gemm_s8            gemm_sm90.cu, S8
  mcan::gemm_s4              kernels.gemm_s4            gemm_int4.cu, S4
  mcan::gemm_w4bf16          kernels.gemm_w4bf16        gemm_int4.cu, W4
  mcan::masked_attention     kernels.masked_attention   masked_attention.cu
  mcan::residual_layernorm   kernels.residual_layernorm residual_layernorm.cu
  mcan::attflat_pool         kernels.attflat_pool       attflat_pool.cu

Each op's implementation, on the card and on the CPU alike, is the wrapper
itself: on a CUDA tensor it launches the kernel (and adds one to
``kernels.LAUNCHES``, so an exported program's launches count as the live
engine's do), on a CPU tensor it runs the plain version. There is no
fallback: an op whose kernel refuses its arguments raises, as the wrapper
does. The fake (meta) implementations give each output's shape and dtype,
all of them fresh contiguous tensors, as the kernels write them.

Serving draws no dropout, so the ops take no keep-mask or Philox source:
exporting a wrapper call that passes one raises. A schema takes no list of
dtypes, so the wrappers' ``out_dtypes`` (one or two distinct dtypes)
become ``out0`` and an optional ``out1``; the multi-output wrappers
return a list. ``quantize_rows`` returns [codes] for static scales and
[codes, scales] for dynamic ones.

The live engines keep their direct wrapper calls: a custom op's dispatch
costs host time on every call, and the live forward is host-bound. The
ops are taken only while exporting, and inside an exported program.
``OP_CALLS`` counts the ops' real calls by name (not the fake ones), so a
run can show that a live forward made none and an artifact's forward one
per kernel launch; ``IMPLS`` holds each op's implementation undecorated,
so a measurement can run a program's graph with the ops' dispatch taken
out.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mcan_vqa_tpu_torch.ops import kernels as K

F32 = torch.float32
BF16 = torch.bfloat16
I8 = torch.int8

OP_CALLS: Dict[str, int] = collections.Counter()


def reset_op_calls() -> None:
    OP_CALLS.clear()


def op_calls() -> Dict[str, int]:
    return dict(OP_CALLS)


def _dtypes(out0: torch.dtype, out1: Optional[torch.dtype]
            ) -> Tuple[torch.dtype, ...]:
    return (out0,) if out1 is None else (out0, out1)


def _split_dtypes(name: str, out_dtypes: Sequence[torch.dtype]):
    out_dtypes = tuple(out_dtypes)
    if not 1 <= len(out_dtypes) <= 2:
        raise ValueError(f"{name}: one or two out_dtypes, got {out_dtypes}")
    return out_dtypes[0], out_dtypes[1] if len(out_dtypes) == 2 else None


def _serving_only(name: str, **dropout) -> None:
    """The ops carry no dropout: refuse a keep source while exporting."""
    given = [k for k, v in dropout.items() if v is not None]
    if given:
        raise ValueError(f"{name}: {', '.join(given)} cannot be exported: "
                         f"the serving ops take no dropout")


# each op's implementation by name, undecorated: what the op runs
IMPLS = {}


def _op(name: str):
    """Register the decorated function as ``mcan::<name>`` (its schema
    inferred from the annotations) and keep it in ``IMPLS``."""
    def register(fn):
        IMPLS[name] = fn
        return torch.library.custom_op(f"mcan::{name}", fn, mutates_args=())
    return register


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@_op("gemm_bias_act")
def _gemm_bias_act(a: torch.Tensor, w: torch.Tensor,
                   bias: Optional[torch.Tensor], relu: bool,
                   out_dtype: torch.dtype) -> torch.Tensor:
    OP_CALLS["gemm_bias_act"] += 1
    return K.gemm_bias_act(a, w, bias, relu=relu, out_dtype=out_dtype)


@_gemm_bias_act.register_fake
def _(a, w, bias, relu, out_dtype):
    return a.new_empty((a.shape[0], w.shape[1]), dtype=out_dtype)


@_op("gemm_ln")
def _gemm_ln(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
             res: torch.Tensor, gamma: torch.Tensor,
             beta: torch.Tensor) -> torch.Tensor:
    OP_CALLS["gemm_ln"] += 1
    return K.gemm_ln(a, w, bias, res, gamma, beta)


@_gemm_ln.register_fake
def _(a, w, bias, res, gamma, beta):
    return a.new_empty((a.shape[0], w.shape[1]), dtype=res.dtype)


@_op("quantize_rows")
def _quantize_rows(x: torch.Tensor,
                   inv_a: Optional[float]) -> List[torch.Tensor]:
    OP_CALLS["quantize_rows"] += 1
    q, s = K.quantize_rows(x, inv_a)
    return [q] if s is None else [q, s]


@_quantize_rows.register_fake
def _(x, inv_a):
    q = x.new_empty(tuple(x.shape), dtype=I8)
    if inv_a is not None:
        return [q]
    return [q, x.new_empty((x.shape[0],), dtype=F32)]


@_op("gemm_s8")
def _gemm_s8(aq: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
             bias: Optional[torch.Tensor], sx: Optional[torch.Tensor],
             a: Optional[float], relu: bool, out0: torch.dtype,
             out1: Optional[torch.dtype]) -> List[torch.Tensor]:
    OP_CALLS["gemm_s8"] += 1
    return list(K.gemm_s8(aq, wq, sw, bias, sx=sx, a=a, relu=relu,
                          out_dtypes=_dtypes(out0, out1)))


@_gemm_s8.register_fake
def _(aq, wq, sw, bias, sx, a, relu, out0, out1):
    return [aq.new_empty((aq.shape[0], wq.shape[1]), dtype=dt)
            for dt in _dtypes(out0, out1)]


@_op("gemm_s4")
def _gemm_s4(aq: torch.Tensor, wp: torch.Tensor, s4: torch.Tensor,
             bias: Optional[torch.Tensor], a: float, relu: bool,
             out0: torch.dtype,
             out1: Optional[torch.dtype]) -> List[torch.Tensor]:
    OP_CALLS["gemm_s4"] += 1
    return list(K.gemm_s4(aq, wp, s4, bias, a=a, relu=relu,
                          out_dtypes=_dtypes(out0, out1)))


@_gemm_s4.register_fake
def _(aq, wp, s4, bias, a, relu, out0, out1):
    return [aq.new_empty((aq.shape[0], wp.shape[1]), dtype=dt)
            for dt in _dtypes(out0, out1)]


@_op("gemm_w4bf16")
def _gemm_w4bf16(x: torch.Tensor, wp: torch.Tensor, s4: torch.Tensor,
                 bias: Optional[torch.Tensor], relu: bool,
                 out_dtype: torch.dtype) -> torch.Tensor:
    OP_CALLS["gemm_w4bf16"] += 1
    return K.gemm_w4bf16(x, wp, s4, bias, relu=relu, out_dtype=out_dtype)


@_gemm_w4bf16.register_fake
def _(x, wp, s4, bias, relu, out_dtype):
    return x.new_empty((x.shape[0], wp.shape[1]), dtype=out_dtype)


@_op("masked_attention")
def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_pad: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    OP_CALLS["masked_attention"] += 1
    return K.masked_attention(q, k, v, key_pad, out_dtype=out_dtype)


@_masked_attention.register_fake
def _(q, k, v, key_pad, out_dtype):
    B, H, Lq, Dh = q.shape
    return q.new_empty((B, Lq, H * Dh), dtype=out_dtype)


@_op("residual_layernorm")
def _residual_layernorm(res: torch.Tensor, y: torch.Tensor,
                        bias: Optional[torch.Tensor], gamma: torch.Tensor,
                        beta: torch.Tensor, out0: torch.dtype,
                        out1: Optional[torch.dtype]) -> List[torch.Tensor]:
    OP_CALLS["residual_layernorm"] += 1
    return list(K.residual_layernorm(res, y, bias, gamma, beta,
                                     _dtypes(out0, out1)))


@_residual_layernorm.register_fake
def _(res, y, bias, gamma, beta, out0, out1):
    return [res.new_empty(tuple(res.shape), dtype=dt)
            for dt in _dtypes(out0, out1)]


@_op("attflat_pool")
def _attflat_pool(h: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  mask: torch.Tensor, x: torch.Tensor) -> List[torch.Tensor]:
    OP_CALLS["attflat_pool"] += 1
    return list(K.attflat_pool(h, w2, b2, mask, x))


@_attflat_pool.register_fake
def _(h, w2, b2, mask, x):
    B, L, D = x.shape
    G = w2.shape[1]
    return [x.new_empty((B, G * D), dtype=BF16),
            x.new_empty((B, L, G), dtype=F32)]


# ---------------------------------------------------------------------------
# the wrappers' signatures onto the ops (ops/kernels.py calls these while
# exporting)
# ---------------------------------------------------------------------------

def gemm_bias_act(a, w, bias=None, *, relu=False, out_dtype=F32, mask=None,
                  inv_keep=1.0):
    _serving_only("gemm_bias_act", mask=mask)
    return torch.ops.mcan.gemm_bias_act(a, w, bias, bool(relu), out_dtype)


def gemm_ln(a, w, bias, res, gamma, beta):
    return torch.ops.mcan.gemm_ln(a, w, bias, res, gamma, beta)


def quantize_rows(x, inv_a=None):
    outs = torch.ops.mcan.quantize_rows(
        x, None if inv_a is None else float(inv_a))
    return outs[0], (outs[1] if inv_a is None else None)


def gemm_s8(aq, wq, sw, bias=None, *, sx=None, a=None, relu=False,
            out_dtypes=(F32,)):
    return tuple(torch.ops.mcan.gemm_s8(
        aq, wq, sw, bias, sx, None if a is None else float(a), bool(relu),
        *_split_dtypes("gemm_s8", out_dtypes)))


def gemm_s4(aq, wp, s4, bias=None, *, a, relu=False, out_dtypes=(F32,)):
    return tuple(torch.ops.mcan.gemm_s4(
        aq, wp, s4, bias, float(a), bool(relu),
        *_split_dtypes("gemm_s4", out_dtypes)))


def gemm_w4bf16(x, wp, s4, bias=None, *, relu=False, out_dtype=F32):
    return torch.ops.mcan.gemm_w4bf16(x, wp, s4, bias, bool(relu), out_dtype)


def masked_attention(q, k, v, key_pad, drop=None, inv_keep=1.0,
                     out_dtype=BF16):
    _serving_only("masked_attention", drop=drop)
    return torch.ops.mcan.masked_attention(q, k, v, key_pad, out_dtype)


def residual_layernorm(res, y, bias, gamma, beta, out_dtypes=(F32,), *,
                       mask=None, inv_keep=1.0, save_r=False,
                       reciprocal=False, r_dtype=F32):
    _serving_only("residual_layernorm", mask=mask,
                  save_r=save_r or None, reciprocal=reciprocal or None)
    return tuple(torch.ops.mcan.residual_layernorm(
        res, y, bias, gamma, beta,
        *_split_dtypes("residual_layernorm", out_dtypes)))


def attflat_pool(h, w2, b2, mask, x):
    pooled, att = torch.ops.mcan.attflat_pool(h, w2, b2, mask, x)
    return pooled, att
