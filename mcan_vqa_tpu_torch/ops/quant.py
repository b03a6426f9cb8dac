"""The int8 serving blocks and their quantization
(mcan_vqa_tpu/ops/quant.py, the qffn levels 1-3 of the shipped engine).

  * weights: ``_quant_w`` -- per-out-channel symmetric int8 of an [in, out]
    kernel, s = max|w| / 127 (0 -> 1); ``prepare_qffn_params`` quantizes a
    block's FFN, and by level its fused qkv and its merge / cross-q
    projections;
  * activations: ``_qrow`` (dynamic per-row scales), ``_qdot`` and
    ``_qdot_static`` (one calibrated per-tensor scale) as plain functions;
  * calibration: ``calibrate_qffn_act_scales`` replays the blocks' math in
    plain PyTorch over a batch and records each int8 site's max
    |activation| (x margin / 127), as the JAX replay does (quant.py:736);
  * the blocks: ``fused_qffn_sa_block`` (TPU kernel ``_sa_kernel_qffn``,
    quant.py:1184, called at :1412) and ``fused_qffn_sga_block``
    (``_sga_kernel_qffn``, :1057, called at :1326).

Each block is written once over a set of primitives, as ops/sga_block.py
does: the plain set runs on the CPU, the CUDA set on the card
(ops/kernels.py: ``quantize_rows`` and ``gemm_s8`` at every int8 site, the
bf16 ``gemm_bias_act`` at the others, ``masked_attention`` and
``residual_layernorm``). Each CUDA block call adds one to
``kernels.LAUNCHES["fused_qffn_sa_block" / "fused_qffn_sga_block"]``.

Precision path, that of the TPU kernels: the FFN input is quantized from
the f32 LayerNorm output; h1 = relu(int8 dot) stays f32 and is quantized
again for w2 (a dynamic scale needs the max over all F columns); the qkv
site quantizes the bf16 stream as read; the cross-q site quantizes v1 in
f32; q/k/v and the probabilities are bf16; at level 3 the attention output
reaches its merge site in f32 (quant.py:1139-1141, :1158-1160, :1240-1242).
Attention is per sample, as in every block of the port.

``act_scales``: None for dynamic per-row scales; a 3-tuple (aqkv, a1, a2)
for the qkv and FFN sites; a 6-tuple (SGA: + am1, aq2, am2) or 4-tuple
(SA: + am) for level 3. A longer tuple is cut to 3 where the block carries
no proj weights (quant.py:1316-1318, :1407-1409). The int4 levels 4-7 and
the static-int8 aux sites (q8aux) are not ported: they raise.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from mcan_vqa_tpu_torch.models.attention import split_heads
from mcan_vqa_tpu_torch.models.layers import (BF16, bf16_matmul, make_mask,
                                              std_layer_norm)
from mcan_vqa_tpu_torch.models.lstm import lstm_forward
from mcan_vqa_tpu_torch.ops import kernels
from mcan_vqa_tpu_torch.ops.kernels import F32, I8, _f32, true_div
from mcan_vqa_tpu_torch.ops.sga_block import _check_stream, _qkv_heads

NEG_INF = -1e9
INT4_NOT_PORTED = ("the int4 qffn levels 4-7 (_quant_w4, _qdot_static4, "
                   "_qdot_w4bf16) and the q8aux sites are not ported yet; "
                   "they are the next serving slice of the port")


# ---------------------------------------------------------------------------
# weights and the plain int8 dots
# ---------------------------------------------------------------------------

def _quant_w(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] kernel -> int8 weight + f32 per-out-channel scale."""
    w32 = kernel.float()
    s = true_div(w32.abs().amax(dim=0), 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    wq = torch.round(w32 / s).clamp_(-127.0, 127.0).to(I8)
    return {"w_q": wq.contiguous(), "w_scale": s.contiguous()}


def _qrow(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 [M, D] -> (int8, f32 [M, 1] scale), symmetric per row."""
    xq, s = kernels.quantize_rows_plain(x)
    return xq, s[:, None]


def _qdot(x, wq, sw, bias):
    """Dynamic per-row quantization of x, int8 dot, dequantize."""
    xq, sx = kernels.quantize_rows_plain(x)
    return kernels.gemm_s8_plain(xq, wq, sw, bias, sx=sx)[0]


def _qdot_static(x, a: float, wq, sw, bias):
    """``_qdot`` with a calibrated per-tensor scale ``a`` (a Python float;
    1 / a is taken in double, then both are f32 constants)."""
    xq, _ = kernels.quantize_rows_plain(x, 1.0 / a)
    return kernels.gemm_s8_plain(xq, wq, sw, bias, a=a)[0]


def prepare_qffn_params(wp: Mapping[str, torch.Tensor],
                        qkv_int8: bool = False, proj_int8: bool = False,
                        w4: int = 0) -> Dict[str, torch.Tensor]:
    """One block's bf16 layout (``_mk``, ops/sga_block.py) -> its int8
    weights and f32 scales, keyed as JAX ``prepare_qffn_params`` (:639):
    the FFN always (w1_q / s1, w2_q / s2, b1, b2); qkv_int8 the fused
    self-attention qkv (wqkv_q / sqkv); proj_int8 the merges and the
    decoder's cross q (SA: wm_q / sm; SGA: wm1_q, wq2_q, wm2_q and their
    scales). The ``_mk`` weights are already the bf16-rounded kernels,
    which is what JAX quantizes (its bf16 cast runs first, serving.py:189).
    w4 > 0 (int4) raises."""
    if w4:
        raise NotImplementedError(f"w4={w4}: {INT4_NOT_PORTED}")
    q1, q2 = _quant_w(wp["w1"]), _quant_w(wp["w2"])
    out = {"b1": wp["b1"].float(), "b2": wp["b2"].float(),
           "w1_q": q1["w_q"], "s1": q1["w_scale"],
           "w2_q": q2["w_q"], "s2": q2["w_scale"]}
    is_sga = "wqkv1" in wp
    if qkv_int8:
        qq = _quant_w(wp["wqkv1" if is_sga else "wqkv"])
        out["wqkv_q"], out["sqkv"] = qq["w_q"], qq["w_scale"]
    if proj_int8:
        sites = ((("wm1_full", "wm1_q", "sm1"), ("wq2_full", "wq2_q", "sq2"),
                  ("wm2_full", "wm2_q", "sm2")) if is_sga
                 else (("wm", "wm_q", "sm"),))
        for src, wq, ws in sites:
            q = _quant_w(wp[src])
            out[wq], out[ws] = q["w_q"], q["w_scale"]
    return out


# ---------------------------------------------------------------------------
# calibration of the static activation scales
# ---------------------------------------------------------------------------

def _check_scales(scales: Dict[str, tuple]) -> Dict[str, tuple]:
    """Scales are baked into the engine: one NaN / Inf (a non-finite row in
    the calibration sample) would poison every int8 site it reaches."""
    for name, tup in scales.items():
        for s in tup:
            if not (math.isfinite(s) and s > 0.0):
                raise ValueError(
                    f"calibration produced a non-finite/non-positive "
                    f"activation scale at {name}: {tup} — check the "
                    f"calibration sample for NaN/Inf features")
    return scales


# The replay helpers: plain mirrors of the qffn blocks' math (bf16 attention
# matmuls, f32 softmax / LN, int8 dots) with JAX's replay roundings
# (quant.py:849-1055): 1 / a and a * sw in f32, the scores divided by
# sqrt(Dh), the pad mask added as mask * -1e9, residuals summed
# (x + y) + bias. Every max runs over the whole batch, padding rows
# included, as in JAX.

def _cal_scale_of(x: torch.Tensor, margin: float) -> torch.Tensor:
    m = true_div(x.abs().max(), 127.0) * _f32(margin)
    return torch.where(m == 0.0, torch.ones_like(m), m)


def _cal_qdot(x, a, wq, sw, b):
    xq = torch.round(x * (1.0 / a)).clamp_(-127.0, 127.0).to(I8)
    return kernels.int8_dot_exact(xq, wq) * (a * sw) + b


def _cal_bdot(x, w, b=None):
    y = bf16_matmul(x, w)
    return y if b is None else y + b


def _cal_sdpa(q, k, v, mask, num_heads):
    B, Lq, D = q.shape
    Dh = D // num_heads

    def heads(t):
        return t.to(BF16).float().reshape(B, -1, num_heads, Dh) \
            .transpose(1, 2)

    s = true_div(heads(q) @ heads(k).transpose(-1, -2), Dh ** 0.5)
    s = s + mask.float() * NEG_INF
    att = torch.softmax(s, dim=-1).to(BF16).float()
    return (att @ heads(v)).transpose(1, 2).reshape(B, Lq, D)


def _cal_qkv_site(flat, wp, qf, wqkv_key, bqkv, margin):
    if "wqkv_q" in qf:
        aq = _cal_scale_of(flat, margin)
        return _cal_qdot(flat, aq, qf["wqkv_q"], qf["sqkv"], bqkv), aq
    return _cal_bdot(flat, wp[wqkv_key], bqkv), \
        torch.ones((), dtype=F32, device=flat.device)


def _cal_ffn_sites(qf, xin, margin):
    a1 = _cal_scale_of(xin, margin)
    h1 = torch.relu(_cal_qdot(xin, a1, qf["w1_q"], qf["s1"], qf["b1"]))
    a2 = _cal_scale_of(h1, margin)
    return a1, a2, _cal_qdot(h1, a2, qf["w2_q"], qf["s2"], qf["b2"])


def _cal_proj_site(flat, wq, sw, margin):
    a = _cal_scale_of(flat, margin)
    return _cal_qdot(flat, a, wq, sw, 0.0), a


def _cal_sa_block(block, q, mask, num_heads, margin):
    """One SA block of the replay -> (stream out bf16, (aq, a1, a2) or
    (aq, a1, a2, am) with proj-int8 weights)."""
    wp, qf = block["_mk"], block["_qffn"]
    B, Lq, D = q.shape
    x = q.float()
    flat = x.reshape(B * Lq, D)
    qkv, aq = _cal_qkv_site(flat, wp, qf, "wqkv", wp["bqkv"], margin)
    qx, kx, vx = qkv.reshape(B, Lq, 3 * D).split(D, dim=-1)
    att = _cal_sdpa(qx, kx, vx, mask, num_heads).reshape(B * Lq, D)
    if "wm_q" in qf:
        y, am = _cal_proj_site(att, qf["wm_q"], qf["sm"], margin)
    else:
        y, am = _cal_bdot(att, wp["wm"]), None
    x1 = std_layer_norm(x + y.reshape(B, Lq, D) + wp["bm"], wp["ln1_s"],
                        wp["ln1_b"])
    a1, a2, y = _cal_ffn_sites(qf, x1.reshape(B * Lq, D), margin)
    x2 = std_layer_norm(x1 + y.reshape(B, Lq, D), wp["ln2_s"], wp["ln2_b"])
    return x2.to(BF16), (aq, a1, a2) if am is None else (aq, a1, a2, am)


def _cal_sga_block(dec, v, q, v_mask, q_mask, num_heads, margin):
    """One SGA block of the replay -> (stream out bf16, (aq, a1, a2) or
    (aq, a1, a2, am1, aq2, am2) with proj-int8 weights)."""
    wp, qf = dec["_mk"], dec["_qffn"]
    B, Lv, D = v.shape
    kv = dec["mhatt2"]["linear_kv"]
    kq, vq = _cal_bdot(q, kv["kernel"], kv["bias"]).split(D, dim=-1)
    proj8 = "wm1_q" in qf

    x = v.float()
    flat = x.reshape(B * Lv, D)
    qkv, aq = _cal_qkv_site(flat, wp, qf, "wqkv1", wp["bqkv1"], margin)
    qx, kx, vx = qkv.reshape(B, Lv, 3 * D).split(D, dim=-1)
    att = _cal_sdpa(qx, kx, vx, v_mask, num_heads).reshape(B * Lv, D)
    if proj8:
        y, am1 = _cal_proj_site(att, qf["wm1_q"], qf["sm1"], margin)
    else:
        y = _cal_bdot(att, wp["wm1_full"])
    v1 = std_layer_norm(x + y.reshape(B, Lv, D) + wp["bm1"], wp["ln1_s"],
                        wp["ln1_b"])

    v1_flat = v1.reshape(B * Lv, D)
    if proj8:
        aq2 = _cal_scale_of(v1_flat, margin)
        qx2 = _cal_qdot(v1_flat, aq2, qf["wq2_q"], qf["sq2"], wp["bq2_full"])
    else:
        qx2 = _cal_bdot(v1_flat, wp["wq2_full"], wp["bq2_full"])
    att = _cal_sdpa(qx2.reshape(B, Lv, D), kq, vq, q_mask,
                    num_heads).reshape(B * Lv, D)
    if proj8:
        y, am2 = _cal_proj_site(att, qf["wm2_q"], qf["sm2"], margin)
    else:
        y = _cal_bdot(att, wp["wm2_full"])
    v2 = std_layer_norm(v1 + y.reshape(B, Lv, D) + wp["bm2"], wp["ln2_s"],
                        wp["ln2_b"])

    a1, a2, y = _cal_ffn_sites(qf, v2.reshape(B * Lv, D), margin)
    v3 = std_layer_norm(v2 + y.reshape(B, Lv, D), wp["ln3_s"], wp["ln3_b"])
    scales = (aq, a1, a2, am1, aq2, am2) if proj8 else (aq, a1, a2)
    return v3.to(BF16), scales


def calibrate_qffn_act_scales(params: Mapping[str, Any], img_feat, ques_ix,
                              num_layers: int, num_heads: int,
                              margin: float = 1.1, w4dq: bool = False
                              ) -> Dict[str, tuple]:
    """Static per-tensor activation scales for the int8 engine.

    params: a prepared serving tree with ``_qffn`` on every block
    (ops/serving.py ``prepare_params(qffn=...)``). img_feat [B, R, F] f32
    and ques_ix [B, T] int (numpy arrays or tensors) are the calibration
    batch. Replays the blocks in plain PyTorch on the params' device and
    returns {"enc_i" / "dec_i": (aqkv, a1, a2[, proj scales])} as Python
    floats (scale = max / 127 x margin; values past it saturate at +-127).
    The qkv scale is 1.0 where the block keeps a bf16 qkv. w4dq and a
    ``_q8aux`` tree (the int4 / aux replays) raise."""
    if w4dq or "_q8aux" in params:
        raise NotImplementedError(INT4_NOT_PORTED)
    emb = params["embedding"]["embedding"]
    img = torch.as_tensor(img_feat, dtype=F32).to(emb.device)
    ques = torch.as_tensor(ques_ix).to(emb.device).long()
    with torch.no_grad():
        q_mask = make_mask(ques.unsqueeze(-1))
        v_mask = make_mask(img)
        lp = params["lstm"]
        q = lstm_forward(emb[ques], lp["w_ih"], lp["w_hh"], lp["b_ih"],
                         lp["b_hh"]).to(BF16)
        ifl = params["img_feat_linear"]
        v = _cal_bdot(img, ifl["kernel"], ifl["bias"]).to(BF16)
        bb = params["backbone"]
        scales: Dict[str, tuple] = {}
        for i in range(num_layers):
            q, scales[f"enc_{i}"] = _cal_sa_block(bb[f"enc_{i}"], q, q_mask,
                                                  num_heads, margin)
        for i in range(num_layers):
            v, scales[f"dec_{i}"] = _cal_sga_block(bb[f"dec_{i}"], v, q,
                                                   v_mask, q_mask, num_heads,
                                                   margin)
    return _check_scales({k: tuple(float(x) for x in tup)
                          for k, tup in scales.items()})


# ---------------------------------------------------------------------------
# the blocks, written once over a set of primitives
# ---------------------------------------------------------------------------

class _QPrims(NamedTuple):
    gemm: Callable
    gemm_s8: Callable
    quantize: Callable
    attention: Callable
    layernorm: Callable


_PLAIN = _QPrims(kernels.gemm_bias_act_plain, kernels.gemm_s8_plain,
                 kernels.quantize_rows_plain, kernels.masked_attention_plain,
                 kernels.residual_layernorm_plain)
_CUDA = _QPrims(kernels.gemm_bias_act, kernels.gemm_s8,
                kernels.quantize_rows, kernels.masked_attention,
                kernels.residual_layernorm)


def _site_scales(qf, act_scales, proj_key: str, n_proj: int):
    """act_scales -> (six site scales, None where dynamic or unused;
    proj8), with JAX's truncation of a proj tuple on a block without proj
    weights."""
    if "w1_p" in qf or "wqkv_p" in qf:
        raise NotImplementedError(INT4_NOT_PORTED)
    if act_scales is None:
        return (None,) * 6, False
    sc = tuple(float(a) for a in act_scales)
    proj8 = proj_key in qf and len(sc) >= n_proj
    if not proj8:
        sc = sc[:3]
    return sc + (None,) * (6 - len(sc)), proj8


def _qsite(ops: _QPrims, x, wq, sw, bias, a: Optional[float], *,
           relu: bool = False, out_dtype=F32):
    """One int8 site: quantize x [M, K] (per row when a is None, else with
    the static scale a), then the int8 product and its epilogue."""
    if a is None:
        xq, sx = ops.quantize(x)
        return ops.gemm_s8(xq, wq, sw, bias, sx=sx, relu=relu,
                           out_dtypes=(out_dtype,))[0]
    xq, _ = ops.quantize(x, 1.0 / a)
    return ops.gemm_s8(xq, wq, sw, bias, a=a, relu=relu,
                       out_dtypes=(out_dtype,))[0]


def _qkv(ops, xs, wp, qf, w_key, b_key, a):
    """The fused self-attention qkv [M, 3D] bf16: int8 from the stream as
    read where the block quantizes it, else the bf16 product."""
    if "wqkv_q" in qf:
        return _qsite(ops, xs, qf["wqkv_q"], qf["sqkv"], wp[b_key], a,
                      out_dtype=BF16)
    return ops.gemm(xs.to(BF16), wp[w_key], wp[b_key], out_dtype=BF16)


def _merge(ops, att, wp, qf, w_key, q_key, s_key, a, proj8):
    """A merge projection (no bias: it joins the residual in the LN)."""
    if proj8:
        return _qsite(ops, att, qf[q_key], qf[s_key], None, a)
    return ops.gemm(att, wp[w_key])


def _ffn_ln(ops, x32, wp, qf, a1, a2, ln_s, ln_b, out_dtype):
    h1 = _qsite(ops, x32, qf["w1_q"], qf["s1"], qf["b1"], a1, relu=True)
    y = _qsite(ops, h1, qf["w2_q"], qf["s2"], qf["b2"], a2)
    return ops.layernorm(x32, y, None, wp[ln_s], wp[ln_b],
                         out_dtypes=(out_dtype,))[0]


def _qffn_sa_block(ops, x, x_mask, wp, qf, num_heads, act_scales):
    a, proj8 = _site_scales(qf, act_scales, "wm_q", 4)
    att_dtype = F32 if proj8 else BF16
    B, L, D = x.shape
    xs = x.reshape(B * L, D)
    qkv = _qkv(ops, xs, wp, qf, "wqkv", "bqkv", a[0])
    att = ops.attention(*_qkv_heads(qkv, B, L, num_heads), x_mask,
                        out_dtype=att_dtype)
    y = _merge(ops, att.view(B * L, D), wp, qf, "wm", "wm_q", "sm", a[3],
               proj8)
    x1 = ops.layernorm(xs, y, wp["bm"], wp["ln1_s"], wp["ln1_b"],
                       out_dtypes=(F32,))[0]
    out = _ffn_ln(ops, x1, wp, qf, a[1], a[2], "ln2_s", "ln2_b", x.dtype)
    return out.view(B, L, D)


def _qffn_sga_block(ops, v, kq, vq, v_mask, q_mask, wp, qf, num_heads,
                    act_scales):
    a, proj8 = _site_scales(qf, act_scales, "wm1_q", 6)
    att_dtype = F32 if proj8 else BF16
    B, L, D = v.shape
    vs = v.reshape(B * L, D)
    # self-attention over the regions + merge + LN1
    qkv = _qkv(ops, vs, wp, qf, "wqkv1", "bqkv1", a[0])
    att = ops.attention(*_qkv_heads(qkv, B, L, num_heads), v_mask,
                        out_dtype=att_dtype)
    y = _merge(ops, att.view(B * L, D), wp, qf, "wm1_full", "wm1_q", "sm1",
               a[3], proj8)
    # cross-attention against the pre-projected question k/v + LN2; the
    # cross-q site quantizes v1 from f32, the bf16 product reads its copy
    if proj8:
        v1 = ops.layernorm(vs, y, wp["bm1"], wp["ln1_s"], wp["ln1_b"],
                           out_dtypes=(F32,))[0]
        qx = _qsite(ops, v1, qf["wq2_q"], qf["sq2"], wp["bq2_full"], a[4],
                    out_dtype=BF16)
    else:
        v1, v1b = ops.layernorm(vs, y, wp["bm1"], wp["ln1_s"], wp["ln1_b"],
                                out_dtypes=(F32, BF16))
        qx = ops.gemm(v1b, wp["wq2_full"], wp["bq2_full"], out_dtype=BF16)
    att = ops.attention(split_heads(qx.view(B, L, D), num_heads), kq, vq,
                        q_mask, out_dtype=att_dtype)
    y = _merge(ops, att.view(B * L, D), wp, qf, "wm2_full", "wm2_q", "sm2",
               a[5], proj8)
    v2 = ops.layernorm(v1, y, wp["bm2"], wp["ln2_s"], wp["ln2_b"],
                       out_dtypes=(F32,))[0]
    # int8 FFN + LN3
    out = _ffn_ln(ops, v2, wp, qf, a[1], a[2], "ln3_s", "ln3_b", v.dtype)
    return out.view(B, L, D)


def fused_qffn_sa_block_plain(x, x_mask, wp, qf, *, num_heads: int,
                              act_scales=None):
    return _qffn_sa_block(_PLAIN, x, x_mask, wp, qf, num_heads, act_scales)


def fused_qffn_sga_block_plain(v, kq, vq, v_mask, q_mask, wp, qf, *,
                               num_heads: int, act_scales=None):
    return _qffn_sga_block(_PLAIN, v, kq, vq, v_mask, q_mask, wp, qf,
                           num_heads, act_scales)


def fused_qffn_sa_block(x: torch.Tensor, x_mask: torch.Tensor,
                        wp: Mapping[str, torch.Tensor],
                        qf: Mapping[str, torch.Tensor], *, num_heads: int,
                        act_scales=None) -> torch.Tensor:
    """One whole SA encoder block with int8 sites: x [B, L, D] (bf16 or f32
    stream), x_mask bool [B, 1, 1, L] (True = PAD), wp the bf16 layout
    (``prepare_sa_block_params``), qf its int8 weights
    (``prepare_qffn_params``). Returns [B, L, D] in x's dtype."""
    if not kernels.on_cuda(x):
        return fused_qffn_sa_block_plain(x, x_mask, wp, qf,
                                         num_heads=num_heads,
                                         act_scales=act_scales)
    _check_stream("fused_qffn_sa_block", x)
    out = _qffn_sa_block(_CUDA, x, x_mask, wp, qf, num_heads, act_scales)
    kernels.LAUNCHES["fused_qffn_sa_block"] += 1
    return out


def fused_qffn_sga_block(v: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                         v_mask: torch.Tensor, q_mask: torch.Tensor,
                         wp: Mapping[str, torch.Tensor],
                         qf: Mapping[str, torch.Tensor], *, num_heads: int,
                         act_scales=None) -> torch.Tensor:
    """One whole SGA decoder block with int8 sites: v [B, Lv, D] (bf16 or
    f32 stream), kq/vq [B, H, Lq, Dh] pre-projected cross keys / values,
    v_mask / q_mask bool [B, 1, 1, L], wp from
    ``prepare_sga_block_params``, qf from ``prepare_qffn_params``. Returns
    [B, Lv, D] in v's dtype."""
    if not kernels.on_cuda(v):
        return fused_qffn_sga_block_plain(v, kq, vq, v_mask, q_mask, wp, qf,
                                          num_heads=num_heads,
                                          act_scales=act_scales)
    _check_stream("fused_qffn_sga_block", v)
    out = _qffn_sga_block(_CUDA, v, kq, vq, v_mask, q_mask, wp, qf,
                          num_heads, act_scales)
    kernels.LAUNCHES["fused_qffn_sga_block"] += 1
    return out
