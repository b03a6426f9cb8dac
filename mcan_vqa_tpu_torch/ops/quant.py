"""The quantized serving blocks and their quantization
(mcan_vqa_tpu/ops/quant.py): the qffn levels 1-7 of the shipped engine and
the full-int8 engine.

  * weights: ``_quant_w`` -- per-out-channel symmetric int8 of an [in, out]
    kernel, s = max|w| / 127 (0 -> 1); ``_quant_w4`` -- symmetric int4 per
    (128-row group, out-channel), s = max|w| / 7, rows j and j + K/2
    nibble-packed into one byte (``_unpack_w4``); ``prepare_qffn_params``
    quantizes a block's FFN, and by level its fused qkv and its merge /
    cross-q projections (int4 FFN at w4 >= 1, int4 qkv at w4 = 2);
    ``prepare_q8aux_params`` the static-int8 aux sites (cross k/v, AttFlat
    merges, answer head); ``prepare_quant_sa_params`` /
    ``prepare_quant_sga_params`` every projection of a block, from f32
    weights, for the full-int8 engine;
  * activations: ``_qrow`` (dynamic per-row scales), ``_qdot`` and
    ``_qdot_static`` (one calibrated per-tensor scale) as plain functions;
  * calibration: ``calibrate_qffn_act_scales`` replays the blocks' math in
    plain PyTorch over a batch and records each int8 site's max
    |activation| (x margin / 127), as the JAX replay does (quant.py:736),
    with the int4 sites (``w4dq`` for levels 6/7) and the aux sites;
  * the blocks: ``fused_qffn_sa_block`` (TPU kernel ``_sa_kernel_qffn``,
    quant.py:1184, called at :1412), ``fused_qffn_sga_block``
    (``_sga_kernel_qffn``, :1057, called at :1326), ``fused_quant_sa_block``
    (``_qsa_kernel``, :464, called at :599) and ``fused_quant_sga_block``
    (``_qsga_kernel``, :391, called at :539).

Each block is written once over a set of primitives, as ops/sga_block.py
does: the plain set runs on the CPU, the CUDA set on the card
(ops/kernels.py: ``quantize_rows`` and ``gemm_s8`` at every int8 site,
``gemm_s4`` at the int4 sites of levels 4/5, ``gemm_w4bf16`` at those of
levels 6/7, the bf16 ``gemm_bias_act`` at the others, ``masked_attention``
and ``residual_layernorm``). Each CUDA block call adds one to
``kernels.LAUNCHES["fused_qffn_sa_block" / "fused_qffn_sga_block" /
"fused_quant_sa_block" / "fused_quant_sga_block"]``, and a qffn block at an
int4 level also to ``"<name>_level<4-7>"``. While ``torch.export`` traces
a block (artifact.py) it runs the CUDA set on either device, whose wrappers
then become ``torch.ops.mcan.*`` ops, and counts nothing.

Precision path, that of the TPU kernels: the FFN input is quantized from
the f32 LayerNorm output; h1 = relu(int8 dot) stays f32 and is quantized
again for w2 (a dynamic scale needs the max over all F columns); the qkv
site quantizes the bf16 stream as read; the cross-q site quantizes v1 in
f32; q/k/v and the probabilities are bf16; at level 3 the attention output
reaches its merge site in f32 (quant.py:1139-1141, :1158-1160, :1240-1242).
The int4 sites of levels 4/5 take the same static codes; those of levels
6/7 quantize no activation and read bf16(x) (the LayerNorm writes the bf16
copy, h1 leaves w1 as bf16). The full-int8 blocks are level 3 with every
site dynamic, the stream f32 in and out (quant.py:391-511). Attention is
per sample, as in every block of the port.

``act_scales``: None for dynamic per-row scales; a 3-tuple (aqkv, a1, a2)
for the qkv and FFN sites; a 6-tuple (SGA: + am1, aq2, am2) or 4-tuple
(SA: + am) for level 3 and up. A longer tuple is cut to 3 where the block
carries no proj weights (quant.py:1316-1318, :1407-1409). An int4 block
needs static scales.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from mcan_vqa_tpu_torch.models.attention import split_heads
from mcan_vqa_tpu_torch.models.layers import (BF16, bf16_matmul, make_mask,
                                              std_layer_norm)
from mcan_vqa_tpu_torch.models.lstm import lstm_forward
from mcan_vqa_tpu_torch.models.net import attflat_pool
from mcan_vqa_tpu_torch.ops import kernels
from mcan_vqa_tpu_torch.ops.kernels import F32, I8, _f32, true_div
from mcan_vqa_tpu_torch.ops.sga_block import _check_stream, _qkv_heads, _vec

NEG_INF = -1e9
W4_GROUP = kernels.W4_GROUP
_unpack_w4 = kernels.unpack_w4


# ---------------------------------------------------------------------------
# weights and the plain int8 dots
# ---------------------------------------------------------------------------

def _quant_w(kernel: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] kernel -> int8 weight + f32 per-out-channel scale. The
    weight keeps JAX's [in, out] shape and values, stored K-major
    (``kernels.k_major``: the layout ``gemm_s8`` reads), once, here, for
    every engine that quantizes."""
    w32 = kernel.float()
    s = true_div(w32.abs().amax(dim=0), 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    wq = torch.round(w32 / s).clamp_(-127.0, 127.0).to(I8)
    return {"w_q": kernels.k_major(wq), "w_scale": s.contiguous()}


def _quant_w4(kernel: torch.Tensor, group: int = W4_GROUP
              ) -> Dict[str, torch.Tensor]:
    """[in, out] kernel -> nibble-packed int4 weight [K/2, out] int8 and
    grouped scales [K/g, out] f32 (quant.py:56): q = round(w / s) in
    [-7, 7], s = max|w| over each g-row slab / 7 (0 -> 1); rows j and
    j + K/2 share a byte, (q_lo + 8) | (q_hi + 8) << 4, so JAX-packed
    weights load unchanged. The packed weight keeps JAX's shape and values,
    stored K-major (``kernels.k_major``: the layout ``gemm_s4`` and
    ``gemm_w4bf16`` read), once, here, for every int4 engine."""
    w32 = kernel.float()
    K = w32.shape[0]
    g = min(group, K)
    if K % 2 or K % g:
        raise ValueError(f"_quant_w4: K={K} must be even and a multiple of "
                         f"the group {g}")
    s = true_div(w32.abs().reshape(K // g, g, -1).amax(dim=1), 7.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.round(w32 / s.repeat_interleave(g, dim=0)).clamp_(-7.0, 7.0)
    n = (q + 8.0).to(torch.int32)
    packed = (n[:K // 2] | (n[K // 2:] << 4)).to(torch.uint8)
    return {"w_p": kernels.k_major(packed.view(I8)),
            "w_gscale": s.contiguous()}


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
    """One block's bf16 layout (``_mk``, ops/sga_block.py) -> its quantized
    weights and f32 scales, keyed as JAX ``prepare_qffn_params`` (:639):
    the FFN always (int8 w1_q / s1, w2_q / s2, or at w4 >= 1 int4 w1_p /
    s1_g, w2_p / s2_g; b1, b2); qkv_int8 the fused self-attention qkv
    (wqkv_q / sqkv, or int4 wqkv_p / sqkv_g at w4 = 2); proj_int8 the
    merges and the decoder's cross q, int8 at every level (SA: wm_q / sm;
    SGA: wm1_q, wq2_q, wm2_q and their scales). The ``_mk`` weights are
    already the bf16-rounded kernels, which is what JAX quantizes (its
    bf16 cast runs first, serving.py:189)."""
    out = {"b1": wp["b1"].float(), "b2": wp["b2"].float()}
    if w4 >= 1:
        q1, q2 = _quant_w4(wp["w1"]), _quant_w4(wp["w2"])
        out.update(w1_p=q1["w_p"], s1_g=q1["w_gscale"], w2_p=q2["w_p"],
                   s2_g=q2["w_gscale"])
    else:
        q1, q2 = _quant_w(wp["w1"]), _quant_w(wp["w2"])
        out.update(w1_q=q1["w_q"], s1=q1["w_scale"], w2_q=q2["w_q"],
                   s2=q2["w_scale"])
    is_sga = "wqkv1" in wp
    if qkv_int8:
        wqkv = wp["wqkv1" if is_sga else "wqkv"]
        if w4 >= 2:
            qq = _quant_w4(wqkv)
            out["wqkv_p"], out["sqkv_g"] = qq["w_p"], qq["w_gscale"]
        else:
            qq = _quant_w(wqkv)
            out["wqkv_q"], out["sqkv"] = qq["w_q"], qq["w_scale"]
    if proj_int8:
        sites = ((("wm1_full", "wm1_q", "sm1"), ("wq2_full", "wq2_q", "sq2"),
                  ("wm2_full", "wm2_q", "sm2")) if is_sga
                 else (("wm", "wm_q", "sm"),))
        for src, wq, ws in sites:
            q = _quant_w(wp[src])
            out[wq], out[ws] = q["w_q"], q["w_scale"]
    return out


def _aux_site(kernel: torch.Tensor, bias: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    q = _quant_w(kernel)
    return {"w_q": q["w_q"], "w_s": q["w_scale"], "b": bias.float()}


def prepare_q8aux_params(params: Mapping[str, Any], num_layers: int
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The static-int8 aux sites (quant.py:702), the products outside the
    blocks: each decoder block's cross k/v [D, 2D], both AttFlat merges and
    the answer head, from a prepared serving tree (ops/serving.py
    ``prepare_params``; bf16 kernels). -> {"dec_i_kv" / "lang_merge" /
    "img_merge" / "proj": {w_q, w_s, b}}, per-out-channel int8
    (``_quant_w``, K-major for ``gemm_s8``, the head's 3129 answers
    too)."""
    aux: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in range(num_layers):
        kv = params["backbone"][f"dec_{i}"]["mhatt2"]["linear_kv"]
        aux[f"dec_{i}_kv"] = _aux_site(kv["kernel"], kv["bias"])
    for name, head in (("lang_merge", "attflat_lang"),
                       ("img_merge", "attflat_img")):
        m = params[head]["linear_merge"]
        aux[name] = _aux_site(m["kernel"], m["bias"])
    aux["proj"] = _aux_site(params["proj"]["kernel"], params["proj"]["bias"])
    return aux


def _f32_kernel(p: Mapping[str, torch.Tensor], name: str, device
                ) -> torch.Tensor:
    """A reference Linear weight [out, in] -> the JAX kernel [in, out] in
    f32 (the full-int8 engine quantizes the f32 weights, quant.py:88)."""
    return p[f"{name}.weight"].detach().to(device, torch.float32).t()


def _quant_sites(sites) -> Dict[str, torch.Tensor]:
    out = {}
    for name, k in sites:
        q = _quant_w(k)
        out[f"w_{name}"], out[f"s_{name}"] = q["w_q"], q["w_scale"]
    return out


def _biases(p, names, device):
    return {key: _vec(p, src).to(device) for key, src in names}


def prepare_quant_sa_params(p: Mapping[str, torch.Tensor], device="cpu"
                            ) -> Dict[str, torch.Tensor]:
    """One encoder block, keyed as the reference SA block
    (``mhatt.linear_q.weight`` ...), -> the full-int8 layout of
    ``prepare_quant_sa_params`` (quant.py:364): int8 w_qkv, w_m, w_w1, w_w2
    with their s_ scales, f32 biases and LN, on ``device``."""
    qkv = torch.cat([_f32_kernel(p, f"mhatt.linear_{n}", device)
                     for n in "qkv"], dim=1)
    out = _quant_sites((("qkv", qkv),
                        ("m", _f32_kernel(p, "mhatt.linear_merge", device)),
                        ("w1", _f32_kernel(p, "ffn.mlp.fc.linear", device)),
                        ("w2", _f32_kernel(p, "ffn.mlp.linear", device))))
    out["b_qkv"] = torch.cat([_vec(p, f"mhatt.linear_{n}.bias")
                              for n in "qkv"]).to(device)
    out.update(_biases(p, (("b_m", "mhatt.linear_merge.bias"),
                           ("b_w1", "ffn.mlp.fc.linear.bias"),
                           ("b_w2", "ffn.mlp.linear.bias"),
                           ("ln1_s", "norm1.a_2"), ("ln1_b", "norm1.b_2"),
                           ("ln2_s", "norm2.a_2"), ("ln2_b", "norm2.b_2")),
                       device))
    return out


def prepare_quant_sga_params(p: Mapping[str, torch.Tensor], device="cpu"
                             ) -> Dict[str, torch.Tensor]:
    """One decoder block, keyed as the reference SGA block, -> the
    full-int8 layout of ``prepare_quant_sga_params`` (quant.py:330): int8
    w_qkv1, w_m1, w_q2, w_m2, w_w1, w_w2 with their s_ scales, f32 biases
    and LN. The cross k/v runs outside the block."""
    qkv = torch.cat([_f32_kernel(p, f"mhatt1.linear_{n}", device)
                     for n in "qkv"], dim=1)
    out = _quant_sites((("qkv1", qkv),
                        ("m1", _f32_kernel(p, "mhatt1.linear_merge", device)),
                        ("q2", _f32_kernel(p, "mhatt2.linear_q", device)),
                        ("m2", _f32_kernel(p, "mhatt2.linear_merge", device)),
                        ("w1", _f32_kernel(p, "ffn.mlp.fc.linear", device)),
                        ("w2", _f32_kernel(p, "ffn.mlp.linear", device))))
    out["b_qkv1"] = torch.cat([_vec(p, f"mhatt1.linear_{n}.bias")
                               for n in "qkv"]).to(device)
    out.update(_biases(p, (("b_m1", "mhatt1.linear_merge.bias"),
                           ("b_q2", "mhatt2.linear_q.bias"),
                           ("b_m2", "mhatt2.linear_merge.bias"),
                           ("b_w1", "ffn.mlp.fc.linear.bias"),
                           ("b_w2", "ffn.mlp.linear.bias"),
                           ("ln1_s", "norm1.a_2"), ("ln1_b", "norm1.b_2"),
                           ("ln2_s", "norm2.a_2"), ("ln2_b", "norm2.b_2"),
                           ("ln3_s", "norm3.a_2"), ("ln3_b", "norm3.b_2")),
                       device))
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


# The replay helpers: plain mirrors of the quantized blocks' math (bf16
# attention matmuls, f32 softmax / LN, int8 and int4 dots) with JAX's
# replay roundings (quant.py:849-1055): 1 / a and a * sw in f32, the scores
# divided by sqrt(Dh), the pad mask added as mask * -1e9, residuals summed
# (x + y) + bias. Every max runs over the whole batch, padding rows
# included, as in JAX.

def _cal_scale_of(x: torch.Tensor, margin: float) -> torch.Tensor:
    m = true_div(x.abs().max(), 127.0) * _f32(margin)
    return torch.where(m == 0.0, torch.ones_like(m), m)


def _cal_codes(x, a):
    return torch.round(x * (1.0 / a)).clamp_(-127.0, 127.0).to(I8)


def _cal_qdot(x, a, wq, sw, b):
    return kernels.int8_dot_exact(_cal_codes(x, a), wq) * (a * sw) + b


def _cal_qdot4(x, a, wp, s4, b):
    """``_cal_qdot4`` (quant.py:862): the static codes against the packed
    int4 weight, one exact product per K-group, summed in order."""
    xq, w = _cal_codes(x, a), _unpack_w4(wp)
    g = w.shape[0] // s4.shape[0]
    y = None
    for gi in range(s4.shape[0]):
        t = kernels.int8_dot_exact(xq[:, gi * g:(gi + 1) * g],
                                   w[gi * g:(gi + 1) * g]) * (a * s4[gi])
        y = t if y is None else y + t
    return y + b


def _cal_qdot4dq(x, wp, s4, b):
    """``_cal_qdot4dq`` (quant.py:881): bf16(x) against the bf16-dequantized
    int4 weight, no activation quantization."""
    return bf16_matmul(x, kernels.dequant_w4(wp, s4)) + b


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


def _cal_qkv_site(flat, wp, qf, wqkv_key, bqkv, margin, w4dq=False):
    if "wqkv_p" in qf:
        aq = _cal_scale_of(flat, margin)
        if w4dq:
            return _cal_qdot4dq(flat, qf["wqkv_p"], qf["sqkv_g"], bqkv), aq
        return _cal_qdot4(flat, aq, qf["wqkv_p"], qf["sqkv_g"], bqkv), aq
    if "wqkv_q" in qf:
        aq = _cal_scale_of(flat, margin)
        return _cal_qdot(flat, aq, qf["wqkv_q"], qf["sqkv"], bqkv), aq
    return _cal_bdot(flat, wp[wqkv_key], bqkv), \
        torch.ones((), dtype=F32, device=flat.device)


def _cal_ffn_sites(qf, xin, margin, w4dq=False):
    a1 = _cal_scale_of(xin, margin)
    if "w1_p" in qf and w4dq:
        h1 = torch.relu(_cal_qdot4dq(xin, qf["w1_p"], qf["s1_g"], qf["b1"]))
    elif "w1_p" in qf:
        h1 = torch.relu(_cal_qdot4(xin, a1, qf["w1_p"], qf["s1_g"],
                                   qf["b1"]))
    else:
        h1 = torch.relu(_cal_qdot(xin, a1, qf["w1_q"], qf["s1"], qf["b1"]))
    a2 = _cal_scale_of(h1, margin)
    if "w2_p" in qf and w4dq:
        y = _cal_qdot4dq(h1, qf["w2_p"], qf["s2_g"], qf["b2"])
    elif "w2_p" in qf:
        y = _cal_qdot4(h1, a2, qf["w2_p"], qf["s2_g"], qf["b2"])
    else:
        y = _cal_qdot(h1, a2, qf["w2_q"], qf["s2"], qf["b2"])
    return a1, a2, y


def _cal_proj_site(flat, wq, sw, margin):
    a = _cal_scale_of(flat, margin)
    return _cal_qdot(flat, a, wq, sw, 0.0), a


def _cal_attflat(p, site, x, mask, margin):
    """The AttFlat replay with its static-int8 merge site (quant.py:959)
    -> (merged f32, a)."""
    B, L, D = x.shape
    mlp = p["mlp"]
    fc = mlp["FCLayer_0"]["Dense_0"]
    h = torch.relu(_cal_bdot(x.float().reshape(B * L, D), fc["kernel"],
                             fc["bias"]))
    logits = _cal_bdot(h, mlp["Dense_0"]["kernel"],
                       mlp["Dense_0"]["bias"]).reshape(B, L, -1)
    pooled = attflat_pool(logits, x, mask)
    a = _cal_scale_of(pooled, margin)
    return _cal_qdot(pooled, a, site["w_q"], site["w_s"], site["b"]), a


def _cal_sa_block(block, q, mask, num_heads, margin, w4dq=False):
    """One SA block of the replay -> (stream out bf16, (aq, a1, a2) or
    (aq, a1, a2, am) with proj-int8 weights)."""
    wp, qf = block["_mk"], block["_qffn"]
    B, Lq, D = q.shape
    x = q.float()
    flat = x.reshape(B * Lq, D)
    qkv, aq = _cal_qkv_site(flat, wp, qf, "wqkv", wp["bqkv"], margin, w4dq)
    qx, kx, vx = qkv.reshape(B, Lq, 3 * D).split(D, dim=-1)
    att = _cal_sdpa(qx, kx, vx, mask, num_heads).reshape(B * Lq, D)
    if "wm_q" in qf:
        y, am = _cal_proj_site(att, qf["wm_q"], qf["sm"], margin)
    else:
        y, am = _cal_bdot(att, wp["wm"]), None
    x1 = std_layer_norm(x + y.reshape(B, Lq, D) + wp["bm"], wp["ln1_s"],
                        wp["ln1_b"])
    a1, a2, y = _cal_ffn_sites(qf, x1.reshape(B * Lq, D), margin, w4dq)
    x2 = std_layer_norm(x1 + y.reshape(B, Lq, D), wp["ln2_s"], wp["ln2_b"])
    return x2.to(BF16), (aq, a1, a2) if am is None else (aq, a1, a2, am)


def _cal_sga_block(dec, v, q, v_mask, q_mask, num_heads, margin,
                   w4dq=False, kv_q8=None):
    """One SGA block of the replay -> (stream out bf16, (aq, a1, a2) or
    (aq, a1, a2, am1, aq2, am2) with proj-int8 weights). kv_q8: (a_kv, the
    ``_q8aux`` site) for the static-int8 cross k/v."""
    wp, qf = dec["_mk"], dec["_qffn"]
    B, Lv, D = v.shape
    if kv_q8 is not None:
        a_kv, site = kv_q8
        Lq = q.shape[1]
        kv = _cal_qdot(q.float().reshape(B * Lq, D), a_kv, site["w_q"],
                       site["w_s"], site["b"]).reshape(B, Lq, 2 * D)
    else:
        kv = dec["mhatt2"]["linear_kv"]
        kv = _cal_bdot(q, kv["kernel"], kv["bias"])
    kq, vq = kv.split(D, dim=-1)
    proj8 = "wm1_q" in qf

    x = v.float()
    flat = x.reshape(B * Lv, D)
    qkv, aq = _cal_qkv_site(flat, wp, qf, "wqkv1", wp["bqkv1"], margin, w4dq)
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

    a1, a2, y = _cal_ffn_sites(qf, v2.reshape(B * Lv, D), margin, w4dq)
    v3 = std_layer_norm(v2 + y.reshape(B, Lv, D), wp["ln3_s"], wp["ln3_b"])
    scales = (aq, a1, a2, am1, aq2, am2) if proj8 else (aq, a1, a2)
    return v3.to(BF16), scales


def calibrate_qffn_act_scales(params: Mapping[str, Any], img_feat, ques_ix,
                              num_layers: int, num_heads: int,
                              margin: float = 1.1, w4dq: bool = False
                              ) -> Dict[str, tuple]:
    """Static per-tensor activation scales for the quantized engine.

    params: a prepared serving tree with ``_qffn`` on every block
    (ops/serving.py ``prepare_params(qffn=...)``), and optionally the aux
    sites ``_q8aux`` (``prepare_q8aux_params``). img_feat [B, R, F] f32 and
    ques_ix [B, T] int (numpy arrays or tensors) are the calibration batch.
    Replays the blocks in plain PyTorch on the params' device and returns
    {"enc_i" / "dec_i": (aqkv, a1, a2[, proj scales])} as Python floats
    (scale = max / 127 x margin; values past it saturate at +-127), and
    with ``_q8aux`` also "aux": (a_kv, a_lang_merge, a_img_merge, a_head),
    the decoder replayed on the static-int8 cross k/v. The qkv scale is 1.0
    where the block keeps a bf16 qkv. w4dq: the int4 sites run the
    bf16-dequant compute of levels 6/7."""
    emb = params["embedding"]["embedding"]
    img = torch.as_tensor(img_feat, dtype=F32).to(emb.device)
    ques = torch.as_tensor(ques_ix).to(emb.device).long()
    aux_w = params.get("_q8aux")
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
                                                  num_heads, margin, w4dq)
        a_kv = None if aux_w is None else _cal_scale_of(q.float(), margin)
        for i in range(num_layers):
            kv_q8 = None if aux_w is None else (a_kv, aux_w[f"dec_{i}_kv"])
            v, scales[f"dec_{i}"] = _cal_sga_block(
                bb[f"dec_{i}"], v, q, v_mask, q_mask, num_heads, margin,
                w4dq, kv_q8)
        if aux_w is not None:
            lang, a_lang = _cal_attflat(params["attflat_lang"],
                                        aux_w["lang_merge"], q, q_mask,
                                        margin)
            img_flat, a_img = _cal_attflat(params["attflat_img"],
                                           aux_w["img_merge"], v, v_mask,
                                           margin)
            pn = params["proj_norm"]
            fused = std_layer_norm(lang + img_flat, pn["scale"], pn["bias"])
            scales["aux"] = (a_kv, a_lang, a_img,
                             _cal_scale_of(fused, margin))
    return _check_scales({k: tuple(float(x) for x in tup)
                          for k, tup in scales.items()})


def calibrate_classifier_act_scales(params: Mapping[str, Any], img_feat,
                                    num_layers: int, num_heads: int,
                                    margin: float = 1.1, w4dq: bool = False
                                    ) -> Dict[str, tuple]:
    """The classifier's twin of ``calibrate_qffn_act_scales`` (quant.py:
    819-840): the image-only SA stack replayed on the calibration batch
    img_feat [B, R, F]. params: a prepared classifier tree with ``_qffn``
    on every block (ops/serving.py ``prepare_classifier_params``, pruned
    or not). -> {"enc_i": (aqkv, a1, a2[, am])} as Python floats."""
    ifl = params["img_feat_linear"]
    img = torch.as_tensor(img_feat, dtype=F32).to(ifl["kernel"].device)
    with torch.no_grad():
        v_mask = make_mask(img)
        v = _cal_bdot(img, ifl["kernel"], ifl["bias"]).to(BF16)
        bb = params["backbone"]
        scales: Dict[str, tuple] = {}
        for i in range(num_layers):
            v, scales[f"enc_{i}"] = _cal_sa_block(bb[f"enc_{i}"], v, v_mask,
                                                  num_heads, margin, w4dq)
    return _check_scales({k: tuple(float(x) for x in tup)
                          for k, tup in scales.items()})


# ---------------------------------------------------------------------------
# the blocks, written once over a set of primitives
# ---------------------------------------------------------------------------

class _QPrims(NamedTuple):
    gemm: Callable
    gemm_s8: Callable
    gemm_s4: Callable
    gemm_w4bf16: Callable
    quantize: Callable
    attention: Callable
    layernorm: Callable


_PLAIN = _QPrims(kernels.gemm_bias_act_plain, kernels.gemm_s8_plain,
                 kernels.gemm_s4_plain, kernels.gemm_w4bf16_plain,
                 kernels.quantize_rows_plain, kernels.masked_attention_plain,
                 kernels.residual_layernorm_plain)
_CUDA = _QPrims(kernels.gemm_bias_act, kernels.gemm_s8, kernels.gemm_s4,
                kernels.gemm_w4bf16, kernels.quantize_rows,
                kernels.masked_attention, kernels.residual_layernorm)


def _qffn_args(qf, act_scales, proj_key: str, n_proj: int, w4dq: bool):
    """act_scales -> (six site scales, None where dynamic or unused; proj8;
    the bf16-dequant int4 compute), with JAX's truncation of a proj tuple
    on a block without proj weights (quant.py:1311-1318)."""
    w4 = "w1_p" in qf or "wqkv_p" in qf
    if w4 and act_scales is None:
        raise ValueError("int4 (w4) blocks ship only with calibrated static "
                         "act scales")
    if act_scales is None:
        return (None,) * 6, False, False
    sc = tuple(float(a) for a in act_scales)
    proj8 = proj_key in qf and len(sc) >= n_proj
    if not proj8:
        sc = sc[:3]
    return sc + (None,) * (6 - len(sc)), proj8, w4 and bool(w4dq)


def _int4_level(qf, dq: bool) -> int:
    """The qffn level of an int4 block (4-7), 0 for an int8 one."""
    w4 = 2 if "wqkv_p" in qf else 1 if "w1_p" in qf else 0
    return w4 and {1: 4, 2: 5}[w4] + 2 * dq


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


def _q4site(ops: _QPrims, x, wp4, s4, bias, a: float, dq: bool, *,
            relu: bool = False, out_dtype=F32):
    """One int4 site: the static codes of x against the packed weight
    (``_qdot_static4``), or with dq bf16(x) against its bf16 dequant
    (``_qdot_w4bf16``; ``a`` unused)."""
    if dq:
        return ops.gemm_w4bf16(x.to(BF16), wp4, s4, bias, relu=relu,
                               out_dtype=out_dtype)
    xq, _ = ops.quantize(x, 1.0 / a)
    return ops.gemm_s4(xq, wp4, s4, bias, a=a, relu=relu,
                       out_dtypes=(out_dtype,))[0]


def _qkv(ops, xs, wp, qf, w_key, b_key, a, dq):
    """The fused self-attention qkv [M, 3D] bf16: int4 or int8 from the
    stream as read where the block quantizes it, else the bf16 product."""
    if "wqkv_p" in qf:
        return _q4site(ops, xs, qf["wqkv_p"], qf["sqkv_g"], wp[b_key], a,
                       dq, out_dtype=BF16)
    if "wqkv_q" in qf:
        return _qsite(ops, xs, qf["wqkv_q"], qf["sqkv"], wp[b_key], a,
                      out_dtype=BF16)
    return ops.gemm(xs.to(BF16), wp[w_key], wp[b_key], out_dtype=BF16)


def _merge(ops, att, wp, qf, w_key, q_key, s_key, a, proj8):
    """A merge projection (no bias: it joins the residual in the LN)."""
    if proj8:
        return _qsite(ops, att, qf[q_key], qf[s_key], None, a)
    return ops.gemm(att, wp[w_key])


def _ffn_ln(ops, x32, xb, wp, qf, a1, a2, dq, ln_s, ln_b, out_dtype):
    """The FFN and its LayerNorm: int4 (x32 quantized, or with dq its bf16
    copy xb read, and h1 kept bf16) or int8 sites."""
    if "w1_p" in qf:
        h1 = _q4site(ops, xb if dq else x32, qf["w1_p"], qf["s1_g"],
                     qf["b1"], a1, dq, relu=True,
                     out_dtype=BF16 if dq else F32)
        y = _q4site(ops, h1, qf["w2_p"], qf["s2_g"], qf["b2"], a2, dq)
    else:
        h1 = _qsite(ops, x32, qf["w1_q"], qf["s1"], qf["b1"], a1, relu=True)
        y = _qsite(ops, h1, qf["w2_q"], qf["s2"], qf["b2"], a2)
    return ops.layernorm(x32, y, None, wp[ln_s], wp[ln_b],
                         out_dtypes=(out_dtype,))[0]


def _ffn_input(ops, res, y, bias, wp, ln_s, ln_b, dq):
    """The LayerNorm before the FFN -> (f32 output, its bf16 copy with dq,
    which the bf16-dequant w1 reads, else None)."""
    outs = ops.layernorm(res, y, bias, wp[ln_s], wp[ln_b],
                         out_dtypes=(F32, BF16) if dq else (F32,))
    return outs[0], outs[1] if dq else None


def _sa_body(ops, x, x_mask, wp, qf, num_heads, a, proj8, dq):
    att_dtype = F32 if proj8 else BF16
    B, L, D = x.shape
    xs = x.reshape(B * L, D)
    qkv = _qkv(ops, xs, wp, qf, "wqkv", "bqkv", a[0], dq)
    att = ops.attention(*_qkv_heads(qkv, B, L, num_heads), x_mask,
                        out_dtype=att_dtype)
    y = _merge(ops, att.view(B * L, D), wp, qf, "wm", "wm_q", "sm", a[3],
               proj8)
    x1, x1b = _ffn_input(ops, xs, y, wp["bm"], wp, "ln1_s", "ln1_b", dq)
    out = _ffn_ln(ops, x1, x1b, wp, qf, a[1], a[2], dq, "ln2_s", "ln2_b",
                  x.dtype)
    return out.view(B, L, D)


def _sga_body(ops, v, kq, vq, v_mask, q_mask, wp, qf, num_heads, a, proj8,
              dq):
    att_dtype = F32 if proj8 else BF16
    B, L, D = v.shape
    vs = v.reshape(B * L, D)
    # self-attention over the regions + merge + LN1
    qkv = _qkv(ops, vs, wp, qf, "wqkv1", "bqkv1", a[0], dq)
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
    v2, v2b = _ffn_input(ops, v1, y, wp["bm2"], wp, "ln2_s", "ln2_b", dq)
    # quantized FFN + LN3
    out = _ffn_ln(ops, v2, v2b, wp, qf, a[1], a[2], dq, "ln3_s", "ln3_b",
                  v.dtype)
    return out.view(B, L, D)


def fused_qffn_sa_block_plain(x, x_mask, wp, qf, *, num_heads: int,
                              act_scales=None, w4dq: bool = False):
    return _sa_body(_PLAIN, x, x_mask, wp, qf, num_heads,
                    *_qffn_args(qf, act_scales, "wm_q", 4, w4dq))


def fused_qffn_sga_block_plain(v, kq, vq, v_mask, q_mask, wp, qf, *,
                               num_heads: int, act_scales=None,
                               w4dq: bool = False):
    return _sga_body(_PLAIN, v, kq, vq, v_mask, q_mask, wp, qf, num_heads,
                     *_qffn_args(qf, act_scales, "wm1_q", 6, w4dq))


def _count(name: str, qf, dq: bool) -> None:
    kernels.count_block(name)
    level = _int4_level(qf, dq)
    if level:
        kernels.count_block(f"{name}_level{level}")


def fused_qffn_sa_block(x: torch.Tensor, x_mask: torch.Tensor,
                        wp: Mapping[str, torch.Tensor],
                        qf: Mapping[str, torch.Tensor], *, num_heads: int,
                        act_scales=None, w4dq: bool = False) -> torch.Tensor:
    """One whole SA encoder block with quantized sites: x [B, L, D] (bf16
    or f32 stream), x_mask bool [B, 1, 1, L] (True = PAD), wp the bf16
    layout (``prepare_sa_block_params``), qf its quantized weights
    (``prepare_qffn_params``). w4dq: the int4 sites run the bf16-dequant
    compute (levels 6/7). Returns [B, L, D] in x's dtype."""
    args = _qffn_args(qf, act_scales, "wm_q", 4, w4dq)
    if not kernels.kernel_route(x):
        return _sa_body(_PLAIN, x, x_mask, wp, qf, num_heads, *args)
    _check_stream("fused_qffn_sa_block", x)
    out = _sa_body(_CUDA, x, x_mask, wp, qf, num_heads, *args)
    _count("fused_qffn_sa_block", qf, args[2])
    return out


def fused_qffn_sga_block(v: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                         v_mask: torch.Tensor, q_mask: torch.Tensor,
                         wp: Mapping[str, torch.Tensor],
                         qf: Mapping[str, torch.Tensor], *, num_heads: int,
                         act_scales=None, w4dq: bool = False
                         ) -> torch.Tensor:
    """One whole SGA decoder block with quantized sites: v [B, Lv, D] (bf16
    or f32 stream), kq/vq [B, H, Lq, Dh] pre-projected cross keys / values,
    v_mask / q_mask bool [B, 1, 1, L], wp from
    ``prepare_sga_block_params``, qf from ``prepare_qffn_params``, w4dq as
    for the SA block. Returns [B, Lv, D] in v's dtype."""
    args = _qffn_args(qf, act_scales, "wm1_q", 6, w4dq)
    if not kernels.kernel_route(v):
        return _sga_body(_PLAIN, v, kq, vq, v_mask, q_mask, wp, qf,
                         num_heads, *args)
    _check_stream("fused_qffn_sga_block", v)
    out = _sga_body(_CUDA, v, kq, vq, v_mask, q_mask, wp, qf, num_heads,
                    *args)
    _count("fused_qffn_sga_block", qf, args[2])
    return out


# ---------------------------------------------------------------------------
# the full-int8 blocks: the qffn bodies at level 3 with every site dynamic
# ---------------------------------------------------------------------------

_DYNAMIC = ((None,) * 6, True, False)
# the qffn bodies' keys -> the full-int8 layout's (quant.py:330-388)
_QSA_KEYS = {"wqkv_q": "w_qkv", "sqkv": "s_qkv", "bqkv": "b_qkv",
             "wm_q": "w_m", "sm": "s_m", "bm": "b_m"}
_QSGA_KEYS = {"wqkv_q": "w_qkv1", "sqkv": "s_qkv1", "bqkv1": "b_qkv1",
              "wm1_q": "w_m1", "sm1": "s_m1", "bm1": "b_m1",
              "wq2_q": "w_q2", "sq2": "s_q2", "bq2_full": "b_q2",
              "wm2_q": "w_m2", "sm2": "s_m2", "bm2": "b_m2"}
_FFN_KEYS = {"w1_q": "w_w1", "s1": "s_w1", "b1": "b_w1", "w2_q": "w_w2",
             "s2": "s_w2", "b2": "b_w2"}


def _relabel(mk: Mapping[str, torch.Tensor], keys) -> Dict[str, torch.Tensor]:
    out = {k: mk[src] for k, src in {**keys, **_FFN_KEYS}.items()}
    out.update({k: v for k, v in mk.items() if k.startswith("ln")})
    return out


def _check_f32_stream(name: str, x: torch.Tensor) -> None:
    if x.dtype != F32:
        raise ValueError(f"{name}: the full-int8 stream is f32, got "
                         f"{x.dtype}")


def fused_quant_sa_block_plain(x, x_mask, mk, *, num_heads: int):
    blk = _relabel(mk, _QSA_KEYS)
    return _sa_body(_PLAIN, x, x_mask, blk, blk, num_heads, *_DYNAMIC)


def fused_quant_sga_block_plain(v, kq, vq, v_mask, q_mask, mk, *,
                                num_heads: int):
    blk = _relabel(mk, _QSGA_KEYS)
    return _sga_body(_PLAIN, v, kq, vq, v_mask, q_mask, blk, blk, num_heads,
                     *_DYNAMIC)


def fused_quant_sa_block(x: torch.Tensor, x_mask: torch.Tensor,
                         mk: Mapping[str, torch.Tensor], *,
                         num_heads: int) -> torch.Tensor:
    """One whole SA encoder block of the full-int8 engine: x [B, L, D] f32,
    x_mask bool [B, 1, 1, L], mk from ``prepare_quant_sa_params``. Every
    projection and the FFN int8 with dynamic per-row activation scales,
    q/k/v and the probabilities bf16, the attention output f32 into its
    merge (``_qsa_kernel``, quant.py:464). Returns [B, L, D] f32."""
    _check_f32_stream("fused_quant_sa_block", x)
    if not kernels.kernel_route(x):
        return fused_quant_sa_block_plain(x, x_mask, mk, num_heads=num_heads)
    blk = _relabel(mk, _QSA_KEYS)
    out = _sa_body(_CUDA, x, x_mask, blk, blk, num_heads, *_DYNAMIC)
    kernels.count_block("fused_quant_sa_block")
    return out


def fused_quant_sga_block(v: torch.Tensor, kq: torch.Tensor,
                          vq: torch.Tensor, v_mask: torch.Tensor,
                          q_mask: torch.Tensor,
                          mk: Mapping[str, torch.Tensor], *,
                          num_heads: int) -> torch.Tensor:
    """One whole SGA decoder block of the full-int8 engine: v [B, Lv, D]
    f32, kq/vq [B, H, Lq, Dh] f32 cross keys / values (from the dynamic
    int8 cross k/v outside), masks as ``fused_qffn_sga_block``'s, mk from
    ``prepare_quant_sga_params``; every site dynamic int8 (``_qsga_kernel``,
    quant.py:391). Returns [B, Lv, D] f32."""
    _check_f32_stream("fused_quant_sga_block", v)
    if not kernels.kernel_route(v):
        return fused_quant_sga_block_plain(v, kq, vq, v_mask, q_mask, mk,
                                           num_heads=num_heads)
    blk = _relabel(mk, _QSGA_KEYS)
    out = _sga_body(_CUDA, v, kq, vq, v_mask, q_mask, blk, blk, num_heads,
                    *_DYNAMIC)
    kernels.count_block("fused_quant_sga_block")
    return out
