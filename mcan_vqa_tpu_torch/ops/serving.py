"""The serving forwards (mcan_vqa_tpu/ops/serving.py, ``make_serving_fn``
modes 0-5, and ops/quant.py ``make_quant_serving_fn``, the full-int8
engine) and their construction paths, ``build_production_engine`` and
``quantize_params``.

By default (``qffn=None``) the engine is the JAX package's shipped one:
int8 level 1 -- an int8 FFN with dynamic per-row activation scales, and
the fused qkv too at hidden >= 1024 -- or, given a calibration batch or
stored scales, level 3, every projection int8 with static per-tensor
scales. Levels 4/5 store the FFN (and at 5 the qkv) as int4 with 128-row
group scales, levels 6/7 the same weights computed in bf16; they need
static scales. ``q8aux=True`` adds the static-int8 aux sites outside the
blocks: the cross k/v, both AttFlat merges and the answer head. Each
encoder block runs through ``fused_qffn_sa_block`` and each decoder block
through ``fused_qffn_sga_block`` (ops/quant.py); ``qffn=0``, and a
dynamic-scale block past ``QFFN_MAX_BATCH``, run the all-bf16
``fused_sa_block`` / ``fused_sga_block`` (ops/sga_block.py). On the card
those are the hand-written kernels, on the CPU their plain versions. What
the JAX engine leaves to XLA outside its Pallas kernels -- the embedding
and LSTM, the image projection, the cross k/v projection (``_cross_kv``),
both AttFlat heads and the answer head -- is plain PyTorch here, with the
same bf16 operand / f32 accumulation rule, but for the aux sites, which
are ``quantize_rows`` + ``gemm_s8``.

Mode 0, the per-sub-op path (``sga_mode=0``, and every mode-2 forward
whose width fails ``megakernel_vmem_ok``, as in JAX): each attention
sub-block is its projections in plain PyTorch, the attention
(``use_pallas``: True / "batched" / "packed" -> ops/masked_attention.py on
the attention kernel; False -> plain) and, with ``use_pallas_ffn``, the
merge + residual + LN on ``gemm_ln`` (ops/fused_ffn.py ``fused_proj_ln``)
and the FFN + residual + LN on ``gemm_bias_act`` + ``gemm_ln``
(``fused_ffn_ln``); without it plain ``ln(x + ...)``. AttFlat runs
ops/attflat.py (``gemm_bias_act``, ``attflat_pool``, ``gemm_bias_act``)
under ``use_pallas`` or ``use_pallas_attflat``, in every mode.

The JAX engine's other decoder modes, as serving.py:828-941 runs them:
mode 1 runs the encoder as mode 0 does and each decoder block through
``fused_sga_block(fused_proj=False)`` (the head-major layout, bf16 at every
qffn level); modes 3 and 4 run the encoder as mode 2 does and the whole
decoder in one launch (``fused_sga_decoder``: the cross k/v projected
inside; ``fused_sga_decoder_extkv``: projected outside, every layer's at
once); mode 5 runs the whole encoder in one launch too
(``fused_sa_encoder``). Modes 3-5 serve mode 2 where ``decoder_vmem_ok``
fails, every mode serves mode 0 where ``megakernel_vmem_ok`` fails. The
packing group ``sga_group`` is accepted and has no effect: attention is
per sample.

The full-int8 engine (``Predictor(engine="int8")``) carries an f32 stream
and runs every product int8 with dynamic per-row scales: the image
projection, the cross k/v, the AttFlat MLPs and merges and the head as
``quantize_rows`` + ``gemm_s8`` (``_qdense``, quant.py:169), each block
through ``fused_quant_sa_block`` / ``fused_quant_sga_block``, the
``megakernel=True`` engine of the JAX package.

The classifier engine (serving.py:282-477) serves ``ClassifierNet``, the
image-only SA stack: ``build_production_classifier_engine`` over
``prepare_classifier_params``, each block through ``fused_qffn_sa_block``
(levels 1-7) or ``fused_sa_block`` as the VQA encoder's, the mode-0
encoder past ``megakernel_vmem_ok``, AttFlat and the head plain.

Weights arrive as a reference-shaped state_dict (models/net.py
``MCANet.state_dict()``, train/checkpoint.py); ``prepare_params`` lays
them out once: fused [D, 3D] self-attention qkv, fused [D, 2D] cross k/v,
bf16 matmul weights in the JAX [in, out] layout, f32 biases and LN, and
within ``megakernel_vmem_ok`` each block's mode-2 layout (``_mk``, the
decoder's with mode 1's head-major entries beside the fused ones), with
``qffn`` its quantized weights (``_qffn``) and, within ``decoder_vmem_ok``,
the all-layer stacks (``_mk_dec``, ``_mk_enc``).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from mcan_vqa_tpu_torch.device import resolve_device
from mcan_vqa_tpu_torch.models.attention import masked_attention as \
    masked_attention_xla
from mcan_vqa_tpu_torch.models.attention import split_heads
from mcan_vqa_tpu_torch.models.layers import (BF16, bf16_matmul, make_mask,
                                              std_layer_norm)
from mcan_vqa_tpu_torch.models.lstm import lstm_forward
from mcan_vqa_tpu_torch.models.net import attflat_pool
from mcan_vqa_tpu_torch.ops import kernels
from mcan_vqa_tpu_torch.ops.attflat import attflat_pallas
from mcan_vqa_tpu_torch.ops.fused_ffn import fused_ffn_ln, fused_proj_ln
from mcan_vqa_tpu_torch.ops.masked_attention import (
    masked_attention_pallas, masked_attention_pallas_batched,
    masked_attention_pallas_packed)
from mcan_vqa_tpu_torch.ops.quant import (_check_scales, _quant_w,
                                          calibrate_classifier_act_scales,
                                          calibrate_qffn_act_scales,
                                          fused_qffn_sa_block,
                                          fused_qffn_sga_block,
                                          fused_quant_sa_block,
                                          fused_quant_sga_block,
                                          prepare_q8aux_params,
                                          prepare_qffn_params,
                                          prepare_quant_sa_params,
                                          prepare_quant_sga_params)
from mcan_vqa_tpu_torch.ops.sga_block import (HEAD_MAJOR, decoder_vmem_ok,
                                              fused_sa_block,
                                              fused_sa_encoder,
                                              fused_sga_block,
                                              fused_sga_decoder,
                                              fused_sga_decoder_extkv,
                                              prepare_sa_block_params,
                                              prepare_sa_encoder_params,
                                              prepare_sga_block_params,
                                              prepare_sga_decoder_params)

Params = Dict[str, Any]
F32 = torch.float32

# Largest batch at which a block with DYNAMIC activation scales runs the
# int8 kernels; past it the block runs the all-bf16 ones. Static scales
# lift the gate. The value is the JAX package's (serving.py:42), measured
# on a TPU; the port keeps it so that both engines route a batch alike.
QFFN_MAX_BATCH = 512


def decode_qffn_level(qffn, D: int):
    """qffn level -> (qkv_int8, proj_int8, w4), as serving.py:120: 1/True
    = int8 FFN (+ qkv at D >= 1024), 2 = + qkv everywhere, 3 = + merge and
    cross-q projections (static scales only), 4/5 = int4 FFN / FFN+qkv,
    6/7 = the same int4 weights with bf16-dequant compute."""
    qkv8 = int(qffn) >= 2 or D >= 1024
    proj8 = int(qffn) >= 3
    w4 = {4: 1, 5: 2, 6: 1, 7: 2}.get(int(qffn), 0)
    return qkv8, proj8, w4


def megakernel_vmem_ok(D: int, F: int) -> bool:
    """JAX's gate of the whole-block engines (serving.py:133): one decoder
    block's bf16 weights within the megakernels' 48 MB VMEM budget. The
    H100 has no VMEM, but the port routes a width as the JAX engine does:
    past the gate a mode-2 forward runs the per-sub-op path (mode 0), and
    the engines differ in their answers."""
    return (6 * D * D + 2 * D * F) * 2 <= 48 * 1024 * 1024


def _sub(sd: Mapping[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    """The entries of a state_dict under ``prefix.``, prefix removed."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _dense_params(sd, name: str, device) -> Dict[str, torch.Tensor]:
    return {"kernel": sd[f"{name}.weight"].detach().t().to(device, BF16)
            .contiguous(),
            "bias": sd[f"{name}.bias"].detach().to(device, torch.float32)}


def _ln_params(sd, name: str, device) -> Dict[str, torch.Tensor]:
    return {"scale": sd[f"{name}.a_2"].detach().to(device, torch.float32),
            "bias": sd[f"{name}.b_2"].detach().to(device, torch.float32)}


def _mlp_params(sd, name: str, device) -> Params:
    return {"FCLayer_0": {"Dense_0": _dense_params(sd, f"{name}.fc.linear",
                                                   device)},
            "Dense_0": _dense_params(sd, f"{name}.linear", device)}


def _question_params(sd, device) -> Params:
    """The word embedding (f32) and the LSTM (bf16 weights [in, 4H], f32
    biases), as every engine reads them."""
    def vec(key):
        return sd[key].detach().to(device, torch.float32)

    def mat(key):
        return sd[key].detach().t().to(device, BF16).contiguous()
    return {"embedding": {"embedding": vec("embedding.weight")},
            "lstm": {"w_ih": mat("lstm.weight_ih_l0"),
                     "w_hh": mat("lstm.weight_hh_l0"),
                     "b_ih": vec("lstm.bias_ih_l0"),
                     "b_hh": vec("lstm.bias_hh_l0")}}


def _dense_of(w: torch.Tensor, b: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"kernel": w, "bias": b}


def _ln_of(mk, i: int) -> Dict[str, torch.Tensor]:
    return {"scale": mk[f"ln{i}_s"], "bias": mk[f"ln{i}_b"]}


def _ffn_of(mk) -> Params:
    return {"mlp": {"FCLayer_0": {"Dense_0": _dense_of(mk["w1"], mk["b1"])},
                    "Dense_0": _dense_of(mk["w2"], mk["b2"])}}


def _sa_block_entries(sd, i: int, dev) -> Params:
    """Encoder block i of a state_dict -> the raw entries the per-sub-op
    path reads (the fused ``linear_qkv``, the merge, the norms, the FFN)
    and the mode-2 layout ``_mk``, sharing their tensors."""
    enc = {k: v.to(dev) for k, v in prepare_sa_block_params(
        _sub(sd, f"backbone.enc_list.{i}")).items()}
    return {"mhatt": {"linear_qkv": _dense_of(enc["wqkv"], enc["bqkv"]),
                      "linear_merge": _dense_of(enc["wm"], enc["bm"])},
            "norm1": _ln_of(enc, 1), "norm2": _ln_of(enc, 2),
            "ffn": _ffn_of(enc), "_mk": enc}


def _attach_layouts(bb: Params, qffn) -> bool:
    """Within ``megakernel_vmem_ok`` give every block of ``bb`` its
    quantized weights ``_qffn`` at level ``qffn`` (none when falsy) ->
    True; past it drop the ``_mk`` layouts -> False."""
    mk = bb["enc_0"]["_mk"]
    D, F = mk["wqkv"].shape[0], mk["w1"].shape[1]
    if not megakernel_vmem_ok(D, F):
        for blk in bb.values():
            del blk["_mk"]
        return False
    if qffn:
        qkv8, proj8, w4 = decode_qffn_level(qffn, D)
        for blk in bb.values():
            blk["_qffn"] = prepare_qffn_params(blk["_mk"], qkv8, proj8, w4)
    return True


def prepare_params(state_dict: Mapping[str, torch.Tensor], num_layers: int,
                   device="cuda", qffn=False, prune: bool = True,
                   num_heads: int = 8, alllayer: bool = True) -> Params:
    """Reference state_dict -> the serving tree on ``device`` ("cuda" by
    default; "cpu" for the plain versions), named as the JAX package's
    ``prepare_params`` tree. Per block the raw entries the per-sub-op path
    reads (the fused ``linear_qkv``, the cross ``linear_q`` and
    ``linear_kv``, each ``linear_merge``, the norms, the FFN) and, where
    ``megakernel_vmem_ok``, the mode-2 layout ``_mk`` (the decoder's with
    the head-major entries of mode 1 at ``num_heads``) and, with a truthy
    ``qffn`` level, the block's quantized weights ``_qffn``
    (``decode_qffn_level``). The raw entries and ``_mk`` share their
    tensors. alllayer: where ``decoder_vmem_ok`` also holds, the backbone's
    ``_mk_dec`` / ``_mk_enc``, every layer stacked for modes 3-5
    (serving.py:213-220). prune: drop what the mode-2 forward does not read
    (``prune_prepared_params``, the stacks included), where the ``_mk``
    layouts exist."""
    sd = state_dict
    dev = resolve_device(device)
    bb: Params = {}
    for i in range(num_layers):
        bb[f"enc_{i}"] = _sa_block_entries(sd, i, dev)
        dec_sd = _sub(sd, f"backbone.dec_list.{i}")
        # on the device first: the head-major entries are views of the
        # fused ones
        dec = prepare_sga_block_params(
            {k: v.detach().to(dev) for k, v in dec_sd.items()}, num_heads)
        kv = [_dense_params(dec_sd, f"mhatt2.{n}", dev)
              for n in ("linear_k", "linear_v")]
        bb[f"dec_{i}"] = {
            "mhatt1": {"linear_qkv": _dense_of(dec["wqkv1"], dec["bqkv1"]),
                       "linear_merge": _dense_of(dec["wm1_full"], dec["bm1"])},
            "mhatt2": {
                "linear_q": _dense_of(dec["wq2_full"], dec["bq2_full"]),
                "linear_kv": _dense_of(
                    torch.cat([p["kernel"] for p in kv], 1).contiguous(),
                    torch.cat([p["bias"] for p in kv])),
                "linear_merge": _dense_of(dec["wm2_full"], dec["bm2"])},
            "norm1": _ln_of(dec, 1), "norm2": _ln_of(dec, 2),
            "norm3": _ln_of(dec, 3), "ffn": _ffn_of(dec), "_mk": dec}
    D = bb["enc_0"]["_mk"]["wqkv"].shape[0]
    F = bb["enc_0"]["_mk"]["w1"].shape[1]
    if not _attach_layouts(bb, qffn):
        prune = False
    # the stacks only where they stay (prune drops them, as JAX's does)
    if alllayer and not prune and "_mk" in bb["enc_0"] \
            and decoder_vmem_ok(D, F, num_layers):
        bb["_mk_dec"] = prepare_sga_decoder_params(bb, num_layers)
        bb["_mk_enc"] = prepare_sa_encoder_params(bb, num_layers)
    prepared = {
        **_question_params(sd, dev),
        "img_feat_linear": _dense_params(sd, "img_feat_linear", dev),
        "backbone": bb,
        "attflat_lang": {"mlp": _mlp_params(sd, "attflat_lang.mlp", dev),
                         "linear_merge": _dense_params(
                             sd, "attflat_lang.linear_merge", dev)},
        "attflat_img": {"mlp": _mlp_params(sd, "attflat_img.mlp", dev),
                        "linear_merge": _dense_params(
                            sd, "attflat_img.linear_merge", dev)},
        "proj_norm": _ln_params(sd, "proj_norm", dev),
        "proj": _dense_params(sd, "proj", dev),
    }
    if prune:
        prepared = prune_prepared_params(prepared, num_layers)
    return prepared


def prune_prepared_params(params: Params, num_layers: int) -> Params:
    """The tree the mode-2 forward reads (serving.py:229): per block only
    ``_mk`` (the decoder's without the head-major entries of mode 1) /
    ``_qffn``, and the decoder's fused cross ``linear_kv``; no all-layer
    stack. Raises where a block lacks its ``_mk`` layout (a width outside
    ``megakernel_vmem_ok``)."""
    bb = params["backbone"]
    blocks = [bb[f"{s}_{i}"] for s in ("enc", "dec") for i in range(num_layers)]
    if any("_mk" not in blk for blk in blocks):
        raise ValueError(
            "prune_prepared_params needs the _mk megakernel layouts on every "
            "block (a width within megakernel_vmem_ok)")
    out = {k: v for k, v in params.items() if k != "backbone"}
    nbb: Params = {}
    for i in range(num_layers):
        enc, dec = bb[f"enc_{i}"], bb[f"dec_{i}"]
        nbb[f"enc_{i}"] = {k: enc[k] for k in ("_mk", "_qffn") if k in enc}
        nbb[f"dec_{i}"] = {k: dec[k] for k in ("_qffn",) if k in dec}
        nbb[f"dec_{i}"]["_mk"] = {k: t for k, t in dec["_mk"].items()
                                  if k not in HEAD_MAJOR}
        nbb[f"dec_{i}"]["mhatt2"] = {
            "linear_kv": dec["mhatt2"]["linear_kv"]}
    out["backbone"] = nbb
    return out


def _dense(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return bf16_matmul(x, p["kernel"]) + p["bias"]


def _std_layer_norm(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return std_layer_norm(x, p["scale"], p["bias"]).to(out_dtype)


def _mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _dense(p["Dense_0"],
                  torch.relu(_dense(p["FCLayer_0"]["Dense_0"], x)))


def _lstm(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return lstm_forward(x, p["w_ih"], p["w_hh"], p["b_ih"], p["b_hh"])


def _qdense_static(site: Mapping[str, torch.Tensor], x: torch.Tensor,
                   a: float) -> torch.Tensor:
    """A static-int8 aux site (serving.py:518): x [M, K] quantized with the
    calibrated scale a, the int8 product with its per-channel dequant and
    bias -> f32 [M, N]."""
    xq, _ = kernels.quantize_rows(x, 1.0 / a)
    return kernels.gemm_s8(xq, site["w_q"], site["w_s"], site["b"], a=a)[0]


def _attflat(p: Params, x: torch.Tensor, mask: torch.Tensor,
             use_pallas=False, q8=None) -> torch.Tensor:
    """AttFlat (serving.py:545) -> [B, O] f32. use_pallas: through the
    kernels (ops/attflat.py ``attflat_pallas``); else plain, and q8: (aux
    site, a), the merge as a static-int8 site."""
    if use_pallas:
        mlp = p["mlp"]
        return attflat_pallas(
            x, mask, mlp["FCLayer_0"]["Dense_0"]["kernel"],
            mlp["FCLayer_0"]["Dense_0"]["bias"], mlp["Dense_0"]["kernel"],
            mlp["Dense_0"]["bias"], p["linear_merge"]["kernel"],
            p["linear_merge"]["bias"])[0]
    pooled = attflat_pool(_mlp(p["mlp"], x), x, mask)
    if q8 is not None:
        return _qdense_static(q8[0], pooled, q8[1])
    return _dense(p["linear_merge"], pooled)


def _split_kv(kv: torch.Tensor, num_heads: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, Lq, 2D] -> two [B, H, Lq, Dh] strided views (the attention
    kernel reads them in place)."""
    kx, vx = kv.chunk(2, dim=-1)
    return split_heads(kx, num_heads), split_heads(vx, num_heads)


def _mhatt(p: Params, v: torch.Tensor, k: torch.Tensor, q: torch.Tensor,
           mask: torch.Tensor, num_heads: int, use_pallas,
           merge: bool = True) -> torch.Tensor:
    """One attention sub-block of the per-sub-op path (serving.py:480): the
    projections in plain PyTorch (the fused qkv where q, k, v are one
    tensor, else the cross q and the fused k/v), the attention per
    ``use_pallas`` (True / "batched" / "packed": ops/masked_attention.py on
    the attention kernel; False: plain), -> the pre-merge output
    [B, Lq, D] f32, or with ``merge`` the merge projection's."""
    B, Lq, D = q.shape
    if "linear_qkv" in p and q is k and k is v:
        qx, kx, vx = _dense(p["linear_qkv"], q).split(D, dim=-1)
    else:
        kx, vx = _dense(p["linear_kv"], k).split(D, dim=-1)
        qx = _dense(p["linear_q"], q)
    heads = [split_heads(t, num_heads) for t in (qx, kx, vx)]
    if use_pallas == "batched":
        atted = masked_attention_pallas_batched(*heads, mask)
    elif use_pallas == "packed":
        atted = masked_attention_pallas_packed(*heads, mask)
    elif use_pallas:
        atted = masked_attention_pallas(*heads, mask)
    else:
        atted = masked_attention_xla(*heads, mask)
    atted = atted.transpose(1, 2).reshape(B, Lq, D)
    return _dense(p["linear_merge"], atted) if merge else atted


def _cross_kv(p: Params, q: torch.Tensor, num_heads: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-project cross-attention keys/values -> two [B, H, Lq, Dh] f32
    strided views of one [B, Lq, 2D] product."""
    return _split_kv(_dense(p["linear_kv"], q), num_heads)


def _cross_kv_q8(site: Mapping[str, torch.Tensor], q: torch.Tensor,
                 num_heads: int, a: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_cross_kv`` against a static-int8 ``_q8aux`` site (serving.py:532)."""
    B, Lq, D = q.shape
    kv = _qdense_static(site, q.reshape(B * Lq, D), a)
    return _split_kv(kv.view(B, Lq, 2 * D), num_heads)


def _att_block(mh_p, norm_p, v_, k_, q_, mask_, num_heads: int, use_pallas,
               use_pallas_ffn: bool, stream) -> torch.Tensor:
    """A residual attention sub-block of mode 0: q_ is the residual."""
    if use_pallas_ffn:
        pre = _mhatt(mh_p, v_, k_, q_, mask_, num_heads, use_pallas,
                     merge=False)
        return fused_proj_ln(q_, pre, mh_p["linear_merge"]["kernel"],
                             mh_p["linear_merge"]["bias"], norm_p["scale"],
                             norm_p["bias"])
    att = _mhatt(mh_p, v_, k_, q_, mask_, num_heads, use_pallas)
    return _std_layer_norm(norm_p, q_ + att.to(stream), out_dtype=stream)


def _ffn_block(norm_p, mlp_p, x, use_pallas_ffn: bool, stream
               ) -> torch.Tensor:
    """The FFN + residual + LN of mode 0."""
    if use_pallas_ffn:
        return fused_ffn_ln(
            x, mlp_p["FCLayer_0"]["Dense_0"]["kernel"],
            mlp_p["FCLayer_0"]["Dense_0"]["bias"],
            mlp_p["Dense_0"]["kernel"], mlp_p["Dense_0"]["bias"],
            norm_p["scale"], norm_p["bias"])
    return _std_layer_norm(norm_p, x + _mlp(mlp_p, x).to(stream),
                           out_dtype=stream)


def _encoder0(bb, q, q_mask, num_layers: int, num_heads: int, use_pallas,
              use_pallas_ffn: bool, stream) -> torch.Tensor:
    """The SA stack of mode 0, sub-block by sub-block."""
    for i in range(num_layers):
        p = bb[f"enc_{i}"]
        q = _att_block(p["mhatt"], p["norm1"], q, q, q, q_mask, num_heads,
                       use_pallas, use_pallas_ffn, stream)
        q = _ffn_block(p["norm2"], p["ffn"]["mlp"], q, use_pallas_ffn,
                       stream)
    return q


def _encoder2(bb, q, q_mask, num_layers: int, num_heads: int, qffn: bool,
              scales, w4dq: bool) -> torch.Tensor:
    """The SA stack of mode 2, a whole-block kernel per layer: a block with
    ``_qffn`` through ``fused_qffn_sa_block`` (static scales where
    ``scales`` holds its entry; dynamic ones only while B <=
    ``QFFN_MAX_BATCH``), else ``fused_sa_block``."""
    for i in range(num_layers):
        p = bb[f"enc_{i}"]
        a = scales.get(f"enc_{i}")
        if qffn and "_qffn" in p and (q.shape[0] <= QFFN_MAX_BATCH
                                      or a is not None):
            q = fused_qffn_sa_block(q, q_mask, p["_mk"], p["_qffn"],
                                    num_heads=num_heads, act_scales=a,
                                    w4dq=w4dq)
        else:
            q = fused_sa_block(q, q_mask, p["_mk"], num_heads=num_heads)
    return q


def make_serving_fn(num_layers: int, num_heads: int, use_pallas=True,
                    bf16_stream: bool = False, use_pallas_ffn: bool = False,
                    use_sga_megakernel=False, sga_group=None,
                    use_pallas_attflat: bool = False, qffn: bool = False,
                    qffn_act_scales=None, qffn_w4dq: bool = False
                    ) -> Callable:
    """forward(params, img_feat [B, R, F] f32, ques_ix [B, T] int)
    -> logits [B, A] f32; params from ``prepare_params``. The JAX
    ``make_serving_fn`` (serving.py:717), with its defaults.

    use_sga_megakernel (serving.py:828-941): 0 / False, the per-sub-op path
    (:957-980); 1 / True, the mode-0 encoder and each decoder block through
    ``fused_sga_block(fused_proj=False)`` (head-major weights); 2, the
    whole-block engine (each encoder block through ``fused_sa_block`` /
    ``fused_qffn_sa_block``, each decoder block through ``fused_sga_block``
    / ``fused_qffn_sga_block``, the cross k/v outside); 3, the mode-2
    encoder and the whole decoder in one launch (``fused_sga_decoder``, the
    cross k/v inside); 4, the same with the cross k/v outside
    (``fused_sga_decoder_extkv``); 5, mode 4 with the whole encoder in one
    launch (``fused_sa_encoder``). Modes 3-5 run mode 2 where
    ``decoder_vmem_ok`` fails; every mode runs mode 0 where
    ``megakernel_vmem_ok`` fails (:837-842). The all-layer modes read the
    backbone's ``_mk_dec`` / ``_mk_enc`` stacks, or stack the blocks'
    layouts per call. sga_group: the TPU kernels' packing group (None:
    auto); accepted and without effect, since attention is per sample --
    in JAX a group > 1 changes the result only for a fully padded sample
    (ROADMAP §3). use_pallas: the attention of mode 0 on the kernel (True,
    "batched", "packed") or plain (False). use_pallas_ffn: mode 0's (and
    mode 1's encoder's) merges and FFNs with their residual and LN on
    ``fused_proj_ln`` / ``fused_ffn_ln``. use_pallas or use_pallas_attflat:
    both AttFlats on ``attflat_pallas``. bf16_stream: a bf16 residual
    stream between the blocks (LN statistics in f32), else f32.

    qffn: run each mode-2 block (and modes 3 / 4's encoder blocks) that
    carries ``_qffn`` through the quantized block kernels; the decoder of
    modes 1 and 3-5 stays bf16 (:927). qffn_act_scales: {"enc_i" / "dec_i":
    scale tuple} from ``calibrate_qffn_act_scales`` (static scales), or
    None (dynamic). Per block, as serving.py:859-871 / :926-941: a block
    with dynamic scales runs int8 only while B <= QFFN_MAX_BATCH, else the
    bf16 kernels; static scales lift the gate. qffn_w4dq: the int4 sites
    run the bf16-dequant compute (levels 6/7). The aux sites run static
    int8 when params carry ``_q8aux`` and the scales an "aux" tuple
    (serving.py:688-694), in modes 1-5 (``build_production_engine``
    refuses them outside 1 and 2). ``forward.act_scales`` holds the scales baked in (None:
    dynamic)."""
    if int(use_sga_megakernel) not in range(6):
        raise ValueError(f"use_sga_megakernel={use_sga_megakernel}: the "
                         f"modes are 0-5")
    stream = BF16 if bf16_stream else F32
    scales = qffn_act_scales or {}
    pallas_attflat = bool(use_pallas or use_pallas_attflat)

    def int8_block(p: Params, name: str, batch: int) -> bool:
        return qffn and "_qffn" in p and (batch <= QFFN_MAX_BATCH
                                          or name in scales)

    def att_block(mh_p, norm_p, v_, k_, q_, mask_):
        return _att_block(mh_p, norm_p, v_, k_, q_, mask_, num_heads,
                          use_pallas, use_pallas_ffn, stream)

    def ffn_block(norm_p, mlp_p, x):
        return _ffn_block(norm_p, mlp_p, x, use_pallas_ffn, stream)

    def encoder0(bb, q, q_mask):
        return _encoder0(bb, q, q_mask, num_layers, num_heads, use_pallas,
                         use_pallas_ffn, stream)

    def encoder2(bb, q, q_mask):
        return _encoder2(bb, q, q_mask, num_layers, num_heads, qffn, scales,
                         qffn_w4dq)

    def decoder12(bb, q, v, q_mask, v_mask, aux_w, aux_s, mode):
        for i in range(num_layers):
            p = bb[f"dec_{i}"]
            if aux_w is not None:
                kq, vq = _cross_kv_q8(aux_w[f"dec_{i}_kv"], q, num_heads,
                                      aux_s[0])
            else:
                kq, vq = _cross_kv(p["mhatt2"], q, num_heads)
            if mode == 2 and int8_block(p, f"dec_{i}", v.shape[0]):
                v = fused_qffn_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                         p["_qffn"], num_heads=num_heads,
                                         act_scales=scales.get(f"dec_{i}"),
                                         w4dq=qffn_w4dq)
            else:
                v = fused_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                    num_heads=num_heads,
                                    fused_proj=mode == 2)
        return v

    def decoder_alllayer(bb, q, v, q_mask, v_mask, mode):
        wp = (bb["_mk_dec"] if "_mk_dec" in bb
              else prepare_sga_decoder_params(bb, num_layers))
        if mode == 3:
            return fused_sga_decoder(v, q, v_mask, q_mask, wp,
                                     num_heads=num_heads)
        # every layer's cross k/v outside, layer-major [B, L*H, Lq, Dh]
        kvs = [_cross_kv(bb[f"dec_{i}"]["mhatt2"], q, num_heads)
               for i in range(num_layers)]
        kq = torch.cat([k for k, _ in kvs], dim=1)
        vq = torch.cat([v_ for _, v_ in kvs], dim=1)
        return fused_sga_decoder_extkv(v, kq, vq, v_mask, q_mask, wp,
                                       num_heads=num_heads)

    def decoder0(bb, q, v, q_mask, v_mask):
        for i in range(num_layers):
            p = bb[f"dec_{i}"]
            v = att_block(p["mhatt1"], p["norm1"], v, v, v, v_mask)
            v = att_block(p["mhatt2"], p["norm2"], q, q, v, q_mask)
            v = ffn_block(p["norm3"], p["ffn"]["mlp"], v)
        return v

    def resolve_mode(bb, D: int) -> int:
        """The mode this width runs (serving.py:832-842)."""
        mode = int(use_sga_megakernel)
        if mode:
            dec0 = bb["dec_0"]
            F_ff = (dec0["_mk"]["w1"] if "_mk" in dec0 else dec0["ffn"][
                "mlp"]["FCLayer_0"]["Dense_0"]["kernel"]).shape[1]
            if mode >= 3 and not decoder_vmem_ok(D, F_ff, num_layers):
                mode = 2
            if not megakernel_vmem_ok(D, F_ff):
                mode = 0
        return mode

    def forward(params: Params, img_feat: torch.Tensor,
                ques_ix: torch.Tensor) -> torch.Tensor:
        aux_w, aux_s = params.get("_q8aux"), scales.get("aux")
        use_aux = aux_w is not None and aux_s is not None
        if use_aux and pallas_attflat:
            # JAX's assert (serving.py:802), raised under -O too
            raise AssertionError(
                "q8aux does not compose with the pallas AttFlat experiment")
        q_mask = make_mask(ques_ix.unsqueeze(-1))
        v_mask = make_mask(img_feat)
        q = params["embedding"]["embedding"][ques_ix.long()]
        q = _lstm(params["lstm"], q).to(stream)
        v = _dense(params["img_feat_linear"], img_feat).to(stream)
        bb = params["backbone"]
        mode = resolve_mode(bb, v.shape[-1])
        if mode == 5:
            wp = (bb["_mk_enc"] if "_mk_enc" in bb
                  else prepare_sa_encoder_params(bb, num_layers))
            q = fused_sa_encoder(q, q_mask, wp, num_heads=num_heads)
        elif mode >= 2:
            q = encoder2(bb, q, q_mask)
        else:
            q = encoder0(bb, q, q_mask)
        if mode >= 3:
            v = decoder_alllayer(bb, q, v, q_mask, v_mask, mode)
        elif mode:
            v = decoder12(bb, q, v, q_mask, v_mask,
                          aux_w if use_aux else None, aux_s, mode)
        else:
            v = decoder0(bb, q, v, q_mask, v_mask)
            use_aux = False
        lang_flat = _attflat(params["attflat_lang"], q, q_mask,
                             pallas_attflat,
                             (aux_w["lang_merge"], aux_s[1]) if use_aux
                             else None)
        img_flat = _attflat(params["attflat_img"], v, v_mask, pallas_attflat,
                            (aux_w["img_merge"], aux_s[2]) if use_aux
                            else None)
        fused = _std_layer_norm(params["proj_norm"], lang_flat + img_flat)
        if use_aux:
            return _qdense_static(aux_w["proj"], fused, aux_s[3])
        return _dense(params["proj"], fused)

    forward.act_scales = qffn_act_scales if qffn else None
    return forward


def prepare_production_params(state_dict: Mapping[str, torch.Tensor],
                              num_layers: int, *, qffn=True,
                              sga_mode: int = 2, prune: bool = True,
                              device="cuda", num_heads: int = 8,
                              alllayer: bool = False) -> Params:
    """The shipped engine's tree (serving.py:582): the layouts of level
    ``qffn``, with the all-layer stacks when ``alllayer``, pruned to what
    the mode-2 forward reads when ``prune``, ``sga_mode == 2`` and not
    ``alllayer`` (:593; and the width has the ``_mk`` layouts); the other
    modes read the raw entries, and modes 3-5 without the stacks stack the
    blocks' layouts per call."""
    return prepare_params(state_dict, num_layers, device, qffn=qffn,
                          prune=prune and sga_mode == 2 and not alllayer,
                          num_heads=num_heads, alllayer=alllayer)


def build_production_engine(state_dict: Mapping[str, torch.Tensor],
                            num_layers: int, num_heads: int, *, qffn=None,
                            act_scale_inputs=None, act_scales=None,
                            q8aux: bool = False, prune: bool = True,
                            sga_mode: int = 2, alllayer: bool = False,
                            bf16_stream: bool = True,
                            use_pallas_ffn: bool = True, device="cuda",
                            **serving_kwargs) -> Tuple[Callable, Params]:
    """ONE construction path for the shipped serving engine
    (serving.py:602) -> (forward, prepared).

    qffn: None picks the production default -- level 1 (dynamic int8 FFN,
    + qkv at hidden >= 1024) without calibration, level 3 (every
    projection int8, static scales) with a calibration batch or stored
    scales; an int forces a level, 0 the all-bf16 kernels. Levels 4/5
    (int4 FFN / FFN + qkv) and 6/7 (the same weights with bf16-dequant
    compute) need a calibration batch or stored scales.
    act_scale_inputs: an (img_feat, ques_ix) batch to calibrate static
    scales on (``calibrate_qffn_act_scales``). act_scales: precomputed
    scales ({"enc_i" / "dec_i": tuple of floats}); mutually exclusive with
    act_scale_inputs. With qffn=0 both are ignored, as in JAX; at a width
    outside ``megakernel_vmem_ok`` too, with JAX's warning (the per-sub-op
    path has no int8 site).
    q8aux: the static-int8 aux sites (``prepare_q8aux_params``); they need
    a calibration batch or stored scales with an "aux" tuple, a quantized
    level and sga_mode 1 or 2. sga_mode: 0-5, ``make_serving_fn``'s
    ``use_sga_megakernel``. alllayer: attach the all-layer stacks once
    (``prepare_params``) rather than stack them per call. prune: prune the
    mode-2 tree (``prepare_production_params``). bf16_stream,
    use_pallas_ffn and serving_kwargs (use_pallas, which defaults to False
    here, use_pallas_attflat and sga_group) go to ``make_serving_fn``."""
    if act_scale_inputs is not None and act_scales is not None:
        raise ValueError(
            "pass a calibration batch OR precomputed scales, not both")
    if qffn is None:
        qffn = 3 if (act_scale_inputs is not None
                     or act_scales is not None) else True
    if int(qffn) >= 4 and act_scale_inputs is None and act_scales is None:
        raise ValueError(
            "qffn levels 4-7 (int4 weight streaming) require a calibration "
            "batch (act_scale_inputs) or precomputed act_scales -- the int4 "
            "kernels have no dynamic-quant path")
    w4dq = int(qffn) >= 6
    if q8aux and act_scale_inputs is None and (
            act_scales is None or "aux" not in act_scales):
        raise ValueError(
            "q8aux requires a calibration batch (act_scale_inputs) or "
            "precomputed act_scales that include the \"aux\" tuple")
    if q8aux and not qffn:
        raise ValueError(
            "q8aux requires a quantized serving level (qffn >= 1, the aux "
            "sites share its static-scale machinery); got qffn=0")
    if q8aux and sga_mode not in (1, 2, True):
        raise ValueError(
            f"q8aux applies to the per-block megakernel engines (sga_mode "
            f"1/2), got sga_mode={sga_mode}")
    prepared = prepare_production_params(state_dict, num_layers, qffn=qffn,
                                         sga_mode=sga_mode, prune=prune,
                                         device=device, num_heads=num_heads,
                                         alllayer=alllayer)
    if q8aux:
        prepared["_q8aux"] = prepare_q8aux_params(prepared, num_layers)
    if (act_scale_inputs is not None or act_scales is not None) and qffn \
            and "_mk" not in prepared["backbone"]["enc_0"]:
        warnings.warn(
            "activation-scale calibration ignored: model dims are outside "
            "the megakernel VMEM envelope, the engine falls back to the "
            "per-sub-op path (no int8 quant sites)")
        act_scale_inputs = act_scales = None
        prepared.pop("_q8aux", None)
    if act_scales is not None and qffn:
        act_scales = _check_scales({k: tuple(float(x) for x in v)
                                    for k, v in act_scales.items()})
    elif act_scale_inputs is not None and qffn:
        img, ques = act_scale_inputs
        act_scales = calibrate_qffn_act_scales(prepared, img, ques,
                                               num_layers, num_heads,
                                               w4dq=w4dq)
    else:
        act_scales = None
    serving_kwargs.setdefault("use_pallas", False)
    return make_serving_fn(num_layers, num_heads,
                           use_pallas_ffn=use_pallas_ffn,
                           use_sga_megakernel=sga_mode,
                           bf16_stream=bf16_stream, qffn=bool(qffn),
                           qffn_act_scales=act_scales, qffn_w4dq=w4dq,
                           **serving_kwargs), prepared


def calibrate_serving_scales(state_dict: Mapping[str, torch.Tensor],
                             img, ques, num_layers: int, num_heads: int,
                             device="cuda"):
    """Static activation scales of the shipped engine, with the aux sites'
    tuple, from one batch in two replays (the JAX Predictor's
    ``_calibrate_scales(need_aux=True)``, api.py:474, and the Trainer's
    end-of-train calibration, trainer.py:495-528): the block scales on the
    bf16 cross k/v path of a level-3 tree, which the default engine runs,
    then only the "aux" tuple from a replay with the aux sites attached.
    -> {"enc_i" / "dec_i" / "aux": tuple of floats}, or None at a width
    outside ``megakernel_vmem_ok`` (no int8 site to calibrate)."""
    prepared = prepare_production_params(state_dict, num_layers, qffn=3,
                                         device=device, num_heads=num_heads)
    if "_mk" not in prepared["backbone"]["enc_0"]:
        return None
    scales = calibrate_qffn_act_scales(prepared, img, ques, num_layers,
                                       num_heads)
    prepared["_q8aux"] = prepare_q8aux_params(prepared, num_layers)
    scales["aux"] = calibrate_qffn_act_scales(prepared, img, ques,
                                              num_layers, num_heads)["aux"]
    return scales


# ---------------------------------------------------------------------------
# the classifier engine (serving.py:282-477)
# ---------------------------------------------------------------------------

def prepare_classifier_params(state_dict: Mapping[str, torch.Tensor],
                              num_layers: int, device="cuda", qffn=True
                              ) -> Params:
    """``ClassifierNet.state_dict()`` -> the classifier engine's tree on
    ``device`` (serving.py:282): per SA block the raw entries of the
    per-sub-op path and, within ``megakernel_vmem_ok``, the mode-2 layout
    ``_mk`` and with a truthy ``qffn`` level its quantized weights
    ``_qffn``; the image projection, AttFlat over the image, ``proj_norm``
    and ``proj`` as ``prepare_params`` lays them out."""
    sd = state_dict
    dev = resolve_device(device)
    bb = {f"enc_{i}": _sa_block_entries(sd, i, dev)
          for i in range(num_layers)}
    _attach_layouts(bb, qffn)
    return {
        "img_feat_linear": _dense_params(sd, "img_feat_linear", dev),
        "backbone": bb,
        "attflat_img": {"mlp": _mlp_params(sd, "attflat_img.mlp", dev),
                        "linear_merge": _dense_params(
                            sd, "attflat_img.linear_merge", dev)},
        "proj_norm": _ln_params(sd, "proj_norm", dev),
        "proj": _dense_params(sd, "proj", dev),
    }


def prune_classifier_params(params: Params, num_layers: int) -> Params:
    """The tree the classifier's mode-2 forward reads (serving.py:323): per
    block only ``_mk`` / ``_qffn``. Raises where a block lacks its ``_mk``
    layout (a width outside ``megakernel_vmem_ok``)."""
    bb = params["backbone"]
    if any("_mk" not in bb[f"enc_{i}"] for i in range(num_layers)):
        raise ValueError(
            "prune_classifier_params needs the _mk layouts on every block "
            "(a width within megakernel_vmem_ok)")
    out = {k: v for k, v in params.items() if k != "backbone"}
    out["backbone"] = {
        f"enc_{i}": {k: bb[f"enc_{i}"][k] for k in ("_mk", "_qffn")
                     if k in bb[f"enc_{i}"]}
        for i in range(num_layers)}
    return out


def prepare_production_classifier_params(
        state_dict: Mapping[str, torch.Tensor], num_layers: int, *,
        qffn=True, device="cuda") -> Params:
    """The shipped classifier tree (serving.py:343): the layouts of level
    ``qffn``, pruned to what the mode-2 forward reads where the width has
    the ``_mk`` layouts; past ``megakernel_vmem_ok`` the raw entries of the
    per-sub-op path."""
    prepared = prepare_classifier_params(state_dict, num_layers, device,
                                         qffn=qffn)
    if "_mk" in prepared["backbone"]["enc_0"]:
        prepared = prune_classifier_params(prepared, num_layers)
    return prepared


def build_production_classifier_engine(
        state_dict: Mapping[str, torch.Tensor], num_layers: int,
        num_heads: int, *, qffn=None, act_scale_inputs=None,
        act_scales=None, device="cuda") -> Tuple[Callable, Params]:
    """ONE construction path for the classifier engine (serving.py:355,
    the classifier twin of ``build_production_engine``) -> (forward,
    prepared). qffn: None -> level 1 without calibration, level 3 with a
    calibration batch or stored scales; an int forces a level, 0 the
    all-bf16 kernels; levels 4-7 need a calibration batch or stored
    scales. act_scale_inputs: an img_feat batch to calibrate static scales
    on (``calibrate_classifier_act_scales``); act_scales: precomputed
    {"enc_i": tuple of floats} (the Trainer's side file); not both. With
    qffn=0 both are ignored; past ``megakernel_vmem_ok`` too, with JAX's
    warning."""
    if act_scale_inputs is not None and act_scales is not None:
        raise ValueError(
            "pass a calibration batch OR precomputed scales, not both")
    if qffn is None:
        qffn = 3 if (act_scale_inputs is not None
                     or act_scales is not None) else True
    if int(qffn) >= 4 and act_scale_inputs is None and act_scales is None:
        raise ValueError(
            "qffn levels 4-7 (int4 weight streaming) require a calibration "
            "batch (act_scale_inputs) or precomputed act_scales -- the int4 "
            "kernels have no dynamic-quant path")
    w4dq = int(qffn) >= 6
    prepared = prepare_production_classifier_params(
        state_dict, num_layers, qffn=qffn, device=device)
    if (act_scale_inputs is not None or act_scales is not None) and qffn \
            and "_mk" not in prepared["backbone"]["enc_0"]:
        warnings.warn(
            "activation-scale calibration ignored: classifier dims are "
            "outside the megakernel VMEM envelope (no int8 quant sites)")
        act_scale_inputs = act_scales = None
    if act_scales is not None and qffn:
        act_scales = _check_scales({k: tuple(float(x) for x in v)
                                    for k, v in act_scales.items()})
    elif act_scale_inputs is not None and qffn:
        act_scales = calibrate_classifier_act_scales(
            prepared, act_scale_inputs, num_layers, num_heads, w4dq=w4dq)
    else:
        act_scales = None
    return make_classifier_serving_fn(
        num_layers, num_heads, qffn=bool(qffn), qffn_act_scales=act_scales,
        qffn_w4dq=w4dq), prepared


def make_classifier_serving_fn(num_layers: int, num_heads: int,
                               qffn: bool = True, qffn_act_scales=None,
                               qffn_w4dq: bool = False) -> Callable:
    """forward(params, img_feat [B, R, F] f32) -> logits [B, A] f32 for
    ``ClassifierNet`` (serving.py:410): the image projection, every SA
    block over the image stream as ``make_serving_fn``'s mode-2 encoder
    runs the question's (``fused_qffn_sa_block`` where the block has
    ``_qffn`` and, with dynamic scales, B <= ``QFFN_MAX_BATCH``, else
    ``fused_sa_block``), AttFlat, ``proj_norm`` and ``proj`` plain, a bf16
    stream between the blocks (JAX's ``bf16_stream=True``). Past
    ``megakernel_vmem_ok`` the blocks run the mode-0 encoder (JAX: plain
    per-sub-op ops, :463-471), its merges and FFNs on ``fused_proj_ln`` /
    ``fused_ffn_ln`` as the VQA engine's. qffn_act_scales: {"enc_i": scale
    tuple} (static) or None (dynamic). ``forward.act_scales`` holds the
    scales baked in."""
    scales = qffn_act_scales or {}

    def forward(params: Params, img_feat: torch.Tensor) -> torch.Tensor:
        v_mask = make_mask(img_feat)
        v = _dense(params["img_feat_linear"], img_feat).to(BF16)
        bb = params["backbone"]
        enc0 = bb["enc_0"]
        F_ff = (enc0["_mk"]["w1"] if "_mk" in enc0 else enc0["ffn"]["mlp"][
            "FCLayer_0"]["Dense_0"]["kernel"]).shape[1]
        if megakernel_vmem_ok(v.shape[-1], F_ff):
            v = _encoder2(bb, v, v_mask, num_layers, num_heads, qffn,
                          scales, qffn_w4dq)
        else:
            v = _encoder0(bb, v, v_mask, num_layers, num_heads, False, True,
                          BF16)
        img_flat = _attflat(params["attflat_img"], v, v_mask)
        return _dense(params["proj"],
                      _std_layer_norm(params["proj_norm"], img_flat))

    forward.act_scales = qffn_act_scales if qffn else None
    return forward


# ---------------------------------------------------------------------------
# the full-int8 engine (quant.py:88-198, :1441-1513, megakernel=True)
# ---------------------------------------------------------------------------

def _qd(kernel: torch.Tensor, bias: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A Dense of the full-int8 engine: the f32 kernel [in, out] quantized
    per output channel (K-major for ``gemm_s8``), the f32 bias."""
    q = _quant_w(kernel)
    return {"w_q": q["w_q"], "w_scale": q["w_scale"],
            "bias": bias.detach().float()}


def _qd_sd(sd, names, device) -> Dict[str, torch.Tensor]:
    """The int8 Dense of the reference Linear(s) ``names``, fused along the
    output (quantize_params' qd over fuse_projections, quant.py:106)."""
    return _qd(torch.cat([sd[f"{n}.weight"].detach().to(device, torch.float32)
                          .t() for n in names], dim=1),
               torch.cat([sd[f"{n}.bias"].to(device) for n in names]))


def quantize_params(state_dict: Mapping[str, torch.Tensor], num_layers: int,
                    device="cuda") -> Params:
    """Reference state_dict -> the full-int8 engine's tree
    (``quantize_params(megakernel=True)``, quant.py:88, pruned to what
    ``make_quant_serving_fn`` reads): per block the int8 layout ``_mk``
    (``prepare_quant_sa_params`` / ``prepare_quant_sga_params``), the
    decoder's int8 cross ``linear_kv``, the int8 image projection, AttFlat
    MLPs and merges and answer head, all quantized from the f32 weights;
    the embedding, LSTM and LayerNorm as ``prepare_params`` lays them out."""
    sd = state_dict
    dev = resolve_device(device)
    bb: Params = {}
    for i in range(num_layers):
        enc = _sub(sd, f"backbone.enc_list.{i}")
        dec = _sub(sd, f"backbone.dec_list.{i}")
        bb[f"enc_{i}"] = {"_mk": prepare_quant_sa_params(enc, dev)}
        bb[f"dec_{i}"] = {"_mk": prepare_quant_sga_params(dec, dev),
                          "mhatt2": {"linear_kv": _qd_sd(
                              dec, ("mhatt2.linear_k", "mhatt2.linear_v"),
                              dev)}}

    def qd(name):
        return _qd_sd(sd, (name,), dev)

    def mlp(name):
        return {"FCLayer_0": {"Dense_0": qd(f"{name}.fc.linear")},
                "Dense_0": qd(f"{name}.linear")}

    return {
        **_question_params(sd, dev),
        "img_feat_linear": qd("img_feat_linear"),
        "backbone": bb,
        "attflat_lang": {"mlp": mlp("attflat_lang.mlp"),
                         "linear_merge": qd("attflat_lang.linear_merge")},
        "attflat_img": {"mlp": mlp("attflat_img.mlp"),
                        "linear_merge": qd("attflat_img.linear_merge")},
        "proj_norm": _ln_params(sd, "proj_norm", dev),
        "proj": qd("proj"),
    }


def _qdense(p: Mapping[str, torch.Tensor], x: torch.Tensor,
            relu: bool = False) -> torch.Tensor:
    """``_qdense`` (quant.py:169): x [..., K] quantized per row (dynamic),
    the int8 product, per-row x per-channel dequant, + bias (then ReLU)
    -> f32 [..., N]."""
    xq, sx = kernels.quantize_rows(x.reshape(-1, x.shape[-1]))
    y = kernels.gemm_s8(xq, p["w_q"], p["w_scale"], p["bias"], sx=sx,
                        relu=relu)[0]
    return y.view(*x.shape[:-1], y.shape[-1])


def _qattflat(p: Params, x: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """``_qattflat`` (quant.py:190): the MLP logits and the merge as
    dynamic int8 sites around the f32 pooling."""
    mlp = p["mlp"]
    logits = _qdense(mlp["Dense_0"], _qdense(mlp["FCLayer_0"]["Dense_0"], x,
                                             relu=True))
    return _qdense(p["linear_merge"], attflat_pool(logits, x, mask))


def make_quant_serving_fn(num_layers: int, num_heads: int) -> Callable:
    """forward(params, img_feat [B, R, F] f32, ques_ix [B, T] int) -> logits
    [B, A] f32 over a ``quantize_params`` tree: the full-int8 engine as the
    JAX package runs it on its accelerator (``make_quant_serving_fn(
    megakernel=True)``, quant.py:1441): an f32 stream, every block through
    ``fused_quant_sa_block`` / ``fused_quant_sga_block``, the cross k/v
    from ``_qdense`` outside the block."""

    def forward(params: Params, img_feat: torch.Tensor,
                ques_ix: torch.Tensor) -> torch.Tensor:
        q_mask = make_mask(ques_ix.unsqueeze(-1))
        v_mask = make_mask(img_feat)
        q = params["embedding"]["embedding"][ques_ix.long()]
        q = _lstm(params["lstm"], q)
        v = _qdense(params["img_feat_linear"], img_feat)
        bb = params["backbone"]
        for i in range(num_layers):
            q = fused_quant_sa_block(q, q_mask, bb[f"enc_{i}"]["_mk"],
                                     num_heads=num_heads)
        for i in range(num_layers):
            p = bb[f"dec_{i}"]
            kq, vq = _split_kv(_qdense(p["mhatt2"]["linear_kv"], q),
                               num_heads)
            v = fused_quant_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                      num_heads=num_heads)
        lang_flat = _qattflat(params["attflat_lang"], q, q_mask)
        img_flat = _qattflat(params["attflat_img"], v, v_mask)
        fused = _std_layer_norm(params["proj_norm"], lang_flat + img_flat)
        return _qdense(params["proj"], fused)

    return forward
