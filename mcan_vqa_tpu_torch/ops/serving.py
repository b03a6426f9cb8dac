"""The serving forwards (mcan_vqa_tpu/ops/serving.py, ``make_serving_fn``
mode 2 with a bf16 residual stream, and ops/quant.py
``make_quant_serving_fn``, the full-int8 engine) and their construction
paths, ``build_production_engine`` and ``quantize_params``.

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

The full-int8 engine (``Predictor(engine="int8")``) carries an f32 stream
and runs every product int8 with dynamic per-row scales: the image
projection, the cross k/v, the AttFlat MLPs and merges and the head as
``quantize_rows`` + ``gemm_s8`` (``_qdense``, quant.py:169), each block
through ``fused_quant_sa_block`` / ``fused_quant_sga_block``, the
``megakernel=True`` engine of the JAX package.

Weights arrive as a reference-shaped state_dict (models/net.py
``MCANet.state_dict()``, train/checkpoint.py); ``prepare_params`` lays
them out once: fused [D, 3D] self-attention qkv, fused [D, 2D] cross k/v,
bf16 matmul weights in the JAX [in, out] layout, f32 biases and LN, and
with ``qffn`` each block's quantized weights (``_qffn``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from mcan_vqa_tpu_torch.device import resolve_device
from mcan_vqa_tpu_torch.models.attention import split_heads
from mcan_vqa_tpu_torch.models.layers import (BF16, bf16_matmul, make_mask,
                                              std_layer_norm)
from mcan_vqa_tpu_torch.models.lstm import lstm_forward
from mcan_vqa_tpu_torch.models.net import attflat_pool
from mcan_vqa_tpu_torch.ops import kernels
from mcan_vqa_tpu_torch.ops.quant import (_check_scales, _quant_w,
                                          calibrate_qffn_act_scales,
                                          fused_qffn_sa_block,
                                          fused_qffn_sga_block,
                                          fused_quant_sa_block,
                                          fused_quant_sga_block,
                                          prepare_q8aux_params,
                                          prepare_qffn_params,
                                          prepare_quant_sa_params,
                                          prepare_quant_sga_params)
from mcan_vqa_tpu_torch.ops.sga_block import (fused_sa_block,
                                              fused_sga_block,
                                              prepare_sa_block_params,
                                              prepare_sga_block_params)

Params = Dict[str, Any]

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


def prepare_params(state_dict: Mapping[str, torch.Tensor], num_layers: int,
                   device="cuda", qffn=False) -> Params:
    """Reference state_dict -> the serving tree on ``device`` ("cuda" by
    default; "cpu" for the plain versions), named as the JAX package's
    pruned mode-2 tree (``prune_prepared_params``): per block the ``_mk``
    layout, the decoder's fused cross ``linear_kv``, and with a truthy
    ``qffn`` level the block's quantized weights ``_qffn``
    (``decode_qffn_level``)."""
    sd = state_dict
    dev = resolve_device(device)

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    bb: Params = {}
    for i in range(num_layers):
        enc = _sub(sd, f"backbone.enc_list.{i}")
        dec = _sub(sd, f"backbone.dec_list.{i}")
        kv = [_dense_params(dec, f"mhatt2.{n}", dev)
              for n in ("linear_k", "linear_v")]
        bb[f"enc_{i}"] = {"_mk": to_dev(prepare_sa_block_params(enc))}
        bb[f"dec_{i}"] = {
            "_mk": to_dev(prepare_sga_block_params(dec)),
            "mhatt2": {"linear_kv": {
                "kernel": torch.cat([p["kernel"] for p in kv], 1)
                .contiguous(),
                "bias": torch.cat([p["bias"] for p in kv])}}}
    if qffn:
        qkv8, proj8, w4 = decode_qffn_level(
            qffn, bb["enc_0"]["_mk"]["wqkv"].shape[0])
        for blk in bb.values():
            blk["_qffn"] = prepare_qffn_params(blk["_mk"], qkv8, proj8, w4)
    return {
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
             q8=None) -> torch.Tensor:
    """Plain AttFlat (serving.py:545-575 without the Pallas branch); q8:
    (aux site, a), the merge as a static-int8 site."""
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


def make_serving_fn(num_layers: int, num_heads: int, qffn: bool = False,
                    qffn_act_scales=None, qffn_w4dq: bool = False
                    ) -> Callable:
    """forward(params, img_feat [B, R, F] f32, ques_ix [B, T] int)
    -> logits [B, A] f32; params from ``prepare_params``. Mode 2 of the
    JAX engine with a bf16 residual stream (bf16_stream=True).

    qffn: run each block that carries ``_qffn`` through the quantized block
    kernels. qffn_act_scales: {"enc_i" / "dec_i": scale tuple} from
    ``calibrate_qffn_act_scales`` (static scales), or None (dynamic). Per
    block, as serving.py:859-871 / :926-941: a block with dynamic scales
    runs int8 only while B <= QFFN_MAX_BATCH, else the bf16 kernels; static
    scales lift the gate. qffn_w4dq: the int4 sites run the bf16-dequant
    compute (levels 6/7). The aux sites run static int8 when params carry
    ``_q8aux`` and the scales an "aux" tuple (serving.py:688-694).
    ``forward.act_scales`` holds the scales baked in (None: dynamic)."""
    stream = BF16
    scales = qffn_act_scales or {}

    def int8_block(p: Params, name: str, batch: int) -> bool:
        return qffn and "_qffn" in p and (batch <= QFFN_MAX_BATCH
                                          or name in scales)

    def forward(params: Params, img_feat: torch.Tensor,
                ques_ix: torch.Tensor) -> torch.Tensor:
        aux_w, aux_s = params.get("_q8aux"), scales.get("aux")
        use_aux = aux_w is not None and aux_s is not None
        q_mask = make_mask(ques_ix.unsqueeze(-1))
        v_mask = make_mask(img_feat)
        q = params["embedding"]["embedding"][ques_ix.long()]
        q = _lstm(params["lstm"], q).to(stream)
        v = _dense(params["img_feat_linear"], img_feat).to(stream)
        bb = params["backbone"]
        for i in range(num_layers):
            p = bb[f"enc_{i}"]
            if int8_block(p, f"enc_{i}", q.shape[0]):
                q = fused_qffn_sa_block(q, q_mask, p["_mk"], p["_qffn"],
                                        num_heads=num_heads,
                                        act_scales=scales.get(f"enc_{i}"),
                                        w4dq=qffn_w4dq)
            else:
                q = fused_sa_block(q, q_mask, p["_mk"], num_heads=num_heads)
        for i in range(num_layers):
            p = bb[f"dec_{i}"]
            if use_aux:
                kq, vq = _cross_kv_q8(aux_w[f"dec_{i}_kv"], q, num_heads,
                                      aux_s[0])
            else:
                kq, vq = _cross_kv(p["mhatt2"], q, num_heads)
            if int8_block(p, f"dec_{i}", v.shape[0]):
                v = fused_qffn_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                         p["_qffn"], num_heads=num_heads,
                                         act_scales=scales.get(f"dec_{i}"),
                                         w4dq=qffn_w4dq)
            else:
                v = fused_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                    num_heads=num_heads)
        lang_flat = _attflat(params["attflat_lang"], q, q_mask,
                             (aux_w["lang_merge"], aux_s[1]) if use_aux
                             else None)
        img_flat = _attflat(params["attflat_img"], v, v_mask,
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
                              device="cuda") -> Params:
    """The shipped engine's tree (serving.py:582): the pruned mode-2
    layout with the ``_qffn`` weights of level ``qffn``."""
    return prepare_params(state_dict, num_layers, device, qffn=qffn)


def build_production_engine(state_dict: Mapping[str, torch.Tensor],
                            num_layers: int, num_heads: int, *, qffn=None,
                            act_scale_inputs=None, act_scales=None,
                            q8aux: bool = False, sga_mode: int = 2,
                            device="cuda") -> Tuple[Callable, Params]:
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
    act_scale_inputs. With qffn=0 both are ignored, as in JAX.
    q8aux: the static-int8 aux sites (``prepare_q8aux_params``); they need
    a calibration batch or stored scales with an "aux" tuple, and a
    quantized level. sga_mode: the JAX engine's decoder mode; the port
    runs the per-block mode 2."""
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
    if sga_mode != 2:
        raise NotImplementedError(
            f"sga_mode={sga_mode}: the port runs the per-block mode-2 engine "
            f"only")
    prepared = prepare_production_params(state_dict, num_layers, qffn=qffn,
                                         device=device)
    if q8aux:
        prepared["_q8aux"] = prepare_q8aux_params(prepared, num_layers)
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
    return make_serving_fn(num_layers, num_heads, qffn=bool(qffn),
                           qffn_act_scales=act_scales,
                           qffn_w4dq=w4dq), prepared


# ---------------------------------------------------------------------------
# the full-int8 engine (quant.py:88-198, :1441-1513, megakernel=True)
# ---------------------------------------------------------------------------

def _qd(kernel: torch.Tensor, bias: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A Dense of the full-int8 engine: the f32 kernel [in, out] quantized
    per output channel, its rows padded for ``gemm_s8``, the f32 bias."""
    q = _quant_w(kernel)
    return {"w_q": kernels.pad_cols(q["w_q"]), "w_scale": q["w_scale"],
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
