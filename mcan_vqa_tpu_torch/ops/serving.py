"""The serving forward (mcan_vqa_tpu/ops/serving.py, ``make_serving_fn``
mode 2 with a bf16 residual stream) and its one construction path,
``build_production_engine``.

By default (``qffn=None``) the engine is the JAX package's shipped one:
int8 level 1 -- an int8 FFN with dynamic per-row activation scales, and
the fused qkv too at hidden >= 1024 -- or, given a calibration batch or
stored scales, level 3, every projection int8 with static per-tensor
scales. Each encoder block then runs through ``fused_qffn_sa_block`` and
each decoder block through ``fused_qffn_sga_block`` (ops/quant.py);
``qffn=0``, and a dynamic-scale block past ``QFFN_MAX_BATCH``, run the
all-bf16 ``fused_sa_block`` / ``fused_sga_block`` (ops/sga_block.py). On
the card those are the hand-written kernels, on the CPU their plain
versions. What the JAX engine leaves to XLA outside its Pallas kernels --
the embedding and LSTM, the image projection, the cross k/v projection
(``_cross_kv``), both AttFlat heads and the answer head -- is plain PyTorch
here, with the same bf16 operand / f32 accumulation rule.

Weights arrive as a reference-shaped state_dict (models/net.py
``MCANet.state_dict()``, train/checkpoint.py); ``prepare_params`` lays
them out once: fused [D, 3D] self-attention qkv, fused [D, 2D] cross k/v,
bf16 matmul weights in the JAX [in, out] layout, f32 biases and LN, and
with ``qffn`` each block's int8 weights (``_qffn``).
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
from mcan_vqa_tpu_torch.ops.quant import (INT4_NOT_PORTED, _check_scales,
                                          calibrate_qffn_act_scales,
                                          fused_qffn_sa_block,
                                          fused_qffn_sga_block,
                                          prepare_qffn_params)
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


def prepare_params(state_dict: Mapping[str, torch.Tensor], num_layers: int,
                   device="cuda", qffn=False) -> Params:
    """Reference state_dict -> the serving tree on ``device`` ("cuda" by
    default; "cpu" for the plain versions), named as the JAX package's
    pruned mode-2 tree (``prune_prepared_params``): per block the ``_mk``
    layout, the decoder's fused cross ``linear_kv``, and with a truthy
    ``qffn`` level the block's int8 weights ``_qffn``
    (``decode_qffn_level``; the int4 levels 4-7 raise)."""
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
        if w4:
            raise NotImplementedError(f"qffn={qffn}: {INT4_NOT_PORTED}")
        for blk in bb.values():
            blk["_qffn"] = prepare_qffn_params(blk["_mk"], qkv8, proj8)
    return {
        "embedding": {"embedding": sd["embedding.weight"].detach()
                      .to(dev, torch.float32)},
        "lstm": {"w_ih": sd["lstm.weight_ih_l0"].detach().t()
                 .to(dev, BF16).contiguous(),
                 "w_hh": sd["lstm.weight_hh_l0"].detach().t()
                 .to(dev, BF16).contiguous(),
                 "b_ih": sd["lstm.bias_ih_l0"].detach().to(dev,
                                                          torch.float32),
                 "b_hh": sd["lstm.bias_hh_l0"].detach().to(dev,
                                                          torch.float32)},
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


def _attflat(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain AttFlat (serving.py:545-564 without the Pallas branch)."""
    return _dense(p["linear_merge"], attflat_pool(_mlp(p["mlp"], x), x, mask))


def _cross_kv(p: Params, q: torch.Tensor, num_heads: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-project cross-attention keys/values -> two [B, H, Lq, Dh] f32
    strided views of one [B, Lq, 2D] product (the attention kernel reads
    them in place)."""
    kv = _dense(p["linear_kv"], q)
    kx, vx = kv.chunk(2, dim=-1)
    return split_heads(kx, num_heads), split_heads(vx, num_heads)


def make_serving_fn(num_layers: int, num_heads: int, qffn: bool = False,
                    qffn_act_scales=None) -> Callable:
    """forward(params, img_feat [B, R, F] f32, ques_ix [B, T] int)
    -> logits [B, A] f32; params from ``prepare_params``. Mode 2 of the
    JAX engine with a bf16 residual stream (bf16_stream=True).

    qffn: run each block that carries ``_qffn`` through the int8 block
    kernels. qffn_act_scales: {"enc_i" / "dec_i": scale tuple} from
    ``calibrate_qffn_act_scales`` (static scales), or None (dynamic). Per
    block, as serving.py:859-871 / :926-941: a block with dynamic scales
    runs int8 only while B <= QFFN_MAX_BATCH, else the bf16 kernels; static
    scales lift the gate. ``forward.act_scales`` holds the scales baked in
    (None: dynamic)."""
    stream = BF16
    scales = qffn_act_scales or {}

    def int8_block(p: Params, name: str, batch: int) -> bool:
        return qffn and "_qffn" in p and (batch <= QFFN_MAX_BATCH
                                          or name in scales)

    def forward(params: Params, img_feat: torch.Tensor,
                ques_ix: torch.Tensor) -> torch.Tensor:
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
                                        act_scales=scales.get(f"enc_{i}"))
            else:
                q = fused_sa_block(q, q_mask, p["_mk"], num_heads=num_heads)
        for i in range(num_layers):
            p = bb[f"dec_{i}"]
            kq, vq = _cross_kv(p["mhatt2"], q, num_heads)
            if int8_block(p, f"dec_{i}", v.shape[0]):
                v = fused_qffn_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                         p["_qffn"], num_heads=num_heads,
                                         act_scales=scales.get(f"dec_{i}"))
            else:
                v = fused_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                    num_heads=num_heads)
        lang_flat = _attflat(params["attflat_lang"], q, q_mask)
        img_flat = _attflat(params["attflat_img"], v, v_mask)
        fused = _std_layer_norm(params["proj_norm"], lang_flat + img_flat)
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
                            q8aux: bool = False, device="cuda"
                            ) -> Tuple[Callable, Params]:
    """ONE construction path for the shipped serving engine
    (serving.py:602) -> (forward, prepared).

    qffn: None picks the production default -- level 1 (dynamic int8 FFN,
    + qkv at hidden >= 1024) without calibration, level 3 (every
    projection int8, static scales) with a calibration batch or stored
    scales; an int forces a level, 0 the all-bf16 kernels.
    act_scale_inputs: an (img_feat, ques_ix) batch to calibrate static
    scales on (``calibrate_qffn_act_scales``). act_scales: precomputed
    scales ({"enc_i" / "dec_i": tuple of floats}); mutually exclusive with
    act_scale_inputs. With qffn=0 both are ignored, as in JAX. The int4
    levels 4-7 and q8aux raise NotImplementedError."""
    if act_scale_inputs is not None and act_scales is not None:
        raise ValueError(
            "pass a calibration batch OR precomputed scales, not both")
    if qffn is None:
        qffn = 3 if (act_scale_inputs is not None
                     or act_scales is not None) else True
    if int(qffn) >= 4:
        raise NotImplementedError(f"qffn={qffn}: {INT4_NOT_PORTED}")
    if q8aux:
        raise NotImplementedError(f"q8aux: {INT4_NOT_PORTED}")
    prepared = prepare_production_params(state_dict, num_layers, qffn=qffn,
                                         device=device)
    if act_scales is not None and qffn:
        act_scales = _check_scales({k: tuple(float(x) for x in v)
                                    for k, v in act_scales.items()})
    elif act_scale_inputs is not None and qffn:
        img, ques = act_scale_inputs
        act_scales = calibrate_qffn_act_scales(prepared, img, ques,
                                               num_layers, num_heads)
    else:
        act_scales = None
    return make_serving_fn(num_layers, num_heads, qffn=bool(qffn),
                           qffn_act_scales=act_scales), prepared
