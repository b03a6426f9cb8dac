"""The serving forward (mcan_vqa_tpu/ops/serving.py, ``make_serving_fn``
mode 2 with a bf16 residual stream, built by
``build_production_engine(qffn=0)``).

Each encoder block runs through ``fused_sa_block`` and each decoder block
through ``fused_sga_block`` (ops/sga_block.py): on the card those are the
hand-written kernels, on the CPU their plain versions. What the JAX engine
leaves to XLA outside its Pallas kernels -- the embedding and LSTM, the
image projection, the cross k/v projection (``_cross_kv``), both AttFlat
heads and the answer head -- is plain PyTorch here, with the same bf16
operand / f32 accumulation rule.

Weights arrive as a reference-shaped state_dict (models/net.py
``MCANet.state_dict()``, train/checkpoint.py); ``prepare_params`` lays
them out once: fused [D, 3D] self-attention qkv, fused [D, 2D] cross k/v,
bf16 matmul weights in the JAX [in, out] layout, f32 biases and LN.
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
from mcan_vqa_tpu_torch.ops.sga_block import (fused_sa_block,
                                              fused_sga_block,
                                              prepare_sa_block_params,
                                              prepare_sga_block_params)

Params = Dict[str, Any]


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
                   device="cuda") -> Params:
    """Reference state_dict -> the serving tree on ``device`` ("cuda" by
    default; "cpu" for the plain versions), named as the JAX package's
    pruned mode-2 tree (``prune_prepared_params``): per block only the
    ``_mk`` layout, plus the decoder's fused cross ``linear_kv``."""
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


def make_serving_fn(num_layers: int, num_heads: int) -> Callable:
    """forward(params, img_feat [B, R, F] f32, ques_ix [B, T] int)
    -> logits [B, A] f32; params from ``prepare_params``. Mode 2 of the
    JAX engine with a bf16 residual stream (bf16_stream=True)."""
    stream = BF16

    def forward(params: Params, img_feat: torch.Tensor,
                ques_ix: torch.Tensor) -> torch.Tensor:
        q_mask = make_mask(ques_ix.unsqueeze(-1))
        v_mask = make_mask(img_feat)
        q = params["embedding"]["embedding"][ques_ix.long()]
        q = _lstm(params["lstm"], q).to(stream)
        v = _dense(params["img_feat_linear"], img_feat).to(stream)
        bb = params["backbone"]
        for i in range(num_layers):
            q = fused_sa_block(q, q_mask, bb[f"enc_{i}"]["_mk"],
                               num_heads=num_heads)
        for i in range(num_layers):
            p = bb[f"dec_{i}"]
            kq, vq = _cross_kv(p["mhatt2"], q, num_heads)
            v = fused_sga_block(v, kq, vq, v_mask, q_mask, p["_mk"],
                                num_heads=num_heads)
        lang_flat = _attflat(params["attflat_lang"], q, q_mask)
        img_flat = _attflat(params["attflat_img"], v, v_mask)
        fused = _std_layer_norm(params["proj_norm"], lang_flat + img_flat)
        return _dense(params["proj"], fused)

    return forward


def build_production_engine(state_dict: Mapping[str, torch.Tensor],
                            num_layers: int, num_heads: int, *, qffn=0,
                            act_scale_inputs=None, act_scales=None,
                            q8aux: bool = False, device="cuda"
                            ) -> Tuple[Callable, Params]:
    """The all-bf16 block-kernel serving engine -> (forward, prepared).

    The port has only the all-bf16 engine so far (JAX
    ``build_production_engine(qffn=0)``): the int8 engines, their
    calibration and the static-int8 aux sites raise rather than serve
    something else."""
    if qffn is None or int(qffn) != 0:
        raise NotImplementedError(
            f"qffn={qffn!r}: the int8/int4 block kernels are not ported "
            f"yet; use qffn=0 (the all-bf16 engine)")
    for name, val in (("act_scale_inputs", act_scale_inputs),
                      ("act_scales", act_scales), ("q8aux", q8aux or None)):
        if val is not None:
            raise NotImplementedError(
                f"{name}: activation calibration and the static-int8 "
                f"sites are not ported yet")
    prepared = prepare_params(state_dict, num_layers, device)
    return make_serving_fn(num_layers, num_heads), prepared

