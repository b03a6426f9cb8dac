"""The training forwards of MCAN and of the image-only classifier, built
for autograd (mcan_vqa_tpu/train/fused_engine.py).

``make_fused_train_forward`` returns forward(net, img_feat, ques_ix,
generator) -> logits over the parameters of an ``MCANet``:

  * every decoder (SGA) block -- most of the model's FLOPs -- runs through
    ``ops/sga_train.fused_sga_block_train``, the autograd.Function whose
    forward and backward are the hand-written CUDA kernels on the card;
    ``att_saves`` / ``bf16_saves`` pass through to it (JAX :241, :250);
  * with ``fused_encoder=True`` (the JAX Trainer's choice at hidden <=
    512) every encoder (SA) block runs through
    ``ops/sa_train.fused_sa_block_train`` likewise (JAX :147-176);
    otherwise the encoder stack is plain PyTorch with dropout;
  * everything else (embedding, LSTM, the cross k / v projections, AttFlat
    and the classifier) is plain PyTorch with dropout, as it is plain XLA
    in the JAX engine.

``sga_block="plain"`` runs the same blocks in plain ops under autograd
(``fused_sga_block_train_plain``, and ``fused_sa_block_train_plain`` for a
fused encoder). JAX's ``group`` / ``encoder_group`` pack samples into one
matrix for the TPU's matrix unit; the port computes attention per sample,
so they have no counterpart here.

Dropout: one generator per step, and every keep-mask of the step drawn from
it up front in the fixed site order of the JAX engine (fused_engine.py:
125-129): the encoder layers (``sa_train.SA_MASK_NAMES``: attention map,
attention output, FFN hidden, FFN output), then the decoder blocks (the six
masks of ``sga_train.MASK_NAMES``), then AttFlat over the question and over
the image, each with ``dropout_bits`` random bits per element. The fused
and plain encoders read the same four masks, so any two engines handed the
same generator state see the same masks.

``in_kernel_dropout`` (the JAX Trainer's route on its accelerator,
fused_engine.py:164-173, :234-245): each train block takes one seed per
step instead of its masks (``dropout.draw_seeds``, host ints, drawn where
the block's masks would be) and draws its keep bits inside the kernels
(``fused_sga_block_train_prng``, ``fused_sa_block_train(..., rate=)``);
the plain sites (AttFlat, an encoder in plain ops) keep generator masks.
With ``sga_block="plain"`` the same seeds feed the plain blocks, which draw
the same bits through ``kernels.philox4x32_plain``.

The forward takes an ``MCANet`` or the same model in the stacked layout
(``ops/stacked_params.py::StackedMCANet``, the Trainer's
``stacked_params="on"``): there each block's train-layout weights are
slices of [L, ...] leaves, so no concatenation or transpose of a block
weight runs in the step, and the cross k / v run ``Dense``'s product on
their stacked [out, in] leaves. The stacked layout takes the fused blocks
only (``sga_block="fused"``, no model group).

``make_fused_classifier_forward`` (JAX :262-311) is the classifier's:
forward(net, img_feat, generator) over a ``ClassifierNet``, every SA block
over the image stream through ``sa_train.fused_sa_block_train`` at every
width (JAX routes nothing by width here), then AttFlat over the image,
``proj_norm`` and ``proj`` in plain PyTorch with dropout. Its masks are
drawn in JAX's site order (``keys = split(rng, num_layers + 1)``): the
blocks' four each (or one seed each), then AttFlat's. JAX's ``group``
(``256 // Lv`` samples packed per score matrix) has no counterpart: the
attention is per sample.

Tensor parallelism (``model_group``, the plain blocks only: JAX's route at
a model axis > 1, trainer.py:550): the module is this model rank's shard
(``parallel/sharding.py::shard_module_``); every projection runs
column- or row-parallel through Megatron's f and g (``models/layers.py``).
Every model rank draws the full-shape masks from the generator it shares
with the other model ranks of its data shard and keeps its slice of the
sliced sites (the per-head attention maps, the FFN hidden;
``shard_masks``), so the masks on the replicated [B, L, D] stream are the
same on every model rank and tp = 2 computes what tp = 1 does, dropout
included, as GSPMD partitions one mask.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from mcan_vqa_tpu_torch.models.attention import NEG_INF, split_heads
from mcan_vqa_tpu_torch.models.layers import (bf16_matmul,
                                              copy_inputs_to_model,
                                              copy_to_model, make_mask,
                                              operand, row_parallel)
from mcan_vqa_tpu_torch.models.net import attflat_pool
from mcan_vqa_tpu_torch.ops import sa_train, sga_train
from mcan_vqa_tpu_torch.ops.dropout import draw_seeds, inv_keep_prob, \
    keep_masks
from mcan_vqa_tpu_torch.ops.stacked_params import StackedBackbone, \
    block_views
from mcan_vqa_tpu_torch.parallel.sharding import group_rank, group_size

Mask = Optional[torch.Tensor]
# sga_block -> (the block fed masks, the block fed a seed)
SGA_BLOCKS = {"fused": (sga_train.fused_sga_block_train,
                        sga_train.fused_sga_block_train_prng),
              "plain": (sga_train.fused_sga_block_train_plain,
                        sga_train.fused_sga_block_train_prng_plain)}
SA_BLOCKS = {"fused": sa_train.fused_sa_block_train,
             "plain": sa_train.fused_sa_block_train_plain}


def _drop(x: torch.Tensor, mask: Mask, inv_keep: float) -> torch.Tensor:
    return x if mask is None else torch.where(mask, x * inv_keep,
                                              torch.zeros_like(x))


def _masked_attention_train(p, v, k, q, mask, num_heads: int, drop: Mask,
                            inv_keep: float, group=None) -> torch.Tensor:
    """Multi-head attention with dropout on the attention map (the encoder
    path): bf16 operands, PAD keys replaced by -1e9, f32 softmax. p is an
    ``MHAtt``; with a model group its local heads (num_heads of them)."""
    H = num_heads
    if group is not None:
        v, k, q = copy_inputs_to_model(group, v, k, q)
    qh, kh, vh = (split_heads(lin(x), H) for lin, x in
                  ((p.linear_q, q), (p.linear_k, k), (p.linear_v, v)))
    scale = 1.0 / qh.shape[-1] ** 0.5
    scores = (operand(qh) @ operand(kh).transpose(-1, -2)) \
        * scale
    att = _drop(torch.softmax(scores.masked_fill(mask, NEG_INF), dim=-1),
                drop, inv_keep)
    out = operand(att) @ operand(vh)
    B, _, Lq, _ = out.shape
    out = out.transpose(1, 2).reshape(B, Lq, -1)
    if group is None:
        return p.linear_merge(out)
    m = p.linear_merge
    return row_parallel(out, m.weight.t(), m.bias, group)


def _mlp_train(p, x: torch.Tensor, drop: Mask,
               inv_keep: float) -> torch.Tensor:
    """MLP (FC with ReLU, dropout on its output, Linear); p is an ``MLP``."""
    return p.linear(_drop(p.fc(x), drop, inv_keep))


def _ffn_train(p, x: torch.Tensor, drop: Mask, inv_keep: float,
               group=None) -> torch.Tensor:
    """The FFN's MLP with dropout on its hidden; with a model group the up
    projection column-parallel behind f, the down one through g."""
    if group is None:
        return _mlp_train(p, x, drop, inv_keep)
    h = _drop(p.fc(copy_to_model(x, group)), drop, inv_keep)
    return row_parallel(h, p.linear.weight.t(), p.linear.bias, group)


def shard_masks(masks: Dict[str, Mask], tp: int, index: int
                ) -> Dict[str, Mask]:
    """Model rank ``index``'s slices of one block's full-shape masks: the
    attention maps [B, H, L, L'] by head, the FFN hidden [B, L, F] by
    column; the [B, L, D] stream's masks whole. At tp 1 ``masks`` itself
    (a seed too)."""
    if tp == 1:
        return masks
    out = {}
    for name, m in masks.items():
        if m is not None and name.startswith("att"):
            m = m.chunk(tp, dim=1)[index]
        elif m is not None and name == "h1":
            m = m.chunk(tp, dim=-1)[index]
        out[name] = m
    return out


def _attflat_train(p, x: torch.Tensor, mask: torch.Tensor, drop: Mask,
                   inv_keep: float) -> torch.Tensor:
    """AttFlat with dropout inside its MLP; p is an ``AttFlat``."""
    return p.linear_merge(attflat_pool(_mlp_train(p.mlp, x, drop, inv_keep),
                                       x, mask))


def draw_step_masks(generator: Optional[torch.Generator], rate: float, *,
                    B: int, Lq: int, Lv: int, D: int, F: int, H: int,
                    num_layers: int, flat_mlp: int, bit_width: int = 32,
                    seeded_enc: bool = False,
                    seeded_dec: bool = False) -> Dict[str, List]:
    """Every keep-mask of one step, in site order (see the module
    docstring), on the generator's device; a seeded stack gets one host
    int seed per block in place of its masks. At rate 0 all masks are None
    and nothing is drawn."""
    def draw(shapes):
        return keep_masks(generator, rate, shapes, bit_width)[0]

    enc = (draw_seeds(generator, num_layers) if seeded_enc
           else [draw(sa_train.mask_shapes(B, Lq, D, F, H))
                 for _ in range(num_layers)])
    dec = (draw_seeds(generator, num_layers) if seeded_dec
           else [draw(sga_train.mask_shapes(B, Lv, Lq, D, F, H))
                 for _ in range(num_layers)])
    flat = draw({"lang": (B, Lq, flat_mlp), "img": (B, Lv, flat_mlp)})
    return {"enc": enc, "dec": dec, "flat": [flat["lang"], flat["img"]]}


def make_fused_train_forward(num_layers: int, num_heads: int,
                             dropout_rate: float = 0.1,
                             fused_encoder: bool = False,
                             sga_block: str = "fused",
                             att_saves: bool = False,
                             bf16_saves: bool = False,
                             dropout_bits: int = 32,
                             in_kernel_dropout: bool = False,
                             model_group=None) -> Callable:
    """-> forward(net, img_feat [B, R, F] f32, ques_ix [B, T] int,
    generator) -> logits [B, A], differentiable w.r.t. net's parameters.
    sga_block: "fused" (the kernels) or "plain" (the same blocks in plain
    ops, autograd). fused_encoder: the encoder through the SA train
    blocks. att_saves / bf16_saves: what the decoder blocks save for their
    backward (``fused_sga_block_train``; the plain blocks leave that to
    autograd). dropout_bits: random bits per keep decision of every
    generator mask (8, 16 or 32). in_kernel_dropout: the train blocks draw
    their dropout inside the kernels from one seed each per step.
    model_group: tensor parallelism over ``net``'s shards (the plain
    blocks, generator masks; see the module docstring); num_heads stays
    the model's."""
    if sga_block not in SGA_BLOCKS:
        raise ValueError(f"sga_block must be one of {tuple(SGA_BLOCKS)}")
    if model_group is not None and (sga_block != "plain" or fused_encoder
                                    or in_kernel_dropout):
        raise ValueError("tensor parallelism runs the plain blocks with "
                         "generator masks")
    block, seeded_block = SGA_BLOCKS[sga_block]
    if sga_block == "fused":
        block, seeded_block = (functools.partial(
            b, att_saves=att_saves, bf16_saves=bf16_saves)
            for b in (block, seeded_block))
    sa_block = SA_BLOCKS[sga_block] if fused_encoder else None
    rate = dropout_rate
    if rate >= 1.0:
        raise ValueError(f"dropout rate {rate} >= 1 keeps nothing")
    inv_keep = inv_keep_prob(rate, dropout_bits) if rate > 0.0 else 1.0
    seeded = in_kernel_dropout and rate > 0.0

    group = model_group
    tp, index = group_size(group), group_rank(group)

    def forward(net, img_feat: torch.Tensor, ques_ix: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        q_mask = make_mask(ques_ix.unsqueeze(-1))
        v_mask = make_mask(img_feat)
        H = num_heads // tp
        q = net.lstm(net.embedding(ques_ix))
        v = net.img_feat_linear(img_feat)
        B, Lq, D = q.shape
        Lv = v.shape[1]
        bb = net.backbone
        # the stacked layout (ops/stacked_params.py): each block's train
        # layout is a slice of the stacks; else built from its leaves
        stacked = isinstance(bb, StackedBackbone)
        if stacked and (model_group is not None
                        or sga_block != "fused"
                        or hasattr(bb, "enc") != (sa_block is not None)):
            raise ValueError("the stacked layout runs the fused blocks, "
                             "its encoder stacked where the SA train "
                             "blocks run it")
        dec_w = (block_views(bb.dec) if stacked else
                 [sga_train.prepare_sga_train_params(
                     dict(dec.named_parameters())) for dec in bb.dec_list])
        enc_w = (block_views(bb.enc) if stacked and hasattr(bb, "enc")
                 else [None] * num_layers)
        masks = draw_step_masks(
            generator, rate, B=B, Lq=Lq, Lv=Lv, D=D,
            F=dec_w[0]["w1"].shape[1] * tp, H=num_heads,
            num_layers=num_layers,
            flat_mlp=net.attflat_lang.mlp.fc.linear.weight.shape[0],
            bit_width=dropout_bits, seeded_enc=seeded and fused_encoder,
            seeded_dec=seeded)

        # ---- encoder SA stack over the question: the train block, or
        # plain ops
        enc_blocks = bb.enc_list if hasattr(bb, "enc_list") else enc_w
        for enc, w, m in zip(enc_blocks, enc_w, masks["enc"]):
            m = shard_masks(m, tp, index)
            if sa_block is not None:
                if w is None:
                    w = sa_train.prepare_sa_train_params(
                        dict(enc.named_parameters()))
                q = sa_block(q.float(), q_mask, m, w, num_heads=H,
                             inv_keep=inv_keep,
                             rate=rate if seeded else None)
                continue
            att = _masked_attention_train(enc.mhatt, q, q, q, q_mask, H,
                                          m["att"], inv_keep, group)
            q = enc.norm1(q + _drop(att, m["y1"], inv_keep))
            ff = _ffn_train(enc.ffn.mlp, q, m["h1"], inv_keep, group)
            q = enc.norm2(q + _drop(ff, m["y2"], inv_keep))

        # ---- decoder SGA stack over the regions (the train block); under
        # tensor parallelism one f on q carries every layer's cross k / v
        qk = copy_to_model(q, group)
        tp_kw = {} if group is None else {"model_group": group}
        for i, (w, m) in enumerate(zip(dec_w, masks["dec"])):
            if stacked:
                # Dense's product on the [out, in] leaf
                kq = split_heads(bf16_matmul(qk, w["wk2"].t()) + w["bk2"],
                                 H)
                vq = split_heads(bf16_matmul(qk, w["wv2"].t()) + w["bv2"],
                                 H)
            else:
                dec = bb.dec_list[i]
                kq = split_heads(dec.mhatt2.linear_k(qk), H)
                vq = split_heads(dec.mhatt2.linear_v(qk), H)
            if seeded:
                v = seeded_block(v, kq, vq, v_mask, q_mask, m, w,
                                 num_heads=H, rate=rate)
            else:
                v = block(v, kq, vq, v_mask, q_mask,
                          shard_masks(m, tp, index), w, num_heads=H,
                          inv_keep=inv_keep, **tp_kw)

        lang = _attflat_train(net.attflat_lang, q, q_mask, masks["flat"][0],
                              inv_keep)
        img = _attflat_train(net.attflat_img, v, v_mask, masks["flat"][1],
                             inv_keep)
        return net.proj(net.proj_norm(lang + img))

    return forward


def draw_classifier_masks(generator: Optional[torch.Generator], rate: float,
                          *, B: int, Lv: int, D: int, F: int, H: int,
                          num_layers: int, flat_mlp: int,
                          bit_width: int = 32, seeded: bool = False
                          ) -> Dict[str, List]:
    """The classifier step's keep-masks in site order: each block's four
    (``sa_train.SA_MASK_NAMES``; a seeded stack gets one host int seed per
    block instead), then AttFlat's over the image. At rate 0 nothing is
    drawn."""
    def draw(shapes):
        return keep_masks(generator, rate, shapes, bit_width)[0]

    blocks = (draw_seeds(generator, num_layers) if seeded
              else [draw(sa_train.mask_shapes(B, Lv, D, F, H))
                    for _ in range(num_layers)])
    return {"enc": blocks, "flat": draw({"img": (B, Lv, flat_mlp)})["img"]}


def make_fused_classifier_forward(num_layers: int, num_heads: int,
                                  dropout_rate: float = 0.1,
                                  sa_block: str = "fused",
                                  dropout_bits: int = 32,
                                  in_kernel_dropout: bool = False,
                                  model_group=None) -> Callable:
    """-> forward(net, img_feat [B, R, F] f32, generator) -> logits [B, A],
    differentiable w.r.t. the parameters of a ``ClassifierNet``.
    sa_block: "fused" (the SA train kernels) or "plain" (the same blocks in
    plain ops, autograd). dropout_bits: random bits per keep decision of
    every generator mask. in_kernel_dropout: the blocks draw their dropout
    inside the kernels from one seed each per step; AttFlat keeps its
    generator mask. model_group: tensor parallelism over ``net``'s shards,
    as ``make_fused_train_forward`` takes it."""
    if sa_block not in SA_BLOCKS:
        raise ValueError(f"sa_block must be one of {tuple(SA_BLOCKS)}")
    if model_group is not None and (sa_block != "plain" or in_kernel_dropout):
        raise ValueError("tensor parallelism runs the plain blocks with "
                         "generator masks")
    block = SA_BLOCKS[sa_block]
    rate = dropout_rate
    if rate >= 1.0:
        raise ValueError(f"dropout rate {rate} >= 1 keeps nothing")
    inv_keep = inv_keep_prob(rate, dropout_bits) if rate > 0.0 else 1.0
    seeded = in_kernel_dropout and rate > 0.0

    group = model_group
    tp, index = group_size(group), group_rank(group)
    tp_kw = {} if group is None else {"model_group": group}

    def forward(net, img_feat: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        v_mask = make_mask(img_feat)
        v = net.img_feat_linear(img_feat)
        B, Lv, D = v.shape
        blocks = net.backbone.enc_list
        masks = draw_classifier_masks(
            generator, rate, B=B, Lv=Lv, D=D,
            F=blocks[0].ffn.mlp.fc.linear.weight.shape[0] * tp, H=num_heads,
            num_layers=num_layers,
            flat_mlp=net.attflat_img.mlp.fc.linear.weight.shape[0],
            bit_width=dropout_bits, seeded=seeded)
        for enc, m in zip(blocks, masks["enc"]):
            w = sa_train.prepare_sa_train_params(dict(enc.named_parameters()))
            m = shard_masks(m, tp, index)
            v = block(v.float(), v_mask, m, w, num_heads=num_heads // tp,
                      inv_keep=inv_keep, rate=rate if seeded else None,
                      **tp_kw)
        img = _attflat_train(net.attflat_img, v, v_mask, masks["flat"],
                             inv_keep)
        return net.proj(net.proj_norm(img))

    return forward
