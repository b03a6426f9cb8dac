"""The SA encoder block for training: forward with its four dropout sites,
and its backward (mcan_vqa_tpu/ops/sa_train.py).

The reference SA block (core/model/mca.py:105-127) over the question:

    x1 = LN1(x + drop_y1(merge(self_att(x, drop_att))))
    x2 = LN2(x1 + drop_y2(W2 . drop_h1(relu(W1 . x1 + b1)) + b2))

On the TPU one train step runs two Pallas kernels per encoder block:
``_fwd_kernel`` (sa_train.py:172, called at :389) and the whole backward
in one launch, ``_bwd_kernel_sav`` from the saved r2 / h1d (:304) or
``_bwd_kernel`` with the FFN recomputed (:287), both called at :487. On
the card each is a short sequence of the hand-written kernels of
ops/kernels.py:

  forward   gemm_bias_act (qkv; merge; FFN with the h1 mask on the ReLU
            output), masked_attention (att mask), residual_layernorm (the
            y1 / y2 masks; LN2 also writes r2 with save_acts)
  backward  residual_layernorm_bwd (LN2, from the saved r2 or from the
            recomputed FFN), gemm_dx (dy2 . W2^T with the ReLU / h1
            gradient gate read off h1d; da1 . W1^T + the residual), the
            self-attention recomputed from x, residual_layernorm_bwd (LN1),
            gemm_dx, masked_attention_bwd, gemm_dw (dWqkv, dWm, dW1, dW2),
            col_sum (the biases and LayerNorms)

The products are those of the TPU kernels, at their precision: bf16
operands, f32 sums, f32 LayerNorm (the train kernels' reciprocal rounding,
``_ln_fwd``) and softmax. Every weight gradient is summed over all B * Lq
rows by one block per output tile in a fixed order, so a step's gradients
are the same bits on every run.

Attention is per sample. The TPU kernel packs G samples (the JAX Trainer
ships ``encoder_group=16``) into one score matrix with one collapsed
additive mask (``_block_masks``, sa_train.py:141), so at G > 1 a question
that is all PAD scores its neighbours' real tokens as high as its own PAD
tokens and mixes them in. Here a fully padded question is uniform over its
own keys (model.apply's forward); JAX's group has no counterpart.

Dropout masks are external, per sample, drawn once per step and read by
both the forward and the backward (``make_sa_dropout_masks``), or drawn
inside the kernels from a seed (``fused_sa_block_train(..., seed,
rate=...)``: the TPU's ``_fwd_kernel_prng`` :179, ``_bwd_kernel_sav_prng``
:314 and ``_bwd_kernel_prng`` :295, with the SA site codes :49-53), as
ops/sga_train.py describes; ``dump_sa_prng_masks`` writes those masks in
the external layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from mcan_vqa_tpu_torch.models.attention import split_heads
from mcan_vqa_tpu_torch.models.layers import BF16, bf16_matmul, \
    copy_to_model, row_parallel, std_layer_norm
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops.dropout import keep_masks
from mcan_vqa_tpu_torch.ops.sga_train import _attention_plain, \
    _check_train_inputs, _count, _drop, _dump, _kernel_weights, _qkv_heads, \
    _rows, prng_sites

F32 = torch.float32

SA_MASK_NAMES = ("att", "y1", "h1", "y2")
# the Philox site codes (sa_train.py:49-53), disjoint from the SGA block's
SA_SITES = {"att": 0x400, "y1": 0x501, "h1": 0x502, "y2": 0x503}
SA_WEIGHT_NAMES = ("wqkv", "bqkv", "wm", "bm", "ln1_s", "ln1_b",
                   "w1", "b1", "w2", "b2", "ln2_s", "ln2_b")
SA_MATMUL_WEIGHTS = ("wqkv", "wm", "w1", "w2")

Masks = Dict[str, K.Keep]


# ---------------------------------------------------------------------------
# parameters and masks
# ---------------------------------------------------------------------------

def prepare_sa_train_params(p: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """One encoder block's parameters, keyed as in the reference SA block
    (``dict(block.named_parameters())``), -> the train layout of
    sa_train.py:103: wqkv [D, 3D], the merge, the FFN ([in, out]) and the
    LN vectors, f32. Built with differentiable ops, so gradients of the
    layout flow back to the block's parameters."""
    def t(name):
        return p[f"{name}.weight"].t()

    def b(name):
        return p[f"{name}.bias"]

    qkv = ("mhatt.linear_q", "mhatt.linear_k", "mhatt.linear_v")
    return {
        "wqkv": torch.cat([t(n) for n in qkv], dim=1),
        "bqkv": torch.cat([b(n) for n in qkv]),
        "wm": t("mhatt.linear_merge"), "bm": b("mhatt.linear_merge"),
        "ln1_s": p["norm1.a_2"], "ln1_b": p["norm1.b_2"],
        "w1": t("ffn.mlp.fc.linear"), "b1": b("ffn.mlp.fc.linear"),
        "w2": t("ffn.mlp.linear"), "b2": b("ffn.mlp.linear"),
        "ln2_s": p["norm2.a_2"], "ln2_b": p["norm2.b_2"],
    }


def mask_shapes(B: int, Lq: int, D: int, F: int, H: int
                ) -> Dict[str, Tuple[int, ...]]:
    """The per-sample layout of the four masks: the attention map
    [B, H, Lq, Lq], the sublayer outputs [B, Lq, D], the FFN hidden
    [B, Lq, F]."""
    return {"att": (B, H, Lq, Lq), "y1": (B, Lq, D), "h1": (B, Lq, F),
            "y2": (B, Lq, D)}


def make_sa_dropout_masks(generator: Optional[torch.Generator], rate: float,
                          B: int, Lq: int, D: int, F: int, H: int,
                          bit_width: int = 32) -> Tuple[Masks, float]:
    """The four keep-masks of one block for one step (bool, per sample, in
    SA_MASK_NAMES order from ``generator``, on its device, ``bit_width``
    bits per element) and the inverse keep probability. At rate 0 every
    mask is None and nothing is drawn."""
    return keep_masks(generator, rate, mask_shapes(B, Lq, D, F, H),
                      bit_width)


def dump_sa_prng_masks(seed: int, rate: float, B: int, Lq: int, D: int,
                       F: int, H: int, device="cuda"
                       ) -> Tuple[Dict[str, torch.Tensor], float]:
    """The four uint8 keep-masks the seeded SA block draws from ``seed``,
    in ``mask_shapes`` layout, and its inv_keep = 2^32 / t: fed to the
    external-mask block they give the seeded block's bits. One kernel
    launch on the card; the plain version on the CPU."""
    return _dump(K.dump_prng_masks, seed, rate, mask_shapes(B, Lq, D, F, H),
                 SA_SITES, device)


def dump_sa_prng_masks_plain(seed: int, rate: float, B: int, Lq: int,
                             D: int, F: int, H: int, device="cpu"
                             ) -> Tuple[Dict[str, torch.Tensor], float]:
    """``dump_sa_prng_masks`` through ``kernels.philox4x32_plain``."""
    return _dump(K.dump_prng_masks_plain, seed, rate,
                 mask_shapes(B, Lq, D, F, H), SA_SITES, device)


# ---------------------------------------------------------------------------
# the kernel sequence
# ---------------------------------------------------------------------------

def _self_attention(xb, x_mask, m: Masks, w, inv_keep: float, B: int,
                    L: int, H: int):
    """qkv = x . Wqkv + b (bf16), the per-sample masked attention with the
    att mask, y1 = att . Wm (f32, its bias added in the LayerNorm)."""
    D = xb.shape[1]
    qkv = K.gemm_bias_act(xb, w["wqkv"], w["bqkv"], out_dtype=BF16)
    heads = _qkv_heads(qkv, B, L, H)
    att = K.masked_attention(*heads, x_mask, m["att"],
                             inv_keep).view(B * L, D)
    return heads, att, K.gemm_bias_act(att, w["wm"])


def _ffn(x1b, m: Masks, w, inv_keep: float):
    """h1d = drop_h1(relu(x1 . W1 + b1)) in bf16, y2 = h1d . W2 (f32)."""
    F = w["w1"].shape[1]
    h1d = K.gemm_bias_act(x1b, w["w1"], w["b1"], relu=True, out_dtype=BF16,
                          mask=_rows(m["h1"], F), inv_keep=inv_keep)
    return h1d, K.gemm_bias_act(h1d, w["w2"])


def _forward(x, x_mask, m: Masks, w, inv_keep: float, H: int,
             save_acts: bool = True):
    """The block forward of _fwd_kernel -> (x2 f32, the saves): x and x1
    as bf16 matmul operands, and r2 (f32) and h1d with save_acts
    (sa_train.py:165-169), else x1 (f32) for the FFN recompute."""
    B, L, D = x.shape
    M = B * L
    xs = x.reshape(M, D)
    xb = xs.to(BF16)
    _, _, y1 = _self_attention(xb, x_mask, m, w, inv_keep, B, L, H)
    x1, x1b = K.residual_layernorm(xs, y1, w["bm"], w["ln1_s"], w["ln1_b"],
                                   (F32, BF16), mask=_rows(m["y1"], D),
                                   inv_keep=inv_keep, reciprocal=True)
    h1d, y2 = _ffn(x1b, m, w, inv_keep)
    x2, *r2 = K.residual_layernorm(x1, y2, w["b2"], w["ln2_s"], w["ln2_b"],
                                   (F32,), mask=_rows(m["y2"], D),
                                   inv_keep=inv_keep, save_r=save_acts,
                                   reciprocal=True)
    saves = {"xb": xb, "x1b": x1b}
    if save_acts:
        saves.update(r2=r2[0], h1d=h1d)
    else:
        saves["x1"] = x1
    return x2.view(B, L, D), saves


def _backward(g, x, x_mask, saves, m: Masks, w, inv_keep: float, H: int):
    """_bwd_kernel_sav (saves from ``save_acts``) or _bwd_kernel (the FFN
    recomputed from x1): LN2 + FFN, then LN1 + self-attention recomputed
    from x -> (dx, and the 12 weight-gradient pieces in SA_WEIGHT_NAMES
    order)."""
    B, L, D = x.shape
    M = B * L
    xb, x1b = saves["xb"], saves["x1b"]
    # ---- LN2 + FFN, from the saved r2 / h1d or recomputed from x1
    if "r2" in saves:
        h1d, r2, y2, b2 = saves["h1d"], saves["r2"], None, None
    else:
        h1d, y2 = _ffn(x1b, m, w, inv_keep)
        r2, b2 = saves["x1"], w["b2"]
    gr2, gu2, dy2, dy2b = K.residual_layernorm_bwd(
        g, r2, y2, b2, w["ln2_s"], mask=_rows(m["y2"], D), inv_keep=inv_keep,
        dy_dtypes=(F32, BF16))
    # da1 = where(h1d > 0, inv_keep * dy2 . W2^T, 0) (sa_train.py:228; the
    # recompute's where(a1 > 0, drop_h1(.)) is the same gate, :226)
    da1, da1b = K.gemm_dx(dy2b, w["w2"], gate=h1d, inv_keep=inv_keep,
                          out_dtypes=(F32, BF16))
    gx1, = K.gemm_dx(da1b, w["w1"], res=gr2)
    # ---- LN1 + self-attention, recomputed from x
    heads, att, y1 = _self_attention(xb, x_mask, m, w, inv_keep, B, L, H)
    gr1, gu1, dy1, dy1b = K.residual_layernorm_bwd(
        gx1, x.reshape(M, D), y1, w["bm"], w["ln1_s"],
        mask=_rows(m["y1"], D), inv_keep=inv_keep, dy_dtypes=(F32, BF16))
    datt, = K.gemm_dx(dy1b, w["wm"], out_dtypes=(BF16,))
    dqkv = torch.empty((M, 3 * D), dtype=F32, device=x.device)
    dqkv16 = torch.empty((M, 3 * D), dtype=BF16, device=x.device)
    dq, dk, dv = _qkv_heads(dqkv, B, L, H)
    dq16, dk16, dv16 = _qkv_heads(dqkv16, B, L, H)
    K.masked_attention_bwd(*heads, x_mask, datt.view(B, L, D), dq, dk, dv,
                           dq16=dq16, dk16=dk16, dv16=dv16, drop=m["att"],
                           inv_keep=inv_keep)
    dx, = K.gemm_dx(dqkv16, w["wqkv"], res=gr1)
    # ---- weight gradients, each summed over all M rows
    dwqkv = K.gemm_dw(xb, dqkv16)
    dwm = K.gemm_dw(att, dy1b)
    dw1 = K.gemm_dw(x1b, da1b)
    dw2 = K.gemm_dw(h1d, dy2b)
    dbqkv, dbm, dln1_s, dln1_b = K.col_sum([dqkv, dy1, gu1, gx1])
    db1, db2, dln2_s, dln2_b = K.col_sum([da1, dy2, gu2, g])
    return (dx.view(B, L, D), dwqkv, dbqkv, dwm, dbm, dln1_s, dln1_b,
            dw1, db1, dw2, db2, dln2_s, dln2_b)


class SABlockTrain(torch.autograd.Function):
    """The differentiable block: forward saves what ``_forward`` lists;
    backward is the whole block's backward (sa_train.py:546-564).
    Gradients flow to x and all 12 weight pieces."""

    @staticmethod
    def forward(ctx, x, x_mask, inv_keep, num_heads, save_acts, mask_tuple,
                *ws):
        w = _kernel_weights(ws, SA_WEIGHT_NAMES, SA_MATMUL_WEIGHTS)
        m = dict(zip(SA_MASK_NAMES, mask_tuple))
        x = x.detach().float().contiguous()
        x2, saves = _forward(x, x_mask, m, w, inv_keep, num_heads, save_acts)
        _count(x, "sa_train_fwd", m)
        ctx.inputs = (x, x_mask)
        ctx.saves, ctx.masks, ctx.w = saves, m, w
        ctx.inv_keep, ctx.num_heads = inv_keep, num_heads
        return x2

    @staticmethod
    def backward(ctx, g):
        x, x_mask = ctx.inputs
        B, L, D = x.shape
        g = g.reshape(B * L, D).float().contiguous()
        dx, *dw = _backward(g, x, x_mask, ctx.saves, ctx.masks, ctx.w,
                            ctx.inv_keep, ctx.num_heads)
        _count(x, "sa_train_bwd", ctx.masks)
        ctx.inputs = ctx.saves = ctx.masks = ctx.w = None
        return (dx, None, None, None, None, None, *dw)


def _seeded(masks_or_seed, rate: Optional[float], rows: int,
            inv_keep: float) -> Tuple[Masks, float]:
    """The masks as given, or with rate set the seed's Philox sources and
    their inverse keep probability (JAX's masks_or_seed, sa_train.py:
    570-590)."""
    if rate is None:
        return masks_or_seed, inv_keep
    return prng_sites(masks_or_seed, rate, rows, SA_SITES)


def fused_sa_block_train(x: torch.Tensor, x_mask: torch.Tensor,
                         masks_or_seed, w: Mapping[str, torch.Tensor], *,
                         num_heads: int, inv_keep: float = 1.0,
                         save_acts: bool = True,
                         rate: Optional[float] = None) -> torch.Tensor:
    """One encoder block of a train step. x [B, Lq, D] f32 question
    stream; x_mask bool [B, 1, 1, Lq] (True = PAD); masks_or_seed: the
    masks from ``make_sa_dropout_masks`` (None entries: no dropout at that
    site) with their inv_keep, or, with ``rate`` set, a host int seed: the
    in-kernel dropout, every site drawn inside the kernels and regenerated
    by the backward (kept values x 2^32 / t); w from
    ``prepare_sa_train_params``. save_acts: the forward saves r2 and h1d
    so the backward skips the FFN recompute (the JAX default, which the
    Trainer runs). -> x2 [B, Lq, D] f32. On CUDA tensors every step is a
    kernel launch; on CPU tensors the same sequence runs the kernels'
    plain versions."""
    masks, inv_keep = _seeded(masks_or_seed, rate, x.shape[1], inv_keep)
    if K.on_cuda(x):
        _check_train_inputs(x, masks, w, "fused_sa_block_train",
                            SA_MASK_NAMES, SA_MATMUL_WEIGHTS)
    return SABlockTrain.apply(x, x_mask, float(inv_keep), num_heads,
                              bool(save_acts),
                              tuple(masks[n] for n in SA_MASK_NAMES),
                              *(w[n] for n in SA_WEIGHT_NAMES))


# ---------------------------------------------------------------------------
# the plain version: the same function step by step, torch autograd
# ---------------------------------------------------------------------------

def fused_sa_block_train_plain(x: torch.Tensor, x_mask: torch.Tensor,
                               masks_or_seed, w: Mapping[str, torch.Tensor],
                               *, num_heads: int, inv_keep: float = 1.0,
                               save_acts: bool = True,
                               rate: Optional[float] = None,
                               model_group=None) -> torch.Tensor:
    """``fused_sa_block_train`` in plain PyTorch ops, differentiated by
    autograd: the reference block (core/model/mca.py:105-127) with the
    four dropout sites and the TPU kernel's precision at every step; a
    seed (rate set) becomes its masks through ``kernels.philox4x32_plain``.
    save_acts changes only what the kernels' backward recomputes, so it
    does not change this function. model_group: tensor parallelism, as
    ``sga_train.fused_sga_block_train_plain`` takes it (the masks then the
    model rank's att / h1 slices; no seed)."""
    del save_acts
    B, L, D = x.shape
    masks = masks_or_seed
    if rate is not None:
        if model_group is not None:
            raise ValueError("the seeded block takes no model group")
        masks, inv_keep = dump_sa_prng_masks_plain(
            masks_or_seed, rate, B, L, D, w["w1"].shape[1], num_heads,
            x.device)
    H, group = num_heads, model_group
    x = x.float()
    qkv = bf16_matmul(copy_to_model(x, group), w["wqkv"]) + w["bqkv"]
    q, k, v = (split_heads(t, H)
               for t in qkv.split(w["wqkv"].shape[1] // 3, dim=-1))
    att = _attention_plain(q, k, v, x_mask, masks["att"], inv_keep)
    y1 = row_parallel(att, w["wm"], w["bm"], group)
    x1 = std_layer_norm(x + _drop(y1, masks["y1"], inv_keep), w["ln1_s"],
                        w["ln1_b"], reciprocal=True)
    h1d = _drop(torch.relu(bf16_matmul(copy_to_model(x1, group), w["w1"])
                           + w["b1"]), masks["h1"], inv_keep)
    y2 = row_parallel(h1d, w["w2"], w["b2"], group)
    return std_layer_norm(x1 + _drop(y2, masks["y2"], inv_keep), w["ln2_s"],
                          w["ln2_b"], reciprocal=True)
