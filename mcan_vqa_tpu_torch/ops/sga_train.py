"""The SGA decoder block for training: forward with its six dropout sites,
and its backward (mcan_vqa_tpu/ops/sga_train.py).

On the TPU one train step runs three Pallas kernels per decoder block
(sga_train.py): ``_fwd_kernel`` (:415, called at :977), the FFN backward
from saved activations ``_bwd_ffn_kernel_sav`` (:576, :1081) -- or, with
``save_acts=False``, ``_bwd_ffn_kernel`` (:561, :1024), which recomputes
h1 and y3 from v2 -- and the attention backward, ``_bwd_att_kernel``
(:631, :1139) or, under ``att_saves`` (the JAX Trainer at hidden > 512),
``_bwd_att_kernel_sav`` (:1183, :1272). On the card each is a short
sequence of the hand-written kernels of ops/kernels.py:

  forward       gemm_bias_act (qkv, merges, cross q, FFN with the h1 mask on
                the ReLU output), masked_attention (with the att1 / att2
                masks), residual_layernorm (with the y1 / y2 / y3 masks; LN3
                also writes r3)
  FFN backward  residual_layernorm_bwd (LN3 from the saved r3), gemm_dx
                (dy3 . W2^T with the ReLU / h1 gradient gate; da1 . W1^T +
                the residual), gemm_dw (dW1, dW2), col_sum (b1, b2, LN3)
  FFN backward  save_acts=False: h1d and y3 recomputed from the saved v2
    (recompute) by the forward's two gemm_bias_act calls (the h1 mask, or
                its Philox source drawn again), r3 = v2 + drop(y3 + b2)
                formed inside residual_layernorm_bwd, then the same
                gemm_dx, gemm_dw and col_sum
  att backward  the forward's cross and self attention recomputed from the
                saved v1 and x, residual_layernorm_bwd (LN2, LN1), gemm_dx,
                masked_attention_bwd (cross, self), gemm_dw, col_sum
  att backward  under att_saves: the same without the four projection
    (saves)     recomputes (qkv, both merges, the cross q): the saved qkv /
                qx feed the attention recompute (P.V, for the merges' dW)
                and its backward, the saved r1 / r2 the LN backwards

The products are those of the TPU kernels, at their precision: bf16
operands, f32 sums, f32 LayerNorm and softmax. Every weight gradient is
summed over all B * Lv rows by one block per output tile in a fixed order,
so a step's gradients are the same bits on every run.

Attention is per sample. The TPU kernel packs G samples into one score
matrix with one collapsed additive mask (sga_train.py:256-263), so at G > 1
a sample whose question is all PAD spreads its cross-attention over its
neighbours' question keys. Here a fully padded sample is uniform over its
own keys (model.apply's forward); its score gradient is the softmax's,
dS = P * (dP - rowsum(P * dP)), which is what the TPU kernel's additive
mask gives at G = 1.

Dropout, two routes through the same kernels:

  * external masks, per sample, drawn once per step and read by both the
    forward and the backward (``make_dropout_masks``; the TPU's
    ``_fwd_kernel`` and its backward kernels), kept values x 1 / (1 -
    rate);
  * in-kernel (``fused_sga_block_train_prng``; the TPU's
    ``_fwd_kernel_prng`` :507, ``_bwd_ffn_kernel_sav_prng`` :617,
    ``_bwd_ffn_kernel_prng`` :568, ``_bwd_att_kernel_prng`` :812 and
    ``_bwd_att_kernel_sav_prng``
    :1202): one seed per block and step, a ``kernels.Philox`` keep source
    per site (JAX's site codes, :154-159) that every kernel reading the
    site draws from in place -- the backward regenerates the forward's
    bits and no mask byte exists. Kept values x 2^32 / t
    (``prng_keep_params``). ``dump_prng_masks`` writes those masks in the
    external layout (``_mask_dump_kernel`` :1530), so the external route
    fed them gives the same bits, which is how the in-kernel route is
    tested.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from mcan_vqa_tpu_torch.models.attention import NEG_INF, split_heads
from mcan_vqa_tpu_torch.models.layers import BF16, bf16_matmul, \
    copy_to_model, operand, row_parallel, std_layer_norm
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops.dropout import keep_masks

F32 = torch.float32

MASK_NAMES = ("att1", "att2", "y1", "y2", "h1", "y3")
# the Philox site codes of the six sites (sga_train.py:154-159): the
# attention maps add the head index
SITES = {"att1": 0x100, "att2": 0x200, "y1": 0x301, "y2": 0x302,
         "h1": 0x303, "y3": 0x304}
WEIGHT_NAMES = ("wqkv", "bqkv", "wm1", "bm1", "ln1_s", "ln1_b",
                "wq2", "bq2", "wm2", "bm2", "ln2_s", "ln2_b",
                "w1", "b1", "w2", "b2", "ln3_s", "ln3_b")
MATMUL_WEIGHTS = ("wqkv", "wm1", "wq2", "wm2", "w1", "w2")

Masks = Dict[str, K.Keep]


# ---------------------------------------------------------------------------
# parameters and masks
# ---------------------------------------------------------------------------

def prepare_sga_train_params(p: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """One decoder block's parameters, keyed as in the reference SGA block
    (``dict(block.named_parameters())``), -> the train layout of
    sga_train.py:65: wqkv [D, 3D], the merges, the cross q, the FFN
    ([in, out]) and the LN vectors, f32. Built with differentiable ops, so
    gradients of the layout flow back to the block's parameters. The cross
    k / v projection is not here: it runs outside the block."""
    def t(name):
        return p[f"{name}.weight"].t()

    def b(name):
        return p[f"{name}.bias"]

    qkv = ("mhatt1.linear_q", "mhatt1.linear_k", "mhatt1.linear_v")
    return {
        "wqkv": torch.cat([t(n) for n in qkv], dim=1),
        "bqkv": torch.cat([b(n) for n in qkv]),
        "wm1": t("mhatt1.linear_merge"), "bm1": b("mhatt1.linear_merge"),
        "ln1_s": p["norm1.a_2"], "ln1_b": p["norm1.b_2"],
        "wq2": t("mhatt2.linear_q"), "bq2": b("mhatt2.linear_q"),
        "wm2": t("mhatt2.linear_merge"), "bm2": b("mhatt2.linear_merge"),
        "ln2_s": p["norm2.a_2"], "ln2_b": p["norm2.b_2"],
        "w1": t("ffn.mlp.fc.linear"), "b1": b("ffn.mlp.fc.linear"),
        "w2": t("ffn.mlp.linear"), "b2": b("ffn.mlp.linear"),
        "ln3_s": p["norm3.a_2"], "ln3_b": p["norm3.b_2"],
    }


def mask_shapes(B: int, Lv: int, Lq: int, D: int, F: int, H: int
                ) -> Dict[str, Tuple[int, ...]]:
    """The per-sample layout of the six masks: attention maps [B, H, Lq',
    Lk], sublayer outputs [B, Lv, D], the FFN hidden [B, Lv, F]."""
    return {"att1": (B, H, Lv, Lv), "att2": (B, H, Lv, Lq),
            "y1": (B, Lv, D), "y2": (B, Lv, D), "h1": (B, Lv, F),
            "y3": (B, Lv, D)}


def make_dropout_masks(generator: Optional[torch.Generator], rate: float,
                       B: int, Lv: int, Lq: int, D: int, F: int, H: int,
                       bit_width: int = 32) -> Tuple[Masks, float]:
    """The six keep-masks of one block for one step (bool, per sample, in
    MASK_NAMES order from ``generator``, on its device, ``bit_width`` bits
    drawn per element) and the inverse keep probability. At rate 0 every
    mask is None and nothing is drawn (sga_train.py:875)."""
    return keep_masks(generator, rate, mask_shapes(B, Lv, Lq, D, F, H),
                      bit_width)


def prng_keep_params(rate: float) -> Tuple[int, float]:
    """(t, inv_keep) of the in-kernel keep decision (sga_train.py:1451):
    keep iff a uint32 word < t = round((1 - rate) 2^32) clamped to
    [1, 2^32 - 1]; kept values scale by the exact 2^32 / t."""
    q = 1 << 32
    t = max(1, min(q - 1, int(round((1.0 - rate) * q))))
    return t, float(q) / t


def prng_sites(seed: int, rate: float, rows: int,
               codes: Mapping[str, int] = SITES) -> Tuple[Masks, float]:
    """The seeded keep source of every site of one block (``rows``: the
    sequence length of its rows operands) and the inverse keep
    probability."""
    t, inv_keep = prng_keep_params(rate)
    return {name: K.Philox(int(seed), code, t,
                           0 if name.startswith("att") else rows)
            for name, code in codes.items()}, inv_keep


def mask_sites(shapes: Mapping[str, Tuple[int, ...]],
               codes: Mapping[str, int]) -> List[Tuple[int, int, int]]:
    """The (site code, heads, n) of each mask of a ``mask_shapes`` layout,
    as ``kernels.dump_prng_masks`` takes them: an attention map's heads
    keyed apart, every other mask one row of a sample."""
    sites = []
    for name, shape in shapes.items():
        heads = shape[1] if name.startswith("att") else 1
        sites.append((codes[name], heads,
                      int(torch.Size(shape[1:]).numel()) // heads))
    return sites


def _dump(dump, seed, rate, shapes, codes, device):
    """Every site's mask as ``dump`` draws it, in the ``shapes`` layout."""
    t, inv_keep = prng_keep_params(rate)
    B = next(iter(shapes.values()))[0]
    outs = dump(int(seed), t, B, mask_sites(shapes, codes), device)
    return {name: o.reshape(shape) for (name, shape), o in
            zip(shapes.items(), outs)}, inv_keep


def dump_prng_masks(seed: int, rate: float, B: int, Lv: int, Lq: int,
                    D: int, F: int, H: int, device="cuda"
                    ) -> Tuple[Dict[str, torch.Tensor], float]:
    """The six uint8 keep-masks that ``fused_sga_block_train_prng`` draws
    from ``seed``, in ``mask_shapes`` layout, and its inv_keep = 2^32 / t:
    fed to ``fused_sga_block_train`` they give the seeded block's bits
    (sga_train.py:1581). One kernel launch on the card; the plain version
    on the CPU."""
    return _dump(K.dump_prng_masks, seed, rate,
                 mask_shapes(B, Lv, Lq, D, F, H), SITES, device)


def dump_prng_masks_plain(seed: int, rate: float, B: int, Lv: int, Lq: int,
                          D: int, F: int, H: int, device="cpu"
                          ) -> Tuple[Dict[str, torch.Tensor], float]:
    """``dump_prng_masks`` through ``kernels.philox4x32_plain`` on any
    device."""
    return _dump(K.dump_prng_masks_plain, seed, rate,
                 mask_shapes(B, Lv, Lq, D, F, H), SITES, device)


# ---------------------------------------------------------------------------
# the kernel sequence
# ---------------------------------------------------------------------------

def _qkv_heads(qkv: torch.Tensor, B: int, L: int, H: int):
    """Fused [B*L, 3D] -> three [B, H, L, Dh] strided views (no copy)."""
    D = qkv.shape[1] // 3
    return tuple(split_heads(t, H)
                 for t in qkv.view(B, L, 3 * D).split(D, dim=-1))


def _rows(m: K.Keep, cols: int) -> K.Keep:
    """A sublayer's keep-mask as [rows, cols] (a Philox source as it
    is)."""
    return m if m is None or isinstance(m, K.Philox) else \
        m.reshape(-1, cols)


def _forward(x, kq, vq, v_mask, q_mask, m: Masks, w, inv_keep: float,
             H: int, att_saves: bool = False, save_dtype=F32,
             save_acts: bool = True):
    """The block forward of _fwd_kernel -> (v3 f32, the saves). Saved for
    the backward: x and v1 / v2 as bf16 matmul operands, r3 and h1d (the
    JAX ``save_acts=True``) or else v2 as the LN3 residual of the FFN
    recompute (the bf16 v2 itself under bf16_saves), v1 as the LN2
    residual of the attention recompute, or, with att_saves, qkv, qx, r1
    and r2 instead (sga_train.py:959-976). The saved r's (and v1, v2) are
    save_dtype: bf16 under the JAX bf16_saves."""
    B, Lv, D = x.shape
    M = B * Lv
    xs = x.reshape(M, D)
    xb = xs.to(BF16)
    r_kw = dict(inv_keep=inv_keep, reciprocal=True, r_dtype=save_dtype)
    # self-attention over the regions + merge + dropout + LN1
    qkv = K.gemm_bias_act(xb, w["wqkv"], w["bqkv"], out_dtype=BF16)
    att1 = K.masked_attention(*_qkv_heads(qkv, B, Lv, H), v_mask,
                              m["att1"], inv_keep).view(M, D)
    y1 = K.gemm_bias_act(att1, w["wm1"])
    v1, v1b, *r1 = K.residual_layernorm(
        xs, y1, w["bm1"], w["ln1_s"], w["ln1_b"], (F32, BF16),
        mask=_rows(m["y1"], D), save_r=att_saves, **r_kw)
    # cross-attention against the pre-projected question k / v + LN2
    qx = K.gemm_bias_act(v1b, w["wq2"], w["bq2"], out_dtype=BF16)
    att2 = K.masked_attention(split_heads(qx.view(B, Lv, D), H), kq, vq,
                              q_mask, m["att2"], inv_keep).view(M, D)
    y2 = K.gemm_bias_act(att2, w["wm2"])
    v2, v2b, *r2 = K.residual_layernorm(
        v1, y2, w["bm2"], w["ln2_s"], w["ln2_b"], (F32, BF16),
        mask=_rows(m["y2"], D), save_r=att_saves, **r_kw)
    # FFN: ReLU, then the h1 mask, written bf16; with save_acts h1d and
    # LN3's r3 are saved
    h1d, y3 = _ffn(v2b, m, w, inv_keep)
    v3, *r3 = K.residual_layernorm(v2, y3, w["b2"], w["ln3_s"], w["ln3_b"],
                                   (F32,), mask=_rows(m["y3"], D),
                                   save_r=save_acts, **r_kw)
    saves = {"xb": xb, "v1b": v1b, "v2b": v2b}
    if save_acts:
        saves.update(r3=r3[0], h1d=h1d)
    elif save_dtype == F32:
        saves["v2"] = v2
    if att_saves:
        saves.update(qkv=qkv, qx=qx, r1=r1[0], r2=r2[0])
    else:
        saves["v1"] = v1 if save_dtype == F32 else v1b
    return v3.view(B, Lv, D), saves


def _ffn(v2b, m: Masks, w, inv_keep: float):
    """h1d = drop_h1(relu(v2 . W1 + b1)) in bf16, y3 = h1d . W2 (f32, its
    bias added in the LayerNorm)."""
    F = w["w1"].shape[1]
    h1d = K.gemm_bias_act(v2b, w["w1"], w["b1"], relu=True, out_dtype=BF16,
                          mask=_rows(m["h1"], F), inv_keep=inv_keep)
    return h1d, K.gemm_bias_act(h1d, w["w2"])


def _bwd_ffn(g, saves, m: Masks, w, inv_keep: float, save_dtype=F32):
    """LN3 + FFN + the y3 dropout -> (gv2 in save_dtype, dw1, db1, dw2,
    db2, dln3_s, dln3_b): _bwd_ffn_kernel_sav from the saved r3, h1d and
    v2 (``save_acts``), else _bwd_ffn_kernel, h1d and y3 recomputed from
    the saved v2 by the forward's own calls (sga_train.py:533-558)."""
    v2b = saves["v2b"]
    if "r3" in saves:
        h1d, r3, y3, b2 = saves["h1d"], saves["r3"], None, None
    else:
        # JAX rounds the saved v2 to bf16 for the products: the bits of v2b
        r3, b2 = saves.get("v2", v2b), w["b2"]
        h1d, y3 = _ffn(v2b, m, w, inv_keep)
    D = r3.shape[1]
    gr3, gu3, dy3, dy3b = K.residual_layernorm_bwd(
        g, r3, y3, b2, w["ln3_s"], mask=_rows(m["y3"], D),
        inv_keep=inv_keep, dy_dtypes=(F32, BF16))
    # dh1d = dy3 . W2^T through ReLU and the h1 mask, read off h1d
    # (sga_train.py:599: where(h1d > 0, inv_keep * dh1d, 0); the
    # recompute's where(a1 > 0, drop_h1(dh1d)) is the same gate, :551)
    da1, da1b = K.gemm_dx(dy3b, w["w2"], gate=h1d, inv_keep=inv_keep,
                          out_dtypes=(F32, BF16))
    gv2, = K.gemm_dx(da1b, w["w1"], res=gr3, out_dtypes=(save_dtype,))
    dw1 = K.gemm_dw(v2b, da1b)
    dw2 = K.gemm_dw(h1d, dy3b)
    db1, db2, dln3_s, dln3_b = K.col_sum([da1, dy3, gu3, g])
    return gv2, dw1, db1, dw2, db2, dln3_s, dln3_b


def _cross_att_bwd(gv2, r2, y2, kq, vq, q_mask, qxh, att2_, m: Masks, w,
                   inv_keep: float, B: int, Lv: int, H: int):
    """LN2 (r2 = r2 + drop(y2 + bm2), or r2 as saved when y2 is None) and
    the cross-attention backward -> (gv1, dkq, dvq, dwq2, dwm2, and the
    four column sums of the cross half)."""
    D = r2.shape[1]
    M = B * Lv
    gr2, gu2, dy2, dy2b = K.residual_layernorm_bwd(
        gv2, r2, y2, None if y2 is None else w["bm2"], w["ln2_s"],
        mask=_rows(m["y2"], D), inv_keep=inv_keep, dy_dtypes=(F32, BF16))
    datt2, = K.gemm_dx(dy2b, w["wm2"], out_dtypes=(BF16,))
    dqx = torch.empty((B, Lv, D), dtype=F32, device=gv2.device)
    dqx16 = torch.empty((B, Lv, D), dtype=BF16, device=gv2.device)
    dkq = torch.empty(kq.shape, dtype=F32, device=gv2.device)
    dvq = torch.empty(vq.shape, dtype=F32, device=gv2.device)
    K.masked_attention_bwd(qxh, kq, vq, q_mask, datt2.view(B, Lv, D),
                           split_heads(dqx, H), dkq, dvq,
                           dq16=split_heads(dqx16, H), drop=m["att2"],
                           inv_keep=inv_keep)
    dqx, dqx16 = dqx.view(M, D), dqx16.view(M, D)
    gv1, = K.gemm_dx(dqx16, w["wq2"], res=gr2)
    dwm2 = K.gemm_dw(att2_, dy2b)
    dbq2, dbm2, dln2_s, dln2_b = K.col_sum([dqx, dy2, gu2, gv2])
    return gv1, dkq, dvq, dqx16, dwm2, dbq2, dbm2, dln2_s, dln2_b


def _self_att_bwd(gv1, r1, y1, heads, att1, v_mask, m: Masks, w,
                  inv_keep: float, B: int, Lv: int, H: int):
    """LN1 (r1 = x + drop(y1 + bm1), or r1 as saved when y1 is None) and
    the self-attention backward -> (dx, dqkv16, dwm1, and the four column
    sums of the self half)."""
    D = r1.shape[1]
    M = B * Lv
    gr1, gu1, dy1, dy1b = K.residual_layernorm_bwd(
        gv1, r1, y1, None if y1 is None else w["bm1"], w["ln1_s"],
        mask=_rows(m["y1"], D), inv_keep=inv_keep, dy_dtypes=(F32, BF16))
    datt1, = K.gemm_dx(dy1b, w["wm1"], out_dtypes=(BF16,))
    dqkv = torch.empty((M, 3 * D), dtype=F32, device=gv1.device)
    dqkv16 = torch.empty((M, 3 * D), dtype=BF16, device=gv1.device)
    dq, dk, dv = _qkv_heads(dqkv, B, Lv, H)
    dq16, dk16, dv16 = _qkv_heads(dqkv16, B, Lv, H)
    K.masked_attention_bwd(*heads, v_mask, datt1.view(B, Lv, D), dq, dk, dv,
                           dq16=dq16, dk16=dk16, dv16=dv16, drop=m["att1"],
                           inv_keep=inv_keep)
    dx, = K.gemm_dx(dqkv16, w["wqkv"], res=gr1)
    dwm1 = K.gemm_dw(att1, dy1b)
    dbqkv, dbm1, dln1_s, dln1_b = K.col_sum([dqkv, dy1, gu1, gv1])
    return dx, dqkv16, dwm1, dbqkv, dbm1, dln1_s, dln1_b


def _bwd_att(gv2, x, kq, vq, v_mask, q_mask, saves, m: Masks, w,
             inv_keep: float, H: int):
    """_bwd_att_kernel: LN2 + cross-attention + LN1 + self-attention and
    their dropouts, recomputing both attentions and the four projections
    (qkv, both merges, the cross q) from the saved x and v1 -> (dx, dkq,
    dvq, and the 12 weight-gradient pieces)."""
    B, Lv, D = x.shape
    M = B * Lv
    xb, v1b, v1 = saves["xb"], saves["v1b"], saves["v1"]
    # ---- cross-attention: recompute from v1, then back through it
    qx = K.gemm_bias_act(v1b, w["wq2"], w["bq2"], out_dtype=BF16)
    qxh = split_heads(qx.view(B, Lv, D), H)
    att2 = K.masked_attention(qxh, kq, vq, q_mask, m["att2"],
                              inv_keep).view(M, D)
    y2 = K.gemm_bias_act(att2, w["wm2"])
    gv1, dkq, dvq, dqx16, dwm2, *sums2 = _cross_att_bwd(
        gv2, v1, y2, kq, vq, q_mask, qxh, att2, m, w, inv_keep, B, Lv, H)
    # ---- self-attention: recompute from x, then back through it
    qkv = K.gemm_bias_act(xb, w["wqkv"], w["bqkv"], out_dtype=BF16)
    heads = _qkv_heads(qkv, B, Lv, H)
    att1 = K.masked_attention(*heads, v_mask, m["att1"], inv_keep).view(M, D)
    y1 = K.gemm_bias_act(att1, w["wm1"])
    dx, dqkv16, dwm1, *sums1 = _self_att_bwd(
        gv1, x.reshape(M, D), y1, heads, att1, v_mask, m, w, inv_keep, B,
        Lv, H)
    return _att_grads(dx, dkq, dvq, xb, dqkv16, dwm1, sums1, v1b, dqx16,
                      dwm2, sums2, B, Lv, D)


def _bwd_att_sav(gv2, x, kq, vq, v_mask, q_mask, saves, m: Masks, w,
                 inv_keep: float, H: int):
    """_bwd_att_kernel_sav (sga_train.py:1183): the attention backward from
    the saved qkv, qx, r1 and r2 -- no projection recompute and no bias
    read; the two attentions' P.V are still recomputed (the dW of both
    merges needs them) -> what ``_bwd_att`` returns."""
    B, Lv, D = x.shape
    M = B * Lv
    qxh = split_heads(saves["qx"].view(B, Lv, D), H)
    att2 = K.masked_attention(qxh, kq, vq, q_mask, m["att2"],
                              inv_keep).view(M, D)
    gv1, dkq, dvq, dqx16, dwm2, *sums2 = _cross_att_bwd(
        gv2, saves["r2"], None, kq, vq, q_mask, qxh, att2, m, w, inv_keep,
        B, Lv, H)
    heads = _qkv_heads(saves["qkv"], B, Lv, H)
    att1 = K.masked_attention(*heads, v_mask, m["att1"], inv_keep).view(M, D)
    dx, dqkv16, dwm1, *sums1 = _self_att_bwd(
        gv1, saves["r1"], None, heads, att1, v_mask, m, w, inv_keep, B, Lv,
        H)
    return _att_grads(dx, dkq, dvq, saves["xb"], dqkv16, dwm1, sums1,
                      saves["v1b"], dqx16, dwm2, sums2, B, Lv, D)


def _att_grads(dx, dkq, dvq, xb, dqkv16, dwm1, sums1, v1b, dqx16, dwm2,
               sums2, B, Lv, D):
    """The two projection weight gradients summed over all rows, and the
    attention backward's outputs in WEIGHT_NAMES order."""
    dwqkv = K.gemm_dw(xb, dqkv16)
    dwq2 = K.gemm_dw(v1b, dqx16)
    dbqkv, dbm1, dln1_s, dln1_b = sums1
    dbq2, dbm2, dln2_s, dln2_b = sums2
    return (dx.view(B, Lv, D), dkq, dvq, dwqkv, dbqkv, dwm1, dbm1, dln1_s,
            dln1_b, dwq2, dbq2, dwm2, dbm2, dln2_s, dln2_b)


def _count(x: torch.Tensor, name: str, m: Masks) -> None:
    """One more run of a TPU kernel's counterpart, counted where its kernel
    sequence was launched on the card; the seeded route (the TPU's _prng
    kernel) under name + "_prng"."""
    if K.on_cuda(x):
        seeded = any(isinstance(t, K.Philox) for t in m.values())
        K.LAUNCHES[name + ("_prng" if seeded else "")] += 1


def _kernel_weights(ws: Sequence[torch.Tensor],
                    names: Sequence[str] = WEIGHT_NAMES,
                    matmuls: Sequence[str] = MATMUL_WEIGHTS
                    ) -> Dict[str, torch.Tensor]:
    """f32 parameters in ``names`` order -> what the kernels read: the
    matmul weights bf16 [in, out] contiguous, vectors f32 contiguous."""
    out = {}
    for name, t in zip(names, ws):
        t = t.detach()
        out[name] = (t.to(BF16) if name in matmuls
                     else t.float()).contiguous()
    return out


class SGABlockTrain(torch.autograd.Function):
    """The differentiable block: forward saves what ``_forward`` lists
    (save_acts, and att_saves when asked); backward is the FFN backward,
    from the saves or recomputed from v2, then the attention backward, from
    the saved projections under att_saves (sga_train.py:1365-1396).
    Gradients flow to x, kq, vq and all 18 weight pieces."""

    @staticmethod
    def forward(ctx, x, kq, vq, v_mask, q_mask, inv_keep, num_heads,
                att_saves, save_dtype, save_acts, mask_tuple, *ws):
        w = _kernel_weights(ws)
        m = dict(zip(MASK_NAMES, mask_tuple))
        x = x.detach().float().contiguous()
        kq, vq = kq.detach(), vq.detach()
        v3, saves = _forward(x, kq, vq, v_mask, q_mask, m, w, inv_keep,
                             num_heads, att_saves, save_dtype, save_acts)
        _count(x, "sga_train_fwd", m)
        ctx.inputs = (x, kq, vq, v_mask, q_mask)
        ctx.saves, ctx.masks, ctx.w = saves, m, w
        ctx.inv_keep, ctx.num_heads = inv_keep, num_heads
        ctx.att_saves, ctx.save_dtype = att_saves, save_dtype
        return v3

    @staticmethod
    def backward(ctx, g):
        x, kq, vq, v_mask, q_mask = ctx.inputs
        B, Lv, D = x.shape
        g = g.reshape(B * Lv, D).float().contiguous()
        gv2, *ffn_dw = _bwd_ffn(g, ctx.saves, ctx.masks, ctx.w, ctx.inv_keep,
                                ctx.save_dtype)
        _count(x, "sga_train_bwd_ffn" if "r3" in ctx.saves
               else "sga_train_bwd_ffn_recompute", ctx.masks)
        bwd_att = _bwd_att_sav if ctx.att_saves else _bwd_att
        dx, dkq, dvq, *att_dw = bwd_att(gv2, x, kq, vq, v_mask, q_mask,
                                        ctx.saves, ctx.masks, ctx.w,
                                        ctx.inv_keep, ctx.num_heads)
        _count(x, "sga_train_bwd_att_sav" if ctx.att_saves
               else "sga_train_bwd_att", ctx.masks)
        dw = att_dw + ffn_dw    # WEIGHT_NAMES order
        ctx.inputs = ctx.saves = ctx.masks = ctx.w = None
        return (dx, dkq, dvq, None, None, None, None, None, None, None,
                None, *dw)


def fused_sga_block_train(x: torch.Tensor, kq: torch.Tensor,
                          vq: torch.Tensor, v_mask: torch.Tensor,
                          q_mask: torch.Tensor, masks: Masks,
                          w: Mapping[str, torch.Tensor], *, num_heads: int,
                          inv_keep: float = 1.0, att_saves: bool = False,
                          bf16_saves: bool = False,
                          save_acts: bool = True) -> torch.Tensor:
    """One decoder block of a train step. x [B, Lv, D] f32 image stream;
    kq / vq [B, H, Lq, Dh] the pre-projected cross keys / values (f32;
    strided views whose last dim is contiguous; Dh = D / H, at most 128 on
    the card); v_mask / q_mask bool [B, 1, 1, L] (True = PAD); masks from
    ``make_dropout_masks`` (None entries: no dropout at that site), or the
    seeded sources of ``prng_sites`` (``fused_sga_block_train_prng``); w from
    ``prepare_sga_train_params``. att_saves: the forward also saves qkv,
    qx, r1 and r2 and the attention backward skips its four projection
    recomputes (the JAX Trainer's choice at hidden > 512). bf16_saves: the
    saved r1 / r2 / r3 (and v1) and the gradient gv2 between the two
    backward halves are bf16, rounded where the JAX kernels round them
    (sga_train.py:959-976, :1032). save_acts: the forward saves r3 and
    h1d so the FFN backward skips its recompute (the JAX default, which
    the Trainer runs); False saves the f32 v2 instead (under bf16_saves
    the bf16 v2, which both keep for the products) and the FFN backward
    recomputes h1d and y3 from it (``_bwd_ffn_kernel``), holding M * 2 F
    fewer bytes per block from the forward to the backward (M * (2 D +
    2 F) under bf16_saves: r3 goes too). att_saves requires save_acts, as in JAX
    (sga_train.py:918). -> v3 [B, Lv, D] f32. On CUDA tensors every step
    is a kernel launch; on CPU tensors the same sequence runs the kernels'
    plain versions."""
    if att_saves and not save_acts:
        raise ValueError("att_saves requires save_acts (output ordering)")
    if K.on_cuda(x):
        _check_train_inputs(x, masks, w)
    return SGABlockTrain.apply(x, kq, vq, v_mask, q_mask, float(inv_keep),
                               num_heads, bool(att_saves),
                               BF16 if bf16_saves else F32, bool(save_acts),
                               tuple(masks[n] for n in MASK_NAMES),
                               *(w[n] for n in WEIGHT_NAMES))


def fused_sga_block_train_prng(x: torch.Tensor, kq: torch.Tensor,
                               vq: torch.Tensor, v_mask: torch.Tensor,
                               q_mask: torch.Tensor, seed: int,
                               w: Mapping[str, torch.Tensor], *,
                               num_heads: int, rate: float = 0.1,
                               att_saves: bool = False,
                               bf16_saves: bool = False,
                               save_acts: bool = True) -> torch.Tensor:
    """``fused_sga_block_train`` with in-kernel dropout
    (sga_train.py:1603-1623): every site draws its keep-mask inside the
    kernels from ``seed`` (a host int, distinct per block and step), the
    backward regenerates the same bits (save_acts=False: the FFN recompute
    draws the h1 and y3 sites again, ``_bwd_ffn_kernel_prng``), and only
    the seed is saved for it. Equal, bit for bit, to
    ``fused_sga_block_train`` fed ``dump_prng_masks(seed, rate, ...)`` with
    its inv_keep."""
    sites, inv_keep = prng_sites(seed, rate, x.shape[1])
    return fused_sga_block_train(x, kq, vq, v_mask, q_mask, sites, w,
                                 num_heads=num_heads, inv_keep=inv_keep,
                                 att_saves=att_saves, bf16_saves=bf16_saves,
                                 save_acts=save_acts)


def _check_train_inputs(x, masks, w, fn: str = "fused_sga_block_train",
                        mask_names: Sequence[str] = MASK_NAMES,
                        matmuls: Sequence[str] = MATMUL_WEIGHTS) -> None:
    if x.dtype != F32 or x.dim() != 3:
        raise ValueError(f"{fn}: the stream must be f32 [B, L, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    for name in matmuls:
        if w[name].dim() != 2:
            raise ValueError(f"{fn}: {name} must be a [in, out] matrix")
    unknown = set(masks) - set(mask_names)
    if unknown:
        raise ValueError(f"{fn}: unknown masks {unknown}")


# ---------------------------------------------------------------------------
# the plain version: the same function step by step, torch autograd
# ---------------------------------------------------------------------------

def _drop(x: torch.Tensor, mask: Optional[torch.Tensor],
          inv_keep: float) -> torch.Tensor:
    return x if mask is None else torch.where(mask.bool(), x * inv_keep,
                                              torch.zeros_like(x))


def _attention_plain(q, k, v, key_pad, drop, inv_keep):
    """Per-sample attention of the train kernels: bf16 operands, f32
    softmax over scores with PAD keys at -1e9 (added, as the TPU kernel
    adds its mask, so the score gradient is the softmax's on every key),
    the dropped probabilities rounded to bf16 for P.V."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = (operand(q) @ operand(k).transpose(-1, -2)) * scale
    p = torch.softmax(s + key_pad.float() * NEG_INF, dim=-1)
    o = operand(_drop(p, drop, inv_keep)) @ operand(v)
    B, H, L, Dh = o.shape
    return o.transpose(1, 2).reshape(B, L, H * Dh)


def fused_sga_block_train_plain(x: torch.Tensor, kq: torch.Tensor,
                                vq: torch.Tensor, v_mask: torch.Tensor,
                                q_mask: torch.Tensor, masks: Masks,
                                w: Mapping[str, torch.Tensor], *,
                                num_heads: int,
                                inv_keep: float = 1.0,
                                model_group=None) -> torch.Tensor:
    """``fused_sga_block_train`` in plain PyTorch ops, differentiated by
    autograd: the reference block (core/model/mca.py:134-164) with the six
    dropout sites and the TPU kernel's precision at every step. What the
    backward saves is autograd's choice, in f32: att_saves gives the
    kernels the same gradients; bf16_saves moves theirs by its roundings of
    r1 / r2 / r3 / gv2 (2^-8 relative each). model_group: tensor
    parallelism, ``w`` this model rank's shards (num_heads its local
    heads, the att / h1 masks its slices): the q / k / v, cross-q and FFN
    up products column-parallel behind f, the merges and the FFN down
    product row-parallel through g (``models/layers.py``)."""
    H, group = num_heads, model_group
    x = x.float()
    qkv = bf16_matmul(copy_to_model(x, group), w["wqkv"]) + w["bqkv"]
    q, k, v = (split_heads(t, H)
               for t in qkv.split(w["wqkv"].shape[1] // 3, dim=-1))
    att1 = _attention_plain(q, k, v, v_mask, masks["att1"], inv_keep)
    y1 = row_parallel(att1, w["wm1"], w["bm1"], group)
    v1 = std_layer_norm(x + _drop(y1, masks["y1"], inv_keep), w["ln1_s"],
                        w["ln1_b"], reciprocal=True)
    qx = bf16_matmul(copy_to_model(v1, group), w["wq2"]) + w["bq2"]
    att2 = _attention_plain(split_heads(qx, H), kq, vq, q_mask,
                            masks["att2"], inv_keep)
    y2 = row_parallel(att2, w["wm2"], w["bm2"], group)
    v2 = std_layer_norm(v1 + _drop(y2, masks["y2"], inv_keep), w["ln2_s"],
                        w["ln2_b"], reciprocal=True)
    h1d = _drop(torch.relu(bf16_matmul(copy_to_model(v2, group), w["w1"])
                           + w["b1"]), masks["h1"], inv_keep)
    y3 = row_parallel(h1d, w["w2"], w["b2"], group)
    return std_layer_norm(v2 + _drop(y3, masks["y3"], inv_keep), w["ln3_s"],
                          w["ln3_b"], reciprocal=True)


def fused_sga_block_train_prng_plain(x: torch.Tensor, kq: torch.Tensor,
                                     vq: torch.Tensor, v_mask: torch.Tensor,
                                     q_mask: torch.Tensor, seed: int,
                                     w: Mapping[str, torch.Tensor], *,
                                     num_heads: int,
                                     rate: float = 0.1) -> torch.Tensor:
    """``fused_sga_block_train_prng`` in plain ops: the masks drawn by
    ``kernels.philox4x32_plain`` (``dump_prng_masks_plain``), then the plain
    block."""
    B, Lv, D = x.shape
    masks, inv_keep = dump_prng_masks_plain(
        seed, rate, B, Lv, kq.shape[2], D, w["w1"].shape[1], num_heads,
        x.device)
    return fused_sga_block_train_plain(x, kq, vq, v_mask, q_mask, masks, w,
                                       num_heads=num_heads,
                                       inv_keep=inv_keep)
