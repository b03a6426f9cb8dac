"""Whole serving blocks: the SA encoder block and the SGA decoder block
(mcan_vqa_tpu/ops/sga_block.py).

On the TPU each block is one Pallas kernel with every weight resident in
VMEM: ``fused_sa_block`` (``_sa_kernel``, sga_block.py:967/1024) and
``fused_sga_block(fused_proj=True)`` (``_sga_kernel_fusedproj``,
sga_block.py:239/326). One kernel of that size does not fit a Hopper SM's
shared memory, so on the card each block is a short sequence of the
hand-written kernels in ops/kernels.py (gemm_bias_act, masked_attention,
residual_layernorm), with the same precision at every step:

  * the stream arrives bf16 (or f32) and becomes f32 (sga_block.py:258);
  * q/k/v, the probabilities and the attention output are bf16
    (:290-291, :281, :295); the fused qkv and cross-q products are
    rounded to bf16 once, in the matmul epilogue, since they are only
    read as bf16;
  * v1 and v2 stay f32 between the sub-steps (:297, :310) -- the
    LayerNorm kernel writes an f32 copy for the next residual and a bf16
    copy for the next matmul;
  * only the block's output is cast to the stream dtype (:320).

Attention is per sample (the TPU kernels' packing group G is an MXU-tile
device; per-sample attention gives bitwise the same result for every
sample that is not fully padded, and the model.apply result for one that
is).

Each block function dispatches on the stream's device: CPU runs the plain
PyTorch version, CUDA runs the kernels and adds one to the block's launch
count (ops/kernels.py ``LAUNCHES``). While ``torch.export`` traces it,
it runs the kernels' wrappers on either device (they become
``torch.ops.mcan.*`` ops) and counts nothing.

``fused_sga_block(fused_proj=False)`` is the JAX engine's mode 1
(``_sga_kernel``, sga_block.py:153, called at :392): the same block over
the head-major weights ([H, D, Dh] projections, [H, Dh, D] merges), which
the TPU kernel walks head by head, summing the merge over the heads in
f32. Per head is an MXU tiling choice, so the port folds each head-major
entry back to its [D, D] product (a view of the fused layout when the tree
comes from ``prepare_sga_block_params``) and runs the same kernels: only
the f32 summation order differs, and q / k / v and the probabilities are
rounded to bf16 at the same points. No kernel source of its own; its
launches count as ``fused_sga_block_head_major``.

The all-layer stacks -- ``fused_sga_decoder`` (mode 3), ``fused_sga_decoder
_extkv`` (modes 4 and 5) and ``fused_sa_encoder`` (mode 5) -- run every layer
in one cooperative launch (ops/kernels.py ``sga_decoder`` / ``sa_encoder``,
csrc/sga_decoder.cu, csrc/sa_encoder.cu) over the layouts of
``prepare_sga_decoder_params`` / ``prepare_sa_encoder_params``, stacked
along a leading layer axis. The stream stays f32 between their layers. The
packing ``group`` of the JAX signatures is accepted and has no effect:
attention is per sample.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import torch

from mcan_vqa_tpu_torch.models.attention import split_heads
from mcan_vqa_tpu_torch.models.layers import BF16
from mcan_vqa_tpu_torch.ops import kernels

F32 = torch.float32


class _Prims(NamedTuple):
    gemm: Callable
    attention: Callable
    layernorm: Callable


_PLAIN = _Prims(kernels.gemm_bias_act_plain, kernels.masked_attention_plain,
                kernels.residual_layernorm_plain)
_CUDA = _Prims(kernels.gemm_bias_act, kernels.masked_attention,
               kernels.residual_layernorm)


# ---------------------------------------------------------------------------
# weight layouts
# ---------------------------------------------------------------------------

def _kernel(p: Mapping[str, torch.Tensor], name: str) -> torch.Tensor:
    """A reference Linear weight [out, in] -> the JAX kernel layout
    [in, out], bf16."""
    return p[f"{name}.weight"].detach().t().to(BF16).contiguous()


def _vec(p: Mapping[str, torch.Tensor], key: str) -> torch.Tensor:
    return p[key].detach().float().contiguous()


def _fused(p, names):
    return (torch.cat([_kernel(p, n) for n in names], dim=1).contiguous(),
            torch.cat([_vec(p, f"{n}.bias") for n in names]))


def prepare_sa_block_params(p: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """One encoder block's weights, keyed as in the reference SA block
    (``mhatt.linear_q.weight`` ...; e.g. ``SA.state_dict()``), -> the
    fused-projection layout: wqkv [D, 3D] bf16 and the merge, FFN and LN
    entries. Matmul weights bf16 [in, out], biases and LN f32."""
    wqkv, bqkv = _fused(p, ("mhatt.linear_q", "mhatt.linear_k",
                            "mhatt.linear_v"))
    return {
        "wqkv": wqkv, "bqkv": bqkv,
        "wm": _kernel(p, "mhatt.linear_merge"),
        "bm": _vec(p, "mhatt.linear_merge.bias"),
        "ln1_s": _vec(p, "norm1.a_2"), "ln1_b": _vec(p, "norm1.b_2"),
        "w1": _kernel(p, "ffn.mlp.fc.linear"),
        "b1": _vec(p, "ffn.mlp.fc.linear.bias"),
        "w2": _kernel(p, "ffn.mlp.linear"),
        "b2": _vec(p, "ffn.mlp.linear.bias"),
        "ln2_s": _vec(p, "norm2.a_2"), "ln2_b": _vec(p, "norm2.b_2"),
    }


def _head_major(wqkv, bqkv, wm1, wq2, bq2, wm2, num_heads: int
                ) -> Dict[str, torch.Tensor]:
    """JAX's head-major entries (sga_block.py:88-103) as views of the fused
    ones: wq1 / wk1 / wv1 / wq2 [H, D, Dh], their biases [H, Dh], wm1 / wm2
    [H, Dh, D]. Views share their storage: no copy of a weight."""
    D = wm1.shape[0]
    H, Dh = num_heads, D // num_heads

    def cols(w):    # [D, D] -> [H, D, Dh]
        return w.view(D, H, Dh).permute(1, 0, 2)

    out = {f"w{n}1": cols(wqkv[:, i * D:(i + 1) * D])
           for i, n in enumerate("qkv")}
    out.update({f"b{n}1": bqkv[i * D:(i + 1) * D].view(H, Dh)
                for i, n in enumerate("qkv")})
    out.update(wm1=wm1.view(H, Dh, D), wq2=cols(wq2), bq2=bq2.view(H, Dh),
               wm2=wm2.view(H, Dh, D))
    return out


def prepare_sga_block_params(p: Mapping[str, torch.Tensor],
                             num_heads: Optional[int] = None
                             ) -> Dict[str, torch.Tensor]:
    """One decoder block's weights, keyed as in the reference SGA block,
    -> the fused-projection entries of the JAX layout (wqkv1 [D, 3D],
    wm1_full, wq2_full, wm2_full, FFN, LNs) and, given ``num_heads``, beside
    them the head-major entries of mode 1, as JAX keeps both in one dict
    (sga_block.py:55-107; here views of the fused ones). The cross k/v
    projection is not here: it runs outside the block (ops/serving.py
    ``_cross_kv``)."""
    wqkv, bqkv = _fused(p, ("mhatt1.linear_q", "mhatt1.linear_k",
                            "mhatt1.linear_v"))
    out = {
        "wqkv1": wqkv, "bqkv1": bqkv,
        "wm1_full": _kernel(p, "mhatt1.linear_merge"),
        "bm1": _vec(p, "mhatt1.linear_merge.bias"),
        "ln1_s": _vec(p, "norm1.a_2"), "ln1_b": _vec(p, "norm1.b_2"),
        "wq2_full": _kernel(p, "mhatt2.linear_q"),
        "bq2_full": _vec(p, "mhatt2.linear_q.bias"),
        "wm2_full": _kernel(p, "mhatt2.linear_merge"),
        "bm2": _vec(p, "mhatt2.linear_merge.bias"),
        "ln2_s": _vec(p, "norm2.a_2"), "ln2_b": _vec(p, "norm2.b_2"),
        "w1": _kernel(p, "ffn.mlp.fc.linear"),
        "b1": _vec(p, "ffn.mlp.fc.linear.bias"),
        "w2": _kernel(p, "ffn.mlp.linear"),
        "b2": _vec(p, "ffn.mlp.linear.bias"),
        "ln3_s": _vec(p, "norm3.a_2"), "ln3_b": _vec(p, "norm3.b_2"),
    }
    if num_heads:
        out.update(_head_major(wqkv, bqkv, out["wm1_full"], out["wq2_full"],
                               out["bq2_full"], out["wm2_full"], num_heads))
    return out


HEAD_MAJOR = ("wq1", "wk1", "wv1", "bq1", "bk1", "bv1", "wm1", "wq2", "bq2",
              "wm2")


# ---------------------------------------------------------------------------
# the all-layer layouts and their gates (sga_block.py:431-480, :813-845)
# ---------------------------------------------------------------------------

def decoder_vmem_ok(D: int, F: int, num_layers: int) -> bool:
    """JAX's gate of the all-layer decoder (sga_block.py:431): every decoder
    layer's bf16 weights, the cross k/v included, within 64 MB of VMEM
    (MCAN-small 50.3 MB: yes; MCAN-large 201 MB: no). The H100 has no
    VMEM; the port routes as JAX does, because the engines' answers
    differ: past the gate modes 3-5 serve mode 2."""
    return num_layers * (8 * D * D + 2 * D * F) * 2 <= 64 * 1024 * 1024


def encoder_vmem_ok(D: int, F: int, num_layers: int) -> bool:
    """JAX's gate of the all-layer encoder (sga_block.py:813): every encoder
    layer's bf16 weights within 64 MB (MCAN-small 37.7 MB)."""
    return num_layers * (4 * D * D + 2 * D * F) * 2 <= 64 * 1024 * 1024


def _stack(bb, prefix: str, num_layers: int, fn) -> torch.Tensor:
    return torch.stack([fn(bb[f"{prefix}_{i}"]) for i in range(num_layers)])


def prepare_sga_decoder_params(bb: Mapping[str, Any], num_layers: int
                               ) -> Dict[str, torch.Tensor]:
    """Every decoder block's fused-projection layout stacked along a leading
    layer axis (sga_block.py:440), from a serving backbone tree
    (ops/serving.py ``prepare_params``: each block's ``_mk`` and its fused
    cross ``mhatt2.linear_kv``), with the cross k/v [L, D, 2D] that the
    in-kernel variant projects. Keys as JAX's: wm1 / wq2 / bq2 / wm2 are the
    full [D, D] / [D] ones here."""
    def mk(key):
        return _stack(bb, "dec", num_layers, lambda p: p["_mk"][key])

    def kv(key):
        return _stack(bb, "dec", num_layers,
                      lambda p: p["mhatt2"]["linear_kv"][key])

    out = {k: mk(k) for k in ("wqkv1", "bqkv1", "bm1", "ln1_s", "ln1_b",
                              "bm2", "ln2_s", "ln2_b", "w1", "b1", "w2",
                              "b2", "ln3_s", "ln3_b")}
    out.update(wm1=mk("wm1_full"), wq2=mk("wq2_full"), bq2=mk("bq2_full"),
               wm2=mk("wm2_full"), wkv2=kv("kernel"), bkv2=kv("bias"))
    return out


def prepare_sa_encoder_params(bb: Mapping[str, Any], num_layers: int
                              ) -> Dict[str, torch.Tensor]:
    """Every encoder block's ``_mk`` layout stacked along a leading layer
    axis (sga_block.py:820)."""
    return {k: _stack(bb, "enc", num_layers, lambda p, k=k: p["_mk"][k])
            for k in kernels.ENCODER_WEIGHTS}


# ---------------------------------------------------------------------------
# the blocks, written once over a set of primitives
# ---------------------------------------------------------------------------

def _qkv_heads(qkv: torch.Tensor, B: int, L: int, num_heads: int):
    """Fused [B*L, 3D] -> three [B, H, L, Dh] strided views (no copy)."""
    D = qkv.shape[1] // 3
    q, k, v = qkv.view(B, L, 3 * D).split(D, dim=-1)
    return (split_heads(q, num_heads), split_heads(k, num_heads),
            split_heads(v, num_heads))


def _ffn_ln(ops: _Prims, x32, xb, wp, ln_s, ln_b, out_dtype):
    h = ops.gemm(xb, wp["w1"], wp["b1"], relu=True, out_dtype=BF16)
    y = ops.gemm(h, wp["w2"], wp["b2"])
    return ops.layernorm(x32, y, None, wp[ln_s], wp[ln_b],
                         out_dtypes=(out_dtype,))[0]


def _sa_block(ops: _Prims, x, x_mask, wp, num_heads: int):
    B, L, D = x.shape
    xs = x.reshape(B * L, D)
    qkv = ops.gemm(xs.to(BF16), wp["wqkv"], wp["bqkv"], out_dtype=BF16)
    att = ops.attention(*_qkv_heads(qkv, B, L, num_heads), x_mask)
    y = ops.gemm(att.view(B * L, D), wp["wm"])
    x1, x1b = ops.layernorm(xs, y, wp["bm"], wp["ln1_s"], wp["ln1_b"],
                            out_dtypes=(F32, BF16))
    out = _ffn_ln(ops, x1, x1b, wp, "ln2_s", "ln2_b", x.dtype)
    return out.view(B, L, D)


def _fold_cols(w: torch.Tensor) -> torch.Tensor:
    """A head-major projection [H, D, Dh] -> its [D, H*Dh] product (a view
    where it was one, sga_block.py's ``head_cols`` undone)."""
    return w.permute(1, 0, 2).reshape(w.shape[1], -1)


def _sga_block(ops: _Prims, v, kq, vq, v_mask, q_mask, wp, num_heads: int,
               head_major: bool = False):
    B, L, D = v.shape
    vs = v.reshape(B * L, D)
    xb = vs.to(BF16)
    # self-attention over the regions + merge + LN1
    if head_major:
        heads = [split_heads(ops.gemm(xb, _fold_cols(wp[f"w{n}1"]),
                                      wp[f"b{n}1"].reshape(-1),
                                      out_dtype=BF16).view(B, L, D), num_heads)
                 for n in "qkv"]
        wm1, wq2, bq2, wm2 = (wp["wm1"].reshape(D, D), _fold_cols(wp["wq2"]),
                              wp["bq2"].reshape(-1), wp["wm2"].reshape(D, D))
    else:
        qkv = ops.gemm(xb, wp["wqkv1"], wp["bqkv1"], out_dtype=BF16)
        heads = _qkv_heads(qkv, B, L, num_heads)
        wm1, wq2, bq2, wm2 = (wp["wm1_full"], wp["wq2_full"], wp["bq2_full"],
                              wp["wm2_full"])
    att = ops.attention(*heads, v_mask)
    y = ops.gemm(att.view(B * L, D), wm1)
    v1, v1b = ops.layernorm(vs, y, wp["bm1"], wp["ln1_s"], wp["ln1_b"],
                            out_dtypes=(F32, BF16))
    # cross-attention against the pre-projected question k/v + LN2
    qx = ops.gemm(v1b, wq2, bq2, out_dtype=BF16)
    att = ops.attention(split_heads(qx.view(B, L, D), num_heads), kq, vq,
                        q_mask)
    y = ops.gemm(att.view(B * L, D), wm2)
    v2, v2b = ops.layernorm(v1, y, wp["bm2"], wp["ln2_s"], wp["ln2_b"],
                            out_dtypes=(F32, BF16))
    # FFN + LN3
    out = _ffn_ln(ops, v2, v2b, wp, "ln3_s", "ln3_b", v.dtype)
    return out.view(B, L, D)


def fused_sa_block_plain(x, x_mask, wp, *, num_heads: int):
    return _sa_block(_PLAIN, x, x_mask, wp, num_heads)


def fused_sga_block_plain(v, kq, vq, v_mask, q_mask, wp, *, num_heads: int,
                          fused_proj: bool = True):
    return _sga_block(_PLAIN, v, kq, vq, v_mask, q_mask, wp, num_heads,
                      head_major=not fused_proj)


def _check_stream(name: str, x: torch.Tensor) -> None:
    if x.dtype not in (BF16, F32) or not x.is_contiguous():
        raise ValueError(f"{name}: the stream must be a contiguous bf16 or "
                         f"f32 tensor, got {x.dtype}")


def fused_sa_block(x: torch.Tensor, x_mask: torch.Tensor,
                   wp: Mapping[str, torch.Tensor], *,
                   num_heads: int) -> torch.Tensor:
    """One whole SA encoder block. x [B, L, D] (bf16 or f32 stream),
    x_mask bool [B, 1, 1, L] (True = PAD), wp from prepare_sa_block_params.
    Returns [B, L, D] in x's dtype."""
    if not kernels.kernel_route(x):
        return fused_sa_block_plain(x, x_mask, wp, num_heads=num_heads)
    _check_stream("fused_sa_block", x)
    out = _sa_block(_CUDA, x, x_mask, wp, num_heads)
    kernels.count_block("fused_sa_block")
    return out


def fused_sga_block(v: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor,
                    v_mask: torch.Tensor, q_mask: torch.Tensor,
                    wp: Mapping[str, torch.Tensor], *, num_heads: int,
                    group: int = 2, fused_proj: bool = True) -> torch.Tensor:
    """One whole SGA decoder block. v [B, Lv, D] (bf16 or f32 stream);
    kq/vq [B, H, Lq, Dh] pre-projected cross keys/values (f32 or bf16);
    v_mask/q_mask bool [B, 1, 1, L]; wp from prepare_sga_block_params.
    Returns [B, Lv, D] in v's dtype. fused_proj: True (the default here,
    the port's per-block engine) reads the fused entries, mode 2; False the
    head-major ones, mode 1 (JAX's default). group: the TPU kernels'
    packing group, accepted and without effect."""
    if not kernels.kernel_route(v):
        return fused_sga_block_plain(v, kq, vq, v_mask, q_mask, wp,
                                     num_heads=num_heads,
                                     fused_proj=fused_proj)
    _check_stream("fused_sga_block", v)
    out = _sga_block(_CUDA, v, kq, vq, v_mask, q_mask, wp, num_heads,
                     head_major=not fused_proj)
    kernels.count_block("fused_sga_block" if fused_proj
                        else "fused_sga_block_head_major")
    return out


# ---------------------------------------------------------------------------
# the all-layer stacks (one cooperative launch each on the card)
# ---------------------------------------------------------------------------

def fused_sga_decoder(v: torch.Tensor, q: torch.Tensor, v_mask: torch.Tensor,
                      q_mask: torch.Tensor, wp: Mapping[str, torch.Tensor],
                      *, num_heads: int, group: int = 4) -> torch.Tensor:
    """The whole decoder (sga_block.py:579, mode 3): v [B, Lv, D] image
    stream; q [B, Lq, D] the final encoder output, every layer's cross k/v
    projected from it inside; wp from prepare_sga_decoder_params. Returns
    [B, Lv, D] in v's dtype."""
    return kernels.sga_decoder(v, v_mask, q_mask, wp, num_heads=num_heads,
                               q=q)


def fused_sga_decoder_extkv(v: torch.Tensor, kq: torch.Tensor,
                            vq: torch.Tensor, v_mask: torch.Tensor,
                            q_mask: torch.Tensor,
                            wp: Mapping[str, torch.Tensor], *, num_heads: int,
                            group: int = 4) -> torch.Tensor:
    """The whole decoder with external cross k/v (sga_block.py:743, modes 4
    and 5): kq / vq [B, L*H, Lq, Dh], layer-major (layer l, head h at index
    l*H + h), f32 or bf16; wp from prepare_sga_decoder_params (wkv2 / bkv2
    unread). Returns [B, Lv, D] in v's dtype."""
    return kernels.sga_decoder(v, v_mask, q_mask, wp, num_heads=num_heads,
                               kq=kq, vq=vq)


def fused_sa_encoder(x: torch.Tensor, x_mask: torch.Tensor,
                     wp: Mapping[str, torch.Tensor], *, num_heads: int,
                     group: int = 0) -> torch.Tensor:
    """The whole SA encoder (sga_block.py:916, mode 5): x [B, Lq, D]; wp
    from prepare_sa_encoder_params. Returns [B, Lq, D] in x's dtype."""
    return kernels.sa_encoder(x, x_mask, wp, num_heads=num_heads)
