"""The plan of the attention backward (``kernels.attention_bwd_plan``:
which masked_attention_bwd.cu instance, how many query and key rows a
block, the grids, the threads, the shared memory and the stats scratch)
and the launch arguments the wrapper derives from it: pure Python,
seconds, no card and no JAX."""

import pytest
import torch

from mcan_vqa_tpu_torch.ops import _build
from mcan_vqa_tpu_torch.ops import kernels as kern

BF16, F32 = torch.bfloat16, torch.float32
SMEM_LIMIT = 232448          # an H100 block's dynamic shared memory
DHS = (1, 24, 60, 64, 100, 128, 192, 256)
LENGTHS = (1, 14, 15, 16, 17, 60, 64, 65, 127, 128, 129, 160, 608)
# (B, H, Lq, Lk, Dh) of the train steps: MCAN-small (enc self 14 x 14,
# dec self 60 x 60, dec cross 60 x 14) at B = 64, MCAN-large's micro-batch
# of 32 at Dh 128, MIMIC's 86 rows, then the long shapes: hidden 1536 /
# 2048 (Dh 192 / 256) at 160 image rows, grid features (608 rows)
MAIN_PATH = [(64, 8, Lq, Lk, 64) for Lq, Lk in ((14, 14), (60, 60),
                                                (60, 14))]
MAIN_PATH += [(32, 8, Lq, Lk, 128) for Lq, Lk in ((14, 14), (60, 60),
                                                  (60, 14))]
MAIN_PATH += [(2, 8, 86, 86, 32), (3, 2, 128, 128, 128),
              (8, 8, 160, 160, 192), (8, 8, 60, 14, 256),
              (8, 8, 608, 608, 64), (8, 8, 608, 14, 256),
              (1, 8, 160, 14, 192), (64, 2, 130, 60, 128)]


def _grid():
    for Dh in DHS:
        for Lq in LENGTHS:
            for Lk in LENGTHS:
                yield Dh, Lq, Lk


def _held_rows(plan, B, H, Lq):
    """Every (sample-head, query row, dQ column part) phase 1 or the rows
    kernel holds, as the kernels map them. One-block: a block per
    (sample, head), warp w holds rows 16 w .. + 16 when 16 w < Lq. Long:
    block x is (sample, head) x // tiles, row tile x % tiles; warp w holds
    rows 16 (w // col_split) .. + 16 of the tile and column part
    w % col_split."""
    held = []
    for x in range(plan.grid):
        bh, tile = divmod(x, plan.tiles)
        for w in range(plan.threads // 32):
            r0 = tile * plan.rows + 16 * (w // plan.col_split)
            if r0 < Lq:
                held += [(bh, i, w % plan.col_split)
                         for i in range(r0, min(r0 + 16, Lq))]
    return held


def _held_keys(plan, B, H, Lk):
    """Every (sample-head, key row, output, column part) phase 2 or the
    keys kernel holds. One-block: the items (16 keys, dK or dV, 32
    columns) dealt round the block's warps: item it is key tile it //
    (2 P), output (it % 2 P) // P, part it % P, P = dhp / 32. Long: block
    x is (sample, head) x // key_tiles, key tile x % key_tiles; warp w
    holds keys 16 (w // key_split) .. + 16 of the tile, output
    (w % key_split) // (key_split / 2), part w % (key_split / 2)."""
    held = []
    if plan.instance == 0:
        parts = plan.dhp // kern.ATT_BWD_ITEM_COLS
        items = plan.key_rows // 16 * 2 * parts
        for bh in range(plan.grid):
            for w in range(plan.threads // 32):
                for it in range(w, items, plan.threads // 32):
                    kt, rem = divmod(it, 2 * parts)
                    held += [(bh, j, rem // parts, rem % parts)
                             for j in range(16 * kt, min(16 * kt + 16, Lk))]
        return held, 2 * parts
    half = plan.key_split // 2
    for x in range(plan.key_grid):
        bh, tile = divmod(x, plan.key_tiles)
        for w in range(plan.key_threads // 32):
            r0 = tile * plan.key_rows + 16 * (w // plan.key_split)
            if r0 < Lk:
                role = w % plan.key_split
                held += [(bh, j, role // half, role % half)
                         for j in range(r0, min(r0 + 16, Lk))]
    return held, plan.key_split


def _check_cover(plan, B, H, Lq, Lk):
    rows = _held_rows(plan, B, H, Lq)
    assert sorted(rows) == [(bh, i, c) for bh in range(B * H)
                            for i in range(Lq)
                            for c in range(plan.col_split)]
    keys, parts = _held_keys(plan, B, H, Lk)
    assert sorted(keys) == [(bh, j, o, c) for bh in range(B * H)
                            for j in range(Lk) for o in range(2)
                            for c in range(parts // 2)]


@pytest.mark.parametrize("B,H,Lq,Lk,Dh", MAIN_PATH)
def test_plan_covers_every_query_and_key_row_once(B, H, Lq, Lk, Dh):
    plan = kern.attention_bwd_plan(B, H, Lq, Lk, Dh)
    _check_cover(plan, B, H, Lq, Lk)
    if plan.instance == 1:
        # no block is wholly past Lq or Lk
        assert (plan.tiles - 1) * plan.rows < Lq <= plan.tiles * plan.rows
        assert (plan.key_tiles - 1) * plan.key_rows < Lk \
            <= plan.key_tiles * plan.key_rows


@pytest.mark.parametrize("B", [1, 3, 7])
def test_plan_covers_every_row_at_the_fragment_edges(B):
    for Dh, Lq, Lk in _grid():
        _check_cover(kern.attention_bwd_plan(B, 2, Lq, Lk, Dh), B, 2, Lq, Lk)


@pytest.mark.parametrize("Dh", DHS)
def test_plan_fits_the_block_limits(Dh):
    cdiv = lambda a, b: -(-a // b)      # noqa: E731
    for B in (1, 64):
        for Lq in LENGTHS:
            for Lk in LENGTHS:
                p = kern.attention_bwd_plan(B, 8, Lq, Lk, Dh)
                for threads, smem in ((p.threads, p.smem),
                                      (p.key_threads, p.key_smem)):
                    if p.instance == 0 and threads == 0:
                        assert smem == 0 and p.key_grid == 0
                        continue
                    assert 0 < smem <= SMEM_LIMIT
                    assert threads % 32 == 0 and \
                        32 <= threads <= 32 * kern.ATT_MAX_WARPS
                ld = (p.dhp + 8) * 2
                if p.instance == 0:
                    lqp, lkp = 16 * cdiv(Lq, 16), 16 * cdiv(Lk, 16)
                    assert (p.rows, p.key_rows) == (lqp, lkp)
                    # Q, dO, K, V rows, then the dS and Pd tiles
                    assert p.smem == 2 * (lqp + lkp) * ld \
                        + 2 * lqp * (lkp + 8) * 2
                    assert p.threads >= 2 * lqp       # a warp per 16 rows
                else:
                    def streamed(L):
                        return 16 * cdiv(L, 16) if L <= 64 else 128
                    assert p.threads == p.rows // 16 * p.col_split * 32
                    assert p.key_threads == \
                        p.key_rows // 16 * p.key_split * 32
                    assert p.smem == (2 * p.rows + 2 * streamed(Lk)) * ld
                    assert p.key_smem == (2 * p.key_rows
                                          + 2 * streamed(Lq)) * ld \
                        + 16 * streamed(Lq)


@pytest.mark.parametrize("Dh", DHS)
def test_plan_picks_the_instance_and_the_stats_by_the_shape(Dh):
    for Lq in LENGTHS:
        for Lk in LENGTHS:
            p = kern.attention_bwd_plan(64, 8, Lq, Lk, Dh)
            fwd = kern.attention_plan(64, 8, Lq, Lk, Dh)
            if max(Dh, Lq, Lk) <= 128:
                # one-block: Dh rounded up to 32 and the keys a row holds
                # as the forward's one-block kernel; no stats, no keys
                # launch
                assert p.instance == 0 and p.stats == 0
                assert p.key_grid == p.key_threads == p.key_smem == 0
                assert (fwd.instance, fwd.dhp, fwd.kc) == (0, p.dhp, p.kc)
                assert p.grid == 64 * 8 and p.col_split == 1
            else:
                # long: chunks of 64, Dh rounded up to 64, two warps a row
                # tile past 128 columns, dK / dV x column halves a key tile
                assert p.instance == 1 and p.kc == kern.ATT_LONG_KC
                assert p.dhp == 64 * -(-Dh // 64)
                assert p.col_split == (2 if p.dhp > 128 else 1)
                assert p.key_split == 2 * p.col_split
                assert p.stats == 64 * 8 * Lq * 4
            assert Dh <= p.dhp


@pytest.mark.parametrize("Dh", DHS)
def test_plan_fills_the_sms_where_the_rows_allow(Dh):
    """The long kernels' blocks are fewer than the SMs only where each
    already holds a single 16-row tile."""
    for B in (1, 2, 64):
        for L in LENGTHS:
            p = kern.attention_bwd_plan(B, 8, L, 300, Dh)
            assert p.grid == B * 8 * p.tiles
            assert p.grid >= kern.GEMM_SMS or p.rows == 16
            p = kern.attention_bwd_plan(B, 8, 300, L, Dh)
            assert p.key_grid == B * 8 * p.key_tiles
            assert p.key_grid >= kern.GEMM_SMS or p.key_rows == 16


def test_plan_depends_on_the_shape_alone():
    shapes = MAIN_PATH + [(3, 2, Lq, Lk, Dh) for Dh, Lq, Lk in _grid()]
    first = [kern.attention_bwd_plan(*s) for s in shapes]
    kern.attention_bwd_plan.cache_clear()
    assert [kern.attention_bwd_plan(*s) for s in reversed(shapes)] == \
        first[::-1]
    # pinned at the main path: one block per head, 4 warps at MCAN-small
    # and MCAN-large (the cross shape's single tile of 14 keys: its 4 or 8
    # phase-2 items over 4 warps), 8 at 128 rows; the long kernels at
    # hidden 1536 and at 608 rows
    pins = {(64, 8, 60, 60, 64): (0, 64, 64, 512, 128, 55296, 0),
            (64, 8, 60, 14, 64): (0, 64, 64, 512, 128, 29184, 0),
            (64, 8, 14, 14, 64): (0, 64, 64, 512, 128, 10752, 0),
            (32, 8, 60, 60, 128): (0, 128, 64, 256, 128, 88064, 0),
            (3, 2, 128, 128, 128): (0, 128, 128, 6, 256, 208896, 0),
            (8, 8, 160, 160, 192): (1, 192, 64, 192, 256, 153600, 320),
            (8, 8, 608, 608, 64): (1, 64, 64, 320, 256, 73728, 640)}
    for shape, want in pins.items():
        p = kern.attention_bwd_plan(*shape)
        assert (p.instance, p.dhp, p.kc, p.grid, p.threads, p.smem,
                p.key_grid) == want, shape


class _Lib:
    """Stands in for the kernels' library: records one launch's arguments."""

    def __init__(self):
        self.args = None

    def mcan_masked_attention_bwd(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("B,Lq,Lk,Dh,kv_dtype,fused,drop,copies", [
    (64, 60, 60, 64, BF16, True, "philox", "qkv"),
    (64, 60, 14, 64, F32, False, "mask", "q"),
    (3, 14, 14, 128, BF16, True, None, ""),
    (8, 160, 160, 192, BF16, False, "mask", "qkv"),
    (2, 608, 14, 256, F32, False, "philox", "q"),
    (1, 17, 15, 24, BF16, True, "mask", "v")])
def test_wrapper_launches_the_plan(monkeypatch, B, Lq, Lk, Dh, kv_dtype,
                                   fused, drop, copies):
    """masked_attention_bwd's launch: the operands' pointers and strides
    as given (fused qkv views and their fused gradient views read and
    written in place), the pad mask, the keep-mask or its Philox words,
    dout's strides, the gradient outputs and their bf16 copies, the stats
    scratch only for the long kernels, and the plan of
    ``attention_bwd_plan``, in the order of the library's signature."""
    lib = _Lib()
    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    H = 8

    def heads(L, n, dtype):
        if fused:
            buf = torch.zeros(B * L, n * H * Dh, dtype=dtype)
            return [t.view(B, L, H, Dh).transpose(1, 2) for t in
                    buf.view(B, L, n * H * Dh).split(H * Dh, dim=-1)]
        return [torch.zeros(B, H, L, Dh, dtype=dtype) for _ in range(n)]

    if fused and Lq == Lk:
        q, k, v = heads(Lq, 3, kv_dtype)
        dq, dk, dv = heads(Lq, 3, F32)
        c16 = heads(Lq, 3, BF16)
    else:
        q, = heads(Lq, 1, BF16)
        k, v = heads(Lk, 2, kv_dtype)
        dq, = heads(Lq, 1, F32)
        dk, dv = heads(Lk, 2, F32)
        c16 = heads(Lq, 1, BF16) + heads(Lk, 2, BF16)
    c16 = [t if n in copies else None for t, n in zip(c16, "qkv")]
    key_pad = torch.zeros(B, 1, 1, Lk, dtype=torch.bool)
    dout = torch.zeros(B, Lq, H * Dh, dtype=BF16)
    keep = None
    if drop == "mask":
        keep = torch.ones(B, H, Lq, Lk, dtype=torch.uint8)
    elif drop == "philox":
        keep = kern.Philox(7, 0x200, 3865470566)
    before = kern.launch_counts().get("masked_attention_bwd", 0)
    kern.masked_attention_bwd(q, k, v, key_pad, dout, dq, dk, dv, *c16,
                              drop=keep, inv_keep=1 / 0.9)
    assert kern.launch_counts()["masked_attention_bwd"] == before + 1
    sig = _build.SIGNATURES["mcan_masked_attention_bwd"]
    assert len(lib.args) == len(sig)
    (pq, qbs, qhs, qrs, pk, pv, kvbs, kvhs, kvrs, kv32, ppad, pdrop, inv,
     keep_on, seed, site, thresh, pdo, dobs, dors, pdq, pdq16, dqbs, dqhs,
     dqrs, pdk, pdk16, dkbs, dkhs, dkrs, pdv, pdv16, dvbs, dvhs, dvrs,
     pstats, b, h, lq, lk, dh, scale, instance, dhp, kc, rows, grid,
     threads, smem, key_rows, key_grid, key_threads, key_smem,
     _) = lib.args
    assert (pq, qbs, qhs, qrs) == (q.data_ptr(), *q.stride()[:3])
    assert (pk, pv, kv32) == (k.data_ptr(), v.data_ptr(),
                              int(kv_dtype == F32))
    assert (kvbs, kvhs, kvrs) == k.stride()[:3] == v.stride()[:3]
    assert ppad == key_pad.data_ptr()
    assert inv == pytest.approx(1 / 0.9)
    if drop == "mask":
        assert pdrop == keep.data_ptr() and keep_on == 0
    else:
        assert pdrop is None
        assert (keep_on, seed, site, thresh) == (
            (1, 7, 0x200, 3865470566) if drop == "philox" else (0, 0, 0, 0))
    assert (pdo, dobs, dors) == (dout.data_ptr(), Lq * H * Dh, H * Dh)
    for (p, p16, bs, hs, rs), t, t16 in zip(
            ((pdq, pdq16, dqbs, dqhs, dqrs), (pdk, pdk16, dkbs, dkhs, dkrs),
             (pdv, pdv16, dvbs, dvhs, dvrs)), (dq, dk, dv), c16):
        assert (p, bs, hs, rs) == (t.data_ptr(), *t.stride()[:3])
        assert p16 == (None if t16 is None else t16.data_ptr())
    assert (b, h, lq, lk, dh) == (B, H, Lq, Lk, Dh)
    assert scale == pytest.approx(Dh ** -0.5)
    plan = kern.attention_bwd_plan(B, H, Lq, Lk, Dh)
    assert (instance, dhp, kc, rows, grid, threads, smem, key_rows,
            key_grid, key_threads, key_smem) == (
        plan.instance, plan.dhp, plan.kc, plan.rows, plan.grid,
        plan.threads, plan.smem, plan.key_rows, plan.key_grid,
        plan.key_threads, plan.key_smem)
    # the stats scratch: [B, H, Lq, 4] f32 for the long kernels only
    assert (pstats is None) == (plan.instance == 0) == (plan.stats == 0)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    B, H, L = 2, 8, 14

    def grads(Dh):
        return [torch.zeros(B, H, L, Dh) for _ in range(3)]

    pad = torch.zeros(B, 1, 1, L, dtype=torch.bool)
    q, k, v = (torch.zeros(B, H, L, 264, dtype=BF16) for _ in range(3))
    dout = torch.zeros(B, L, H * 264, dtype=BF16)
    with pytest.raises(ValueError, match="Dh"):
        kern.masked_attention_bwd(q, k, v, pad, dout, *grads(264))
    q, k, v = (torch.zeros(B, H, L, 64, dtype=BF16) for _ in range(3))
    dout = torch.zeros(B, L, H * 64, dtype=BF16)
    with pytest.raises(ValueError, match="dout"):
        kern.masked_attention_bwd(q, k, v, pad, dout.float(), *grads(64))
    with pytest.raises(ValueError, match="gradient outputs"):
        kern.masked_attention_bwd(q, k, v, pad, dout,
                                  *[t.to(BF16) for t in grads(64)])
    with pytest.raises(ValueError, match="q must be"):
        kern.masked_attention_bwd(q.float(), k, v, pad, dout, *grads(64))
    assert lib.args is None
