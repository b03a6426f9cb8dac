"""The plan of the attention forward (``kernels.attention_plan``: which
masked_attention.cu instance, how many query rows a block, the grid, the
threads and the shared memory) and the launch arguments the wrapper
derives from it: pure Python, seconds, no card and no JAX."""

import pytest
import torch

from mcan_vqa_tpu_torch.ops import _build
from mcan_vqa_tpu_torch.ops import kernels as kern

BF16, F32 = torch.bfloat16, torch.float32
SMEM_LIMIT = 232448          # an H100 block's dynamic shared memory
DHS = (1, 24, 60, 64, 100, 128, 192, 256)
LENGTHS = (1, 14, 15, 16, 17, 60, 64, 65, 127, 128, 129, 160, 608)
# (B, H, Lq, Lk, Dh) of the main paths: MCAN-small serving and training
# (enc self 14 x 14, dec self 60 x 60, dec cross 60 x 14) at B = 64 and 1,
# MCAN-large's micro-batch of 32 at Dh 128, hidden 1536 / 2048 (Dh 192 /
# 256) at 160 image rows, grid features (608 rows)
MAIN_PATH = [(B, 8, Lq, Lk, 64) for B in (64, 1, 8)
             for Lq, Lk in ((14, 14), (60, 60), (60, 14))]
MAIN_PATH += [(32, 8, Lq, Lk, 128) for Lq, Lk in ((14, 14), (60, 60),
                                                   (60, 14))]
MAIN_PATH += [(8, 8, 160, 160, 192), (8, 8, 60, 14, 256),
              (8, 8, 608, 608, 64), (8, 8, 608, 14, 256), (2, 8, 86, 86, 32),
              (64, 2, 160, 160, 128), (1, 8, 160, 14, 192)]


def _grid():
    for Dh in DHS:
        for Lq in LENGTHS:
            for Lk in LENGTHS:
                yield Dh, Lq, Lk


def _cover(plan, B, H, Lq):
    """Every (sample-head, query row, column part) the blocks' warps hold,
    as the kernels map them: block x is (sample, head) x // tiles, row
    tile x % tiles; warp w holds rows 16 (w // col_split) .. + 16 of the
    tile and column part w % col_split."""
    held = []
    for x in range(plan.grid):
        bh, tile = divmod(x, plan.tiles)
        for w in range(plan.threads // 32):
            r0 = tile * plan.rows + 16 * (w // plan.col_split)
            held += [(bh, i, w % plan.col_split)
                     for i in range(r0, min(r0 + 16, Lq))]
    return held


@pytest.mark.parametrize("B,H,Lq,Lk,Dh", MAIN_PATH)
def test_plan_covers_every_query_row_once(B, H, Lq, Lk, Dh):
    plan = kern.attention_plan(B, H, Lq, Lk, Dh)
    held = _cover(plan, B, H, Lq)
    assert sorted(held) == [(bh, i, c) for bh in range(B * H)
                            for i in range(Lq) for c in range(plan.col_split)]
    # no block is wholly past Lq
    assert (plan.tiles - 1) * plan.rows < Lq <= plan.tiles * plan.rows


@pytest.mark.parametrize("B", [1, 3, 17])
def test_plan_covers_every_row_at_the_fragment_edges(B):
    for Dh, Lq, Lk in _grid():
        plan = kern.attention_plan(B, 2, Lq, Lk, Dh)
        held = _cover(plan, B, 2, Lq)
        assert len(held) == len(set(held)) == B * 2 * Lq * plan.col_split
        assert (plan.tiles - 1) * plan.rows < Lq <= plan.tiles * plan.rows


@pytest.mark.parametrize("Dh", DHS)
def test_plan_fits_the_block_limits(Dh):
    for B in (1, 64):
        for Lq in LENGTHS:
            for Lk in LENGTHS:
                plan = kern.attention_plan(B, 8, Lq, Lk, Dh)
                assert 0 < plan.smem <= SMEM_LIMIT
                assert plan.threads % 32 == 0 and \
                    32 <= plan.threads <= 32 * kern.ATT_MAX_WARPS
                assert plan.rows % 16 == 0 and plan.threads == \
                    plan.rows // 16 * plan.col_split * 32
                staged = 2 * 16 * -(-Lk // 16) if plan.instance == 0 or \
                    Lk <= kern.ATT_LONG_KC else 4 * kern.ATT_LONG_KC
                assert plan.smem == (plan.rows + staged) * (plan.dhp + 8) * 2


@pytest.mark.parametrize("Dh", DHS)
def test_plan_picks_the_instance_by_the_shape(Dh):
    for Lq in LENGTHS:
        for Lk in LENGTHS:
            plan = kern.attention_plan(64, 8, Lq, Lk, Dh)
            if Dh <= 128 and Lk <= 128:
                # one-block: all keys at once, Dh rounded up to 32
                assert plan.instance == 0 and plan.col_split == 1
                assert plan.dhp == 32 * -(-Dh // 32)
                assert plan.kc == (64 if Lk <= 64 else 128) >= Lk
            else:
                # long: keys in chunks of 64, Dh rounded up to 64, two
                # warps a row tile past 128 columns
                assert plan.instance == 1 and plan.kc == kern.ATT_LONG_KC
                assert plan.dhp == 64 * -(-Dh // 64)
                assert plan.col_split == (2 if plan.dhp > 128 else 1)
            assert Dh <= plan.dhp


@pytest.mark.parametrize("Dh", DHS)
def test_plan_fills_the_sms_where_the_rows_allow(Dh):
    """Fewer blocks than SMs only where every block already holds a single
    16-row tile (B = 1: the rows are split over more blocks)."""
    for B in (1, 2, 64):
        for Lq in LENGTHS:
            plan = kern.attention_plan(B, 8, Lq, 60, Dh)
            assert plan.grid == B * 8 * plan.tiles
            assert plan.grid >= kern.GEMM_SMS or plan.rows == 16


def test_plan_depends_on_the_shape_alone():
    shapes = MAIN_PATH + [(3, 2, Lq, Lk, Dh) for Dh, Lq, Lk in _grid()]
    first = [kern.attention_plan(*s) for s in shapes]
    kern.attention_plan.cache_clear()
    assert [kern.attention_plan(*s) for s in reversed(shapes)] == first[::-1]
    # pinned at the main path: MCAN-small at B = 64 one block per head
    # (4 warps at 60 rows, 1 at 14), at B = 1 a block per 16 rows; the
    # long kernel at hidden 1536 in blocks of 64 rows by 8 warps
    pins = {(64, 8, 60, 60, 64): (0, 64, 64, 64, 512),
            (64, 8, 14, 14, 64): (0, 64, 64, 16, 512),
            (64, 8, 60, 14, 64): (0, 64, 64, 64, 512),
            (1, 8, 60, 60, 64): (0, 64, 64, 16, 32),
            (32, 8, 60, 60, 128): (0, 128, 64, 64, 256),
            (2, 8, 86, 86, 32): (0, 32, 128, 16, 96),
            (8, 8, 160, 160, 192): (1, 192, 64, 64, 192),
            (8, 8, 608, 608, 64): (1, 64, 64, 128, 320)}
    for shape, want in pins.items():
        p = kern.attention_plan(*shape)
        assert (p.instance, p.dhp, p.kc, p.rows, p.grid) == want, shape


class _Lib:
    """Stands in for the kernels' library: records one launch's arguments."""

    def __init__(self):
        self.args = None

    def mcan_masked_attention(self, *args):
        self.args = args
        return 0


def _heads(B, L, H, Dh, dtype, fused):
    """q, k, v [B, H, L, Dh]: views of one fused [B * L, 3 H Dh] buffer as
    the blocks pass them, or contiguous tensors."""
    if fused:
        qkv = torch.zeros(B * L, 3 * H * Dh, dtype=dtype)
        return [t.view(B, L, H, Dh).transpose(1, 2)
                for t in qkv.view(B, L, 3 * H * Dh).split(H * Dh, dim=-1)]
    return [torch.zeros(B, H, L, Dh, dtype=dtype) for _ in range(3)]


@pytest.mark.parametrize("B,Lq,Lk,Dh,q_dtype,kv_dtype,out_dtype,fused,drop", [
    (64, 60, 60, 64, BF16, BF16, BF16, True, None),
    (64, 60, 14, 64, BF16, F32, BF16, False, None),
    (3, 60, 60, 64, BF16, BF16, BF16, True, "mask"),
    (3, 60, 14, 128, BF16, F32, BF16, False, "philox"),
    (64, 14, 14, 64, F32, F32, F32, True, None),
    (8, 160, 160, 192, F32, F32, F32, False, None),
    (2, 608, 14, 256, BF16, F32, F32, False, "philox"),
    (1, 17, 15, 24, BF16, BF16, F32, True, "mask")])
def test_wrapper_launches_the_plan(monkeypatch, B, Lq, Lk, Dh, q_dtype,
                                   kv_dtype, out_dtype, fused, drop):
    """masked_attention's launch: the operands' pointers, dtype flags and
    strides as given (fused qkv views read in place), the pad mask, the
    keep-mask or its Philox words, the output's strides, and the plan of
    ``attention_plan``, in the order of the library's signature."""
    lib = _Lib()
    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    H = 8
    if fused and Lq == Lk:
        q, k, v = _heads(B, Lq, H, Dh, kv_dtype, True)
        q = q.to(q_dtype) if q_dtype != kv_dtype else q
    else:
        q = _heads(B, Lq, H, Dh, q_dtype, fused)[0]
        k, v = _heads(B, Lk, H, Dh, kv_dtype, False)[1:]
    key_pad = torch.zeros(B, 1, 1, Lk, dtype=torch.bool)
    keep = None
    if drop == "mask":
        keep = torch.ones(B, H, Lq, Lk, dtype=torch.uint8)
    elif drop == "philox":
        keep = kern.Philox(7, 0x200, 3865470566)
    before = kern.launch_counts().get(
        "masked_attention" + ("_f32" if out_dtype == F32 else ""), 0)
    out = kern.masked_attention(q, k, v, key_pad, keep, 1 / 0.9,
                                out_dtype=out_dtype)
    name = "masked_attention" + ("_f32" if out_dtype == F32 else "")
    assert kern.launch_counts()[name] == before + 1
    assert out.shape == (B, Lq, H * Dh) and out.dtype == out_dtype
    assert len(lib.args) == len(_build.SIGNATURES["mcan_masked_attention"])
    (pq, q32, qbs, qhs, qrs, pk, pv, kvbs, kvhs, kvrs, kv32, ppad, pdrop, inv,
     keep_on, seed, site, thresh, pout, o32, obs, ors, b, h, lq, lk, dh,
     scale, instance, dhp, kc, rows, grid, threads, smem, _) = lib.args
    assert (pq, q32, qbs, qhs, qrs) == (q.data_ptr(), int(q_dtype == F32),
                                        *q.stride()[:3])
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
    assert (pout, o32, obs, ors) == (out.data_ptr(), int(out_dtype == F32),
                                     Lq * H * Dh, H * Dh)
    assert (b, h, lq, lk, dh) == (B, H, Lq, Lk, Dh)
    assert scale == pytest.approx(Dh ** -0.5)
    plan = kern.attention_plan(B, H, Lq, Lk, Dh)
    assert (instance, dhp, kc, rows, grid, threads, smem) == (
        plan.instance, plan.dhp, plan.kc, plan.rows, plan.grid, plan.threads,
        plan.smem)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    q, k, v = _heads(2, 14, 8, 264, BF16, False)
    pad = torch.zeros(2, 1, 1, 14, dtype=torch.bool)
    with pytest.raises(ValueError, match="Dh"):
        kern.masked_attention(q, k, v, pad)
    q, k, v = _heads(2, 14, 8, 64, BF16, False)
    with pytest.raises(ValueError, match="key_pad"):
        kern.masked_attention(q, k, v, pad[:, :, :, :7])
    with pytest.raises(ValueError, match="out_dtype"):
        kern.masked_attention(q, k, v, pad, out_dtype=torch.float16)
    assert lib.args is None
