"""The plan of the int4 products (``kernels.gemm_plan`` at gemm_int4.cu's
layouts S4 = ``gemm_s4`` and W4 = ``gemm_w4bf16``), the map from a K-tile's
positions to the packed bytes and nibbles that hold its codes, the launch
arguments the wrappers derive from them, and the K-major packed layout they
read: pure Python, milliseconds, no card and no JAX."""

import pytest
import torch

from mcan_vqa_tpu_torch.ops import kernels as kern

S4, W4 = 5, 6
BF16 = torch.bfloat16

# (K, N) of every level-5 / level-7 int4 site: the fused qkv [D, 3D], w1
# [D, F] and w2 [F, D] of MCAN-small (D 512, F 2048) and MCAN-large (D 1024,
# F 4096); M: one row, the B=1 encoder and decoder (14, 60), a ragged 61,
# the B=64 encoder and decoder (896, 3840)
SITES = [(D, 3 * D) for D in (512, 1024)] + [(512, 2048), (2048, 512),
                                               (1024, 4096), (4096, 1024)]
MS = (1, 14, 60, 61, 896, 3840)
SHAPES = [(layout, M, N, K) for layout in (S4, W4) for K, N in SITES
          for M in MS]
# K % 256 != 0 (hidden 384, 640): one group straddles the nibble halves
ODD = [(layout, M, N, K) for layout in (S4, W4) for M in (14, 3840)
       for K, N in ((384, 1152), (1536, 384), (640, 2560))]


def _items(plan):
    """The (tile, split) of every work item, as the persistent grid walks
    them: block b takes items b, b + grid, ...; item w is split w // tiles
    of tile w % tiles."""
    out = []
    for b in range(plan.grid):
        for w in range(b, plan.blocks, plan.grid):
            out.append((w % plan.tiles, w // plan.tiles))
    return out


@pytest.mark.parametrize("layout,M,N,K", SHAPES + ODD)
def test_int4_tiles_cover_the_output_exactly_once(layout, M, N, K):
    plan = kern.gemm_plan(layout, M, N, K)
    # 128 weight columns x 64 activation rows (S4; W4 up to M 64) or 128
    # (W4), a block an SM
    assert (plan.bm, plan.bn) == (
        (64 if layout == S4 or M <= 64 else 128), 128)
    assert (layout, plan.bm) in kern.INT4_INSTANCES
    assert (plan.tiles_m - 1) * plan.bm < M <= plan.tiles_m * plan.bm
    assert (plan.tiles_n - 1) * plan.bn < N <= plan.tiles_n * plan.bn
    items = _items(plan)
    assert sorted(items) == [(t, s) for t in range(plan.tiles)
                             for s in range(plan.splits)]
    assert plan.grid == min(plan.blocks, kern.GEMM_SMS)


@pytest.mark.parametrize("layout,M,N,K", SHAPES + ODD)
def test_int4_k_tiles_cover_k_in_order(layout, M, N, K):
    """S4: a K-tile is one 128-row scale group; W4: K-tiles of 64 rows,
    each in one group and one nibble half. Either splits into contiguous
    ranges, in order, of at least INT4_SPLIT_MIN_TILES K-tiles, at most
    INT4_MAX_SPLITS of them, only where the tiles leave SMs idle."""
    plan = kern.gemm_plan(layout, M, N, K)
    assert plan.bk == (kern.W4_GROUP if layout == S4 else 64)
    assert plan.k_tiles * plan.bk == K
    ranges = [plan.split_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_tiles
    assert all(e0 == b1 for (_, e0), (b1, _) in zip(ranges, ranges[1:]))
    rows = [r for b, e in ranges for r in range(b * plan.bk, e * plan.bk)]
    assert rows == list(range(K))
    assert plan.splits == 1 or (
        plan.tiles < kern.GEMM_SMS and plan.splits <= kern.INT4_MAX_SPLITS
        and all(e - b >= kern.INT4_SPLIT_MIN_TILES[layout]
                for b, e in ranges))
    if layout == W4:
        for t in range(plan.k_tiles):
            _, nib, group = kern.w4bf16_tile(K, t)
            k0 = 64 * t
            assert group == k0 // 128 == (k0 + 63) // 128
            assert nib == (0 if k0 + 63 < K // 2 else 4)


@pytest.mark.parametrize("layout,M,N,K", SHAPES + ODD)
def test_int4_split_partials_fit_their_workspace(layout, M, N, K):
    """W4: one f32 partial a split, summed in split order. S4 (the prefix
    rule): slot 0 holds split 0's sum of groups 0 .. e0 - 1, and every later
    group g its own term at slot 1 + g - e0, so the last block adds them in
    group order; nothing else is written."""
    plan = kern.gemm_plan(layout, M, N, K)
    assert plan.term_slots == (layout == S4)
    if plan.splits == 1:
        assert plan.workspace_bytes == 0
        return
    assert plan.blocks <= kern.GEMM_SMS
    tile = plan.tiles * plan.bm * plan.bn * 4
    if layout == W4:
        assert plan.workspace_bytes == plan.splits * tile
        return
    e0 = plan.split_range(0)[1]
    assert e0 == plan.k_tiles // plan.splits
    later = [1 + t - e0 for s in range(1, plan.splits)
             for t in range(*plan.split_range(s))]
    assert later == list(range(1, plan.partials))
    assert plan.workspace_bytes == plan.partials * tile


def test_int4_plan_depends_on_the_shape_alone():
    shapes = SHAPES + ODD
    first = [kern.gemm_plan(*s) for s in shapes]
    kern.gemm_plan.cache_clear()
    assert [kern.gemm_plan(*s) for s in reversed(shapes)] == first[::-1]
    # pinned: B=1 w2 of MCAN-small in 8 splits of 4 K-tiles at W4 and 4 of
    # 4 groups at S4; the B=1 w1 in 4 splits of 2 K-tiles at W4, unsplit at
    # S4 (4 groups); the B=64 decoder unsplit; the B=64 encoder's w2 in 4 /
    # 2; MCAN-large's B=1 w2 in 8
    pins = {(W4, 14, 512, 2048): 8, (S4, 14, 512, 2048): 4,
            (W4, 60, 2048, 512): 4, (S4, 60, 2048, 512): 1,
            (S4, 3840, 2048, 512): 1, (W4, 3840, 512, 2048): 1,
            (W4, 896, 512, 2048): 4, (S4, 896, 512, 2048): 2,
            (W4, 14, 1024, 4096): 8, (S4, 14, 1024, 4096): 8}
    for shape, splits in pins.items():
        assert kern.gemm_plan(*shape).splits == splits, shape


@pytest.mark.parametrize("layout,bm", kern.INT4_INSTANCES)
def test_int4_shared_memory_fits(layout, bm):
    """Each instance's ring, second box, scales and barriers fit a block's
    227 KB, with at least four slots in flight."""
    assert kern.int4_smem_bytes(layout, bm) <= kern.SMEM_PER_BLOCK
    assert kern.INT4_STAGES[layout, bm] >= 4


def _packed(K, N, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-128, 128, (K // 2, N), generator=g,
                         dtype=torch.int8)


@pytest.mark.parametrize("K", [256, 384, 512, 640, 2048, 4096])
def test_code_map_holds_against_unpack_w4(K):
    """Every code of every S4 K-tile, read from the byte and nibble the map
    names in the box it names (128 bytes of each column's packed row, zero
    past K/2), equals unpack_w4's; a box's position is the code's own, or
    64 back in a straddling group's high box (the same 16-byte chunk XOR 4,
    so the kernel unpacks each code within one row of the slot). Every W4
    K-tile's 64 codes are one box's nibbles in order."""
    N = 16
    packed = _packed(K, N, K)
    want = kern.unpack_w4(packed)
    half = K // 2
    by = packed.to(torch.int32) & 0xFF
    zero = torch.zeros(128, N, dtype=torch.int32)
    straddles = 0
    for t in range(K // kern.W4_GROUP):
        lo, hi = kern.w4_tile_boxes(K, t)
        boxes = {name: torch.cat([by[at:at + 128], zero])[:128]
                 for name, at in (("lo", lo), ("hi", hi)) if at is not None}
        assert all(b.shape == (128, N) for b in boxes.values())
        straddles += len(boxes) == 2
        for p in range(128):
            box, pos, sh = kern.w4_code_source(K, t, p)
            start = lo if box == "lo" else hi
            assert 0 <= pos < 128 and start + pos < half
            assert pos == p or (box == "hi" and lo is not None and
                                pos == p - 64 and (pos // 16) == (p // 16) ^ 4)
            got = ((boxes[box][pos] >> sh) & 0xF) - 8
            assert torch.equal(got.to(torch.int8), want[128 * t + p])
    assert straddles == (1 if K % 256 else 0)
    for t in range(K // 64):
        at, sh, _ = kern.w4bf16_tile(K, t)
        got = ((by[at:at + 64] >> sh) & 0xF) - 8
        assert at + 64 <= half
        assert torch.equal(got.to(torch.int8), want[64 * t:64 * t + 64])


class _Lib:
    """Stands in for the kernels' library: records one launch's arguments."""

    def __init__(self):
        self.args = None

    def mcan_gemm_s4(self, *args):
        self.args = args
        return 0

    def mcan_gemm_w4bf16(self, *args):
        self.args = args
        return 0


def _fake_card(monkeypatch, lib, made):
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    monkeypatch.setattr(kern, "_SPLIT_COUNTERS", {})
    monkeypatch.setattr(kern.torch, "empty", record_empty)


def _weight(K, N):
    wp = kern.k_major(torch.zeros(K // 2, N, dtype=torch.int8))
    return wp, torch.ones(K // 128, N)


@pytest.mark.parametrize("M,K,N,relu,out_dtypes", [
    (14, 512, 1536, False, (BF16,)),
    (60, 512, 2048, True, (torch.float32,)),
    (3840, 2048, 512, False, (torch.float32,)),
    (896, 384, 1152, False, (torch.float32, BF16)),
    (14, 2048, 512, False, (torch.float32,)),
    (1, 4096, 1024, True, (BF16,))])
def test_s4_wrapper_launches_its_plan(monkeypatch, M, K, N, relu,
                                      out_dtypes):
    """gemm_s4's launch: mcan_gemm_s4 with the S4 plan's tile, splits and
    grid, the codes' row stride, the K-major packed weight's column stride
    (K/2), the scales, the static scale as an f32 value, bias and ReLU, one
    output per asked dtype; a split plan gets its workspace (split 0's sum
    and one slot a later group) and the device's tile counters (all 0)."""
    lib, made = _Lib(), []
    aq = torch.zeros(M, K, dtype=torch.int8)
    wp, s4 = _weight(K, N)
    bias = torch.zeros(N)
    _fake_card(monkeypatch, lib, made)
    before = kern.launch_counts().get("gemm_s4", 0)
    outs = kern.gemm_s4(aq, wp, s4, bias, a=0.1, relu=relu,
                        out_dtypes=out_dtypes)
    plan = kern.gemm_plan(S4, M, N, K)
    assert kern.launch_counts()["gemm_s4"] == before + 1
    assert [o.dtype for o in outs] == list(out_dtypes)
    (pa, lda, pp, ldp, ps, m, n, k, bm, bn, splits, grid, a, pb, rl, o32,
     o16, ws, counters, stream) = lib.args
    assert (m, n, k, bm, bn, splits, grid) == (M, N, K, 64, 128, plan.splits,
                                               plan.grid)
    if plan.splits == 1:
        assert made == list(outs) and ws is None and counters is None
    else:
        wst = [t for t in made if t.data_ptr() == ws][0]
        assert wst.numel() * wst.element_size() == plan.workspace_bytes
        cnt = kern._SPLIT_COUNTERS[aq.device]
        assert counters == cnt.data_ptr() and cnt.numel() >= plan.tiles
        assert not cnt.any()
    assert (pa, lda, pp, ldp, ps) == (aq.data_ptr(), K, wp.data_ptr(),
                                      K // 2, s4.data_ptr())
    assert a == kern._f32(0.1) and (pb, rl) == (bias.data_ptr(), int(relu))
    by = dict(zip(out_dtypes, outs))
    assert o32 == (by[torch.float32].data_ptr()
                   if torch.float32 in by else None)
    assert o16 == (by[BF16].data_ptr() if BF16 in by else None)


@pytest.mark.parametrize("M,K,N,relu,out_dtype", [
    (14, 2048, 512, False, torch.float32),
    (60, 512, 2048, True, BF16),
    (896, 2048, 512, False, torch.float32),
    (3840, 512, 1536, False, BF16),
    (14, 4096, 1024, False, torch.float32),
    (61, 640, 2560, True, torch.float32)])
def test_w4bf16_wrapper_launches_its_plan(monkeypatch, M, K, N, relu,
                                          out_dtype):
    """gemm_w4bf16's launch: mcan_gemm_w4bf16 with the W4 plan's tile
    width, splits and grid, x's row stride, the K-major packed weight's
    column stride, one output of the asked dtype; a split plan gets its
    workspace and the device's tile counters (all 0)."""
    lib, made = _Lib(), []
    x = torch.zeros(M, K, dtype=BF16)
    wp, s4 = _weight(K, N)
    bias = torch.zeros(N)
    _fake_card(monkeypatch, lib, made)
    before = kern.launch_counts().get("gemm_w4bf16", 0)
    out = kern.gemm_w4bf16(x, wp, s4, bias, relu=relu, out_dtype=out_dtype)
    plan = kern.gemm_plan(W4, M, N, K)
    assert kern.launch_counts()["gemm_w4bf16"] == before + 1
    assert out.shape == (M, N) and out.dtype == out_dtype
    (pa, lda, pp, ldp, ps, m, n, k, bm, bn, splits, grid, pb, rl, o32, o16,
     ws, counters, stream) = lib.args
    assert (m, n, k, bm, bn, splits, grid) == (
        M, N, K, 64 if M <= 64 else 128, 128, plan.splits, plan.grid)
    assert (pa, lda, pp, ldp, ps) == (x.data_ptr(), K, wp.data_ptr(),
                                      K // 2, s4.data_ptr())
    assert (pb, rl) == (bias.data_ptr(), int(relu))
    assert (o32, o16) == ((out.data_ptr(), None) if out_dtype == torch.float32
                          else (None, out.data_ptr()))
    if plan.splits == 1:
        assert made == [out] and ws is None and counters is None
    else:
        wst = [t for t in made if t.data_ptr() == ws][0]
        assert wst.numel() * wst.element_size() == plan.workspace_bytes
        cnt = kern._SPLIT_COUNTERS[x.device]
        assert counters == cnt.data_ptr() and cnt.numel() >= plan.tiles
        assert not cnt.any()


@pytest.mark.parametrize("K,N", [(512, 2048), (384, 1152), (2048, 512)])
def test_int4_wrappers_refuse_a_row_major_weight(monkeypatch, K, N):
    """The packed weight is read K-major and never transposed per call: one
    stored row-major, or K-major with a column stride that is no multiple
    of 16, raises before any launch in both wrappers."""
    monkeypatch.setattr(kern, "_lib", lambda: pytest.fail("launched"))
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    aq = torch.zeros(64, K, dtype=torch.int8)
    wp, s4 = _weight(K, N)
    assert wp.stride() == (1, K // 2)
    wide = torch.zeros(N, K // 2 + 8, dtype=torch.int8)[:, :K // 2].t()
    assert wide.shape == (K // 2, N) and wide.stride(0) == 1
    for bad in (wp.contiguous(), wide):
        with pytest.raises(ValueError, match="K-major"):
            kern.gemm_s4(aq, bad, s4, a=1.0)
        with pytest.raises(ValueError, match="K-major"):
            kern.gemm_w4bf16(aq.to(BF16), bad, s4)


def test_quant_w4_stores_the_packed_weight_k_major():
    """The engine's int4 weight is made K-major once, where it is
    quantized, with the row-major packing's values."""
    from mcan_vqa_tpu_torch.ops.quant import _quant_w4
    w = torch.randn(384, 96, generator=torch.Generator().manual_seed(3))
    q = _quant_w4(w)
    assert q["w_p"].shape == (192, 96) and q["w_p"].stride() == (1, 192)
    assert kern._is_k_major(q["w_p"])
    assert q["w_gscale"].is_contiguous()
    s = q["w_gscale"].repeat_interleave(128, dim=0)
    codes = torch.round(w / s).clamp(-7, 7).to(torch.int32) + 8
    want = (codes[:192] | (codes[192:] << 4)).to(torch.uint8).view(torch.int8)
    assert torch.equal(q["w_p"], want)
