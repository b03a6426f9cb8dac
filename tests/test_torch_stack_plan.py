"""The plan of the all-layer stacks (``kernels.stack_plan``: each GEMM
stage's tile and K splits, the attention stages' plans, the workspace and
counters of the split products) and the launch arguments ``sga_decoder``
and ``sa_encoder`` derive from it: pure Python, milliseconds, no card and
no JAX."""

import ctypes

import pytest
import torch

from mcan_vqa_tpu_torch.ops import kernels as kern

BF16 = torch.bfloat16
SMEM_LIMIT = 232448     # an H100 block's dynamic shared memory, 227 KB

# (B, Lx, D, F, H, Lq, kv): MCAN-small (D 512, F 2048, 8 heads; 60 regions,
# 14 tokens) at B = 1, 8, 64 for the decoder with the in-kernel and the
# external k/v and for the encoder; the wide shape of chip_smoke.py (D 256,
# F 1024, 2 heads of 128, 160 regions); ragged rows (37 regions x 3, 14
# tokens x 9) and 130 cross keys
SMALL = [(B, 60, 512, 2048, 8, 14, kv) for B in (1, 8, 64)
         for kv in ("in", "ext")]
SMALL += [(B, 14, 512, 2048, 8, 0, "") for B in (1, 8, 64)]
WIDE = [(8, 160, 256, 1024, 2, 14, "in"), (8, 160, 256, 1024, 2, 14, "ext"),
        (4, 150, 256, 1024, 2, 0, "")]
RAGGED = [(3, 37, 256, 512, 2, 130, "ext"), (3, 37, 512, 2048, 8, 14, "in"),
          (9, 14, 512, 2048, 8, 0, ""), (5, 60, 512, 2048, 8, 14, "ext"),
          (7, 160, 256, 1024, 2, 14, "in")]
SHAPES = SMALL + WIDE + RAGGED


def _plan(B, Lx, D, F, H, Lq, kv):
    return kern.stack_plan(B, Lx, D, F, H, Lq, kv)


def _products(B, Lx, D, F, Lq, kv):
    """The (M, N, K) of each product in the C order (None: absent)."""
    M = B * Lx
    if not kv:
        return [(M, 3 * D, D), (M, D, D), (M, F, D), (M, D, F)]
    return [(M, 3 * D, D), (M, D, D), (M, D, D),
            (B * Lq, 2 * D, D) if kv == "in" else None, (M, D, D),
            (M, F, D), (M, D, F)]


@pytest.mark.parametrize("B,Lx,D,F,H,Lq,kv", SHAPES)
def test_tiles_cover_every_output_once(B, Lx, D, F, H, Lq, kv):
    plan = _plan(B, Lx, D, F, H, Lq, kv)
    for g, shape in zip(plan.gemms, _products(B, Lx, D, F, Lq, kv)):
        assert (g is None) == (shape is None)
        if g is None:
            continue
        assert (g.M, g.N, g.K) == shape
        assert (g.bm, g.bn) in kern.STACK_TILES
        # the item decode of persistent_stages.cuh (StackItem): split w //
        # tiles of tile w % tiles; each (tile, split) once
        seen = set()
        for w in range(g.items):
            tile, split = w % g.tiles, w // g.tiles
            m0, n0 = tile // g.tiles_n * g.bm, tile % g.tiles_n * g.bn
            assert 0 <= m0 < g.M and 0 <= n0 < g.N
            seen.add((m0, n0, split))
        assert len(seen) == g.items
        # row and column tiles abut, start at 0 and end past the last row
        # and column without a tile wholly outside
        assert (g.tiles_m - 1) * g.bm < g.M <= g.tiles_m * g.bm
        assert (g.tiles_n - 1) * g.bn < g.N <= g.tiles_n * g.bn
        # a 64-row stream takes the 64-row tile (both warpgroups busy)
        if g.M <= 64:
            assert (g.bm, g.bn) == (64, 128)


@pytest.mark.parametrize("B,Lx,D,F,H,Lq,kv", SHAPES)
def test_splits_partition_k_in_order(B, Lx, D, F, H, Lq, kv):
    plan = _plan(B, Lx, D, F, H, Lq, kv)
    for g in plan.gemms:
        if g is None:
            continue
        assert g.k_tiles == -(-g.K // 64)
        assert 1 <= g.splits <= g.k_tiles
        ranges = [g.split_range(s) for s in range(g.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == g.k_tiles
        assert all(b > a for a, b in ranges)        # none empty
        assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
        # a split only where the tiles leave most SMs idle, at most one
        # wave of items then
        if g.splits > 1:
            assert g.tiles < kern.GEMM_SMS // 2
            assert g.items <= kern.GEMM_SMS
            assert g.splits <= kern.STACK_MAX_SPLITS
        assert g.ws_floats == (0 if g.splits == 1 else
                               g.splits * g.tiles * g.bm * g.bn)
        assert g.counters == (0 if g.splits == 1 else g.tiles)


@pytest.mark.parametrize("B,Lx,D,F,H,Lq,kv", SHAPES)
def test_split_products_of_a_stage_get_their_own_counters_and_workspace(
        B, Lx, D, F, H, Lq, kv):
    plan = _plan(B, Lx, D, F, H, Lq, kv)
    covered = sorted(i for st in plan.stages for i in st)
    assert covered == [i for i, g in enumerate(plan.gemms) if g is not None]
    for stage in plan.stages:
        ws = cnt = 0
        for i in stage:
            g = plan.gemms[i]
            # consecutive, from 0 at every stage (a barrier lies between)
            assert (g.ws, g.cnt) == (ws, cnt)
            ws += g.ws_floats
            cnt += g.counters
        assert ws <= plan.workspace_floats and cnt <= plan.counters
    assert plan.workspace_floats == max(
        sum(plan.gemms[i].ws_floats for i in st) for st in plan.stages)
    assert plan.counters == max(
        sum(plan.gemms[i].counters for i in st) for st in plan.stages)
    # the decoder's cross query and in-kernel k/v share a stage
    if kv == "in":
        assert (2, 3) in plan.stages


@pytest.mark.parametrize("B,Lx,D,F,H,Lq,kv", SHAPES)
def test_the_plan_is_the_shapes_and_any_grid_walks_it_once(B, Lx, D, F, H,
                                                           Lq, kv):
    plan = _plan(B, Lx, D, F, H, Lq, kv)
    kern.stack_plan.cache_clear()
    assert _plan(B, Lx, D, F, H, Lq, kv) == plan   # no hidden state
    stage_items = [sum(plan.gemms[i].items for i in st) for st in plan.stages]
    stage_items += [B * H * a.tiles for a in plan.attention]
    assert plan.items == max(stage_items + [-(-B * Lx // kern.STACK_WARPS)])
    # the grid-stride loop of every stage: block b takes items b, b + grid,
    # ...; any grid up to the plan's items does each item once
    for grid in (1, 3, 7, kern.GEMM_SMS, plan.items):
        for n in stage_items:
            walked = [w for b in range(grid) for w in range(b, n, grid)]
            assert sorted(walked) == list(range(n))


@pytest.mark.parametrize("B,Lx,D,F,H,Lq,kv", SHAPES)
def test_shared_memory_fits_the_block(B, Lx, D, F, H, Lq, kv):
    plan = _plan(B, Lx, D, F, H, Lq, kv)
    assert plan.smem == kern.STACK_SMEM <= SMEM_LIMIT
    # six slots of two A and two W boxes of 64 x 64 bf16
    assert kern.STACK_RING == 6 * 4 * 64 * 64 * 2
    keys = (Lx, Lq) if kv else (Lx,)
    for a, Lk in zip(plan.attention, keys):
        # masked_attention.cu's own plan, its head width padded to one of
        # the stack's four instances (zero columns and keys add nothing)
        ref = kern.attention_plan(B, H, Lx, Lk, D // H)
        assert (a.instance, a.rows, a.col_split, a.tiles, a.grid,
                a.threads) == (ref.instance, ref.rows, ref.col_split,
                               ref.tiles, ref.grid, ref.threads)
        assert (a.instance, a.dhp, a.kc) in ((0, 64, 64), (0, 128, 128),
                                             (1, 128, 64), (1, 256, 64))
        assert a.dhp >= ref.dhp and a.kc >= ref.kc >= Lk * (1 - a.instance)
        assert a.col_split == (2 if a.dhp > 128 else 1)
        staged = 2 * 16 * -(-Lk // 16) if a.instance == 0 or Lk <= 64 \
            else 4 * 64
        assert a.smem == (a.rows + staged) * (a.dhp + 8) * 2
        assert a.smem <= kern.STACK_RING   # staged in the ring
        assert a.threads <= 32 * (kern.STACK_WARPS - 1)
        assert a.instance == (0 if D // H <= 128 and Lk <= 128 else 1)
    # items a block runs at once: each on its warps, in its ring slice; as
    # many as fit (8 at most: the consumer warps)
    for a, n in zip(plan.attention, plan.att_groups):
        assert n in (1, 2, 4, 8)
        assert n * a.threads <= 256 and n * a.smem <= kern.STACK_RING
        assert n == 8 or 2 * n * a.threads > 256 or \
            2 * n * a.smem > kern.STACK_RING


def test_fields_are_the_c_order():
    plan = _plan(1, 60, 512, 2048, 8, 14, "ext")
    f = plan.fields()
    assert len(f) == 7 * 5 + 2 * 5 + 1
    assert f[3 * 5:4 * 5] == (0,) * 5       # kv2: absent with external k/v
    for i, g in enumerate(plan.gemms):
        if g is not None:
            assert f[5 * i:5 * i + 5] == (g.bm, g.bn, g.splits, g.ws, g.cnt)
    for i, (a, n) in enumerate(zip(plan.attention, plan.att_groups)):
        assert f[35 + 5 * i:40 + 5 * i] == (a.instance, a.dhp, a.kc, a.rows,
                                            n)
    assert f[-1] == plan.items
    enc = _plan(64, 14, 512, 2048, 8, 0, "")
    assert len(enc.fields()) == 4 * 5 + 5 + 1


def test_small_batches_split_the_weight_bound_products():
    """At B = 1 every product of both stacks splits K, so twice the SMs
    read each weight; at B = 64 the decoder's products fill the card
    unsplit."""
    for kv in ("in", "ext", ""):
        Lx = 14 if not kv else 60
        plan = _plan(1, Lx, 512, 2048, 8, 14 if kv else 0, kv)
        assert all(g.splits > 1 and g.items == g.splits * g.tiles >= 8
                   for g in plan.gemms if g is not None)
        if kv:
            big = _plan(64, 60, 512, 2048, 8, 14, kv)
            assert all(g.splits == 1 and g.items >= kern.GEMM_SMS // 2
                       for g in big.gemms if g is not None)
            assert big.workspace_floats == 0 and big.counters == 0


class _Lib:
    """Stands in for the kernels' library: records one launch's arguments
    and gives back a grid."""

    def __init__(self):
        self.args = self.scratch = None

    def _launch(self, args, at, pieces):
        # the scratch pieces' addresses, read while the wrapper holds them
        self.args = args
        ptrs = ctypes.cast(args[at], ctypes.POINTER(ctypes.c_void_p))
        self.scratch = [ptrs[i] for i in range(pieces)]
        info = ctypes.cast(args[-2], ctypes.POINTER(ctypes.c_int))
        for i, v in enumerate((5, 1, 132, kern.STACK_SMEM)):
            info[i] = v
        return 0

    def mcan_sga_decoder(self, *args):
        return self._launch(args, 14, 14)

    def mcan_sa_encoder(self, *args):
        return self._launch(args, 4, 9)


def _stacked(shapes):
    return {n: torch.zeros(s, dtype=BF16 if len(s) == 3 else torch.float32)
            for n, s in shapes.items()}


def _decoder_weights(L, D, F):
    DD = (L, D, D)
    shapes = {"wqkv1": (L, D, 3 * D), "bqkv1": (L, 3 * D), "wm1": DD,
              "wkv2": (L, D, 2 * D), "bkv2": (L, 2 * D), "wq2": DD,
              "wm2": DD, "w1": (L, D, F), "b1": (L, F), "w2": (L, F, D)}
    shapes.update({n: (L, D) for n in ("bm1", "ln1_s", "ln1_b", "bq2", "bm2",
                                       "ln2_s", "ln2_b", "b2", "ln3_s",
                                       "ln3_b")})
    return _stacked(shapes)


def _encoder_weights(L, D, F):
    shapes = {"wqkv": (L, D, 3 * D), "bqkv": (L, 3 * D), "wm": (L, D, D),
              "w1": (L, D, F), "b1": (L, F), "w2": (L, F, D)}
    shapes.update({n: (L, D) for n in ("bm", "ln1_s", "ln1_b", "b2", "ln2_s",
                                       "ln2_b")})
    return _stacked(shapes)


def _as_card(monkeypatch, lib):
    """Route the wrappers to the launch on CPU tensors: the dispatch, the
    library and the stream stubbed."""
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "_STACK_COUNTERS", {})


def _check_plan_args(plan, fields, ws, counters, scratch_last):
    assert tuple(fields) == plan.fields()
    if plan.counters:
        assert ws == scratch_last and ws is not None
        assert counters == kern._STACK_COUNTERS[torch.device("cpu")] \
            .data_ptr()
        assert kern._STACK_COUNTERS[torch.device("cpu")].numel() >= \
            plan.counters
    else:
        assert ws is None and counters is None
        assert kern._STACK_COUNTERS == {}


@pytest.mark.parametrize("B,kv,max_blocks", [(1, "in", 0), (1, "ext", 3),
                                             (64, "in", 0), (8, "ext", 0)])
def test_decoder_wrapper_launches_the_plan(monkeypatch, B, kv, max_blocks):
    L, Lv, Lq, D, F, H = 1, 60, 14, 512, 2048, 8
    lib = _Lib()
    _as_card(monkeypatch, lib)
    wp = _decoder_weights(L, D, F)
    v = torch.zeros(B, Lv, D, dtype=BF16)
    vm = torch.zeros(B, 1, 1, Lv, dtype=torch.bool)
    qm = torch.zeros(B, 1, 1, Lq, dtype=torch.bool)
    if kv == "in":
        kw = dict(q=torch.zeros(B, Lq, D, dtype=BF16))
    else:
        kw = dict(kq=torch.zeros(B, L * H, Lq, D // H, dtype=BF16),
                  vq=torch.zeros(B, L * H, Lq, D // H, dtype=BF16))
    before = kern.launch_counts().get("sga_decoder", 0)
    out = kern.sga_decoder(v, vm, qm, wp, num_heads=H,
                           max_blocks=max_blocks, **kw)
    assert kern.launch_counts()["sga_decoder"] == before + 1
    assert out.shape == v.shape and out.dtype == BF16
    a = lib.args
    plan = kern.stack_plan(B, Lv, D, F, H, Lq, kv)
    assert a[17:25] == (B, Lv, Lq, D, F, H, L, 1.0 / (D // H) ** 0.5)
    assert a[25] == kern.LN_EPS
    _check_plan_args(plan, a[26], a[27], a[28], lib.scratch[13])
    assert a[29] == max_blocks
    assert kern.LAST_GRID["sga_decoder"] == (5, 1, 132, kern.STACK_SMEM)


@pytest.mark.parametrize("B,max_blocks", [(1, 0), (9, 2), (64, 0)])
def test_encoder_wrapper_launches_the_plan(monkeypatch, B, max_blocks):
    L, Lq, D, F, H = 2, 14, 512, 2048, 8
    lib = _Lib()
    _as_card(monkeypatch, lib)
    wp = _encoder_weights(L, D, F)
    x = torch.zeros(B, Lq, D, dtype=torch.float32)
    xm = torch.zeros(B, 1, 1, Lq, dtype=torch.bool)
    out = kern.sa_encoder(x, xm, wp, num_heads=H, max_blocks=max_blocks)
    assert out.shape == x.shape and out.dtype == torch.float32
    a = lib.args
    plan = kern.stack_plan(B, Lq, D, F, H)
    assert a[7:15] == (B, Lq, D, F, H, L, 1.0 / (D // H) ** 0.5,
                       kern.LN_EPS)
    _check_plan_args(plan, a[15], a[16], a[17], lib.scratch[8])
    assert a[18] == max_blocks


def test_wrappers_refuse_unaligned_matrices(monkeypatch):
    _as_card(monkeypatch, _Lib())
    wp = _encoder_weights(1, 64, 128)
    wp["w1"] = torch.zeros(1 * 64 * 128 + 1, dtype=BF16)[1:].view(1, 64, 128)
    x = torch.zeros(2, 14, 64, dtype=BF16)
    xm = torch.zeros(2, 1, 1, 14, dtype=torch.bool)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kern.sa_encoder(x, xm, wp, num_heads=2)
