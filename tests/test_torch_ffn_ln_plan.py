"""The plans of the streaming FFN + LayerNorm kernels
(``kernels.ffn_ln_plan``: ffn_ln_blocked.cu's row blocks, clusters and F
splits; ffn_ln_wstationary.cu's F ranges and clusters) and the launch
arguments their wrappers derive from them: pure Python, milliseconds, no
card and no JAX."""

import ctypes

import pytest
import torch

from mcan_vqa_tpu_torch.ops import kernels as kern

BF16, F32 = torch.bfloat16, torch.float32
VARIANTS = kern.FFN_LN_VARIANTS
WIDTHS = list(range(128, kern.FFN_LN_MAX_WIDTH + 1, 128))
ROWS = [1, 17, 60, 61, 130, 3840]
# (M, D, F): chip_smoke.py's and the card tests' shapes -- MCAN-large at B
# = 64 and 1, a ragged 61, MCAN-small at B = 64, D 256 / 2048 and the
# parent's smallest F steps past a tile
SHAPES = [(3840, 1024, 4096), (60, 1024, 4096), (61, 1024, 4096),
          (3840, 512, 2048), (130, 256, 1024), (17, 2048, 8192),
          (60, 512, 2112)]


def _covers_once(spans, n):
    """The half-open spans partition [0, n), in order, each index once."""
    hits, last = [0] * n, 0
    for lo, hi in spans:
        assert lo == last and lo < hi
        last = hi
        for i in range(lo, hi):
            hits[i] += 1
    return last == n and all(h == 1 for h in hits)


def _step(variant, D):
    return kern.ffn_f_step(variant, D)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("M", ROWS)
def test_row_blocks_cover_every_row_once(variant, M):
    plan = kern.ffn_ln_plan(variant, M, 1024, 4096, True)
    assert plan.row_blocks == -(-M // kern.FFN_LN_ROWS)
    assert _covers_once([plan.rows(b) for b in range(plan.row_blocks)], M)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("x_f32", [True, False])
@pytest.mark.parametrize("D", WIDTHS)
def test_plan_fits_the_card_at_every_width(variant, x_f32, D):
    """A cluster of 2 to 8 CTAs whose columns cover D once, BN by width,
    a ring of 2 to 8 slots, shared memory as the instance lays it out and
    within 227 KB a block."""
    plan = kern.ffn_ln_plan(variant, 3840, D, 8 * _step(variant, D), x_f32)
    assert plan.bn == kern.ffn_ln_bn(D) and 2 <= plan.cluster <= 8
    assert plan.cluster <= kern.FFN_LN_MAX_CLUSTER
    assert _covers_once([plan.columns(r) for r in range(plan.cluster)], D)
    assert kern.FFN_MIN_STAGES <= plan.stages <= kern.FFN_MAX_STAGES
    assert plan.smem == kern.ffn_ln_smem_bytes(
        variant, x_f32, D, plan.bn, plan.cluster, plan.ts, plan.stages)
    assert plan.smem <= kern.SMEM_PER_BLOCK == 232448
    # the deepest ring that fits: one slot more would not
    if plan.stages < kern.FFN_MAX_STAGES:
        assert kern.ffn_ln_smem_bytes(
            variant, x_f32, D, plan.bn, plan.cluster, plan.ts,
            plan.stages + 1) > kern.SMEM_PER_BLOCK


@pytest.mark.parametrize("M,D,F", SHAPES)
@pytest.mark.parametrize("cap", [0, 1, 3, 7, 15])
def test_weight_stationary_clusters_hold_each_f_slice_once(M, D, F, cap):
    """Each F range belongs to one cluster, which walks its ranges in
    order; the ranks' TS-wide slices of all ranges cover F once (past F:
    TMA's zero fill); a cap on the clusters changes nothing else."""
    plan = kern.ffn_ln_plan("wstationary", M, D, F, True, cap)
    assert plan.ts == kern.FFN_WS_TS[plan.bn]
    assert plan.f_width == plan.cluster * plan.ts
    assert plan.f_steps == -(-F // plan.f_width)
    owned = sorted(g for k in range(plan.clusters) for g in plan.ranges_of(k))
    assert owned == list(range(plan.f_steps))
    for k in range(plan.clusters):
        assert plan.ranges_of(k) == sorted(plan.ranges_of(k))
    slices = [(g * plan.f_width + r * plan.ts,
               min(F, g * plan.f_width + (r + 1) * plan.ts))
              for g in range(plan.f_steps) for r in range(plan.cluster)
              if g * plan.f_width + r * plan.ts < F]
    assert _covers_once(slices, F)
    assert _covers_once([plan.f_range(g) for g in range(plan.f_steps)], F)
    assert 1 <= plan.clusters <= (cap or kern.GEMM_SMS // plan.cluster)
    assert plan.grid == plan.cluster * plan.clusters
    free = kern.ffn_ln_plan("wstationary", M, D, F, True)
    assert plan.fields()[:5] == free.fields()[:5]
    assert (plan.stages, plan.smem) == (free.stages, free.smem)
    assert plan.flags == plan.row_blocks * plan.cluster


@pytest.mark.parametrize("M,D,F", SHAPES)
def test_blocked_split_covers_f_in_order(M, D, F):
    """The F tiles of 64 hidden units a rank; at small M split into ranges
    that cover F in order, one cluster each (at most one range an F tile);
    the grid is a cluster per row block and range."""
    plan = kern.ffn_ln_plan("blocked", M, D, F, True)
    assert plan.f_width == kern.FFN_LN_ROWS * plan.cluster
    assert plan.f_steps == -(-F // plan.f_width)
    assert 1 <= plan.splits <= plan.f_steps
    assert _covers_once([plan.f_range(s) for s in range(plan.splits)], F)
    assert plan.clusters == plan.row_blocks * plan.splits
    assert plan.grid == plan.cluster * plan.clusters
    assert plan.workspace_floats == (
        0 if plan.splits == 1 else
        plan.splits * plan.row_blocks * plan.cluster * 64 * plan.bn)


def test_blocked_splits_only_where_the_card_is_idle():
    """MCAN-large B=64 (60 row blocks of 8 CTAs) walks all of F in each
    cluster; B=1 (one row block) splits F into 8 ranges, 64 CTAs; a split
    range holds at least one F tile."""
    big = kern.ffn_ln_plan("blocked", 3840, 1024, 4096, True)
    assert (big.splits, big.grid) == (1, 480)
    one = kern.ffn_ln_plan("blocked", 60, 1024, 4096, True)
    assert (one.splits, one.grid) == (8, 64)
    small = kern.ffn_ln_plan("blocked", 17, 2048, 8192, True)
    assert small.splits == 16 and small.grid <= kern.GEMM_SMS


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("D", WIDTHS)
def test_every_width_and_f_step_the_parent_took_is_taken(variant, D):
    step = _step(variant, D)
    assert step == {"blocked": (64, 128, 256),
                    "wstationary": (32, 32, 16)}[variant][
        0 if D <= 512 else 1 if D <= 1024 else 2]
    for F in (step, 3 * step, 33 * step):
        plan = kern.ffn_ln_plan(variant, 5, D, F, False)
        assert plan.f_steps * plan.f_width >= F


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("D,F", [(96, 512), (4096, 4096), (640, 0),
                                 (1024, 4100), (2048, 8200)])
def test_plan_refuses_shapes_past_the_contract(variant, D, F):
    with pytest.raises(ValueError, match=f"D={D}, F={F}"):
        kern.ffn_ln_plan(variant, 64, D, F, True)


def test_plan_depends_on_the_shape_alone():
    a = kern.ffn_ln_plan("blocked", 3840, 1024, 4096, True)
    kern.ffn_ln_plan.cache_clear()
    assert kern.ffn_ln_plan("blocked", 3840, 1024, 4096, True) == a
    assert kern.ffn_ln_plan("blocked", 3840, 1024, 4096, False).stages \
        > a.stages


class _Lib:
    """Stands in for the kernels' library: records one launch's arguments
    and reports a card that holds `fit` clusters."""

    def __init__(self, fit=15):
        self.args, self.fit, self.queries = None, fit, []

    def mcan_ffn_ln_blocked(self, *args):
        self.args = args
        return 0

    def mcan_ffn_ln_wstationary(self, *args):
        self.args = args
        info = (ctypes.c_int * 4).from_address(args[-2])
        plan = list(args[14])
        info[0], info[1], info[2], info[3] = plan[7], plan[6], self.fit, \
            plan[9]
        return 0

    def mcan_ffn_ln_wstationary_max_clusters(self, *args):
        self.queries.append(args)
        return self.fit


def _stub(monkeypatch, fit=15):
    lib = _Lib(fit)
    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    monkeypatch.setattr(kern, "_FFN_FIT", {})
    return lib


def _operands(M, D, F, x_dtype):
    return (torch.zeros(M, D, dtype=x_dtype), torch.zeros(D, F, dtype=BF16),
            torch.zeros(F), torch.zeros(F, D, dtype=BF16), torch.zeros(D),
            torch.ones(D), torch.zeros(D))


@pytest.mark.parametrize("M,D,F,x_dtype", [(3840, 1024, 4096, F32),
                                           (60, 1024, 4096, F32),
                                           (61, 512, 2112, BF16)])
def test_blocked_wrapper_launches_the_plan(monkeypatch, M, D, F, x_dtype):
    """The operands, the dtype flag, an f32 output, the split workspace and
    the row-block counters only where the plan splits, and the plan's
    fields in mcan_ffn_ln_blocked's order."""
    lib = _stub(monkeypatch)
    ops = _operands(M, D, F, x_dtype)
    out = kern.ffn_ln_blocked(*ops)
    assert out.shape == (M, D) and out.dtype == F32
    (px, x_f32, pw1, pb1, pw2, pb2, pg, pbe, po, ws, counters, m, d, f, eps,
     fields, n, stream) = lib.args
    plan = kern.ffn_ln_plan("blocked", M, D, F, x_dtype == F32)
    x, w1, b1, w2, b2, gamma, beta = ops
    assert (px, x_f32, pw1, pb1, pw2, pb2, pg, pbe, po) == (
        x.data_ptr(), int(x_dtype == F32), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr())
    assert (m, d, f, eps, stream) == (M, D, F, kern.LN_EPS, 0)
    assert tuple(fields) == plan.fields() and n == len(plan.fields()) == 9
    assert plan.fields() == (plan.bn, plan.cluster, plan.f_width,
                             plan.f_steps, plan.splits, plan.row_blocks,
                             plan.grid, plan.stages, plan.smem)
    assert (ws is None) == (counters is None) == (plan.splits == 1)


@pytest.mark.parametrize("M,D,F,max_clusters,fit", [
    (3840, 1024, 4096, 0, 15), (60, 1024, 4096, 3, 15),
    (130, 256, 1024, 0, 62), (17, 2048, 8208, 20, 15)])
def test_wstationary_wrapper_launches_the_plan(monkeypatch, M, D, F,
                                               max_clusters, fit):
    """The card's capacity is asked once per instance; the clusters are the
    least of the ranges, the card's and the caller's cap; the flags are
    zeroed, one a row tile and rank; LAST_GRID reports the launch."""
    lib = _stub(monkeypatch, fit)
    ops = _operands(M, D, F, F32)
    kern.ffn_ln_wstationary(*ops, max_clusters=max_clusters)
    out = kern.ffn_ln_wstationary(*ops, max_clusters=max_clusters)
    assert out.shape == (M, D) and out.dtype == F32
    assert len(lib.queries) == 1
    cap = min(fit, max_clusters) if max_clusters else fit
    plan = kern.ffn_ln_plan("wstationary", M, D, F, True, cap)
    assert plan.clusters == min(plan.f_steps, cap,
                                kern.GEMM_SMS // plan.cluster)
    assert lib.queries[0] == (1, plan.bn, plan.ts, plan.cluster, plan.smem)
    (px, x_f32, _, _, _, _, _, _, po, flags, m, d, f, eps, fields, n, info,
     stream) = lib.args
    assert (px, x_f32, po, m, d, f, eps, stream) == (
        ops[0].data_ptr(), 1, out.data_ptr(), M, D, F, kern.LN_EPS, 0)
    assert tuple(fields) == plan.fields() and n == 10
    assert plan.fields() == (plan.bn, plan.cluster, plan.f_width,
                             plan.f_steps, plan.ts, plan.row_blocks,
                             plan.clusters, plan.grid, plan.stages,
                             plan.smem)
    assert kern.LAST_GRID["ffn_ln_wstationary"] == (
        plan.grid, plan.clusters, fit, plan.smem)


@pytest.mark.parametrize("variant", ["ffn_ln_blocked", "ffn_ln_wstationary"])
def test_wrappers_refuse_before_any_launch(monkeypatch, variant):
    monkeypatch.setattr(kern, "_lib", lambda: pytest.fail("launched"))
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    with pytest.raises(ValueError, match="F step"):
        getattr(kern, variant)(*_operands(8, 1024, 4100, F32))
    with pytest.raises(ValueError, match="multiple of 128"):
        getattr(kern, variant)(*_operands(8, 96, 512, F32))
