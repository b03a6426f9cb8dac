"""The plan of the column sums (``kernels.col_sum_plan``: 128-column chunks
x row slabs, summed in a fixed order) and the launch arguments ``col_sum``
derives from it: pure Python, milliseconds, no card and no JAX."""

import ctypes

import pytest
import torch

from mcan_vqa_tpu_torch.ops import kernels as kern

BF16 = torch.bfloat16

# (rows, widths): the three SGA sums and the two SA sums of the MCAN-small
# B=64 step (decoder 3840 rows, encoder 896; D 512, F 2048), MCAN-large's
# per micro-batch of 32 (1920 rows; D 1024, F 4096), then ragged rows (1,
# 7, counts no slab divides) and matrices narrower than one chunk
MAIN_PATH = [(3840, (2048, 512, 512, 512)), (3840, (512, 512, 512, 512)),
             (3840, (1536, 512, 512, 512)), (896, (1536, 512, 512, 512)),
             (896, (2048, 512, 512, 512)), (1920, (4096, 1024, 1024, 1024)),
             (1920, (1024, 1024, 1024, 1024)),
             (1920, (3072, 1024, 1024, 1024))]
EDGES = [(1, (512, 7)), (7, (2048, 100)), (3841, (512, 24, 1536, 5)),
         (1000, (96, 40, 8, 3)), (64, (512,)), (65, (4096,)),
         (127, (1, 1, 1, 1)), (100000, (8,))]
SHAPES = MAIN_PATH + EDGES


@pytest.mark.parametrize("rows,cols", SHAPES)
def test_every_row_of_every_column_is_summed_once(rows, cols):
    plan = kern.col_sum_plan(rows, cols)
    assert plan.chunk == 128 and plan.rows == rows
    # the chunks cover each matrix's columns once
    assert plan.chunks == tuple(-(-c // 128) for c in cols)
    for c, n in zip(cols, plan.chunks):
        assert (n - 1) * plan.chunk < c <= n * plan.chunk
    # the slabs cover the rows once, in order, none empty
    ranges = [plan.slab_range(s) for s in range(plan.slabs)]
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    for (_, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(e > b for b, e in ranges)
    assert [r for b, e in ranges for r in range(b, e)] == list(range(rows))


@pytest.mark.parametrize("rows,cols", SHAPES)
def test_slabs_fill_the_card_and_keep_their_rows(rows, cols):
    plan = kern.col_sum_plan(rows, cols)
    assert plan.grid == plan.total_chunks * plan.slabs
    assert 1 <= plan.slabs <= max(1, rows // kern.COL_SUM_MIN_ROWS)
    # one wave: no more blocks than the SMs hold at once (four an SM), and
    # as many as fit where the rows allow it
    assert plan.grid <= kern.COL_SUM_ITEMS or plan.slabs == 1
    assert plan.grid + plan.total_chunks > kern.COL_SUM_ITEMS \
        or plan.slabs == max(1, rows // kern.COL_SUM_MIN_ROWS)


@pytest.mark.parametrize("rows,cols", SHAPES)
def test_workspace_holds_every_slab_of_every_chunk(rows, cols):
    plan = kern.col_sum_plan(rows, cols)
    if plan.slabs == 1:
        assert plan.workspace_bytes == 0
    else:
        assert plan.workspace_bytes == (plan.total_chunks * plan.slabs
                                        * plan.chunk * 4)


def test_plan_depends_on_the_shape_alone():
    first = [kern.col_sum_plan(*s) for s in SHAPES]
    assert [kern.col_sum_plan(*s) for s in reversed(SHAPES)] == first[::-1]
    # pinned at the MCAN-small step and MCAN-large's micro-batch
    pins = {(3840, (2048, 512, 512, 512)): (28, 18),
            (3840, (512, 512, 512, 512)): (16, 33),
            (3840, (1536, 512, 512, 512)): (24, 22),
            (896, (1536, 512, 512, 512)): (24, 14),
            (1920, (4096, 1024, 1024, 1024)): (56, 9),
            (7, (2048, 100)): (17, 1)}
    for shape, (chunks, slabs) in pins.items():
        plan = kern.col_sum_plan(*shape)
        assert (plan.total_chunks, plan.slabs) == (chunks, slabs), shape


class _Lib:
    """Stands in for the kernels' library: decodes one col_sum launch's
    arrays while they are alive."""

    def __init__(self):
        self.args = None

    def mcan_col_sum(self, n, srcs, bf16s, lds, cols, dsts, rows, slabs, ws,
                     counters, stream):
        def read(p, ctype):
            return list(ctypes.cast(p, ctypes.POINTER(ctype))[:n])
        self.args = dict(
            n=n, srcs=read(srcs, ctypes.c_void_p),
            bf16s=read(bf16s, ctypes.c_int), lds=read(lds, ctypes.c_longlong),
            cols=read(cols, ctypes.c_int), dsts=read(dsts, ctypes.c_void_p),
            rows=rows, slabs=slabs, ws=ws, counters=counters)
        return 0


@pytest.mark.parametrize("rows,cols,dtypes", [
    (3840, (2048, 512, 512, 512), (torch.float32,) * 4),
    (1920, (3072, 1024, 1024, 1024), (torch.float32,) * 3 + (BF16,)),
    (7, (2048, 100), (torch.float32, BF16)),
    (3841, (512, 24, 1536, 5), (torch.float32, torch.float32, BF16, BF16))])
def test_wrapper_launches_the_plan_with_its_workspace(monkeypatch, rows, cols,
                                                      dtypes):
    lib, made = _Lib(), []
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    monkeypatch.setattr(kern, "_COL_SUM_COUNTERS", {})
    # the last matrix a column slice of a wider one (row stride > width)
    mats = [torch.zeros(rows, c, dtype=dt) for c, dt in zip(cols, dtypes)]
    mats[-1] = torch.zeros(rows, cols[-1] + 16, dtype=dtypes[-1])[:, 3:3 + cols[-1]]
    monkeypatch.setattr(kern.torch, "empty", record_empty)
    before = kern.launch_counts().get("col_sum", 0)
    outs = kern.col_sum(mats)
    plan = kern.col_sum_plan(rows, cols)
    assert kern.launch_counts()["col_sum"] == before + 1
    assert [o.shape for o in outs] == [(c,) for c in cols]
    assert all(o.dtype == torch.float32 for o in outs)
    a = lib.args
    assert (a["n"], a["rows"], a["slabs"]) == (len(cols), rows, plan.slabs)
    assert a["srcs"] == [m.data_ptr() for m in mats]
    assert a["bf16s"] == [int(dt == BF16) for dt in dtypes]
    assert a["lds"] == [m.stride(0) for m in mats]
    assert a["lds"][-1] == cols[-1] + 16
    assert a["cols"] == list(cols)
    assert a["dsts"] == [o.data_ptr() for o in outs]
    if plan.slabs == 1:
        assert a["ws"] is None and a["counters"] is None
        assert made == outs
    else:
        ws = [t for t in made if t.data_ptr() == a["ws"]][0]
        assert ws.numel() * ws.element_size() == plan.workspace_bytes
        cnt = kern._COL_SUM_COUNTERS[mats[0].device]
        assert a["counters"] == cnt.data_ptr()
        assert cnt.numel() >= plan.total_chunks and not cnt.any()
        # its own counters: a split GEMM's are another buffer
        assert cnt is not kern._SPLIT_COUNTERS.get(mats[0].device)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(kern, "_lib", lambda: pytest.fail("launched"))
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    m = torch.zeros(64, 512)
    with pytest.raises(ValueError, match="1 to 4"):
        kern.col_sum([m] * 5)
    with pytest.raises(ValueError, match="unit column stride"):
        kern.col_sum([m, torch.zeros(512, 64).t()])
    with pytest.raises(ValueError, match="64 rows"):
        kern.col_sum([m, torch.zeros(63, 512)])
    with pytest.raises(ValueError, match="f32 or bf16"):
        kern.col_sum([m.half()])
