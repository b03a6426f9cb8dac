"""The plan of csrc/prng_masks.cu (``kernels.prng_plan``): every row's
chunks drawn exactly once by the grid-stride walk the kernel runs, the
store widths, one wave within the card's limits, the magic division, the
refusals, and the launch arguments the wrappers derive from it through a
stub library -- pure Python, milliseconds, no card and no JAX."""

import collections
import itertools
import types

import pytest
import torch

from mcan_vqa_tpu_torch.ops import kernels as kern

SMS = 132
MAX_THREADS_PER_SM = 2048       # an H100 SM's resident threads
# (heads, n) of each site of one block (sga_train.mask_shapes /
# sa_train.mask_shapes): MCAN-small's SGA and SA blocks, MCAN-large's SGA
SGA_SMALL = ((8, 3600), (8, 840), (1, 30720), (1, 30720), (1, 122880),
             (1, 30720))
SA_SMALL = ((8, 196), (1, 7168), (1, 28672), (1, 7168))
SGA_LARGE = ((8, 3600), (8, 840), (1, 61440), (1, 61440), (1, 245760),
             (1, 61440))
# small enough to enumerate: n 1, 3, 4, 5, 840, 3600, 4099, 122880; heads
# 1, 8, 16; 1 to 6 sites of unequal sizes
SMALL = [
    (3, ((1, 1),)),
    (2, ((1, 3), (8, 4), (16, 5))),
    (5, ((8, 840),)),
    (2, ((8, 3600), (8, 840), (1, 4099))),
    (2, ((1, 122880),)),
    (1, ((16, 5), (1, 4099), (8, 840), (1, 1), (8, 3600), (1, 3))),
    (3, ((1, 4), (16, 1), (1, 5), (8, 3), (1, 840))),
    (4, ((8, 0), (1, 5), (0, 840), (1, 3)))]


def _sites(sites, elem_bytes):
    """The masks' sites, or philox_words' one site of one head (the first
    n > 0)."""
    return sites if elem_bytes == 1 else \
        tuple((1, n) for _, n in sites if n)[:1]


def _chunks_drawn(plan):
    """(site, sample, head, chunk of the row) -> how many threads draw it,
    over every thread of the grid."""
    hits = collections.Counter()
    for t in range(plan.grid * plan.threads):
        for b, j in plan.walk(t):
            s, h, c = plan.locate(j)
            hits[s, b, h, c] += 1
    return hits


@pytest.mark.parametrize("elem_bytes", [1, 4])
@pytest.mark.parametrize("sms", [1, 3, SMS])
@pytest.mark.parametrize("B,sites", SMALL)
def test_every_element_falls_in_exactly_one_drawn_chunk(B, sites, sms,
                                                        elem_bytes):
    """Each (site, sample, head, chunk) is drawn once, and a row's chunks
    0 .. per_row - 1 cover its n elements (16 keep bytes or 4 words each,
    the last cut at n): so every element of every row is written by
    exactly one thread."""
    sites = _sites(sites, elem_bytes)
    plan = kern.prng_plan(B, sites, sms, elem_bytes)
    hits = _chunks_drawn(plan)
    want = {(s, b, h, c) for s, (heads, n) in enumerate(sites)
            for b in range(B) for h in range(heads)
            for c in range(plan.per_row[s])}
    assert set(hits) == want and set(hits.values()) <= {1}
    for (heads, n), per_row in zip(sites, plan.per_row):
        assert (per_row - 1) * plan.chunk < n <= per_row * plan.chunk \
            or n == 0
    assert plan.chunk * elem_bytes == kern.PRNG_CHUNK_BYTES


@pytest.mark.parametrize("B,sites", SMALL)
def test_the_walk_is_the_flat_grid_stride(B, sites):
    """The kernel's one division and carries step thread t through chunks
    t, t + S, t + 2S, ... of the samples laid end to end (S = grid x
    threads)."""
    plan = kern.prng_plan(B, sites, 1)
    S = plan.grid * plan.threads
    for t in range(S):
        assert list(plan.walk(t)) == [divmod(g, plan.per_sample)
                                      for g in range(t, plan.chunks, S)]


@pytest.mark.parametrize("B,sites", [(65537, ((1, 5),)),
                                     (65537, SGA_SMALL), (32, SGA_LARGE),
                                     (65537, SGA_LARGE), (64, SA_SMALL)])
def test_large_calls_through_the_prefixes_and_the_grid(B, sites):
    """B past 65,535 and MCAN-large without enumerating: the prefixes, the
    stride, the first steps and the last chunk of the walk, and the
    magic division at every site's edges."""
    plan = kern.prng_plan(B, sites, SMS)
    rows = [h * r for (h, _), r in zip(sites, plan.per_row)]
    assert plan.first == tuple(itertools.accumulate([0] + rows[:-1]))
    assert plan.per_sample == sum(rows) < 1 << 32
    S = plan.grid * plan.threads
    step_b, step_j = plan.step
    assert step_b * plan.per_sample + step_j == S and step_j < plan.per_sample
    for t in (0, 1, S // 2, S - 1):
        got = list(itertools.islice(plan.walk(t), 5))
        assert got == [divmod(g, plan.per_sample)
                       for g in range(t, plan.chunks, S)][:5]
    last = plan.chunks - 1
    assert list(plan.walk(last % S))[-1] == divmod(last, plan.per_sample)
    for s, (heads, n) in enumerate(sites):
        for q in {0, plan.per_row[s] - 1, plan.per_row[s],
                  heads * plan.per_row[s] - 1}:
            if 0 <= q < heads * plan.per_row[s]:
                assert plan.locate(plan.first[s] + q) == (
                    s, q // plan.per_row[s], q % plan.per_row[s])


@pytest.mark.parametrize("B,sites", SMALL + [
    (64, SGA_SMALL), (64, SA_SMALL), (32, SGA_LARGE), (65537, ((1, 5),))])
@pytest.mark.parametrize("elem_bytes", [1, 4])
def test_store_width_divides_every_row_and_chunk(B, sites, elem_bytes):
    """A site's stores of width w land w-aligned: w divides the row's
    bytes (so every row offset), the chunk's 16 bytes and the last
    chunk's remainder; it is the widest such of 16, 8, 4, 2, 1."""
    sites = _sites(sites, elem_bytes)
    plan = kern.prng_plan(B, sites, SMS, elem_bytes)
    for (heads, n), w in zip(sites, plan.width):
        row = n * elem_bytes
        assert w in (1, 2, 4, 8, 16) and row % w == 0
        assert kern.PRNG_CHUNK_BYTES % w == 0
        assert (row % kern.PRNG_CHUNK_BYTES) % w == 0
        assert w == 16 or row % (2 * w) != 0


def test_the_mcan_sites_store_widths():
    assert kern.prng_plan(64, SGA_SMALL, SMS).width == (16, 8, 16, 16, 16,
                                                        16)
    assert kern.prng_plan(64, SA_SMALL, SMS).width == (4, 16, 16, 16)
    assert [kern.prng_plan(2, ((1, n),), SMS, 4).width[0]
            for n in (1, 5, 842, 4099, 131072)] == [4, 4, 8, 4, 16]


@pytest.mark.parametrize("B,sites", SMALL + [
    (64, SGA_SMALL), (64, SA_SMALL), (32, SGA_LARGE), (65537, ((1, 5),)),
    (65537, SGA_LARGE)])
def test_the_grid_is_one_wave_within_the_card(B, sites):
    """At 132 SMs: at most PRNG_BLOCKS_PER_SM CTAs an SM, within an SM's
    resident threads, and no CTA without a chunk."""
    plan = kern.prng_plan(B, sites, SMS)
    assert 1 <= plan.grid <= SMS * kern.PRNG_BLOCKS_PER_SM
    assert plan.threads * kern.PRNG_BLOCKS_PER_SM <= MAX_THREADS_PER_SM
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert (plan.grid - 1) * plan.threads < plan.chunks
    assert plan.grid * plan.threads < 1 << 31


def test_the_mcan_small_unit():
    """One SGA block at B = 64: the full wave, 16,035,840 keep bytes from
    4,008,960 counters (the bound's count), 1,002,496 chunks (att2's rows
    end in a half chunk)."""
    plan = kern.prng_plan(64, SGA_SMALL, SMS)
    assert plan.grid == SMS * kern.PRNG_BLOCKS_PER_SM
    assert (plan.out_bytes, plan.counters, plan.chunks) == (
        16035840, 4008960, 1002496)


def test_the_words_unit():
    """philox_words on 16 x 2^17: a counter a chunk (one 16-byte store),
    524,288 chunks over the full wave."""
    plan = kern.prng_plan(16, ((1, 1 << 17),), SMS, 4)
    assert (plan.chunk, plan.width, plan.grid) == (4, (16,), 528)
    assert (plan.chunks, plan.counters, plan.out_bytes) == (
        524288, 524288, 8388608)


def test_the_magic_division():
    """q // d for every q < 2^12 and d < 300, and at the 32-bit edges."""
    for d in range(1, 300):
        m = kern._magic(d)
        assert all(kern._fast_div(q, *m) == q // d for q in range(1 << 12))
    for d in (7680, 15360, 225, 53, (1 << 31) - 1, 1 << 31, (1 << 32) - 1):
        m = kern._magic(d)
        assert m[0] < 1 << 32
        for q in (0, d - 1, d, d + 1, (1 << 31) - 1, (1 << 32) - 1):
            if q < 1 << 32:
                assert kern._fast_div(q, *m) == q // d


@pytest.mark.parametrize("sites", [(), ((1, 4),) * 7])
def test_prng_plan_refuses_0_and_7_sites(sites):
    with pytest.raises(ValueError, match="1 to 6 sites"):
        kern.prng_plan(4, sites, SMS)


@pytest.mark.parametrize("B,sites", [(0, ((1, 4),)), (1 << 31, ((1, 4),)),
                                     (2, ((0, 4), (1, 0))),
                                     (1, ((1 << 16, (1 << 31) - 1),))])
def test_prng_plan_refuses_what_the_kernel_cannot_index(B, sites):
    with pytest.raises(ValueError, match="prng_plan"):
        kern.prng_plan(B, sites, SMS)


def test_prng_plan_depends_on_the_shapes_alone():
    a = kern.prng_plan(64, SGA_SMALL, SMS)
    kern.prng_plan.cache_clear()
    assert kern.prng_plan(64, SGA_SMALL, SMS) == a
    assert kern.prng_plan(64, SGA_SMALL, 114).grid == 114 * 4


def test_the_fields_are_the_c_entries_layout():
    plan = kern.prng_plan(3, ((8, 840), (1, 5)), SMS)
    f = plan.fields()
    assert len(f) == 7 + 6 * 2 and all(0 <= v < 1 << 32 for v in f)
    assert f[:7] == (2, 3, plan.per_sample, plan.grid, 256, *plan.step)
    assert f[7:13] == (0, 53, *kern._magic(53), 8)
    assert f[13:] == (8 * 53, 1, *kern._magic(1), 1)


# ---------------------------------------------------------------------------
# the wrappers' launch arguments, through a stub library
# ---------------------------------------------------------------------------

class _Lib:
    """Stands in for the kernels' library: records each launch."""

    def __init__(self):
        self.calls = []

    def mcan_prng_masks(self, *args):
        self.calls.append(("masks", args))
        return 0

    def mcan_philox_words(self, *args):
        self.calls.append(("words", args))
        return 0


def _stub(monkeypatch):
    lib = _Lib()
    empty = torch.empty

    def cpu_empty(*shape, device=None, **kw):
        return empty(*shape, **kw)

    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern.torch, "empty", cpu_empty)
    monkeypatch.setattr(kern.torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return lib


def _fields(arr, count):
    return tuple(arr[i] for i in range(count))


def test_dump_wrapper_launches_the_plan(monkeypatch):
    lib = _stub(monkeypatch)
    sites = [(0x100, 2, 36), (0x200, 1, 840), (0x303, 1, 5)]
    before = kern.LAUNCHES["dump_prng_masks"]
    outs = kern.dump_prng_masks(12, 345, 65537, sites, "cuda")
    assert [tuple(o.shape) for o in outs] == [(65537, 2, 36),
                                              (65537, 1, 840), (65537, 1, 5)]
    assert all(o.dtype == torch.uint8 for o in outs)
    (kind, args), = lib.calls
    plan = kern.prng_plan(65537, ((2, 36), (1, 840), (1, 5)), SMS)
    assert kind == "masks" and args[0] == 3 and args[5:8] == (65537, 12, 345)
    assert _fields(args[8], args[9]) == plan.fields() and args[10] == 7
    assert kern.LAST_GRID["dump_prng_masks"] == (plan.grid, 4, SMS, 0)
    assert kern.LAUNCHES["dump_prng_masks"] == before + 1


def test_words_wrapper_launches_the_plan(monkeypatch):
    lib = _stub(monkeypatch)
    out = kern.philox_words(9, 0x303, 5, 842, "cuda")
    assert tuple(out.shape) == (5, 842) and out.dtype == torch.int64
    (kind, args), = lib.calls
    plan = kern.prng_plan(5, ((1, 842),), SMS, 4)
    assert kind == "words" and args[:4] == (9, 0x303, 5, 842)
    assert _fields(args[5], args[6]) == plan.fields() and args[7] == 7
    assert plan.width == (8,)
    assert kern.philox_words(9, 0x303, 5, 842, "cuda", raw=True).dtype == \
        torch.uint32


@pytest.mark.parametrize("B,sites", [(0, [(0x100, 8, 60)]),
                                     (4, [(0x100, 0, 60), (0x200, 8, 0)])])
def test_nothing_to_draw_launches_nothing(monkeypatch, B, sites):
    lib = _stub(monkeypatch)
    outs = kern.dump_prng_masks(1, 2, B, sites, "cuda")
    assert [tuple(o.shape) for o in outs] == [(B, h, n) for _, h, n in sites]
    assert kern.philox_words(1, 2, B, 0, "cuda").shape == (B, 0)
    assert lib.calls == []


@pytest.mark.parametrize("k", [0, 7])
def test_dump_wrapper_refuses_0_and_7_sites(monkeypatch, k):
    lib = _stub(monkeypatch)
    with pytest.raises(ValueError, match="1 to 6 sites"):
        kern.dump_prng_masks(1, 2, 4, [(0x100, 1, 4)] * k, "cuda")
    assert lib.calls == []
