"""The plans of the per-sub-op path's two kernels (``kernels.gemm_ln_plan``:
gemm_ln.cu's row blocks, clusters and instances; ``kernels.attflat_plan``:
attflat_pool.cu's CTAs a sample) and the launch arguments their wrappers
derive from them: pure Python, milliseconds, no card and no JAX."""

import pytest
import torch

from mcan_vqa_tpu_torch.ops import kernels as kern

BF16, F32 = torch.bfloat16, torch.float32
SMS = kern.GEMM_SMS
SMEM_PER_SM = 233472      # an H100 SM's shared memory (228 KB), 1 KB of it
#                           reserved for each resident block

# (M, K, D, f32 a): every gemm_ln shape of chip_smoke.py's per-sub-op cases
# and of the card tests -- MCAN-small's mode-0 sites at B = 64 (decoder
# 3840 rows, encoder 896: the merges read the f32 attention output, the
# FFNs the bf16 hidden) and B = 1 (60, 14), D 1024 / 1536 / 2048 (the wide
# Predictors at B = 8: 480 rows), hidden 480 at 61 rows -- then M 0, 1, 61
# and 3841, D 8 and 72, K 40 and 8192
M0 = [(3840, 512, 512, True), (896, 512, 512, True),
      (3840, 2048, 512, False), (896, 2048, 512, False)]
SHAPES = M0 + [
    (60, 512, 512, True), (14, 512, 512, True), (60, 2048, 512, False),
    (14, 2048, 512, False), (1920, 1024, 1024, True),
    (1920, 4096, 1024, False), (480, 1536, 1536, True),
    (480, 6144, 1536, False), (480, 2048, 2048, True),
    (480, 8192, 2048, False), (112, 2048, 2048, True),
    (112, 8192, 2048, False), (61, 480, 480, True), (61, 512, 480, True),
    (14, 1536, 1536, True), (130, 8192, 2048, False), (1, 1024, 1024, False),
    (77, 40, 72, False), (0, 512, 512, True), (1, 512, 8, True),
    (14, 40, 8, False), (3841, 512, 512, True), (3841, 2048, 512, False)]


def _covers_once(spans, n):
    """The half-open spans partition [0, n): each index in exactly one."""
    hits = [0] * n
    for lo, hi in spans:
        assert lo < hi or n == 0
        for i in range(lo, hi):
            hits[i] += 1
    return all(h == 1 for h in hits)


@pytest.mark.parametrize("M,K,D,a_f32", SHAPES)
def test_gemm_ln_plan_covers_every_row_and_column_once(M, K, D, a_f32):
    plan = kern.gemm_ln_plan(M, K, D, a_f32)
    assert _covers_once([plan.columns(r) for r in range(plan.cluster)], D)
    assert _covers_once([plan.rows(b) for b in range(plan.row_blocks)], M)
    assert plan.grid == plan.cluster * plan.row_blocks
    assert plan.k_tiles * kern.GEMM_BK >= K > (plan.k_tiles - 1) * \
        kern.GEMM_BK


@pytest.mark.parametrize("M,K,D,a_f32", SHAPES)
def test_gemm_ln_plan_fits_the_card(M, K, D, a_f32):
    """A cluster within the portable size, an instance that exists, its
    stages and shared memory as the instance's, at most 227 KB a block (two
    of 64 x 128 on one SM)."""
    plan = kern.gemm_ln_plan(M, K, D, a_f32)
    assert 1 <= plan.cluster <= kern.GEMM_LN_MAX_CLUSTER
    assert (plan.bm, plan.bn) in kern.GEMM_LN_TILES
    assert plan.stages == kern.GEMM_LN_STAGES[plan.bm, plan.bn][a_f32]
    assert plan.smem == kern.gemm_ln_smem_bytes(a_f32, plan.bm, plan.bn)
    assert plan.smem <= kern.SMEM_PER_BLOCK
    if (plan.bm, plan.bn) == (64, 128):
        assert 2 * (plan.smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("M,K,D,a_f32", M0)
def test_gemm_ln_plan_spreads_the_mode0_sites_over_the_card(M, K, D, a_f32):
    """Each B=64 MCAN-small site launches at least 100 CTAs (the parent's
    design: 120 blocks at the decoder, 28 at the encoder): the decoder 120
    of 128 x 128 in clusters of 4, the encoder 112 of 64 x 64 in clusters
    of 8."""
    plan = kern.gemm_ln_plan(M, K, D, a_f32)
    assert plan.grid >= 100
    assert (plan.bm, plan.bn, plan.cluster, plan.grid) == (
        (128, 128, 4, 120) if M == 3840 else (64, 64, 8, 112))


def test_gemm_ln_plan_picks_each_instance_by_the_rule():
    """128 x 128 where it gives 90% of the SMs a CTA; else the widest
    64-row tile that covers the SMs, else the narrowest; D past 1024 at
    256 columns (a cluster of at most 8)."""
    pins = {(3840, 512, 512): (128, 128), (1920, 1024, 1024): (128, 128),
            (896, 512, 512): (64, 64), (60, 2048, 512): (64, 64),
            (2304, 512, 512): (64, 128), (480, 1536, 1536): (64, 256),
            (480, 8192, 2048): (64, 256), (8000, 512, 2048): (64, 256),
            (77, 40, 72): (64, 64)}
    for (M, K, D), tile in pins.items():
        plan = kern.gemm_ln_plan(M, K, D, True)
        assert (plan.bm, plan.bn) == tile, (M, K, D)


@pytest.mark.parametrize("K,D", [(512, 4096), (512, 100), (512, 0),
                                 (100, 512), (0, 512), (512, 2056)])
def test_gemm_ln_plan_refuses_shapes_past_the_contract(K, D):
    with pytest.raises(ValueError, match=f"K={K} and D={D}"):
        kern.gemm_ln_plan(64, K, D, True)


def test_gemm_ln_plan_depends_on_the_shape_alone():
    a = kern.gemm_ln_plan(3840, 512, 512, True)
    kern.gemm_ln_plan.cache_clear()
    assert kern.gemm_ln_plan(3840, 512, 512, True) == a
    assert kern.gemm_ln_plan(3840, 512, 512, False).stages != a.stages


class _Lib:
    """Stands in for the kernels' library: records one launch's arguments."""

    def __init__(self):
        self.args = None

    def mcan_gemm_ln(self, *args):
        self.args = args
        return 0

    def mcan_attflat_pool(self, *args):
        self.args = args
        return 0


def _stub(monkeypatch, made):
    lib = _Lib()
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    monkeypatch.setattr(kern.torch, "empty", record_empty)
    return lib


@pytest.mark.parametrize("M,K,D,a_dtype,res_dtype,bias", [
    (3840, 512, 512, F32, BF16, True), (896, 2048, 512, BF16, BF16, True),
    (61, 512, 480, F32, F32, False), (14, 1536, 1536, F32, BF16, True),
    (1, 1024, 1024, BF16, F32, True), (0, 512, 512, F32, BF16, True)])
def test_gemm_ln_wrapper_launches_the_plan(monkeypatch, M, K, D, a_dtype,
                                           res_dtype, bias):
    """gemm_ln's launch: the operands and their row strides, the dtype
    flags, one output in the residual's dtype (nothing else allocated), the
    eps, and the plan's fields in mcan_gemm_ln's order."""
    made = []
    lib = _stub(monkeypatch, made)
    a, w = torch.zeros(M, K, dtype=a_dtype), torch.zeros(K, D, dtype=BF16)
    b = torch.zeros(D) if bias else None
    res, gamma, beta = torch.zeros(M, D, dtype=res_dtype), torch.ones(D), \
        torch.zeros(D)
    before = kern.launch_counts().get("gemm_ln", 0)
    out = kern.gemm_ln(a, w, b, res, gamma, beta)
    assert kern.launch_counts()["gemm_ln"] == before + 1
    assert made == [out] and out.shape == (M, D) and out.dtype == res_dtype
    (pa, a_f32, lda, pw, ldw, pb, pr, r16, ldr, pg, pbe, po, ldo, m, d, k,
     eps, *fields, stream) = lib.args
    plan = kern.gemm_ln_plan(M, K, D, a_dtype == F32)
    assert (pa, a_f32, lda, pw, ldw) == (a.data_ptr(), int(a_dtype == F32),
                                         K, w.data_ptr(), D)
    assert pb == (b.data_ptr() if bias else None)
    assert (pr, r16, ldr) == (res.data_ptr(), int(res_dtype == BF16), D)
    assert (pg, pbe, po, ldo, m, d, k) == (gamma.data_ptr(), beta.data_ptr(),
                                           out.data_ptr(), D, M, D, K)
    assert eps == kern.LN_EPS and stream == 0
    assert tuple(fields) == plan.fields() == (
        plan.bm, plan.bn, plan.cluster, plan.grid, plan.k_tiles, plan.stages,
        plan.smem)


def test_gemm_ln_wrapper_copies_a_residual_it_cannot_read_in_pieces(
        monkeypatch):
    """The kernel reads the residual's rows 16 bytes at a time: a residual
    whose row stride is no multiple of 8 is read from a dense copy, and one
    whose rows allow it in place."""
    lib = _stub(monkeypatch, [])
    a, w = torch.zeros(5, 64, dtype=BF16), torch.zeros(64, 72, dtype=BF16)
    v = torch.ones(72)
    for width, copied in ((75, True), (80, False)):
        res = torch.zeros(5, width)[:, :72]
        kern.gemm_ln(a, w, v, res, v, v)
        pr, ldr = lib.args[6], lib.args[8]
        assert (pr != res.data_ptr()) == copied
        assert ldr == (72 if copied else width)


@pytest.mark.parametrize("D,K", [(4096, 512), (100, 512), (512, 100)])
def test_gemm_ln_wrapper_refuses_before_any_launch(monkeypatch, D, K):
    monkeypatch.setattr(kern, "_lib", lambda: pytest.fail("launched"))
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    a, w = torch.zeros(8, K, dtype=BF16), torch.zeros(K, D, dtype=BF16)
    v = torch.zeros(D)
    with pytest.raises(ValueError, match=f"K={K} and D={D}"):
        kern.gemm_ln(a, w, v, torch.zeros(8, D), v, v)


# (B, L, G, D): MCAN-small's two AttFlats at B = 64, 8 and 1 (image 60
# rows, language 14), the wide widths, two glimpses, a long sequence at a
# narrow width, odd widths, and the largest L x G
ATTFLAT = [(B, L, 1, 512) for B in (64, 8, 1) for L in (60, 14)]
ATTFLAT += [(8, 60, 1, 1536), (8, 60, 1, 2048), (3, 160, 2, 1536),
            (2, 608, 1, 64), (4, 9, 1, 32), (5, 7, 3, 20), (1, 1, 1, 1),
            (0, 60, 1, 512), (2, 12288, 1, 512), (130, 60, 1, 512)]


@pytest.mark.parametrize("B,L,G,D", ATTFLAT)
def test_attflat_plan_covers_every_column_and_row_once(B, L, G, D):
    plan = kern.attflat_plan(B, L, G, D)
    assert 1 <= plan.ranks <= kern.ATTFLAT_MAX_RANKS
    assert plan.chunk % 8 == 0 and plan.grid == B * plan.ranks
    assert _covers_once([plan.columns(r) for r in range(plan.ranks)], D)
    rows = [l for r in range(plan.ranks) for l in plan.logit_rows(r)]
    assert sorted(rows) == list(range(L))
    assert plan.smem == kern.attflat_smem_bytes(L, G) <= kern.SMEM_PER_BLOCK


def test_attflat_plan_spreads_mcan_small_over_the_card():
    """The image AttFlat (60 rows): at B = 64 four CTAs a sample (256 CTAs,
    where the first design ran 64 blocks), at B = 1 and 8 the most, 8;
    past the SM count one. The language AttFlat (14 rows): two CTAs a
    sample at every B, each computing 7 logit rows; fewer rows than
    ATTFLAT_MIN_ROWS a sample, one."""
    assert kern.attflat_plan(64, 60, 1, 512).ranks == 4
    assert kern.attflat_plan(8, 60, 1, 512).ranks == 8
    assert kern.attflat_plan(1, 60, 1, 512).ranks == 8
    for B in (64, 8, 1):
        assert kern.attflat_plan(B, 14, 1, 512).ranks == 2
    assert kern.attflat_plan(1, kern.ATTFLAT_MIN_ROWS - 1, 1, 512).ranks == 1
    assert kern.attflat_plan(132, 60, 1, 512).ranks == 1
    assert kern.attflat_plan(64, 60, 1, 512).grid >= SMS


def test_attflat_plan_refuses_too_many_logits():
    with pytest.raises(ValueError, match="L x G = 12289"):
        kern.attflat_plan(1, 12289, 1, 512)


@pytest.mark.parametrize("B,L,G,D,x_dtype", [
    (64, 60, 1, 512, BF16), (64, 14, 1, 512, F32), (3, 160, 2, 1536, BF16),
    (2, 608, 1, 64, F32)])
def test_attflat_wrapper_launches_the_plan(monkeypatch, B, L, G, D,
                                          x_dtype):
    made = []
    lib = _stub(monkeypatch, made)
    Fm = 512
    h, w2 = torch.zeros(B * L, Fm, dtype=BF16), torch.zeros(Fm, G,
                                                            dtype=BF16)
    b2, x = torch.zeros(G), torch.zeros(B, L, D, dtype=x_dtype)
    mask = torch.zeros(B, 1, 1, L, dtype=torch.bool)
    before = kern.launch_counts().get("attflat_pool", 0)
    pooled, att = kern.attflat_pool(h, w2, b2, mask, x)
    assert kern.launch_counts()["attflat_pool"] == before + 1
    assert made == [pooled, att]
    assert pooled.shape == (B, G * D) and pooled.dtype == BF16
    assert att.shape == (B, L, G) and att.dtype == F32
    plan = kern.attflat_plan(B, L, G, D)
    (ph, ldh, pw2, pb2, pm, px, x_f32, pp, pa, b, l, fm, g, d, ranks, chunk,
     smem, stream) = lib.args
    assert (ph, ldh, pw2, pb2, pm, px) == (h.data_ptr(), Fm, w2.data_ptr(),
                                           b2.data_ptr(), mask.data_ptr(),
                                           x.data_ptr())
    assert (x_f32, pp, pa, b, l, fm, g, d) == (
        int(x_dtype == F32), pooled.data_ptr(), att.data_ptr(), B, L, Fm, G,
        D)
    assert (ranks, chunk, smem, stream) == (plan.ranks, plan.chunk,
                                            plan.smem, 0)
