"""The plan of the Hopper GEMMs (``kernels.gemm_plan``: the forward NN
product, the backward NT / TN ones and the int8 S8 one), the launch
arguments the wrappers derive from it, and the profiler's kernel groups:
pure Python, milliseconds, no card and no JAX."""

import pytest
import torch

from mcan_vqa_tpu_torch.cli.profile_train import kernel_group
from mcan_vqa_tpu_torch.ops import kernels as kern

BF16 = torch.bfloat16
NT, TN, NN, S8 = 1, 2, 3, 4

# (layout, M, N, K): K the reduction (dW: R rows). Every dX / dW shape of
# the MCAN-small step (decoder M 3840, encoder 896) and of the MCAN-large
# step (micro-batch M 1920, D 1024, F 4096), then R in {1, 7, 77, 896}
MAIN_PATH = [
    (NT, 3840, 2048, 512), (NT, 3840, 512, 2048), (NT, 3840, 512, 512),
    (NT, 3840, 512, 1536), (NT, 896, 2048, 512), (NT, 896, 512, 2048),
    (NT, 896, 512, 512), (NT, 896, 512, 1536), (NT, 1920, 4096, 1024),
    (NT, 1920, 1024, 4096), (NT, 1920, 1024, 1024), (NT, 1920, 1024, 3072),
    (TN, 512, 2048, 3840), (TN, 2048, 512, 3840), (TN, 512, 1536, 3840),
    (TN, 512, 512, 3840), (TN, 512, 1536, 896), (TN, 512, 512, 896),
    (TN, 512, 2048, 896), (TN, 2048, 512, 896), (TN, 1024, 4096, 1920),
    (TN, 4096, 1024, 1920), (TN, 1024, 3072, 1920), (TN, 1024, 1024, 1920)]
EDGES = [(TN, M, N, R) for R in (1, 7, 77, 896)
         for M, N in ((512, 512), (8, 8), (2048, 4096))]
# (NN, M, N, K): every forward product (gemm_bias_act) of the MCAN-small
# B=64 forward and step (decoder M 3840, encoder 896: qkv, merge / q2,
# ffn1, ffn2), of the MCAN-large micro-batch (M 1920), of B=1 (M 14, 60),
# ragged M, hidden 480 (N 480 / 1440 / 1920), AttFlat's merge, K % 64 != 0
# (480, 1000, 40), and an empty M
FORWARD = [(NN, M, N, K) for M in (3840, 896, 14, 60)
           for N, K in ((1536, 512), (512, 512), (2048, 512), (512, 2048))]
FORWARD += [(NN, 1920, N, K) for N, K in ((3072, 1024), (1024, 1024),
                                          (4096, 1024), (1024, 4096))]
FORWARD += [(NN, M, N, K) for M in (1, 42, 61, 77, 130)
            for N, K in ((1536, 512), (2048, 512), (512, 2048))]
FORWARD += [(NN, M, N, K) for M in (3840, 61)
            for N, K in ((1440, 480), (480, 480), (1920, 480), (480, 1920))]
FORWARD += [(NN, 64, 1024, 512), (NN, 14, 8, 1000), (NN, 60, 1536, 40),
            (NN, 0, 512, 512)]
# (S8, M, N, K): every int8 site of the default engine's B=64 forward
# (MCAN-small, encoder M 896, decoder 3840: w1, w2, qkv, merge / cross q),
# of MCAN-large's (D 1024, F 4096: qkv, w1, w2), at B=1 (M 14, 60), ragged
# M (61, 1), the answer head (N 3129) and the AttFlat logit (N 1)
INT8 = [(S8, M, N, K) for M in (896, 3840, 14, 60)
        for N, K in ((2048, 512), (512, 2048), (1536, 512), (512, 512))]
INT8 += [(S8, M, N, K) for M in (896, 3840)
         for N, K in ((3072, 1024), (4096, 1024), (1024, 4096))]
INT8 += [(S8, 61, 2048, 512), (S8, 1, 512, 2048), (S8, 64, 3129, 1024),
         (S8, 61, 3129, 1024), (S8, 3840, 1, 512), (S8, 896, 1, 512),
         (S8, 0, 512, 512)]
SHAPES = MAIN_PATH + EDGES + FORWARD + INT8


@pytest.mark.parametrize("layout,M,N,K", SHAPES)
def test_splits_cover_the_reduction_once_in_order(layout, M, N, K):
    plan = kern.gemm_plan(layout, M, N, K)
    assert plan.k_tiles * plan.bk >= K > (plan.k_tiles - 1) * plan.bk
    assert 1 <= plan.splits <= plan.k_tiles
    ranges = [plan.split_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_tiles
    for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1                  # contiguous, in order
    assert all(e > b for b, e in ranges)  # no empty split
    # on K-tile boundaries: the rows of split s are [b bk, e bk) within R
    rows = [r for b, e in ranges for r in range(b * plan.bk,
                                                min(e * plan.bk, K))]
    assert rows == list(range(K))


@pytest.mark.parametrize("layout,M,N,K", SHAPES)
def test_tiles_cover_the_output_and_fill_the_card(layout, M, N, K):
    plan = kern.gemm_plan(layout, M, N, K)
    # a K-tile is 128 bytes a row: 64 bf16 values, or 128 int8 ones
    assert plan.bm == 128 and plan.bn in (64, 128)
    assert plan.bk == (128 if layout == S8 else 64)
    assert (plan.tiles_m - 1) * plan.bm < M <= plan.tiles_m * plan.bm \
        or M == plan.tiles_m == 0
    assert (plan.tiles_n - 1) * plan.bn < N <= plan.tiles_n * plan.bn
    if layout == TN:
        # tiles x splits reach the SM count wherever R allows it
        assert plan.blocks >= kern.GEMM_SMS or plan.splits == plan.k_tiles
    else:
        assert plan.splits == 1
    # persistent blocks: no more than the work items, nor than the SMs hold
    per_sm = 2 if plan.bn == 64 else 1
    assert plan.grid == min(plan.blocks, kern.GEMM_SMS * per_sm)


@pytest.mark.parametrize("layout,M,N,K", SHAPES)
def test_workspace_holds_every_split_of_every_tile(layout, M, N, K):
    plan = kern.gemm_plan(layout, M, N, K)
    if plan.splits == 1:
        assert plan.workspace_bytes == 0
    else:
        assert plan.workspace_bytes == (plan.splits * plan.tiles_m
                                        * plan.bm * plan.tiles_n * plan.bn
                                        * 4)
        assert plan.workspace_bytes >= plan.splits * M * N * 4


def test_plan_depends_on_the_shape_alone():
    first = [kern.gemm_plan(*s) for s in SHAPES]
    assert [kern.gemm_plan(*s) for s in reversed(SHAPES)] == first[::-1]
    # pinned at the MCAN-small step: dX at 128 x 128 where 128 x 128
    # tiles fill half the SMs or more, else 128 x 64; dW at 128 x 64 in 2
    # splits (dW1, dW2, dWqkv) and 5 (the 512 x 512 weights); MCAN-large's
    # dW1 at 128 x 128 in one
    pins = {(NT, 3840, 2048, 512): (128, 1), (NT, 3840, 512, 2048): (128, 1),
            (NT, 896, 512, 512): (64, 1),
            (TN, 512, 2048, 3840): (64, 2), (TN, 2048, 512, 3840): (64, 2),
            (TN, 512, 1536, 3840): (64, 2), (TN, 512, 512, 3840): (64, 5),
            (TN, 1024, 4096, 1920): (128, 1), (TN, 512, 512, 77): (64, 2),
            (TN, 512, 512, 1): (64, 1),
            # the forward as dX: 128 x 128 at the decoder's and MCAN-large's
            # M, 128 x 64 at the encoder's narrow products and at B=1
            (NN, 3840, 512, 512): (128, 1), (NN, 3840, 2048, 512): (128, 1),
            (NN, 1920, 1024, 4096): (128, 1), (NN, 896, 512, 512): (64, 1),
            (NN, 896, 2048, 512): (128, 1), (NN, 14, 1536, 512): (64, 1)}
    for shape, (bn, splits) in pins.items():
        plan = kern.gemm_plan(*shape)
        assert (plan.bn, plan.splits) == (bn, splits), shape


class _Lib:
    """Stands in for the kernels' library: records one launch's arguments."""

    def __init__(self):
        self.args = None

    def mcan_gemm_sm90(self, *args):
        self.args = args
        return 0


@pytest.mark.parametrize("R,M,N", [(3840, 512, 512), (3840, 512, 2048),
                                   (1920, 1024, 4096), (7, 8, 8)])
def test_wrapper_launches_the_plan_with_its_workspace(monkeypatch, R, M, N):
    lib, made = _Lib(), []
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "_SPLIT_COUNTERS", {})
    monkeypatch.setattr(kern.torch, "empty", record_empty)
    x, dy = torch.zeros(R, M, dtype=BF16), torch.zeros(R, N, dtype=BF16)
    before = kern.launch_counts().get("gemm_dw", 0)
    out, = kern._gemm_sm90("gemm_dw", TN, x, dy, M, N, R)
    plan = kern.gemm_plan(TN, M, N, R)
    assert kern.launch_counts()["gemm_dw"] == before + 1
    assert out.shape == (M, N) and out.dtype == torch.float32
    (layout, a, lda, b, ldb, m, n, k, bn, splits, grid, gate, _, _, res, _,
     bias, relu, mask, ldm, *keep, o32, o16, ws, counters, _) = lib.args
    assert (layout, m, n, k, bn, splits, grid) == (
        TN, M, N, R, plan.bn, plan.splits, plan.grid)
    assert (a, lda, b, ldb) == (x.data_ptr(), M, dy.data_ptr(), N)
    assert gate is None and res is None and o16 is None
    assert (bias, relu, mask, ldm, keep) == (None, 0, None, 0, [0] * 5)
    assert o32 == out.data_ptr()
    if plan.splits == 1:
        assert ws is None and counters is None
    else:
        wst = [t for t in made if t.data_ptr() == ws][0]
        assert wst.numel() * wst.element_size() == plan.workspace_bytes
        cnt = kern._SPLIT_COUNTERS[x.device]
        assert counters == cnt.data_ptr() and cnt.numel() >= plan.tiles
        assert not cnt.any()


@pytest.mark.parametrize("M,K,N,out_dtype,with_bias,relu,keep", [
    (3840, 512, 2048, BF16, True, True, "mask"),
    (3840, 512, 2048, BF16, True, True, "philox"),
    (896, 2048, 512, torch.float32, True, False, None),
    (61, 512, 1536, BF16, False, False, None),
    (14, 40, 8, torch.float32, True, True, "philox")])
def test_forward_wrapper_launches_the_nn_plan(monkeypatch, M, K, N, out_dtype,
                                             with_bias, relu, keep):
    """gemm_bias_act's launch: layout NN, the plan's tile width and grid,
    one split and no workspace, the epilogue's bias / ReLU / keep-mask (row
    stride N) or its Philox words and rows, one output of the asked
    dtype."""
    lib, made = _Lib(), []
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "_SPLIT_COUNTERS", {})
    a, w = torch.zeros(M, K, dtype=BF16), torch.zeros(K, N, dtype=BF16)
    b = torch.zeros(N) if with_bias else None
    rows = 2 if M % 2 == 0 else 1
    mask = torch.ones(M, N, dtype=torch.uint8) if keep == "mask" else \
        kern.Philox(7, 0x303, 3865470566, rows) if keep == "philox" else None
    monkeypatch.setattr(kern.torch, "empty", record_empty)
    before = kern.launch_counts().get("gemm_bias_act", 0)
    out = kern._gemm("gemm_bias_act", a, w, M, N, K, bias=b, relu=relu,
                     mask=mask, inv_keep=1 / 0.9, out_dtype=out_dtype)
    plan = kern.gemm_plan(NN, M, N, K)
    assert kern.launch_counts()["gemm_bias_act"] == before + 1
    assert out.shape == (M, N) and out.dtype == out_dtype
    assert len(made) == 1 and made[0] is out   # no workspace
    assert kern._SPLIT_COUNTERS == {}
    (layout, pa, lda, pb, ldb, m, n, k, bn, splits, grid, gate, ldg, inv,
     res, ldr, bias, rl, pm, ldm, keep_on, seed, site, thresh, keep_rows,
     o32, o16, ws, counters, _) = lib.args
    assert (layout, m, n, k, bn, splits, grid) == (
        NN, M, N, K, plan.bn, 1, plan.grid)
    assert plan.splits == 1
    assert (pa, lda, pb, ldb) == (a.data_ptr(), K, w.data_ptr(), N)
    assert (gate, ldg, res, ldr, ws, counters) == (None, 0, None, 0, None,
                                                   None)
    assert bias == (b.data_ptr() if with_bias else None) and rl == int(relu)
    assert inv == pytest.approx(1 / 0.9)
    if keep == "mask":
        assert (pm, ldm) == (mask.data_ptr(), N)
        assert (keep_on, seed, site, thresh, keep_rows) == (0, 0, 0, 0, 0)
    else:
        assert (pm, ldm) == (None, 0)
        assert (keep_on, seed, site, thresh, keep_rows) == (
            (1, 7, 0x303, 3865470566, rows) if keep == "philox"
            else (0, 0, 0, 0, 0))
    assert (o32, o16) == ((out.data_ptr(), None) if out_dtype == torch.float32
                          else (None, out.data_ptr()))


@pytest.mark.parametrize("M,K,N,static,relu,out_dtypes", [
    (3840, 512, 2048, False, True, (torch.float32,)),
    (896, 2048, 512, True, False, (torch.float32,)),
    (3840, 512, 1536, True, False, (BF16,)),
    (61, 1024, 3129, False, False, (torch.float32, BF16)),
    (64, 1024, 3129, True, False, (torch.float32,)),
    (3840, 512, 1, False, False, (torch.float32,)),
    (1, 2048, 512, True, False, (BF16,))])
def test_int8_wrapper_launches_the_s8_plan(monkeypatch, M, K, N, static,
                                           relu, out_dtypes):
    """gemm_s8's launch: mcan_gemm_sm90_s8 with the S8 plan's tile width
    and grid, the codes' row stride, the K-major weight's column stride
    (K; any for one column), the scales, bias and ReLU, one output per
    asked dtype and nothing else allocated."""
    lib, made = _Lib(), []
    empty = torch.empty

    def record_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    def s8_launch(*args):
        lib.args = args
        return 0

    lib.mcan_gemm_sm90_s8 = s8_launch
    monkeypatch.setattr(kern, "_lib", lambda: lib)
    monkeypatch.setattr(kern, "_stream", lambda t: 0)
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    aq = torch.zeros(M, K, dtype=torch.int8)
    wq = kern.k_major(torch.zeros(K, N, dtype=torch.int8))
    sw, bias = torch.ones(N), torch.zeros(N)
    sx = None if static else torch.ones(M)
    monkeypatch.setattr(kern.torch, "empty", record_empty)
    before = kern.launch_counts().get("gemm_s8", 0)
    outs = kern.gemm_s8(aq, wq, sw, bias, sx=sx, a=0.25 if static else None,
                        relu=relu, out_dtypes=out_dtypes)
    plan = kern.gemm_plan(S8, M, N, K)
    assert kern.launch_counts()["gemm_s8"] == before + 1
    assert [o.dtype for o in outs] == list(out_dtypes)
    assert all(o.shape == (M, N) for o in outs)
    assert made == list(outs)                 # no workspace
    (pa, lda, pb, ldb, m, n, k, bn, grid, psx, a, psw, pbias, rl, o32, o16,
     stream) = lib.args
    assert plan.splits == 1 and plan.bk == 128
    assert (m, n, k, bn, grid) == (M, N, K, plan.bn, plan.grid)
    assert (pa, lda, pb, ldb) == (aq.data_ptr(), K, wq.data_ptr(), K)
    assert psx == (None if static else sx.data_ptr())
    assert a == (0.25 if static else 0.0)
    assert (psw, pbias, rl) == (sw.data_ptr(), bias.data_ptr(), int(relu))
    by = dict(zip(out_dtypes, outs))
    assert o32 == (by[torch.float32].data_ptr()
                   if torch.float32 in by else None)
    assert o16 == (by[BF16].data_ptr() if BF16 in by else None)


@pytest.mark.parametrize("K,N", [(512, 2048), (1024, 3129), (512, 1)])
def test_int8_wrapper_refuses_a_row_major_weight(monkeypatch, K, N):
    """The weight is read K-major and never transposed per call: a [K, N]
    weight stored row-major (N > 1), or a K-major one whose column stride
    is no multiple of 16, raises before any launch."""
    monkeypatch.setattr(kern, "_lib", lambda: pytest.fail("launched"))
    monkeypatch.setattr(kern, "on_cuda", lambda t: True)
    aq = torch.zeros(64, K, dtype=torch.int8)
    sw = torch.ones(N)
    wq = kern.k_major(torch.zeros(K, N, dtype=torch.int8))
    assert wq.stride(0) == 1 and (N == 1 or wq.stride(1) == K)
    if N > 1:
        with pytest.raises(ValueError, match="K-major"):
            kern.gemm_s8(aq, wq.contiguous(), sw, a=1.0)
    wide = torch.zeros(N, K + 8, dtype=torch.int8)[:, :K].t()
    assert wide.shape == (K, N) and wide.stride(0) == 1
    if N > 1:
        with pytest.raises(ValueError, match="K-major"):
            kern.gemm_s8(aq, wide, sw, a=1.0)


@pytest.mark.parametrize("name,group", [
    # the attention forward's one-block and long instances, one group;
    # the backward's one-block and long kernels, another
    ("void (anonymous namespace)::masked_attention_kernel<64, 8>((anonymous "
     "namespace)::Args)", "masked_attention_kernel"),
    ("void (anonymous namespace)::masked_attention_kernel<128, 16>("
     "(anonymous namespace)::Args)", "masked_attention_kernel"),
    ("void (anonymous namespace)::masked_attention_long_kernel<192>("
     "(anonymous namespace)::Args)", "masked_attention_kernel"),
    ("void (anonymous namespace)::masked_attention_bwd_kernel<64, 8>("
     "(anonymous namespace)::Args)", "masked_attention_bwd_kernel"),
    ("void (anonymous namespace)::attention_bwd_rows_kernel<256>("
     "(anonymous namespace)::Args)", "masked_attention_bwd_kernel"),
    ("void (anonymous namespace)::attention_bwd_keys_kernel<128>("
     "(anonymous namespace)::Args)", "masked_attention_bwd_kernel"),
    ("void (anonymous namespace)::residual_layernorm_rolled_kernel<float>("
     "float const*, float const*)", "residual_layernorm_kernel"),
    ("void (anonymous namespace)::residual_layernorm_bwd_rolled_kernel<"
     "float, float>(float const*, float const*)",
     "residual_layernorm_bwd_kernel"),
    # the WMMA forward GEMM of older checkouts is no longer the port's
    ("void (anonymous namespace)::gemm_kernel(__nv_bfloat16 const*, long "
     "long, __nv_bfloat16 const*, long long, int, int, int, "
     "(anonymous namespace)::Epilogue)", "torch gemm"),
    ("void sm90::gemm_sm90_kernel<true, 64>(CUtensorMap_st, CUtensorMap_st, "
     "int, int, int, sm90::Epilogue, float*, int*)", "gemm_sm90_kernel"),
    ("void sm90::gemm_sm90_kernel<false, 128>(CUtensorMap_st, "
     "CUtensorMap_st, int, int, int, sm90::Epilogue, float*, int*)",
     "gemm_sm90_kernel"),
    ("void sm90::gemm_sm90_kernel<1, 128, false>(CUtensorMap_st, "
     "CUtensorMap_st, int, int, int, int, sm90::Epilogue, float*, int*)",
     "gemm_sm90_kernel"),
    ("void sm90::gemm_sm90_kernel<2, 64, false>(CUtensorMap_st, "
     "CUtensorMap_st, int, int, int, int, sm90::Epilogue, float*, int*)",
     "gemm_sm90_kernel"),
    ("void sm90::gemm_sm90_kernel<3, 128, false>(CUtensorMap_st, "
     "CUtensorMap_st, int, int, int, int, sm90::Epilogue, float*, int*)",
     "gemm_sm90_kernel NN"),
    ("void sm90::gemm_sm90_kernel<3, 64, true>(CUtensorMap_st, "
     "CUtensorMap_st, int, int, int, int, sm90::Epilogue, float*, int*)",
     "gemm_sm90_kernel NN"),
    # the int8 product (layout 4) counts with the backward instances
    ("void sm90::gemm_sm90_kernel<4, 128, false>(CUtensorMap_st, "
     "CUtensorMap_st, int, int, int, int, sm90::Epilogue, float*, int*)",
     "gemm_sm90_kernel"),
    ("void (anonymous namespace)::col_sum_kernel((anonymous namespace)::"
     "Sums, int, int, int, float*, int*)", "col_sum_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroup"
     "size1x1x1_execute_segment_k_off_kernel__5x_cublas", "torch gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_bf16_64x64_64x4>",
     "torch gemm")])
def test_profiler_groups_the_port_gemms_apart_from_cublas(name, group):
    assert kernel_group(name) == group
