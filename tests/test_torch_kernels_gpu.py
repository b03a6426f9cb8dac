"""The port's CUDA kernels on the card, each against its plain PyTorch
version, plus both serving blocks and the Predictor at a small width.

Every test is marked ``gpu`` and skips without a CUDA device. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from mcan_vqa_tpu_torch.ops import kernels as K

BF16 = torch.bfloat16
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    # the plain versions run f32 matmuls of bf16-rounded operands
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("M,Kd,N,relu,out_dtype,bias,a_ld,w_ld", [
    (1, 512, 1536, False, BF16, True, 0, 0),
    (61, 512, 512, False, torch.float32, True, 0, 0),
    (130, 2048, 512, False, torch.float32, True, 0, 0),
    (77, 512, 2048, True, BF16, True, 0, 0),
    # the masked last column tile: hidden 480 (N % 64 != 0), K % 64 != 0
    (3840, 512, 480, True, BF16, True, 0, 0),
    (61, 480, 1440, False, torch.float32, True, 0, 0),
    (14, 1000, 8, False, torch.float32, True, 0, 0),
    # no rows, one row, B=1's 14 and 60 rows; K 40 (one K-tile, zero-filled)
    (0, 512, 512, True, BF16, True, 0, 0),
    (1, 2048, 512, False, torch.float32, False, 0, 0),
    (14, 512, 1536, False, BF16, True, 0, 0),
    (60, 512, 2048, True, BF16, False, 0, 0),
    (60, 40, 512, True, torch.float32, True, 0, 0),
    # a a column slice of a wider buffer (row stride 3 x 512, as the
    # blocks pass the fused qkv), w a view of a wider weight (row stride
    # 1536 > N), bias None
    (896, 512, 512, False, torch.float32, False, 1536, 0),
    (3840, 512, 512, True, BF16, True, 0, 1536),
    (61, 512, 1024, False, BF16, False, 1536, 2048)])
def test_gemm_matches_plain(cuda, M, Kd, N, relu, out_dtype, bias, a_ld,
                            w_ld):
    g = torch.Generator(device=cuda).manual_seed(M)
    a = torch.randn(M, max(a_ld, Kd), generator=g, device=cuda).to(BF16)
    a = a[:, a_ld - Kd:] if a_ld else a
    w = (torch.randn(Kd, max(w_ld, N), generator=g, device=cuda)
         / Kd ** 0.5).to(BF16)[:, :N]
    b = torch.randn(N, generator=g, device=cuda) if bias else None
    before = K.launch_counts().get("gemm_bias_act", 0)
    out = K.gemm_bias_act(a, w, b, relu=relu, out_dtype=out_dtype)
    assert K.launch_counts()["gemm_bias_act"] == before + 1
    ref = K.gemm_bias_act_plain(a, w, b, relu=relu, out_dtype=out_dtype)
    assert K.launch_counts()["gemm_bias_act"] == before + 1
    assert out.shape == (M, N) and out.dtype == out_dtype
    # f32: the same exact bf16 products summed in another order; bf16:
    # one rounding may land a step (2^-8) apart
    _close(out, ref, 1e-4 if out_dtype == torch.float32 else 2 ** -7)


def test_gemm_raises_on_unsupported_shapes(cuda):
    a = torch.zeros(8, 512, dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="multiple of"):
        K.gemm_bias_act(a, torch.zeros(512, 100, dtype=BF16, device=cuda))
    with pytest.raises(ValueError, match="bf16"):
        K.gemm_bias_act(a.float(), torch.zeros(512, 64, device=cuda))


def _attention_inputs(B, H, Lq, Lk, lengths, cuda, Dh=64):
    g = torch.Generator(device=cuda).manual_seed(Lq * Lk)
    q = torch.randn(B, H, Lq, Dh, generator=g, device=cuda).to(BF16)
    k = torch.randn(B, H, Lk, Dh, generator=g, device=cuda)
    v = torch.randn(B, H, Lk, Dh, generator=g, device=cuda)
    idx = torch.arange(Lk, device=cuda)
    mask = (idx[None] >= torch.tensor(lengths, device=cuda)[:, None])
    return q, k, v, mask[:, None, None, :]


@pytest.mark.parametrize("Lq,Lk,lengths,kv_dtype", [
    (14, 14, [14, 0, 5], BF16), (60, 60, [0, 60, 17], BF16),
    (60, 14, [3, 14, 0], torch.float32), (1, 64, [64, 1, 30], BF16)])
def test_attention_matches_plain(cuda, Lq, Lk, lengths, kv_dtype):
    q, k, v, mask = _attention_inputs(3, 8, Lq, Lk, lengths, cuda)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    # bf16 probabilities and output: one rounding may land a step apart
    _close(K.masked_attention(q, k, v, mask),
           K.masked_attention_plain(q, k, v, mask), 2 ** -7)


def test_attention_reads_strided_qkv(cuda):
    """q/k/v as views of one fused [B*L, 3D] buffer, as the blocks pass
    them, give what contiguous copies give."""
    B, L, H = 4, 60, 8
    qkv = torch.randn(B * L, 3 * 512, device=cuda).to(BF16)
    views = [t.view(B, L, H, 64).transpose(1, 2)
             for t in qkv.view(B, L, 3 * 512).split(512, dim=-1)]
    mask = torch.zeros(B, 1, 1, L, dtype=torch.bool, device=cuda)
    mask[1, ..., 20:] = True
    out = K.masked_attention(*views, mask)
    ref = K.masked_attention(*[t.contiguous() for t in views], mask)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_attention_raises_past_its_limits(cuda):
    q, k, v, mask = _attention_inputs(2, 8, 14, 0, [0, 0], cuda)
    with pytest.raises(ValueError, match="Lk"):
        K.masked_attention(q, k.to(BF16), v.to(BF16), mask)
    q, k, v, mask = _attention_inputs(2, 8, 14, 14, [14, 3], cuda, Dh=264)
    with pytest.raises(ValueError, match="Dh"):
        K.masked_attention(q, k.to(BF16), v.to(BF16), mask)


@pytest.mark.parametrize("D,res_dtype,with_bias", [
    (512, BF16, True), (512, torch.float32, False), (1024, BF16, False),
    (1024, torch.float32, True), (256, BF16, True),
    (768, torch.float32, True), (2048, BF16, False)])
def test_layernorm_matches_plain(cuda, D, res_dtype, with_bias):
    g = torch.Generator(device=cuda).manual_seed(D)
    rows = 77
    res = torch.randn(rows, D, generator=g, device=cuda).to(res_dtype)
    y = torch.randn(rows, D, generator=g, device=cuda)
    bias = torch.randn(D, generator=g, device=cuda) if with_bias else None
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    beta = 0.1 * torch.randn(D, generator=g, device=cuda)
    dts = (torch.float32, BF16)
    outs = K.residual_layernorm(res, y, bias, gamma, beta, dts)
    refs = K.residual_layernorm_plain(res, y, bias, gamma, beta, dts)
    _close(outs[0], refs[0], 1e-5)      # f32 sums in another order
    _close(outs[1], refs[1], 2 ** -7)   # plus one bf16 rounding


def test_layernorm_raises_on_unsupported_width(cuda):
    for D in (400, 4096):
        x = torch.zeros(4, D, device=cuda)
        with pytest.raises(ValueError, match=f"D={D}"):
            K.residual_layernorm(x, x, None, x[0], x[0])


# ---------------------------------------------------------------------------
# the blocks and the Predictor at MCAN-small width, 2 layers
# ---------------------------------------------------------------------------

def _small_model():
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data import build_vocab
    from mcan_vqa_tpu_torch.models.net import MCANet
    cfg = Config(layer=2, img_feat_size=64)
    questions = ["what is this", "how many cars are there", ""]
    vocab, emb = build_vocab(questions)
    ix_to_ans = {str(i): f"a{i}" for i in range(50)}
    net = MCANet(cfg, len(vocab), len(ix_to_ans), pretrained_emb=emb,
                 generator=torch.Generator().manual_seed(0))
    return cfg, net.state_dict(), vocab, ix_to_ans, questions


def test_blocks_match_plain_with_fully_padded_samples(cuda):
    from mcan_vqa_tpu_torch.ops import sga_block
    from mcan_vqa_tpu_torch.ops.serving import _cross_kv, prepare_params
    cfg, sd, *_ = _small_model()
    bb = prepare_params(sd, cfg.layer, device=cuda)["backbone"]
    g = torch.Generator(device=cuda).manual_seed(2)
    B, D = 5, cfg.hidden_size
    x = torch.randn(B, 14, D, generator=g, device=cuda).to(BF16)
    v = torch.randn(B, 60, D, generator=g, device=cuda).to(BF16)
    q_mask = torch.zeros(B, 1, 1, 14, dtype=torch.bool, device=cuda)
    v_mask = torch.zeros(B, 1, 1, 60, dtype=torch.bool, device=cuda)
    q_mask[1] = True                    # an all-PAD question
    q_mask[3, ..., 4:] = True
    v_mask[2] = True                    # all-zero regions
    v_mask[4, ..., 33:] = True
    before = K.launch_counts()
    H = cfg.multi_head
    out = sga_block.fused_sa_block(x, q_mask, bb["enc_0"]["_mk"],
                                   num_heads=H)
    ref = sga_block.fused_sa_block_plain(x, q_mask, bb["enc_0"]["_mk"],
                                         num_heads=H)
    # same steps and precision, sums in another order: a bf16 rounding one
    # step apart carries through the block (values of LN scale, < 4)
    _close(out, ref, 2 ** -5)
    kq, vq = _cross_kv(bb["dec_0"]["mhatt2"], x, H)
    out = sga_block.fused_sga_block(v, kq, vq, v_mask, q_mask,
                                    bb["dec_0"]["_mk"], num_heads=H)
    ref = sga_block.fused_sga_block_plain(v, kq, vq, v_mask, q_mask,
                                          bb["dec_0"]["_mk"], num_heads=H)
    _close(out, ref, 2 ** -5)
    after = K.launch_counts()
    assert after["fused_sa_block"] - before.get("fused_sa_block", 0) == 1
    assert after["fused_sga_block"] - before.get("fused_sga_block", 0) == 1


def test_predictor_fused_matches_plain_on_the_card(cuda):
    from mcan_vqa_tpu_torch.api import Predictor
    cfg, sd, vocab, ix_to_ans, questions = _small_model()
    kw = dict(ix_to_ans=ix_to_ans, max_batch=8, latency_buckets=(1,),
              device=cuda)
    fused = Predictor(cfg, sd, vocab, engine="fused", **kw)
    plain = Predictor(cfg, sd, vocab, engine="plain", **kw)
    rng = np.random.default_rng(0)
    feats = [np.abs(rng.normal(size=(r, cfg.img_feat_size)))
             .astype(np.float32) for r in (60, 7, 33)]
    K.reset_launches()
    pf = fused.predict_probs(questions, feats)
    # the default engine: int8 level 1 in every block, no bf16 block
    counts = K.launch_counts()
    assert counts["fused_qffn_sga_block"] == cfg.layer
    assert counts["fused_qffn_sa_block"] == cfg.layer
    assert "fused_sga_block" not in counts
    pp = plain.predict_probs(questions, feats)
    # int8 FFN and bf16 residual stream (fused) against f32 (plain): the
    # bound of tests/test_torch_api.py::test_fused_and_plain_engines_agree
    np.testing.assert_allclose(pf, pp, atol=1e-2)
    assert np.isfinite(pf).all() and pf.shape == (3, 50)


# ---------------------------------------------------------------------------
# the per-sub-op path: gemm_ln, attflat_pool, f32 q, the mode-0 engine
# ---------------------------------------------------------------------------

GEMM_LN_SHAPES = [
    (3840, 512, 512, torch.float32, BF16), (896, 2048, 512, BF16, BF16),
    (61, 512, 480, torch.float32, torch.float32),
    (14, 1536, 1536, torch.float32, BF16), (130, 8192, 2048, BF16, BF16),
    (1, 1024, 1024, BF16, torch.float32), (77, 40, 72, BF16, BF16),
    # the plan's other tiles and edges: the decoder's FFN on an f32
    # stream, the encoder's merge, B = 1, a ragged last 128-row block, D 8
    # and the wide merge at B = 8
    (3840, 2048, 512, BF16, torch.float32),
    (896, 512, 512, torch.float32, BF16), (60, 2048, 512, BF16, BF16),
    (3841, 512, 512, torch.float32, BF16), (14, 40, 8, BF16, torch.float32),
    (480, 2048, 2048, torch.float32, torch.float32)]


def _gemm_ln_inputs(cuda, M, Kd, D, a_dtype, res_dtype):
    g = torch.Generator(device=cuda).manual_seed(M + D)
    a = torch.randn(M, Kd, generator=g, device=cuda).to(a_dtype)
    w = (torch.randn(Kd, D, generator=g, device=cuda) / Kd ** 0.5).to(BF16)
    b = 0.1 * torch.randn(D, generator=g, device=cuda)
    res = torch.randn(M, D, generator=g, device=cuda).to(res_dtype)
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    beta = 0.1 * torch.randn(D, generator=g, device=cuda)
    return a, w, b, res, gamma, beta


@pytest.mark.parametrize("M,Kd,D,a_dtype,res_dtype", GEMM_LN_SHAPES)
def test_gemm_ln_matches_plain(cuda, M, Kd, D, a_dtype, res_dtype):
    a, w, b, res, gamma, beta = _gemm_ln_inputs(cuda, M, Kd, D, a_dtype,
                                                res_dtype)
    before = K.launch_counts().get("gemm_ln", 0)
    out = K.gemm_ln(a, w, b, res, gamma, beta)
    assert K.launch_counts()["gemm_ln"] == before + 1
    ref = K.gemm_ln_plain(a, w, b, res, gamma, beta)
    assert out.dtype == res_dtype
    # f32: the same exact bf16 products summed in another order, then an
    # LN of O(1) values; bf16: plus one rounding a step (2^-8) apart
    _close(out, ref, 1e-4 if res_dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("M,Kd,D,a_dtype,res_dtype", GEMM_LN_SHAPES)
def test_gemm_ln_is_bitwise_repeatable(cuda, M, Kd, D, a_dtype, res_dtype):
    """Every CTA of a cluster sums the rows' statistics in rank order: two
    runs give the same bits."""
    args = _gemm_ln_inputs(cuda, M, Kd, D, a_dtype, res_dtype)
    assert torch.equal(K.gemm_ln(*args), K.gemm_ln(*args))


def test_gemm_ln_instances_match_the_plan(cuda):
    """Each instance's shared memory is what kernels.gemm_ln_smem_bytes
    says, and the card holds a cluster of every size the plans use."""
    lib = K._lib()
    for (bm, bn) in K.GEMM_LN_TILES:
        for a_f32 in (0, 1):
            assert lib.mcan_gemm_ln_smem(a_f32, bm, bn) == \
                K.gemm_ln_smem_bytes(bool(a_f32), bm, bn)
            for c in range(1, K.GEMM_LN_MAX_CLUSTER + 1):
                assert lib.mcan_gemm_ln_max_clusters(a_f32, bm, bn, c) >= 1


def test_gemm_ln_raises_on_unsupported_shapes(cuda):
    a = torch.zeros(8, 512, dtype=BF16, device=cuda)
    vec = torch.zeros(4096, device=cuda)
    for D in (100, 4096):
        w = torch.zeros(512, D, dtype=BF16, device=cuda)
        res = torch.zeros(8, D, device=cuda)
        with pytest.raises(ValueError, match=f"D={D}"):
            K.gemm_ln(a, w, vec[:D], res, vec[:D], vec[:D])
    with pytest.raises(ValueError, match="bf16 or f32"):
        K.gemm_ln(a.half(), torch.zeros(512, 64, dtype=BF16, device=cuda),
                  None, torch.zeros(8, 64, device=cuda), vec[:64], vec[:64])


ATTFLAT_SHAPES = [
    (64, 60, 512, 512, 1, BF16), (64, 14, 512, 512, 1, torch.float32),
    (3, 160, 1536, 512, 2, BF16), (2, 608, 64, 24, 1, torch.float32),
    # B = 1 and 8 (eight CTAs a sample), the wide widths, and widths and a
    # hidden size that take no 16-byte loads
    (1, 60, 512, 512, 1, BF16), (8, 60, 2048, 512, 1, BF16),
    (5, 7, 20, 12, 3, torch.float32), (4, 9, 36, 40, 1, BF16)]


def _attflat_inputs(cuda, B, L, D, Fm, G, x_dtype):
    g = torch.Generator(device=cuda).manual_seed(L)
    x = torch.randn(B, L, D, generator=g, device=cuda).to(x_dtype)
    h = torch.relu(torch.randn(B * L, Fm, generator=g, device=cuda)).to(BF16)
    w2 = (torch.randn(Fm, G, generator=g, device=cuda) / Fm ** 0.5).to(BF16)
    b2 = 0.1 * torch.randn(G, generator=g, device=cuda)
    idx = torch.arange(L, device=cuda)
    lens = torch.tensor([(i * 7) % (L + 1) for i in range(B - 1)] + [0],
                        device=cuda)          # the last sample fully padded
    mask = (idx[None] >= lens[:, None])[:, None, None, :].contiguous()
    return h, w2, b2, mask, x


@pytest.mark.parametrize("B,L,D,Fm,G,x_dtype", ATTFLAT_SHAPES)
def test_attflat_pool_matches_plain(cuda, B, L, D, Fm, G, x_dtype):
    h, w2, b2, mask, x = _attflat_inputs(cuda, B, L, D, Fm, G, x_dtype)
    pooled, att = K.attflat_pool(h, w2, b2, mask, x)
    ref_p, ref_a = K.attflat_pool_plain(h, w2, b2, mask, x)
    # att: f32 logits of exact bf16 products summed in another order, one
    # softmax; pooled: plus one bf16 rounding a step (2^-8) apart
    _close(att, ref_a, 1e-5)
    _close(pooled, ref_p, 2 ** -7)
    _close(att[-1], torch.full_like(att[-1], 1.0 / L), 1e-6)


@pytest.mark.parametrize("B,L,D,Fm,G,x_dtype", ATTFLAT_SHAPES)
def test_attflat_pool_is_bitwise_repeatable(cuda, B, L, D, Fm, G, x_dtype):
    """The pooling's row groups are added in a fixed order and att is
    written once: two runs give the same bits."""
    args = _attflat_inputs(cuda, B, L, D, Fm, G, x_dtype)
    pooled, att = K.attflat_pool(*args)
    again = K.attflat_pool(*args)
    assert torch.equal(pooled, again[0]) and torch.equal(att, again[1])


@pytest.mark.parametrize("Lq,Lk,Dh", [(14, 14, 64), (60, 60, 128),
                                      (160, 160, 192)])
def test_attention_reads_f32_q(cuda, Lq, Lk, Dh):
    """q, k, v f32 as the per-sub-op engine's projections give them
    (masked_attention_pallas): the kernel rounds them to bf16 on load."""
    q, k, v, mask = _attention_inputs(3, 8, Lq, Lk, [Lk, 0, 5], cuda, Dh)
    q = q.float() + 1e-3 * torch.randn_like(q.float())
    out = K.masked_attention(q, k, v, mask, out_dtype=torch.float32)
    assert torch.equal(out, K.masked_attention(
        q.to(BF16), k.to(BF16), v.to(BF16), mask, out_dtype=torch.float32))
    _close(out, K.masked_attention_plain(q, k, v, mask,
                                         out_dtype=torch.float32), 2 ** -7)


@pytest.mark.parametrize("use_pallas,use_pallas_attflat", [
    (False, False), (True, False), ("packed", True), (False, True)])
def test_mode0_engine_matches_plain_on_the_card(cuda, use_pallas,
                                                use_pallas_attflat):
    from mcan_vqa_tpu_torch.api import Predictor
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    cfg, sd, vocab, ix_to_ans, questions = _small_model()
    plain = Predictor(cfg, sd, vocab, ix_to_ans=ix_to_ans, max_batch=8,
                      latency_buckets=(1,), engine="plain", device=cuda)
    fwd, prep = build_production_engine(
        sd, cfg.layer, cfg.multi_head, qffn=0, sga_mode=0, device=cuda,
        use_pallas=use_pallas, use_pallas_attflat=use_pallas_attflat)
    rng = np.random.default_rng(0)
    feats = [np.abs(rng.normal(size=(r, cfg.img_feat_size)))
             .astype(np.float32) for r in (60, 7, 33)]
    img, ques = plain.pad_batch(questions, feats)
    K.reset_launches()
    with torch.inference_mode():
        pf = torch.sigmoid(fwd(prep, torch.from_numpy(img).to(cuda),
                               torch.from_numpy(ques).to(cuda)))
    counts = K.launch_counts()
    L, flat = cfg.layer, int(bool(use_pallas or use_pallas_attflat))
    want = {"gemm_ln": 5 * L, "gemm_bias_act": 2 * L + 4 * flat}
    if use_pallas:
        want["masked_attention_f32"] = 3 * L
    if flat:
        want["attflat_pool"] = 2
    assert counts == want
    pp = plain.predict_probs(questions, feats)
    np.testing.assert_allclose(pf[:3].cpu().numpy(), pp, atol=1e-2)


# ---------------------------------------------------------------------------
# the int8 kernels and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,Kd,dtype,static", [
    (77, 512, torch.float32, False), (77, 2048, torch.float32, True),
    (61, 1024, BF16, False), (5, 512, BF16, True)])
def test_quantize_rows_matches_plain_bitwise(cuda, M, Kd, dtype, static):
    g = torch.Generator(device=cuda).manual_seed(M + Kd)
    x = (torch.randn(M, Kd, generator=g, device=cuda) * 3).to(dtype)
    x[1] = 0.0                                       # scale 1, codes 0
    x[2, :4] = torch.tensor([127.0, 0.5, 2.5, -3.5])  # ties at scale 1
    x[2, 4:] = 0.0
    inv_a = 1.0 / 0.021 if static else None          # saturates some rows
    q, s = K.quantize_rows(x, inv_a)
    before = K.launch_counts().get("quantize_rows", 0)
    rq, rs = K.quantize_rows_plain(x, inv_a)
    assert K.launch_counts().get("quantize_rows", 0) == before
    torch.cuda.synchronize()
    # every step is one correctly rounded operation: the same bits
    assert torch.equal(q, rq)
    assert (s is None and rs is None) or torch.equal(s, rs)
    if not static:
        assert q[2, :4].tolist() == [127, 0, 2, -4]


@pytest.mark.parametrize("M,Kd,N,static,relu", [
    (3840, 512, 2048, False, True), (896, 2048, 512, True, False),
    (61, 1024, 3072, False, False), (1, 4096, 1024, True, False)])
def test_gemm_s8_matches_plain_bitwise(cuda, M, Kd, N, static, relu):
    g = torch.Generator(device=cuda).manual_seed(N + M)
    aq = torch.randint(-127, 128, (M, Kd), generator=g, device=cuda,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (Kd, N), generator=g, device=cuda,
                       dtype=torch.int8)
    aq[0] = 127                   # 127 x 127 x K > 2^24 in column 0
    wq[:, 0] = 127
    wq = K.k_major(wq)            # the layout the engines prepare
    sw = torch.rand(N, generator=g, device=cuda) * 1e-3
    bias = torch.randn(N, generator=g, device=cuda)
    kw = dict(a=0.0173) if static else dict(
        sx=torch.rand(M, generator=g, device=cuda) * 0.05)
    outs = K.gemm_s8(aq, wq, sw, bias, relu=relu,
                     out_dtypes=(torch.float32, BF16), **kw)
    refs = K.gemm_s8_plain(aq, wq, sw, bias, relu=relu,
                           out_dtypes=(torch.float32, BF16), **kw)
    torch.cuda.synchronize()
    # exact int32 sums, then the same correctly rounded epilogue
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)


def test_gemm_s8_raises_on_unsupported_operands(cuda):
    aq = torch.zeros(8, 512, dtype=torch.int8, device=cuda)
    sw = torch.ones(64, device=cuda)

    def w(k, n):
        return K.k_major(torch.zeros(k, n, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="multiples of 16"):
        K.gemm_s8(aq[:, :500], w(500, 64), sw, a=1.0)
    with pytest.raises(ValueError, match="int8"):
        K.gemm_s8(aq.float(), w(512, 64), sw, a=1.0)
    with pytest.raises(ValueError, match="sx or a static scale"):
        K.gemm_s8(aq, w(512, 64), sw)
    # a weight stored row-major (the JAX layout as it is) is never
    # transposed per call: it raises
    with pytest.raises(ValueError, match="K-major"):
        K.gemm_s8(aq, torch.zeros(512, 64, dtype=torch.int8, device=cuda),
                  sw, a=1.0)


def test_gemm_s8_reads_rows_padded_to_16(cuda):
    """Any N: the answer head (N = 3129, an f32 row that is not 16-byte
    aligned, and a bf16 one not 8-byte aligned) and an AttFlat logit (N =
    1), each weight stored K-major with no padding (the TMA box reads
    zeros past N), with ragged M; both outputs equal the plain version's
    bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for N in (3129, 1):
        for M, static in ((37, True), (130, False)):
            aq = torch.randint(-127, 128, (M, 1024), generator=g,
                               device=cuda, dtype=torch.int8)
            wq = K.k_major(torch.randint(-127, 128, (1024, N), generator=g,
                                         device=cuda, dtype=torch.int8))
            assert wq.stride(0) == 1
            sw = torch.rand(N, generator=g, device=cuda) * 1e-3
            bias = torch.randn(N, generator=g, device=cuda)
            kw = dict(a=0.02) if static else dict(
                sx=torch.rand(M, generator=g, device=cuda) * 0.05)
            dts = (torch.float32, BF16)
            outs = K.gemm_s8(aq, wq, sw, bias, relu=not static,
                             out_dtypes=dts, **kw)
            refs = K.gemm_s8_plain(aq, wq, sw, bias, relu=not static,
                                   out_dtypes=dts, **kw)
            torch.cuda.synchronize()
            for out, ref in zip(outs, refs):
                assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="multiples of 16"):
        K.gemm_s8(aq[:, :1000], K.k_major(torch.zeros(
            1000, 3129, dtype=torch.int8, device=cuda)),
            torch.ones(3129, device=cuda), a=1.0)


def _packed_w4(g, Kd, N, cuda):
    """A random nibble-packed int4 weight (every code -7..7, the JAX packing)
    stored K-major, as the engines' ``_quant_w4`` stores it, and positive
    group scales."""
    lo = torch.randint(1, 16, (Kd // 2, N), generator=g, device=cuda)
    hi = torch.randint(1, 16, (Kd // 2, N), generator=g, device=cuda)
    wp = K.k_major((lo | (hi << 4)).to(torch.uint8).view(torch.int8))
    s4 = torch.rand(Kd // 128, N, generator=g, device=cuda) * 0.02 + 1e-3
    return wp, s4


@pytest.mark.parametrize("M,Kd,N,relu,with_bias", [
    (14, 512, 1536, False, True), (60, 512, 2048, True, True),
    (896, 2048, 512, False, False), (61, 1024, 3072, True, False),
    (3840, 4096, 1024, False, True), (1, 256, 64, False, True),
    # K % 256 != 0: a group straddles the nibble halves (hidden 384, 640)
    (14, 384, 1152, False, True), (3840, 384, 1536, True, True),
    (60, 640, 2560, False, False),
    # MCAN-large's w1 / w2 at B=1 and B=64
    (14, 1024, 4096, True, True), (14, 4096, 1024, False, True),
    (3840, 1024, 4096, True, False),
    # K split by the prefix rule: MCAN-small's B=1 w2 (4 splits), a
    # straddling group inside split 1 (9 groups, 2 splits)
    (14, 2048, 512, False, True), (60, 2048, 512, True, False),
    (14, 1152, 256, False, True)])
def test_gemm_s4_matches_plain_bitwise(cuda, M, Kd, N, relu, with_bias):
    g = torch.Generator(device=cuda).manual_seed(M + Kd)
    aq = torch.randint(-127, 128, (M, Kd), generator=g, device=cuda,
                       dtype=torch.int8)
    aq[0] = 127                        # the largest codes of every group
    wp, s4 = _packed_w4(g, Kd, N, cuda)
    bias = torch.randn(N, generator=g, device=cuda) if with_bias else None
    before = K.launch_counts().get("gemm_s4", 0)
    outs = K.gemm_s4(aq, wp, s4, bias, a=0.0173, relu=relu,
                     out_dtypes=(torch.float32, BF16))
    assert K.launch_counts()["gemm_s4"] == before + 1
    refs = K.gemm_s4_plain(aq, wp, s4, bias, a=0.0173, relu=relu,
                           out_dtypes=(torch.float32, BF16))
    torch.cuda.synchronize()
    # exact int32 sums per group, then the same correctly rounded steps in
    # the same order, split or not; a second run gives the same bits, and a
    # split plan leaves its tile counters at 0
    again = K.gemm_s4(aq, wp, s4, bias, a=0.0173, relu=relu,
                      out_dtypes=(torch.float32, BF16))
    for out, ref, out2 in zip(outs, refs, again):
        assert torch.equal(out, ref)
        assert torch.equal(out, out2)
    if K.gemm_plan(5, M, N, Kd).splits > 1:
        assert not K._SPLIT_COUNTERS[aq.device].any()


@pytest.mark.parametrize("M,Kd,N,relu,out_dtype", [
    (14, 512, 1536, False, BF16), (60, 512, 2048, True, torch.float32),
    (896, 2048, 512, False, torch.float32), (61, 1024, 3072, True, BF16),
    (14, 384, 1152, False, BF16), (60, 1536, 384, True, torch.float32),
    # MCAN-large's w1 / w2 at B=1 (w2 split 8 ways) and B=64; the B=1 and
    # B=64 encoder's MCAN-small w2 (4 and 2 splits); K 640
    (14, 1024, 4096, True, BF16), (14, 4096, 1024, False, torch.float32),
    (3840, 1024, 4096, True, BF16), (3840, 4096, 1024, False, torch.float32),
    (14, 2048, 512, False, torch.float32), (896, 2048, 512, False, BF16),
    (60, 640, 2560, True, BF16)])
def test_gemm_w4bf16_matches_plain(cuda, M, Kd, N, relu, out_dtype):
    g = torch.Generator(device=cuda).manual_seed(M + N)
    x = torch.randn(M, Kd, generator=g, device=cuda).to(BF16)
    wp, s4 = _packed_w4(g, Kd, N, cuda)
    bias = torch.randn(N, generator=g, device=cuda)
    out = K.gemm_w4bf16(x, wp, s4, bias, relu=relu, out_dtype=out_dtype)
    ref = K.gemm_w4bf16_plain(x, wp, s4, bias, relu=relu,
                              out_dtype=out_dtype)
    # gemm_bias_act's tolerance: the same bf16 weight (formed to the plain
    # version's bits) and exact products, summed in another order
    _close(out, ref, 1e-4 if out_dtype == torch.float32 else 2 ** -7)
    # the splits are summed in a fixed order: a second run, the same bits;
    # a split plan leaves its tile counters at 0
    assert torch.equal(out, K.gemm_w4bf16(x, wp, s4, bias, relu=relu,
                                          out_dtype=out_dtype))
    if K.gemm_plan(6, M, N, Kd).splits > 1:
        torch.cuda.synchronize()
        assert not K._SPLIT_COUNTERS[x.device].any()


def test_int4_gemms_raise_on_unsupported_operands(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    wp, s4 = _packed_w4(g, 192, 64, cuda)
    aq = torch.zeros(8, 192, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.gemm_s4(aq, wp, s4, a=1.0)
    with pytest.raises(ValueError, match="multiple of 128"):
        K.gemm_w4bf16(aq.to(BF16), wp, s4)
    wp, s4 = _packed_w4(g, 512, 64, cuda)
    with pytest.raises(ValueError, match="group scales"):
        K.gemm_s4(torch.zeros(8, 512, dtype=torch.int8, device=cuda), wp,
                  s4[:2], a=1.0)
    # a packed weight stored row-major (JAX's layout as it is) is never
    # transposed per call: both products raise
    x = torch.zeros(8, 512, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="K-major"):
        K.gemm_s4(x, wp.contiguous(), s4, a=1.0)
    with pytest.raises(ValueError, match="K-major"):
        K.gemm_w4bf16(x.to(BF16), wp.contiguous(), s4)


# the fragment edges of masked_attention.cu: Dh against the 16-column
# steps and the padding to 32 / 64, Lq against the 16-row warp tiles, Lk
# against the 8-key tiles, the 16-key steps, the one-block kernel's 64 / 128
# keys and the long kernel's 64-key chunks; odd Lk puts some Philox pairs
# across two counters
ATT_EDGES = [(1, 1, 1), (24, 14, 15), (60, 15, 16), (64, 16, 17),
             (64, 17, 14), (100, 60, 65), (128, 65, 64), (128, 127, 128),
             (64, 128, 129), (24, 129, 127), (192, 14, 15), (256, 17, 65),
             (192, 160, 129), (100, 64, 608), (60, 608, 60), (256, 1, 160),
             (1, 160, 608), (128, 15, 1), (64, 60, 60), (128, 60, 14)]


@pytest.mark.parametrize("Dh,Lq,Lk", ATT_EDGES)
def test_attention_fragment_edges_match_plain(cuda, Dh, Lq, Lk):
    """Each instance at its edges against the plain version, with and
    without a keep-mask; the f32 output rounded to bf16 is the bf16 output,
    f32 q / k / v give what their bf16 roundings give, a fully padded
    sample attends uniformly over its own keys, and the seeded route equals
    the mask route fed its dump, all bit for bit."""
    B, H, f32 = 3, 2, torch.float32
    q, k, v, mask = _attention_inputs(B, H, Lq, Lk, [Lk, 0, (Lk + 1) // 2],
                                      cuda, Dh)
    kb, vb = k.to(BF16), v.to(BF16)
    drop = _keep((B, H, Lq, Lk), cuda, Dh + Lq + Lk, 0.25).to(torch.uint8)
    for d, inv in ((None, 1.0), (drop, 1 / 0.75)):
        out = K.masked_attention(q, kb, vb, mask, d, inv)
        _close(out, K.masked_attention_plain(q, kb, vb, mask, d, inv), 2 ** -7)
        o32 = K.masked_attention(q, kb, vb, mask, d, inv, out_dtype=f32)
        _close(o32, K.masked_attention_plain(q, kb, vb, mask, d, inv,
                                             out_dtype=f32), 2 ** -7)
        assert torch.equal(o32.to(BF16), out)
        assert torch.equal(K.masked_attention(q.float(), k, v, mask, d, inv),
                           out)
    # sample 1 is all PAD: every key's probability is bf16(1 / Lk)
    p = torch.tensor(1.0 / Lk).to(BF16).float()
    uniform = (p * vb[1].float().sum(1, keepdim=True)).expand(H, Lq, Dh)
    _close(K.masked_attention(q, kb, vb, mask)[1],
           uniform.transpose(0, 1).reshape(Lq, H * Dh), 2 ** -7)
    from mcan_vqa_tpu_torch.ops import sga_train as st
    t, inv = st.prng_keep_params(0.1)
    seeded = K.Philox(11, 0x200, t)
    dump = K.dump_prng_masks(11, t, B, [(0x200, H, Lq * Lk)], "cuda")[0]
    assert torch.equal(K.masked_attention(q, kb, vb, mask, seeded, inv),
                       K.masked_attention(q, kb, vb, mask,
                                          dump.reshape(B, H, Lq, Lk), inv))


@pytest.mark.parametrize("Lq,Lk,Dh", [(60, 60, 64), (14, 14, 128),
                                      (60, 14, 64), (160, 160, 192),
                                      (17, 15, 24)])
def test_attention_reads_views_offset_by_one_element(cuda, Lq, Lk, Dh):
    """q, k, v as views that start one element into their buffers, rows of
    an odd stride (not 16-byte aligned: converting loads in place of
    cp.async), give what contiguous copies give, bit for bit."""
    B, H = 3, 8
    g = torch.Generator(device=cuda).manual_seed(Lq + Lk + Dh)

    def views(L, n):
        buf = torch.randn(B * L, n * H * Dh + 1, generator=g,
                          device=cuda).to(BF16)
        return [t.view(B, L, H, Dh).transpose(1, 2) for t in
                buf[:, 1:].view(B, L, n * H * Dh).split(H * Dh, dim=-1)]

    if Lq == Lk:
        q, k, v = views(Lq, 3)
    else:
        q, = views(Lq, 1)
        k, v = views(Lk, 2)
    mask = torch.zeros(B, 1, 1, Lk, dtype=torch.bool, device=cuda)
    mask[1] = True
    mask[2, ..., Lk // 2:] = True
    for odt in (BF16, torch.float32):
        out = K.masked_attention(q, k, v, mask, out_dtype=odt)
        ref = K.masked_attention(*[t.contiguous() for t in (q, k, v)], mask,
                                 out_dtype=odt)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.parametrize("Dh,Lq,Lk,qmax", [
    (64, 14, 1, 2), (64, 14, 14, 2), (64, 60, 17, 2), (64, 17, 32, 2),
    (64, 60, 33, 2), (64, 60, 60, 2), (64, 16, 64, 2), (128, 60, 65, 2),
    (128, 100, 100, 2), (128, 14, 127, 2), (128, 129, 128, 2),
    (64, 60, 60, 16), (128, 100, 100, 16)])
def test_attention_probabilities_equal_torch_softmax_bitwise(cuda, Dh, Lq,
                                                             Lk, qmax):
    """The one-block kernel's probabilities are torch.softmax's bit for bit
    where the scores are: q and k of small integers make every score an
    exact integer in any summation order, and v one-hot per key (v[j, j] =
    1) makes the f32 output the dropped, bf16-rounded probabilities
    themselves. So the row sums follow torch.softmax's order and each
    probability is e / sum, with and without a keep-mask and over ragged
    and fully padded samples; q up to 16 spreads the scores past 41.6, so
    some terms fall under 2^-60 (normalise's division path) and under
    f32's normal range."""
    B, H = 3, 2
    g = torch.Generator(device=cuda).manual_seed(Dh + Lq + Lk)

    def ints(L, m):
        return torch.randint(-m, m + 1, (B, H, L, Dh), generator=g,
                             device=cuda).to(BF16)

    q, k = ints(Lq, qmax), ints(Lk, 2)
    v = torch.zeros(B, H, Lk, Dh, dtype=BF16, device=cuda)
    v[..., torch.arange(Lk), torch.arange(Lk)] = 1.0
    idx = torch.arange(Lk, device=cuda)
    mask = (idx[None] >= torch.tensor([Lk, 0, (Lk + 1) // 2],
                                      device=cuda)[:, None])[:, None, None]
    assert K.attention_plan(B, H, Lq, Lk, Dh).instance == 0
    drop = _keep((B, H, Lq, Lk), cuda, Dh * Lk, 0.25).to(torch.uint8)
    for d, inv in ((None, 1.0), (drop, 1 / 0.75)):
        out = K.masked_attention(q, k, v, mask, d, inv,
                                 out_dtype=torch.float32)
        ref = K.masked_attention_plain(q, k, v, mask, d, inv,
                                       out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_block_gap_with_the_attention_kernel(cuda, seed,
                                                       monkeypatch):
    """The level-5 SGA block at MCAN-large width (D 1024, F 4096, 8 heads
    of 128; B = 64, 100 regions, 14 question keys, ragged pads with fully
    padded samples, random weights, static scales from the calibration
    replay) through the kernels against its plain version, with the
    attention kernel inside and with the plain attention swapped in: both
    within chip_smoke.py's [int4 blocks] tolerance, 6e-2. The attention's
    f32 output feeds a static int8 quantization, so any code it flips
    moves whole rows of the block's output. Prints both gaps."""
    from mcan_vqa_tpu_torch.ops import quant
    from mcan_vqa_tpu_torch.ops.serving import _cross_kv
    B, Lv, Lq, D, F, H = 64, 100, 14, 1024, 4096, 8
    g = torch.Generator(device=cuda).manual_seed(seed)

    def mat(k, n):
        return (torch.randn(k, n, generator=g, device=cuda)
                / k ** 0.5).to(BF16)

    def vec(n, base=0.0):
        return base + 0.1 * torch.randn(n, generator=g, device=cuda)

    wp = {"wqkv1": mat(D, 3 * D), "bqkv1": vec(3 * D), "w1": mat(D, F),
          "b1": vec(F), "w2": mat(F, D), "b2": vec(D),
          "wm1_full": mat(D, D), "bm1": vec(D), "wq2_full": mat(D, D),
          "bq2_full": vec(D), "wm2_full": mat(D, D), "bm2": vec(D)}
    for i in range(1, 4):
        wp[f"ln{i}_s"], wp[f"ln{i}_b"] = vec(D, 1.0), vec(D)
    dec = {"_mk": wp, "_qffn": quant.prepare_qffn_params(wp, True, True, 2),
           "mhatt2": {"linear_kv": {"kernel": mat(D, 2 * D),
                                    "bias": vec(2 * D)}}}
    x = torch.randn(B, Lq, D, generator=g, device=cuda).to(BF16)
    v = torch.randn(B, Lv, D, generator=g, device=cuda).to(BF16)

    def pads(L):
        lens = torch.tensor([(i * 17) % (L + 1) for i in range(B)],
                            device=cuda)
        return (torch.arange(L, device=cuda)[None]
                >= lens[:, None])[:, None, None, :]

    q_mask, v_mask = pads(Lq), pads(Lv)
    kq, vq = _cross_kv(dec["mhatt2"], x, H)
    scales = tuple(float(a) for a in quant._cal_sga_block(
        dec, v, x, v_mask, q_mask, H, 1.1)[1])

    def gap(block):
        out = block(v, kq, vq, v_mask, q_mask, wp, dec["_qffn"],
                    num_heads=H, act_scales=scales)
        torch.cuda.synchronize()
        return float((out.float() - ref.float()).abs().max())

    ref = quant.fused_qffn_sga_block_plain(
        v, kq, vq, v_mask, q_mask, wp, dec["_qffn"], num_heads=H,
        act_scales=scales)
    with_kernel = gap(quant.fused_qffn_sga_block)
    monkeypatch.setattr(quant, "_CUDA", quant._CUDA._replace(
        attention=K.masked_attention_plain))
    with_plain = gap(quant.fused_qffn_sga_block)
    print(f"seed {seed}: max|err| {with_kernel:.4e} with the attention "
          f"kernel, {with_plain:.4e} with the plain attention")
    assert with_kernel <= 6e-2 and with_plain <= 6e-2


def test_attention_rows_do_not_depend_on_the_batch(cuda):
    """B = 1 splits a head's rows over more blocks than B = 64 does: each
    row comes out the same, bit for bit (a replay at another batch size
    gives the same probabilities)."""
    for Lq, Lk, Dh in ((60, 60, 64), (14, 14, 64), (60, 14, 128),
                       (160, 160, 192)):
        q, k, v, mask = _attention_inputs(64, 8, Lq, Lk,
                                          [(i * 7) % (Lk + 1)
                                           for i in range(64)], cuda, Dh)
        assert K.attention_plan(1, 8, Lq, Lk, Dh).rows < \
            K.attention_plan(64, 8, Lq, Lk, Dh).rows or Lq <= 16
        out = K.masked_attention(q, k, v, mask)
        for b in (0, 5, 63):
            sl = slice(b, b + 1)
            assert torch.equal(K.masked_attention(q[sl], k[sl], v[sl],
                                                  mask[sl]), out[sl])


@pytest.mark.parametrize("Lq,Lk,lengths,Dh", [
    (14, 14, [14, 0, 5], 64), (60, 14, [3, 14, 0], 64),
    (60, 60, [0, 60, 17], 128)])
def test_attention_f32_output_matches_plain(cuda, Lq, Lk, lengths, Dh):
    q, k, v, mask = _attention_inputs(3, 8, Lq, Lk, lengths, cuda, Dh=Dh)
    before = K.launch_counts().get("masked_attention_f32", 0)
    out = K.masked_attention(q, k, v, mask, out_dtype=torch.float32)
    assert K.launch_counts()["masked_attention_f32"] == before + 1
    assert out.dtype == torch.float32
    # bf16 probabilities: one may land a rounding step apart
    _close(out, K.masked_attention_plain(q, k, v, mask,
                                         out_dtype=torch.float32), 2 ** -7)
    # the same sums as the bf16 output, kept before its rounding
    assert torch.equal(out.to(BF16), K.masked_attention(q, k, v, mask))


@pytest.mark.parametrize("level", [1, 3, 5, 6])
def test_qffn_blocks_match_plain_with_fully_padded_samples(cuda, level):
    from mcan_vqa_tpu_torch.ops import quant
    from mcan_vqa_tpu_torch.ops.serving import _cross_kv, prepare_params
    cfg, sd, *_ = _small_model()
    bb = prepare_params(sd, cfg.layer, device=cuda, qffn=level)["backbone"]
    g = torch.Generator(device=cuda).manual_seed(3)
    B, D, H = 5, cfg.hidden_size, cfg.multi_head
    x = torch.randn(B, 14, D, generator=g, device=cuda).to(BF16)
    v = torch.randn(B, 60, D, generator=g, device=cuda).to(BF16)
    q_mask = torch.zeros(B, 1, 1, 14, dtype=torch.bool, device=cuda)
    v_mask = torch.zeros(B, 1, 1, 60, dtype=torch.bool, device=cuda)
    q_mask[1] = True                    # an all-PAD question
    q_mask[3, ..., 4:] = True
    v_mask[2] = True                    # all-zero regions
    v_mask[4, ..., 33:] = True
    enc, dec = bb["enc_0"], bb["dec_0"]
    kq, vq = _cross_kv(dec["mhatt2"], x, H)
    sa_sc = sga_sc = None
    dq = level >= 6                     # levels 6/7: bf16-dequant int4
    if level >= 3:                      # the blocks' own static scales
        sa_sc = quant._cal_sa_block(enc, x, q_mask, H, 1.1, dq)[1]
        sga_sc = quant._cal_sga_block(dec, v, x, v_mask, q_mask, H, 1.1,
                                      dq)[1]
    before = K.launch_counts()
    out = quant.fused_qffn_sa_block(x, q_mask, enc["_mk"], enc["_qffn"],
                                    num_heads=H, act_scales=sa_sc, w4dq=dq)
    ref = quant.fused_qffn_sa_block_plain(x, q_mask, enc["_mk"],
                                          enc["_qffn"], num_heads=H,
                                          act_scales=sa_sc, w4dq=dq)
    # as the bf16 blocks (2^-5), plus int8 codes whose f32 input sits on a
    # rounding boundary, each moving one product term by s_x * |w|
    _close(out, ref, 2 ** -5)
    out = quant.fused_qffn_sga_block(v, kq, vq, v_mask, q_mask, dec["_mk"],
                                     dec["_qffn"], num_heads=H,
                                     act_scales=sga_sc, w4dq=dq)
    ref = quant.fused_qffn_sga_block_plain(v, kq, vq, v_mask, q_mask,
                                           dec["_mk"], dec["_qffn"],
                                           num_heads=H, act_scales=sga_sc,
                                           w4dq=dq)
    _close(out, ref, 2 ** -5)
    after = K.launch_counts()
    for name in ("fused_qffn_sa_block", "fused_qffn_sga_block"):
        assert after[name] - before.get(name, 0) == 1
        if level >= 4:
            key = f"{name}_level{level}"
            assert after[key] - before.get(key, 0) == 1
    int4 = {5: "gemm_s4", 6: "gemm_w4bf16"}.get(level)
    if int4:                            # qkv + FFN (5) / FFN (6), per block
        assert after[int4] - before.get(int4, 0) == (6 if level == 5 else 4)


def test_quant_blocks_match_plain_with_fully_padded_samples(cuda):
    """The full-int8 blocks: f32 stream, every site dynamic."""
    from mcan_vqa_tpu_torch.ops import quant
    from mcan_vqa_tpu_torch.ops.serving import (_qdense, _split_kv,
                                                quantize_params)
    cfg, sd, *_ = _small_model()
    bb = quantize_params(sd, cfg.layer, device=cuda)["backbone"]
    g = torch.Generator(device=cuda).manual_seed(4)
    B, D, H = 5, cfg.hidden_size, cfg.multi_head
    x = torch.randn(B, 14, D, generator=g, device=cuda)
    v = torch.randn(B, 60, D, generator=g, device=cuda)
    q_mask = torch.zeros(B, 1, 1, 14, dtype=torch.bool, device=cuda)
    v_mask = torch.zeros(B, 1, 1, 60, dtype=torch.bool, device=cuda)
    q_mask[1] = True
    v_mask[2] = True
    v_mask[4, ..., 33:] = True
    kq, vq = _split_kv(_qdense(bb["dec_0"]["mhatt2"]["linear_kv"], x), H)
    before = K.launch_counts()
    out = quant.fused_quant_sa_block(x, q_mask, bb["enc_0"]["_mk"],
                                     num_heads=H)
    ref = quant.fused_quant_sa_block_plain(x, q_mask, bb["enc_0"]["_mk"],
                                           num_heads=H)
    assert out.dtype == torch.float32
    _close(out, ref, 2 ** -5)           # as the qffn blocks
    out = quant.fused_quant_sga_block(v, kq, vq, v_mask, q_mask,
                                      bb["dec_0"]["_mk"], num_heads=H)
    ref = quant.fused_quant_sga_block_plain(v, kq, vq, v_mask, q_mask,
                                            bb["dec_0"]["_mk"], num_heads=H)
    _close(out, ref, 2 ** -5)
    after = K.launch_counts()
    for name in ("fused_quant_sa_block", "fused_quant_sga_block"):
        assert after[name] - before.get(name, 0) == 1
    # SA: qkv, merge, w1, w2; SGA: + the cross q and its merge
    assert after["gemm_s8"] - before.get("gemm_s8", 0) == 10


@pytest.mark.parametrize("kw", [dict(engine="int4"), dict(q8aux=True),
                                dict(engine="int8")])
def test_quantized_predictors_match_plain_on_the_card(cuda, kw):
    from mcan_vqa_tpu_torch.api import Predictor
    cfg, sd, vocab, ix_to_ans, questions = _small_model()
    rng = np.random.default_rng(1)
    feats = [np.abs(rng.normal(size=(r, cfg.img_feat_size)))
             .astype(np.float32) for r in (60, 7, 33)]
    cal = {} if kw.get("engine") == "int8" else dict(
        act_calibration=(questions, feats))
    p = Predictor(cfg, sd, vocab, ix_to_ans=ix_to_ans, max_batch=8,
                  device=cuda, **kw, **cal)
    plain = Predictor(cfg, sd, vocab, ix_to_ans=ix_to_ans, max_batch=8,
                      device=cuda, engine="plain")
    K.reset_launches()
    pf = p.predict_probs(questions, feats)
    counts = K.launch_counts()
    block = "fused_quant" if kw.get("engine") == "int8" else "fused_qffn"
    assert counts[f"{block}_sa_block"] == counts[f"{block}_sga_block"] \
        == cfg.layer
    if kw.get("engine") == "int4":
        assert counts["fused_qffn_sa_block_level5"] == cfg.layer
    pp = plain.predict_probs(questions, feats)
    assert np.isfinite(pf).all() and pf.shape == (3, 50)
    # the int8 engines' bound, 2e-2; int4's weights alone move these
    # probabilities by up to 4.2e-2 at full width (tests/test_torch_full_
    # size.py), 0.04 at this depth of 2 layers
    np.testing.assert_allclose(
        pf, pp, atol=4e-2 if kw.get("engine") == "int4" else 2e-2)


# ---------------------------------------------------------------------------
# the train kernels: dropout epilogues, the backward products, the LN and
# attention backward, the column sums, and the SGA train block
# ---------------------------------------------------------------------------

def _keep(shape, cuda, seed, rate=0.1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.rand(shape, generator=g, device=cuda) >= rate


def test_gemm_relu_dropout_epilogue_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    M, Kd, N = 130, 512, 2048
    a = torch.randn(M, Kd, generator=g, device=cuda).to(BF16)
    w = (torch.randn(Kd, N, generator=g, device=cuda) / Kd ** 0.5).to(BF16)
    b = torch.randn(N, generator=g, device=cuda)
    mask = _keep((M, N), cuda, 6)
    kw = dict(relu=True, out_dtype=BF16, mask=mask, inv_keep=1 / 0.9)
    _close(K.gemm_bias_act(a, w, b, **kw),
           K.gemm_bias_act_plain(a, w, b, **kw), 2 ** -7)


def _operand(rows, width, g, cuda, sliced, s=1.0):
    """A bf16 [rows, width] operand, or a view of a wider buffer (row
    stride width + 24 > width), as the blocks pass slices of fused
    buffers."""
    full = torch.randn(rows, width + 24 * sliced, generator=g, device=cuda)
    return (full[:, :width] * s).to(BF16) if not sliced else \
        (full * s).to(BF16)[:, 8:8 + width]


@pytest.mark.parametrize("M,N,Kd,with_gate,with_res,sliced", [
    (122, 2048, 512, True, False, False), (122, 2048, 512, False, True, False),
    # the train steps' shapes: MCAN-small decoder / encoder, MCAN-large
    (3840, 2048, 512, True, False, False), (3840, 512, 2048, False, True, True),
    (896, 512, 1536, True, True, False), (1920, 4096, 1024, True, True, True),
    # the edges: one row, 7 rows, widths 8 and 480
    (1, 8, 8, True, True, False), (7, 480, 4096, True, True, True),
    (1920, 8, 480, False, True, False)])
def test_gemm_dx_matches_plain(cuda, M, N, Kd, with_gate, with_res, sliced):
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = _operand(M, Kd, g, cuda, sliced)     # dy [M, K] . w[N, K]^T
    w = _operand(N, Kd, g, cuda, sliced, Kd ** -0.5)
    gate = torch.relu(torch.randn(M, N, generator=g, device=cuda)).to(BF16) \
        if with_gate else None
    res = torch.randn(M, N, generator=g, device=cuda) if with_res else None
    kw = dict(gate=gate, inv_keep=1 / 0.9, res=res,
              out_dtypes=(torch.float32, BF16))
    before = K.launch_counts().get("gemm_dx", 0)
    outs = K.gemm_dx(dy, w, **kw)
    assert K.launch_counts()["gemm_dx"] == before + 1
    refs = K.gemm_dx_plain(dy, w, **kw)
    _close(outs[0], refs[0], 1e-4)
    _close(outs[1], refs[1], 2 ** -7)


@pytest.mark.parametrize("R,M,N,sliced", [
    (3840, 512, 2048, False), (77, 2048, 512, False),
    # the train steps' shapes (split over R: 2 and 5 splits at 3840 rows)
    (3840, 512, 512, True), (3840, 2048, 512, False), (896, 512, 1536, True),
    (1920, 1024, 4096, False), (1920, 4096, 1024, True),
    # the edges: one row, 7 rows, widths 8 and 480
    (1, 8, 8, False), (7, 480, 512, True), (896, 8, 480, False),
    (3840, 4096, 8, True)])
def test_gemm_dw_matches_plain_and_repeats_bitwise(cuda, R, M, N, sliced):
    g = torch.Generator(device=cuda).manual_seed(R)
    x = _operand(R, M, g, cuda, sliced)
    dy = _operand(R, N, g, cuda, sliced, R ** -0.5)
    out = K.gemm_dw(x, dy)
    # f32 sums of exact bf16 products over R rows, in another order
    _close(out, K.gemm_dw_plain(x, dy), 1e-4)
    assert torch.equal(out, K.gemm_dw(x, dy))


def test_gemm_dw_split_k_repeats_bitwise(cuda):
    """Five splits of 3840 rows summed in split order: ten runs, one set of
    bits, whichever block of a tile arrives last."""
    plan = K.gemm_plan(2, 512, 512, 3840)
    assert plan.splits == 5
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(3840, 512, generator=g, device=cuda).to(BF16)
    dy = (torch.randn(3840, 512, generator=g, device=cuda) / 60).to(BF16)
    first = K.gemm_dw(x, dy)
    for _ in range(9):
        assert torch.equal(first, K.gemm_dw(x, dy))
    _close(first, K.gemm_dw_plain(x, dy), 1e-4)


def test_gemm_sm90_raises_on_unsupported_operands(cuda):
    x = torch.zeros(64, 512, dtype=BF16, device=cuda)
    w = torch.zeros(512, 512, dtype=BF16, device=cuda)
    with pytest.raises(ValueError, match="multiple of"):
        K.gemm_dx(x[:, :500], w[:, :500])          # K = 500
    with pytest.raises(ValueError, match="multiple of"):
        K.gemm_dw(x[:, :100], x)                  # dW's M = 100
    with pytest.raises(ValueError, match="16-byte alignment"):
        K.gemm_dw(x[:, 1:9], x[:, :8])            # misaligned start
    with pytest.raises(ValueError, match="bf16"):
        K.gemm_dx(x.float(), w)
    with pytest.raises(ValueError, match="do not chain"):
        K.gemm_dx(x, w[:, :256])


@pytest.mark.parametrize("Lq,Lk,lengths,kv_dtype,Dh", [
    (60, 60, [0, 60, 17], BF16, 64), (60, 14, [3, 14, 0], torch.float32, 64),
    (60, 60, [0, 60, 17], BF16, 128), (60, 14, [3, 14, 0], torch.float32, 128),
    (14, 14, [14, 0, 5], BF16, 128),
    # the widened envelope: hidden 128 / 256 at 8 heads, MIMIC's 86 rows
    (60, 14, [3, 14, 0], torch.float32, 16), (14, 14, [14, 0, 5], BF16, 32),
    (86, 86, [0, 86, 40], BF16, 64), (86, 14, [3, 14, 0], torch.float32, 32),
    (128, 128, [128, 0, 77], BF16, 128), (14, 14, [14, 0, 5], BF16, 96),
    # the long kernels: Dh 192 / 256 (hidden 1536 / 2048 at 8 heads), 160
    # and 608 rows (grid features), any mix
    (160, 160, [0, 160, 77], BF16, 192), (60, 14, [3, 14, 0],
                                          torch.float32, 256),
    (608, 608, [608, 0, 301], BF16, 64), (14, 608, [3, 608, 0],
                                          torch.float32, 256),
    (160, 14, [160, 0, 5], BF16, 192)])
def test_attention_dropout_and_backward_match_plain(cuda, Lq, Lk, lengths,
                                                    kv_dtype, Dh):
    """Head widths 64 (MCAN-small) and 128 (MCAN-large): the forward and
    the backward against their plain versions, with fully padded
    samples."""
    B, H = 3, 8
    q, k, v, mask = _attention_inputs(B, H, Lq, Lk, lengths, cuda, Dh)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    drop = _keep((B, H, Lq, Lk), cuda, Lq + Lk, 0.25).to(torch.uint8)
    inv = 1 / 0.75
    _close(K.masked_attention(q, k, v, mask, drop, inv),
           K.masked_attention_plain(q, k, v, mask, drop, inv), 2 ** -7)
    g = torch.Generator(device=cuda).manual_seed(3)
    dout = torch.randn(B, Lq, H * Dh, generator=g, device=cuda).to(BF16)
    f32 = torch.float32

    def grads(fn):
        dq = torch.empty(B, H, Lq, Dh, device=cuda)
        dk, dv = (torch.empty(B, H, Lk, Dh, device=cuda) for _ in range(2))
        d16 = [torch.empty(t.shape, dtype=BF16, device=cuda)
               for t in (dq, dk, dv)]
        fn(q, k, v, mask, dout, dq, dk, dv, *d16, drop=drop, inv_keep=inv)
        return (dq, dk, dv), d16

    (o32, o16), (r32, r16) = grads(K.masked_attention_bwd), \
        grads(K.masked_attention_bwd_plain)
    for a, b in zip(o32, r32):
        scale = float(b.abs().max()) + 1e-6
        # dS rounded to bf16 may land a step apart: 2^-7 of the scale
        _close(a / scale, b / scale, 2 ** -7)
    for a, b in zip(o16, o32):
        _close(a, b.to(BF16).to(f32), 0)


def _bwd(fn, q, k, v, mask, dout, drop=None, inv=1.0, copies=True):
    """dq, dk, dv (f32) and their bf16 copies from one backward call."""
    B, H, Lq, Dh = q.shape
    dq = torch.empty(B, H, Lq, Dh, device=q.device)
    dk, dv = (torch.empty(k.shape, device=q.device) for _ in range(2))
    d16 = [torch.empty(t.shape, dtype=BF16, device=q.device) if copies
           else None for t in (dq, dk, dv)]
    fn(q, k, v, mask, dout, dq, dk, dv, *d16, drop=drop, inv_keep=inv)
    return (dq, dk, dv), d16


@pytest.mark.parametrize("Dh,Lq,Lk", ATT_EDGES)
def test_attention_bwd_fragment_edges_match_plain(cuda, Dh, Lq, Lk):
    """Each backward instance at the forward's fragment edges (and past
    128 query rows, where the backward takes its long kernels) against the
    plain version, with and without a keep-mask, over a full, a fully
    padded and a ragged sample: within 2^-7 of each output's max|ref|; the
    bf16 copies are the f32 outputs rounded; f32 k / v give what their bf16
    roundings give; a second run gives the same bits; the seeded route
    equals the mask route fed its dump."""
    B, H = 3, 2
    q, k, v, mask = _attention_inputs(B, H, Lq, Lk, [Lk, 0, (Lk + 1) // 2],
                                      cuda, Dh)
    kb, vb = k.to(BF16), v.to(BF16)
    g = torch.Generator(device=cuda).manual_seed(Dh + Lq + Lk)
    dout = torch.randn(B, Lq, H * Dh, generator=g, device=cuda).to(BF16)
    drop = _keep((B, H, Lq, Lk), cuda, Dh + Lq + Lk, 0.25).to(torch.uint8)
    for d, inv in ((None, 1.0), (drop, 1 / 0.75)):
        o32, o16 = _bwd(K.masked_attention_bwd, q, kb, vb, mask, dout, d, inv)
        r32, _ = _bwd(K.masked_attention_bwd_plain, q, kb, vb, mask, dout, d,
                      inv)
        for a, b in zip(o32, r32):
            scale = float(b.abs().max()) + 1e-6
            # dS rounded to bf16 may land a step apart: 2^-7 of the scale
            _close(a / scale, b / scale, 2 ** -7)
        for a, b in zip(o16, o32):
            assert torch.equal(a, b.to(BF16))
        for again in (_bwd(K.masked_attention_bwd, q, kb, vb, mask, dout, d,
                           inv)[0],
                      _bwd(K.masked_attention_bwd, q, k, v, mask, dout, d,
                           inv)[0]):
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(again, o32))
    p, inv = _seeded(0x200)
    dump = _dumped(p, B, H, Lq * Lk).reshape(B, H, Lq, Lk)
    seeded = _bwd(K.masked_attention_bwd, q, kb, vb, mask, dout, p, inv)[0]
    fed = _bwd(K.masked_attention_bwd, q, kb, vb, mask, dout, dump, inv)[0]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(seeded, fed))


@pytest.mark.parametrize("Lq,Lk,Dh", [(60, 60, 64), (60, 14, 64),
                                      (14, 14, 64), (128, 128, 128)])
def test_attention_bwd_recomputes_the_forward_probabilities_bitwise(
        cuda, Lq, Lk, Dh):
    """Where both run one-block, the backward's recomputed dropped,
    bf16-rounded probabilities are the forward's bit for bit: the forward
    with V = I (Lk <= Dh) returns Pd as its f32 output, the backward with
    dO = I (Lq <= Dh) returns Pd^T in dV; without dropout, with a
    keep-mask and with the Philox route, over a full, a fully padded and a
    ragged sample."""
    B, H, f32 = 3, 2, torch.float32
    q, k, _, mask = _attention_inputs(B, H, Lq, Lk, [Lk, 0, (Lk + 1) // 2],
                                      cuda, Dh)
    k = k.to(BF16)
    assert K.attention_plan(B, H, Lq, Lk, Dh).instance == 0
    assert K.attention_bwd_plan(B, H, Lq, Lk, Dh).instance == 0
    eye_v = torch.eye(Lk, Dh, device=cuda).to(BF16).expand(
        B, H, Lk, Dh).contiguous()
    dout = torch.eye(Lq, Dh, device=cuda)[None, :, None, :].expand(
        B, Lq, H, Dh).reshape(B, Lq, H * Dh).to(BF16)
    drop = _keep((B, H, Lq, Lk), cuda, Dh * Lk, 0.25).to(torch.uint8)
    p, pinv = _seeded(0x200)
    for d, inv in ((None, 1.0), (drop, 1 / 0.75), (p, pinv)):
        out = K.masked_attention(q, k, eye_v, mask, d, inv, out_dtype=f32)
        pd_fwd = out.view(B, Lq, H, Dh).transpose(1, 2)[..., :Lk]
        (_, _, dv), _ = _bwd(K.masked_attention_bwd, q, k, eye_v, mask,
                             dout, d, inv, copies=False)
        torch.cuda.synchronize()
        assert torch.equal(dv[..., :Lq].transpose(-1, -2), pd_fwd)


def test_attention_bwd_rows_do_not_depend_on_the_batch(cuda):
    """A sample's gradients do not depend on the batch around it, nor on
    the plan the batch size gives the long kernels (B = 1 splits a head's
    query and key rows over more blocks than B = 64), bit for bit."""
    B, H = 64, 8
    for Lq, Lk, Dh in ((60, 60, 64), (60, 14, 128), (160, 160, 192),
                       (130, 60, 64)):
        q, k, v, mask = _attention_inputs(B, H, Lq, Lk,
                                          [(i * 7) % (Lk + 1)
                                           for i in range(B)], cuda, Dh)
        k, v = k.to(BF16), v.to(BF16)
        g = torch.Generator(device=cuda).manual_seed(Lq + Dh)
        dout = torch.randn(B, Lq, H * Dh, generator=g, device=cuda).to(BF16)
        drop = _keep((B, H, Lq, Lk), cuda, Lq + Lk, 0.25).to(torch.uint8)
        one, full = K.attention_bwd_plan(1, H, Lq, Lk, Dh), \
            K.attention_bwd_plan(B, H, Lq, Lk, Dh)
        assert one.instance == 0 or (one.rows, one.key_rows) != (
            full.rows, full.key_rows)
        ref = _bwd(K.masked_attention_bwd, q, k, v, mask, dout, drop,
                   1 / 0.75)[0]
        for b in (0, 5, 63):
            sl = slice(b, b + 1)
            got = _bwd(K.masked_attention_bwd, q[sl], k[sl], v[sl],
                       mask[sl], dout[sl], drop[sl], 1 / 0.75)[0]
            torch.cuda.synchronize()
            assert all(torch.equal(a, r[sl]) for a, r in zip(got, ref))


@pytest.mark.parametrize("D,with_y", [(512, True), (1024, False),
                                      (256, True), (768, True)])
def test_layernorm_dropout_save_r_and_backward_match_plain(cuda, D, with_y):
    g = torch.Generator(device=cuda).manual_seed(D + 1)
    rows = 123
    res = torch.randn(rows, D, generator=g, device=cuda)
    y = torch.randn(rows, D, generator=g, device=cuda) if with_y else None
    bias = torch.randn(D, generator=g, device=cuda) if with_y else None
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    beta = 0.1 * torch.randn(D, generator=g, device=cuda)
    mask = _keep((rows, D), cuda, D + 2) if with_y else None
    inv = 1 / 0.9
    if with_y:
        kw = dict(mask=mask, inv_keep=inv, save_r=True, reciprocal=True)
        outs = K.residual_layernorm(res, y, bias, gamma, beta,
                                    (torch.float32,), **kw)
        refs = K.residual_layernorm_plain(res, y, bias, gamma, beta,
                                          (torch.float32,), **kw)
        _close(outs[0], refs[0], 1e-5)
        _close(outs[1], refs[1], 1e-6)      # r: the same f32 adds
    gout = torch.randn(rows, D, generator=g, device=cuda)
    kw = dict(mask=mask, inv_keep=inv, dy_dtypes=(torch.float32, BF16))
    outs = K.residual_layernorm_bwd(gout, res, y, bias, gamma, **kw)
    refs = K.residual_layernorm_bwd_plain(gout, res, y, bias, gamma, **kw)
    for a, b, tol in zip(outs, refs, (1e-4, 1e-5, 1e-4, 2 ** -7)):
        _close(a, b, tol)


def test_layernorm_bf16_saves_match_plain(cuda):
    """bf16_saves: r written bf16 by the forward; the backward reads a bf16
    r (no y) and a bf16 upstream gradient as saved."""
    g = torch.Generator(device=cuda).manual_seed(13)
    rows, D = 1920, 1024
    res, y = (torch.randn(rows, D, generator=g, device=cuda)
              for _ in range(2))
    bias, beta = (0.1 * torch.randn(D, generator=g, device=cuda)
                  for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    mask = _keep((rows, D), cuda, 14)
    kw = dict(mask=mask, inv_keep=1 / 0.9, save_r=True, reciprocal=True,
              r_dtype=BF16)
    out, r = K.residual_layernorm(res, y, bias, gamma, beta, (torch.float32,),
                                  **kw)
    ref, rref = K.residual_layernorm_plain(res, y, bias, gamma, beta,
                                           (torch.float32,), **kw)
    assert r.dtype == BF16
    _close(out, ref, 1e-5)
    _close(r, rref, 2 ** -7)            # the same f32 sum, rounded once
    gout = torch.randn(rows, D, generator=g, device=cuda).to(BF16)
    kw = dict(mask=mask, inv_keep=1 / 0.9, dy_dtypes=(torch.float32, BF16))
    outs = K.residual_layernorm_bwd(gout, rref, None, None, gamma, **kw)
    refs = K.residual_layernorm_bwd_plain(gout, rref, None, None, gamma,
                                          **kw)
    for a, b, tol in zip(outs, refs, (1e-4, 1e-5, 1e-4, 2 ** -7)):
        _close(a, b, tol)


def test_col_sum_matches_plain_and_repeats_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    mats = [torch.randn(3840, n, generator=g, device=cuda)
            for n in (1536, 2048, 512, 7)]
    mats[2] = mats[2].to(BF16)          # a bf16 gradient (bf16_saves)
    outs = K.col_sum(mats)
    for a, b in zip(outs, K.col_sum_plain(mats)):
        _close(a, b, 1e-3)              # 3840-term f32 sums, other order
    assert all(torch.equal(a, b) for a, b in zip(outs, K.col_sum(mats)))
    with pytest.raises(ValueError, match="1 to 4"):
        K.col_sum(mats + mats[:1])


@pytest.mark.parametrize("rows,widths,bf16_last", [
    # MCAN-large per micro-batch of 32 (1920 rows): the FFN, the
    # self-attention and the cross sums, the last with the bf16 gv2
    (1920, (4096, 1024, 1024, 1024), False),
    (1920, (3072, 1024, 1024, 1024), False),
    (1920, (1024, 1024, 1024, 1024), True),
    # ragged rows: one, seven, counts no slab divides; widths narrower
    # than a chunk and no multiple of 4 or 8
    (1, (512, 7), True), (7, (2048, 100), True),
    (3841, (512, 24, 1536, 5), True), (1000, (96, 40, 8, 3), False)])
def test_col_sum_at_large_and_ragged_shapes(cuda, rows, widths, bf16_last):
    """Every shape against the plain sums (f32 sums in another order), two
    runs bit for bit, and the chunk counters left at 0."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    mats = [torch.randn(rows, w, generator=g, device=cuda) for w in widths]
    if bf16_last:
        mats[-1] = mats[-1].to(BF16)
    outs = K.col_sum(mats)
    for a, b in zip(outs, K.col_sum_plain(mats)):
        _close(a, b, 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(outs, K.col_sum(mats)))
    torch.cuda.synchronize()
    counters = K._COL_SUM_COUNTERS.get(mats[0].device)
    assert counters is None or not counters.any()


def _train_block_inputs(cuda, B=64, Lv=60, Lq=14, D=512, F=2048, H=8):
    """The main path's shapes (MCAN-small, B=64; MCAN-large per
    micro-batch of 32: D=1024, F=4096), rate 0.1, with fully padded image
    and question samples among ragged ones. Weights of std 0.05 at
    D = 512, scaled by sqrt(512 / D) so that every product's outputs keep
    that spread at another width (as chip_smoke.py draws them)."""
    from mcan_vqa_tpu_torch.ops import sga_train as st
    g = torch.Generator(device=cuda).manual_seed(21)

    def mat(*shape, s=0.05 * (512 / D) ** 0.5):
        return (torch.randn(*shape, generator=g, device=cuda) * s)

    w = {"wqkv": mat(D, 3 * D), "bqkv": mat(3 * D), "wm1": mat(D, D),
         "bm1": mat(D), "ln1_s": 1 + mat(D), "ln1_b": mat(D),
         "wq2": mat(D, D), "bq2": mat(D), "wm2": mat(D, D), "bm2": mat(D),
         "ln2_s": 1 + mat(D), "ln2_b": mat(D), "w1": mat(D, F),
         "b1": mat(F), "w2": mat(F, D), "b2": mat(D), "ln3_s": 1 + mat(D),
         "ln3_b": mat(D)}
    x = torch.randn(B, Lv, D, generator=g, device=cuda)
    kq = torch.randn(B, H, Lq, D // H, generator=g, device=cuda)
    vq = torch.randn(B, H, Lq, D // H, generator=g, device=cuda)
    v_len = torch.tensor([(i * 17) % (Lv + 1) for i in range(B)],
                         device=cuda)
    q_len = torch.tensor([(i * 5) % (Lq + 1) for i in range(B)], device=cuda)
    v_mask = (torch.arange(Lv, device=cuda)[None] >= v_len[:, None])
    q_mask = (torch.arange(Lq, device=cuda)[None] >= q_len[:, None])
    masks, inv = st.make_dropout_masks(g, 0.1, B, Lv, Lq, D, F, H)
    probe = torch.randn(B, Lv, D, generator=g, device=cuda)
    return (x, kq, vq, v_mask[:, None, None], q_mask[:, None, None], masks,
            w, inv, probe)


def _block_vs_plain(fused, plain, leaves, ws, names, probe, call):
    """Run the kernel block and its plain twin under autograd -> (out,
    grads) of each, and the kernel block's launch counts."""
    def run(block):
        ls = [t.clone().requires_grad_() for t in leaves]
        wd = {k: t.clone().requires_grad_() for k, t in ws.items()}
        out = call(block, ls, wd)
        (out * probe).sum().backward()
        return out.detach(), [t.grad for t in ls] + [wd[n].grad
                                                     for n in names]

    K.reset_launches()
    got = run(fused)
    counts = K.launch_counts()
    return got, run(plain), run(fused), counts


def _check_block(got, ref, again):
    """Tolerances: the kernels match their plain versions call by call
    (tests above); composed over the block, sums in another order move
    bf16 roundings and ReLU gates, which the LayerNorm and softmax
    backwards carry on. Measured on an H100 at the MCAN-small SGA block:
    v3 within 2e-2, every gradient within 2e-2 in relative norm and 6.4e-2
    of its max|ref| elementwise."""
    (out, grads), (rout, rgrads), (out2, grads2) = got, ref, again
    _close(out, rout, 6e-2)
    for a, b in zip(grads, rgrads):
        assert float((a - b).norm() / b.norm()) <= 3e-2
        scale = float(b.abs().max()) + 1e-6
        _close(a / scale, b / scale, 1e-1)
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_sga_train_block_matches_plain_and_repeats_bitwise(cuda):
    from mcan_vqa_tpu_torch.ops import sga_train as st
    x, kq, vq, vm, qm, masks, w, inv, probe = _train_block_inputs(cuda)
    got, ref, again, counts = _block_vs_plain(
        st.fused_sga_block_train, st.fused_sga_block_train_plain,
        (x, kq, vq), w, st.WEIGHT_NAMES, probe,
        lambda blk, ls, wd: blk(*ls, vm, qm, masks, wd, num_heads=8,
                                inv_keep=inv))
    assert counts["sga_train_fwd"] == counts["sga_train_bwd_ffn"] == \
        counts["sga_train_bwd_att"] == 1
    _check_block(got, ref, again)


def test_sga_train_block_att_saves_bf16_at_large_width(cuda):
    """MCAN-large's decoder block (D=1024, 8 heads of 128, F=4096) per
    micro-batch of 32, with att_saves and bf16_saves, against the plain
    block, which saves f32 (bf16_saves rounds r1 / r2 / r3 / gv2: 2^-8
    relative each, inside the block tolerance)."""
    import functools

    from mcan_vqa_tpu_torch.ops import sga_train as st
    x, kq, vq, vm, qm, masks, w, inv, probe = _train_block_inputs(
        cuda, B=32, D=1024, F=4096)
    fused = functools.partial(st.fused_sga_block_train, att_saves=True,
                              bf16_saves=True)
    got, ref, again, counts = _block_vs_plain(
        fused, st.fused_sga_block_train_plain, (x, kq, vq), w,
        st.WEIGHT_NAMES, probe,
        lambda blk, ls, wd: blk(*ls, vm, qm, masks, wd, num_heads=8,
                                inv_keep=inv))
    assert counts["sga_train_bwd_att_sav"] == 1
    assert "sga_train_bwd_att" not in counts
    _check_block(got, ref, again)


def test_sa_train_block_matches_plain_and_repeats_bitwise(cuda):
    """MCAN-small's encoder block at B=64, 14 tokens, rate 0.1, with
    all-PAD questions among ragged ones, save_acts both ways."""
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    B, L, D, F, H = 64, 14, 512, 2048, 8
    g = torch.Generator(device=cuda).manual_seed(31)
    w = {n: 0.05 * torch.randn(*shape, generator=g, device=cuda)
         for n, shape in (("wqkv", (D, 3 * D)), ("bqkv", (3 * D,)),
                          ("wm", (D, D)), ("bm", (D,)), ("ln1_b", (D,)),
                          ("w1", (D, F)), ("b1", (F,)), ("w2", (F, D)),
                          ("b2", (D,)), ("ln2_b", (D,)))}
    for n in ("ln1_s", "ln2_s"):
        w[n] = 1 + 0.05 * torch.randn(D, generator=g, device=cuda)
    x = torch.randn(B, L, D, generator=g, device=cuda)
    lens = torch.tensor([(i * 5) % (L + 1) for i in range(B)], device=cuda)
    mask = (torch.arange(L, device=cuda)[None] >= lens[:, None])[:, None,
                                                                 None]
    masks, inv = sa.make_sa_dropout_masks(g, 0.1, B, L, D, F, H)
    probe = torch.randn(B, L, D, generator=g, device=cuda)
    for save_acts in (True, False):
        got, ref, again, counts = _block_vs_plain(
            sa.fused_sa_block_train, sa.fused_sa_block_train_plain, (x,), w,
            sa.SA_WEIGHT_NAMES, probe,
            lambda blk, ls, wd: blk(*ls, mask, masks, wd, num_heads=H,
                                    inv_keep=inv, save_acts=save_acts))
        assert counts["sa_train_fwd"] == counts["sa_train_bwd"] == 1
        _check_block(got, ref, again)


def _image_sa_inputs(cuda, B, D, L=60, seed=41):
    """The classifier's SA block over the image stream: weights of
    LN-scale activations at width D, [B, 60, D], ragged regions with a
    fully padded image."""
    F = 4 * D
    g = torch.Generator(device=cuda).manual_seed(seed)
    s = 0.05 * (512 / D) ** 0.5
    w = {n: s * torch.randn(*shape, generator=g, device=cuda)
         for n, shape in (("wqkv", (D, 3 * D)), ("bqkv", (3 * D,)),
                          ("wm", (D, D)), ("bm", (D,)), ("ln1_b", (D,)),
                          ("w1", (D, F)), ("b1", (F,)), ("w2", (F, D)),
                          ("b2", (D,)), ("ln2_b", (D,)))}
    for n in ("ln1_s", "ln2_s"):
        w[n] = 1 + s * torch.randn(D, generator=g, device=cuda)
    x = torch.randn(B, L, D, generator=g, device=cuda)
    lens = torch.tensor([(i * 17) % (L + 1) for i in range(B)], device=cuda)
    mask = (torch.arange(L, device=cuda)[None] >= lens[:, None])[:, None,
                                                                 None]
    probe = torch.randn(B, L, D, generator=g, device=cuda)
    return x, mask, w, probe, g


@pytest.mark.parametrize("D", [512, 1024])
def test_image_sa_train_block_matches_plain(cuda, D):
    """The classifier's SA train block at 60 regions (MCAN-small, and
    hidden 1024 with 128-wide heads), fed masks and seeded: against its
    plain twin, and the seeded block equal bit for bit to the block fed
    its dump."""
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    B, H = 16, 8
    x, mask, w, probe, g = _image_sa_inputs(cuda, B, D)
    masks, inv = sa.make_sa_dropout_masks(g, 0.1, B, 60, D, 4 * D, H)
    got, ref, again, counts = _block_vs_plain(
        sa.fused_sa_block_train, sa.fused_sa_block_train_plain, (x,), w,
        sa.SA_WEIGHT_NAMES, probe,
        lambda blk, ls, wd: blk(*ls, mask, masks, wd, num_heads=H,
                                inv_keep=inv))
    assert counts["sa_train_fwd"] == counts["sa_train_bwd"] == 1
    _check_block(got, ref, again)
    dump, inv = sa.dump_sa_prng_masks(SEED, RATE, B, 60, D, 4 * D, H,
                                      device=cuda)
    seeded, _, _, counts = _block_vs_plain(
        sa.fused_sa_block_train, sa.fused_sa_block_train_plain, (x,), w,
        sa.SA_WEIGHT_NAMES, probe,
        lambda blk, ls, wd: blk(*ls, mask, SEED, wd, num_heads=H,
                                rate=RATE))
    assert counts["sa_train_fwd_prng"] == counts["sa_train_bwd_prng"] == 1
    fed, _, _, _ = _block_vs_plain(
        sa.fused_sa_block_train, sa.fused_sa_block_train_plain, (x,), w,
        sa.SA_WEIGHT_NAMES, probe,
        lambda blk, ls, wd: blk(*ls, mask, dump, wd, num_heads=H,
                                inv_keep=inv))
    assert torch.equal(seeded[0], fed[0])
    assert all(torch.equal(a, b) for a, b in zip(seeded[1], fed[1]))


@pytest.mark.parametrize("D,level", [(512, 1), (512, 3), (1024, 1),
                                     (1024, 3)])
def test_image_qffn_sa_block_matches_plain(cuda, D, level):
    """The classifier engine's quantized SA block over [B, 60, D] image
    activations (qkv int8 at D 1024), dynamic (level 1) and with the
    block's own static scales (level 3), fully padded images included."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import ClassifierNet
    from mcan_vqa_tpu_torch.ops import quant
    from mcan_vqa_tpu_torch.ops.serving import prepare_classifier_params
    cfg = Config(hidden_size=D, ff_size=4 * D, layer=1, img_feat_size=64)
    net = ClassifierNet(cfg, 14, generator=torch.Generator().manual_seed(0))
    enc = prepare_classifier_params(net.state_dict(), 1, device=cuda,
                                    qffn=level)["backbone"]["enc_0"]
    B, H = 8, 8
    x, mask, *_ = _image_sa_inputs(cuda, B, D)
    x = x.to(BF16)
    sc = quant._cal_sa_block(enc, x, mask, H, 1.1)[1] if level == 3 \
        else None
    before = K.launch_counts().get("fused_qffn_sa_block", 0)
    out = quant.fused_qffn_sa_block(x, mask, enc["_mk"], enc["_qffn"],
                                    num_heads=H, act_scales=sc)
    assert K.launch_counts()["fused_qffn_sa_block"] == before + 1
    ref = quant.fused_qffn_sa_block_plain(x, mask, enc["_mk"], enc["_qffn"],
                                          num_heads=H, act_scales=sc)
    assert ("wqkv_q" in enc["_qffn"]) == (D >= 1024 or level >= 2)
    # test_qffn_blocks_match_plain_with_fully_padded_samples's tolerance
    _close(out, ref, 2 ** -5)


# ---------------------------------------------------------------------------
# in-kernel dropout: Philox, the mask dump, the seeded kernels
# ---------------------------------------------------------------------------

SEED, RATE = 987654321, 0.1


def test_philox_words_match_plain_on_a_million_words(cuda):
    words = K.philox_words(SEED, 0x303, 8, 1 << 17, cuda)       # 1,048,576
    torch.cuda.synchronize()
    assert torch.equal(words, K.philox_words_plain(SEED, 0x303, 8, 1 << 17,
                                                   cuda))


def test_dump_matches_plain_bitwise_and_keeps_its_rate(cuda):
    from mcan_vqa_tpu_torch.ops import sga_train as st
    shape = (64, 60, 14, 512, 2048, 8)
    masks, inv = st.dump_prng_masks(SEED, RATE, *shape, device=cuda)
    ref, inv_ref = st.dump_prng_masks_plain(SEED, RATE, *shape, device=cuda)
    t, inv_keep = st.prng_keep_params(RATE)
    assert inv == inv_ref == inv_keep
    n = kept = 0
    for name in st.MASK_NAMES:
        assert masks[name].dtype == torch.uint8
        assert torch.equal(masks[name], ref[name]), name
        n += masks[name].numel()
        kept += int(masks[name].sum())
    p = t / 2 ** 32
    assert abs(kept / n - p) <= 5 * (p * (1 - p) / n) ** 0.5


# (B, [(site code, heads, n)]): the plan's edges (tests/test_torch_prng_plan.py)
# on the card -- rows with n % 4 != 0 (a counter's last words past the
# row: byte and 2-byte stores), att2's n = 840 (8-byte stores), one site
# and six, B = 1, and B = 65,537 (past the parent's 65,535) with one small
# site
PRNG_EDGES = [
    (7, [(0x100, 3, 5), (0x200, 1, 3), (0x301, 2, 4099), (0x302, 1, 842)]),
    (64, [(0x200, 8, 840)]),
    (3, [(0x303, 1, 122880)]),
    (3, [(0x100, 8, 3600), (0x200, 8, 840), (0x301, 1, 1), (0x302, 16, 5),
         (0x303, 1, 4099), (0x304, 1, 30720)]),
    (1, [(0x100, 8, 3600), (0x303, 1, 7)]),
    (65537, [(0x303, 1, 5)])]


@pytest.mark.parametrize("B,sites", PRNG_EDGES)
def test_dump_matches_plain_bitwise_at_the_plan_edges(cuda, B, sites):
    from mcan_vqa_tpu_torch.ops import sga_train as st
    t, _ = st.prng_keep_params(RATE)
    got = K.dump_prng_masks(SEED, t, B, sites, cuda)
    grid = K.LAST_GRID["dump_prng_masks"][0]
    again = K.dump_prng_masks(SEED, t, B, sites, cuda)
    ref = K.dump_prng_masks_plain(SEED, t, B, sites, cuda)
    torch.cuda.synchronize()
    plan = K.prng_plan(B, tuple((h, n) for _, h, n in sites), K.GEMM_SMS)
    assert grid == plan.grid
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r) and torch.equal(g, a)


@pytest.mark.parametrize("B,n", [(1, 1), (3, 5), (7, 4099), (5, 842),
                                 (2, 122880), (65537, 3)])
def test_philox_words_match_plain_bitwise_at_the_plan_edges(cuda, B, n):
    got = K.philox_words(SEED, 0x304, B, n, cuda)
    raw = K.philox_words(SEED, 0x304, B, n, cuda, raw=True)
    ref = K.philox_words_plain(SEED, 0x304, B, n, cuda)
    torch.cuda.synchronize()
    assert raw.dtype == torch.uint32
    assert torch.equal(got, ref) and torch.equal(raw.to(torch.int64), ref)


def test_prng_kernels_do_not_spill(cuda):
    import ctypes
    from mcan_vqa_tpu_torch.ops._build import load_library
    for words in (0, 1):
        info = (ctypes.c_int * 3)()
        assert load_library().mcan_prng_kernel_attrs(words, info) == 0
        regs, local, threads = info
        assert local == 0 and threads >= K.PRNG_THREADS
        assert regs <= 65536 // (K.PRNG_THREADS * K.PRNG_BLOCKS_PER_SM)


def _seeded(site, rows=0):
    from mcan_vqa_tpu_torch.ops import sga_train as st
    t, inv = st.prng_keep_params(RATE)
    return K.Philox(SEED, site, t, rows), inv


def _dumped(p, B, heads, n):
    return K.dump_prng_masks(p.seed, p.thresh, B, [(p.site, heads, n)],
                             "cuda")[0]


def test_seeded_gemm_equals_the_mask_fed_the_dump(cuda):
    g = torch.Generator(device=cuda).manual_seed(41)
    B, L, Kd, N = 7, 60, 512, 2048
    a = torch.randn(B * L, Kd, generator=g, device=cuda).to(BF16)
    w = (torch.randn(Kd, N, generator=g, device=cuda) / Kd ** 0.5).to(BF16)
    b = torch.randn(N, generator=g, device=cuda)
    p, inv = _seeded(0x303, L)
    mask = _dumped(p, B, 1, L * N).reshape(B * L, N)
    kw = dict(relu=True, out_dtype=BF16, inv_keep=inv)
    out = K.gemm_bias_act(a, w, b, mask=p, **kw)
    assert torch.equal(out, K.gemm_bias_act(a, w, b, mask=mask, **kw))
    _close(out, K.gemm_bias_act_plain(a, w, b, mask=p, **kw), 2 ** -7)


@pytest.mark.parametrize("B,L,Kd,N", [
    (64, 60, 512, 2048),      # the decoder's ffn1 at M 3840
    (7, 11, 512, 1440),       # ragged: M 77, N % 128 != 0
    (3, 14, 1000, 512)])      # K % 64 != 0
def test_seeded_gemm_equals_the_mask_route_bitwise(cuda, B, L, Kd, N):
    """The seeded NN epilogue (one Philox draw per column pair) against the
    mask route fed _rows_keep's mask, bit for bit, and two launches of each
    route give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(B * L + N)
    a = torch.randn(B * L, Kd, generator=g, device=cuda).to(BF16)
    w = (torch.randn(Kd, N, generator=g, device=cuda) / Kd ** 0.5).to(BF16)
    b = torch.randn(N, generator=g, device=cuda)
    p, inv = _seeded(0x303, L)
    mask = K._rows_keep(p, B * L, N, cuda)
    assert torch.equal(mask.view(B, L * N).to(torch.uint8),
                       _dumped(p, B, 1, L * N).view(B, L * N))
    for out_dtype in (BF16, torch.float32):
        kw = dict(relu=True, out_dtype=out_dtype, inv_keep=inv)
        out = K.gemm_bias_act(a, w, b, mask=p, **kw)
        fed = K.gemm_bias_act(a, w, b, mask=mask, **kw)
        assert torch.equal(out, fed)
        assert torch.equal(out, K.gemm_bias_act(a, w, b, mask=p, **kw))
        assert torch.equal(fed, K.gemm_bias_act(a, w, b, mask=mask, **kw))
        _close(out, K.gemm_bias_act_plain(a, w, b, mask=p, **kw),
               1e-4 if out_dtype == torch.float32 else 2 ** -7)


def test_gemm_repeats_bitwise(cuda):
    """No split, one fixed summation order: two launches, one set of bits
    (at the decoder's ffn2, the widest reduction of the step)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    a = torch.randn(3840, 2048, generator=g, device=cuda).to(BF16)
    w = (torch.randn(2048, 512, generator=g, device=cuda) / 45).to(BF16)
    b = torch.randn(512, generator=g, device=cuda)
    first = K.gemm_bias_act(a, w, b)
    assert torch.equal(first, K.gemm_bias_act(a, w, b))


@pytest.mark.parametrize("D", [512, 256, 768])
def test_seeded_layernorm_equals_the_mask_fed_the_dump(cuda, D):
    g = torch.Generator(device=cuda).manual_seed(D + 3)
    B, L = 9, 14
    res, y, gout = (torch.randn(B * L, D, generator=g, device=cuda)
                    for _ in range(3))
    bias, beta = (0.1 * torch.randn(D, generator=g, device=cuda)
                  for _ in range(2))
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    p, inv = _seeded(0x501, L)
    mask = _dumped(p, B, 1, L * D).reshape(B * L, D)
    kw = dict(inv_keep=inv, save_r=True, reciprocal=True)
    outs = K.residual_layernorm(res, y, bias, gamma, beta, (torch.float32,),
                                mask=p, **kw)
    refs = K.residual_layernorm(res, y, bias, gamma, beta, (torch.float32,),
                                mask=mask, **kw)
    assert all(torch.equal(a, b) for a, b in zip(outs, refs))
    kw = dict(inv_keep=inv, dy_dtypes=(torch.float32, BF16))
    outs = K.residual_layernorm_bwd(gout, res, y, bias, gamma, mask=p, **kw)
    refs = K.residual_layernorm_bwd(gout, res, y, bias, gamma, mask=mask,
                                    **kw)
    assert all(torch.equal(a, b) for a, b in zip(outs, refs))
    plain = K.residual_layernorm_bwd_plain(gout, res, y, bias, gamma,
                                           mask=p, **kw)
    for a, b, tol in zip(outs, plain, (1e-4, 1e-5, 1e-4, 2 ** -7)):
        _close(a, b, tol)


@pytest.mark.parametrize("Lq,Lk,Dh", [(60, 60, 64), (60, 14, 128),
                                      (86, 86, 32), (160, 160, 192),
                                      (608, 60, 64), (130, 60, 128)])
def test_seeded_attention_equals_the_mask_fed_the_dump(cuda, Lq, Lk, Dh):
    B, H = 3, 8
    q, k, v, mask = _attention_inputs(B, H, Lq, Lk, [0, Lk, 5], cuda, Dh)
    k, v = k.to(BF16), v.to(BF16)
    p, inv = _seeded(0x200)
    drop = _dumped(p, B, H, Lq * Lk).reshape(B, H, Lq, Lk)
    out = K.masked_attention(q, k, v, mask, p, inv)
    assert torch.equal(out, K.masked_attention(q, k, v, mask, drop, inv))
    _close(out, K.masked_attention_plain(q, k, v, mask, p, inv), 2 ** -7)
    g = torch.Generator(device=cuda).manual_seed(5)
    dout = torch.randn(B, Lq, H * Dh, generator=g, device=cuda).to(BF16)

    def grads(d):
        dq = torch.empty(B, H, Lq, Dh, device=cuda)
        dk, dv = (torch.empty(B, H, Lk, Dh, device=cuda) for _ in range(2))
        K.masked_attention_bwd(q, k, v, mask, dout, dq, dk, dv, drop=d,
                               inv_keep=inv)
        return dq, dk, dv

    assert all(torch.equal(a, b) for a, b in zip(grads(p), grads(drop)))


def _prng_block_vs_dump(fused, ext, leaves, ws, names, probe, call, dump):
    """The seeded block and the external-mask block fed its dump: equal
    output and gradients, bit for bit."""
    def run(block, masks):
        ls = [t.clone().requires_grad_() for t in leaves]
        wd = {k: t.clone().requires_grad_() for k, t in ws.items()}
        out = call(block, ls, wd, masks)
        (out * probe).sum().backward()
        return [out.detach()] + [t.grad for t in ls] + [wd[n].grad
                                                        for n in names]

    K.reset_launches()
    got = run(fused, None)
    counts = K.launch_counts()
    want = run(ext, dump)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return counts


@pytest.mark.parametrize("B,D,F,saves", [(64, 512, 2048, False),
                                         (8, 1024, 4096, True)])
def test_seeded_sga_block_equals_the_block_fed_the_dump(cuda, B, D, F, saves):
    from mcan_vqa_tpu_torch.ops import sga_train as st
    x, kq, vq, vm, qm, _, w, _, probe = _train_block_inputs(cuda, B=B, D=D,
                                                             F=F)
    masks, inv = st.dump_prng_masks(SEED, RATE, B, 60, 14, D, F, 8, cuda)
    kw = dict(num_heads=8, att_saves=saves, bf16_saves=saves)

    def call(block, ls, wd, dump):
        if dump is None:
            return block(*ls, vm, qm, SEED, wd, rate=RATE, **kw)
        return block(*ls, vm, qm, dump, wd, inv_keep=inv, **kw)

    counts = _prng_block_vs_dump(
        st.fused_sga_block_train_prng, st.fused_sga_block_train,
        (x, kq, vq), w, st.WEIGHT_NAMES, probe, call, masks)
    bwd = "sga_train_bwd_att_sav_prng" if saves else "sga_train_bwd_att_prng"
    assert counts["sga_train_fwd_prng"] == counts[bwd] == 1
    assert "sga_train_fwd" not in counts


def test_seeded_sa_block_equals_the_block_fed_the_dump(cuda):
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    B, L, D, F, H = 64, 14, 512, 2048, 8
    g = torch.Generator(device=cuda).manual_seed(33)
    w = {n: 0.05 * torch.randn(*shape, generator=g, device=cuda)
         for n, shape in (("wqkv", (D, 3 * D)), ("bqkv", (3 * D,)),
                          ("wm", (D, D)), ("bm", (D,)), ("ln1_b", (D,)),
                          ("w1", (D, F)), ("b1", (F,)), ("w2", (F, D)),
                          ("b2", (D,)), ("ln2_b", (D,)))}
    for n in ("ln1_s", "ln2_s"):
        w[n] = 1 + 0.05 * torch.randn(D, generator=g, device=cuda)
    x = torch.randn(B, L, D, generator=g, device=cuda)
    lens = torch.tensor([(i * 5) % (L + 1) for i in range(B)], device=cuda)
    mask = (torch.arange(L, device=cuda)[None] >= lens[:, None])[:, None,
                                                                 None]
    probe = torch.randn(B, L, D, generator=g, device=cuda)
    masks, inv = sa.dump_sa_prng_masks(SEED, RATE, B, L, D, F, H, cuda)

    def call(block, ls, wd, dump):
        if dump is None:
            return block(*ls, mask, SEED, wd, num_heads=H, rate=RATE)
        return block(*ls, mask, dump, wd, num_heads=H, inv_keep=inv)

    counts = _prng_block_vs_dump(sa.fused_sa_block_train,
                                 sa.fused_sa_block_train, (x,), w,
                                 sa.SA_WEIGHT_NAMES, probe, call, masks)
    assert counts["sa_train_fwd_prng"] == counts["sa_train_bwd_prng"] == 1


# ---------------------------------------------------------------------------
# the all-layer stacks: sga_decoder (in-kernel and external k/v), sa_encoder
# ---------------------------------------------------------------------------

def _stack(cuda, shapes, seed):
    """Random stacked weights: matrices bf16 scaled by 1 / sqrt(fan-in),
    biases f32, LayerNorm scales 1 + noise."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = {}
    for n, shape in shapes.items():
        t = torch.randn(*shape, generator=g, device=cuda)
        if len(shape) == 3:
            w[n] = (t / shape[1] ** 0.5).to(BF16)
        else:
            w[n] = 1 + 0.1 * t if n.endswith("_s") else 0.1 * t
    return w


def _decoder_weights(cuda, L, D, F, seed=0):
    DD = (L, D, D)
    shapes = {"wqkv1": (L, D, 3 * D), "bqkv1": (L, 3 * D), "wm1": DD,
              "wkv2": (L, D, 2 * D), "bkv2": (L, 2 * D), "wq2": DD,
              "wm2": DD, "w1": (L, D, F), "b1": (L, F), "w2": (L, F, D)}
    shapes.update({n: (L, D) for n in ("bm1", "ln1_s", "ln1_b", "bq2", "bm2",
                                       "ln2_s", "ln2_b", "b2", "ln3_s",
                                       "ln3_b")})
    return _stack(cuda, shapes, seed)


def _encoder_weights(cuda, L, D, F, seed=0):
    shapes = {"wqkv": (L, D, 3 * D), "bqkv": (L, 3 * D), "wm": (L, D, D),
              "w1": (L, D, F), "b1": (L, F), "w2": (L, F, D)}
    shapes.update({n: (L, D) for n in ("bm", "ln1_s", "ln1_b", "b2", "ln2_s",
                                       "ln2_b")})
    return _stack(cuda, shapes, seed)


def _pads(cuda, B, L, seed):
    """Ragged lengths, sample 0 fully padded when B > 1."""
    lens = torch.tensor([L if B == 1 else (i * 7 + seed) % (L + 1)
                         for i in range(B)], device=cuda)
    if B > 1:
        lens[0] = 0
    return (torch.arange(L, device=cuda)[None] >= lens[:, None])[:, None,
                                                                 None]


# Two layers, each a bf16 rounding (qkv, the probabilities, h) a step apart
# where the sums run in another order: 2^-4 on values of LayerNorm scale.
STACK_TOL = 2 ** -4


def _stack_counters_idle(cuda):
    """Every split counter of the stacks is back at 0 after the calls."""
    torch.cuda.synchronize()
    c = K._STACK_COUNTERS.get(torch.device("cuda",
                                           torch.cuda.current_device()))
    assert c is None or int(c.abs().sum()) == 0


@pytest.mark.parametrize("B,Lv,Lq,D,F,H,kv,dtype,L", [
    (1, 60, 14, 512, 2048, 8, "in", BF16, 2),
    (5, 60, 14, 512, 2048, 8, "ext", BF16, 2),
    (7, 160, 14, 256, 1024, 2, "in", torch.float32, 2),  # Dh 128, 3 chunks
    (3, 37, 130, 256, 512, 2, "ext", torch.float32, 2),   # 130 cross keys
    (64, 60, 14, 512, 2048, 8, "in", BF16, 6),    # MCAN-small, B = 64
    (1, 60, 14, 512, 2048, 8, "ext", BF16, 6)])   # B = 1: every product split
def test_sga_decoder_matches_plain(cuda, B, Lv, Lq, D, F, H, kv, dtype, L):
    g = torch.Generator(device=cuda).manual_seed(B)
    w = _decoder_weights(cuda, L, D, F, seed=B)
    v = torch.randn(B, Lv, D, generator=g, device=cuda).to(dtype)
    q = torch.randn(B, Lq, D, generator=g, device=cuda).to(dtype)
    vm, qm = _pads(cuda, B, Lv, 1), _pads(cuda, B, Lq, 2)
    if kv == "in":
        kw = dict(q=q)
    else:
        kq, vq = torch.randn(2, B, L * H, Lq, D // H, generator=g,
                             device=cuda).to(dtype).unbind(0)
        kw = dict(kq=kq, vq=vq)
    before = K.launch_counts().get("sga_decoder", 0)
    out = K.sga_decoder(v, vm, qm, w, num_heads=H, **kw)
    assert K.launch_counts()["sga_decoder"] == before + 1
    ref = K.sga_decoder_plain(v, vm, qm, w, num_heads=H, **kw)
    assert out.dtype == dtype and out.shape == (B, Lv, D)
    _close(out, ref, STACK_TOL)
    # two runs, and any grid that fits (fewer blocks than the plan's items
    # too), give the same bits: each work item is one block's, a split tile
    # is summed in split order
    plan = K.stack_plan(B, Lv, D, F, H, Lq, kv)
    assert 3 < plan.items
    again = K.sga_decoder(v, vm, qm, w, num_heads=H, **kw)
    small = K.sga_decoder(v, vm, qm, w, num_heads=H, max_blocks=3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again, out) and torch.equal(small, out)
    grid, per_sm, sms, smem = K.LAST_GRID["sga_decoder"]
    assert grid == 3 and per_sm >= 1 and sms >= 1 and smem == K.STACK_SMEM
    _stack_counters_idle(cuda)


@pytest.mark.parametrize("B,Lq,D,F,H,dtype,L", [
    (1, 14, 512, 2048, 8, BF16, 2), (9, 14, 512, 2048, 8, BF16, 2),
    (4, 150, 256, 1024, 2, torch.float32, 2),
    (64, 14, 512, 2048, 8, BF16, 6),     # MCAN-small, B = 64
    (1, 14, 512, 2048, 8, torch.float32, 6)])   # B = 1: every product split
def test_sa_encoder_matches_plain(cuda, B, Lq, D, F, H, dtype, L):
    g = torch.Generator(device=cuda).manual_seed(B)
    w = _encoder_weights(cuda, L, D, F, seed=B)
    x = torch.randn(B, Lq, D, generator=g, device=cuda).to(dtype)
    xm = _pads(cuda, B, Lq, 3)
    before = K.launch_counts().get("sa_encoder", 0)
    out = K.sa_encoder(x, xm, w, num_heads=H)
    assert K.launch_counts()["sa_encoder"] == before + 1
    ref = K.sa_encoder_plain(x, xm, w, num_heads=H)
    _close(out, ref, STACK_TOL)
    again = K.sa_encoder(x, xm, w, num_heads=H)
    small = K.sa_encoder(x, xm, w, num_heads=H, max_blocks=2)
    torch.cuda.synchronize()
    assert torch.equal(again, out) and torch.equal(small, out)
    assert K.LAST_GRID["sa_encoder"][0] == 2 < K.stack_plan(B, Lq, D, F,
                                                             H).items
    _stack_counters_idle(cuda)


def test_stacks_raise_on_unsupported_shapes(cuda):
    w = _encoder_weights(cuda, 1, 520, 1040)
    x = torch.zeros(2, 14, 520, dtype=BF16, device=cuda)
    xm = torch.zeros(2, 1, 1, 14, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="D / H"):
        K.sa_encoder(x, xm, w, num_heads=2)      # Dh 260
    w = _decoder_weights(cuda, 1, 64, 128)
    v = torch.zeros(2, 8, 64, dtype=BF16, device=cuda)
    vm = torch.zeros(2, 1, 1, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="pass q"):
        K.sga_decoder(v, vm, vm, w, num_heads=4)
    w["w1"] = w["w1"].float()
    with pytest.raises(ValueError, match="w1"):
        K.sga_decoder(v, vm, vm, w, num_heads=4, q=v)


def test_head_major_block_and_alllayer_engines_on_the_card(cuda):
    """Modes 1, 3, 4, 5 of build_production_engine at 2 layers against the
    plain engine on the same card, and their launches: mode 1 one
    head-major block per layer; modes 3 / 4 one sga_decoder and the
    per-block encoder; mode 5 one sga_decoder and one sa_encoder."""
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    cfg, sd, *_ = _small_model()
    L, H = cfg.layer, cfg.multi_head
    rng = np.random.default_rng(5)
    img = torch.from_numpy(np.abs(rng.normal(size=(3, 60, 64))).astype(
        np.float32)).to(cuda)
    img[1, 20:] = 0
    ques = torch.from_numpy(rng.integers(1, 8, size=(3, 14))).to(cuda)
    ques[2, 5:] = 0
    plain, pprep = build_production_engine(sd, L, H, qffn=0, sga_mode=0,
                                           use_pallas_ffn=False,
                                           bf16_stream=False, device="cpu")
    with torch.no_grad():
        ref = torch.sigmoid(plain(pprep, img.cpu(), ques.cpu()))
    want = {1: {"fused_sga_block_head_major": L},
            3: {"sga_decoder": 1, "fused_sa_block": L},
            4: {"sga_decoder": 1, "fused_sa_block": L},
            5: {"sga_decoder": 1, "sa_encoder": 1}}
    for mode, launches in want.items():
        fwd, prep = build_production_engine(sd, L, H, qffn=0, sga_mode=mode,
                                            alllayer=mode > 2, device=cuda)
        K.reset_launches()
        with torch.no_grad():
            out = torch.sigmoid(fwd(prep, img, ques))
        counts = K.launch_counts()
        for name, n in launches.items():
            assert counts.get(name, 0) == n, (mode, counts)
        # the bf16 stream against f32 on the plain side: the bf16 bound
        np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), atol=1e-2)


# ---------------------------------------------------------------------------
# the last sites: the SGA train block's recompute FFN backward
# (save_acts=False) and the streaming FFN + LayerNorm kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,D,F,bf16_saves", [(64, 512, 2048, False),
                                              (32, 1024, 4096, True)])
def test_sga_train_block_recompute_matches_plain(cuda, B, D, F, bf16_saves):
    """save_acts=False (the TPU's _bwd_ffn_kernel): h1d and y3 recomputed
    from v2 in the backward. MCAN-small at B=64 and MCAN-large's
    micro-batch of 32 with bf16_saves, against the plain block under
    autograd, with the tolerances of the saved-activation block."""
    import functools

    from mcan_vqa_tpu_torch.ops import sga_train as st
    x, kq, vq, vm, qm, masks, w, inv, probe = _train_block_inputs(
        cuda, B=B, D=D, F=F)
    fused = functools.partial(st.fused_sga_block_train, save_acts=False,
                              bf16_saves=bf16_saves)
    got, ref, again, counts = _block_vs_plain(
        fused, st.fused_sga_block_train_plain, (x, kq, vq), w,
        st.WEIGHT_NAMES, probe,
        lambda blk, ls, wd: blk(*ls, vm, qm, masks, wd, num_heads=8,
                                inv_keep=inv))
    assert counts["sga_train_bwd_ffn_recompute"] == 1
    assert "sga_train_bwd_ffn" not in counts
    # 6 products in the forward, the FFN's 2 again in its backward, 4
    # projections in the attention backward's recompute
    assert counts["gemm_bias_act"] == 6 + 2 + 4
    _check_block(got, ref, again)


def test_seeded_recompute_equals_the_block_fed_the_dump(cuda):
    """The seeded block with save_acts=False (_bwd_ffn_kernel_prng): the
    recompute draws the h1 and y3 sites from the seed again."""
    from mcan_vqa_tpu_torch.ops import sga_train as st
    B, D, F = 64, 512, 2048
    x, kq, vq, vm, qm, _, w, _, probe = _train_block_inputs(cuda, B=B)
    masks, inv = st.dump_prng_masks(SEED, RATE, B, 60, 14, D, F, 8, cuda)

    def call(block, ls, wd, dump):
        if dump is None:
            return block(*ls, vm, qm, SEED, wd, num_heads=8, rate=RATE,
                         save_acts=False)
        return block(*ls, vm, qm, dump, wd, num_heads=8, inv_keep=inv,
                     save_acts=False)

    counts = _prng_block_vs_dump(
        st.fused_sga_block_train_prng, st.fused_sga_block_train,
        (x, kq, vq), w, st.WEIGHT_NAMES, probe, call, masks)
    assert counts["sga_train_bwd_ffn_recompute_prng"] == 1


def _ffn_operands(cuda, M, D, F, x_dtype=torch.float32, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + M + D)
    x = torch.randn(M, D, generator=g, device=cuda).to(x_dtype)
    w1 = (torch.randn(D, F, generator=g, device=cuda) / D ** 0.5).to(BF16)
    w2 = (torch.randn(F, D, generator=g, device=cuda) / F ** 0.5).to(BF16)
    b1, b2, beta = (0.1 * torch.randn(n, generator=g, device=cuda)
                    for n in (F, D, D))
    gamma = 1 + 0.1 * torch.randn(D, generator=g, device=cuda)
    return x, w1, b1, w2, b2, gamma, beta


FFN_SHAPES = [("both", 3840, 512, 2048, torch.float32),    # MCAN-small, B=64
              ("both", 3840, 1024, 4096, torch.float32),   # MCAN-large, B=64
              ("both", 60, 1024, 4096, torch.float32),     # B=1: F split
              ("both", 61, 1024, 4096, torch.bfloat16),    # ragged, bf16 x
              ("both", 130, 256, 1024, torch.float32),
              ("both", 17, 2048, 8192, torch.float32),
              # the parent's smallest F steps past a tile: 33 x 64, 513 x 16
              ("both", 60, 512, 2112, torch.float32),
              ("ffn_ln_wstationary", 17, 2048, 8208, torch.float32)]
FFN_CASES = [(variant, M, D, F, xdt) for which, M, D, F, xdt in FFN_SHAPES
             for variant in ("ffn_ln_blocked", "ffn_ln_wstationary")
             if which in ("both", variant)]


@pytest.mark.parametrize("variant,M,D,F,x_dtype", FFN_CASES)
def test_streaming_ffn_ln_matches_plain_and_repeats_bitwise(cuda, variant, M,
                                                            D, F, x_dtype):
    """f32 out: the same exact bf16 products summed in another order (over
    F tiles, splits or ranges), then an LN of O(1) values. Where the order
    moves a pre-activation across a rounding boundary, h's bf16 rounding
    lands a step apart (2^-6 at |h| ~ 4), which moves r by that step times
    |W2| (~0.07): 1.1e-3 measured on an H100 at D 512 for one element of 2
    M. So 1e-3 of max|ref| (~4.5e-3). Two runs give equal bits; the grid is
    the plan's (``kernels.ffn_ln_plan``), and the weight-stationary kernel
    gives the same bits on any number of clusters."""
    ops = _ffn_operands(cuda, M, D, F, x_dtype)
    fn = getattr(K, variant)
    K.reset_launches()
    out = fn(*ops)
    assert K.launch_counts() == {variant: 1}
    ref = K.ffn_ln_plain(*ops)
    scale = float(ref.abs().max())
    _close(out / scale, ref / scale, 1e-3)
    assert out.dtype == torch.float32 and out.shape == (M, D)
    assert torch.equal(out, fn(*ops))
    if variant == "ffn_ln_wstationary":
        grid, clusters, fit, smem = K.LAST_GRID[variant]
        plan = K.ffn_ln_plan("wstationary", M, D, F, x_dtype == torch.float32,
                             fit)
        assert (grid, clusters, smem) == (plan.grid, plan.clusters, plan.smem)
        for cap in (1, 3, 7):
            assert torch.equal(out, fn(*ops, max_clusters=cap))
            assert K.LAST_GRID[variant][1] == min(cap, plan.f_steps)


def test_streaming_ffn_public_functions_on_the_card(cuda):
    """fused_ffn_ln_blocked / _weight_stationary take [..., D] and f32
    weights (rounded to bf16 for the products) and launch their kernel
    once, whatever tile_m / tile_f say."""
    from mcan_vqa_tpu_torch.ops import fused_ffn as ffn
    x, w1, b1, w2, b2, gamma, beta = _ffn_operands(cuda, 120, 512, 2048)
    x3 = x.view(2, 60, 512)
    want = K.ffn_ln_plain(x, w1, b1, w2, b2, gamma, beta).view(2, 60, 512)
    for name, fn in (("ffn_ln_blocked", ffn.fused_ffn_ln_blocked),
                     ("ffn_ln_wstationary",
                      ffn.fused_ffn_ln_weight_stationary)):
        K.reset_launches()
        out = fn(x3, w1.float(), b1, w2.float(), b2, gamma, beta,
                 tile_m=16, tile_f=128)
        assert K.launch_counts() == {name: 1}
        scale = float(want.abs().max())     # as in the test above
        _close(out / scale, want / scale, 1e-3)


def test_streaming_ffn_empty_rows_launch_nothing(cuda):
    """M = 0: an empty f32 [0, D] and no launch counted."""
    x, w1, b1, w2, b2, gamma, beta = _ffn_operands(cuda, 8, 512, 2048)
    for name in ("ffn_ln_blocked", "ffn_ln_wstationary"):
        K.reset_launches()
        out = getattr(K, name)(x[:0], w1, b1, w2, b2, gamma, beta)
        assert out.shape == (0, 512) and out.dtype == torch.float32
        assert K.launch_counts() == {}


def test_streaming_ffn_raises_on_unsupported_shapes(cuda):
    for fn in (K.ffn_ln_blocked, K.ffn_ln_wstationary):
        x, w1, b1, w2, b2, gamma, beta = _ffn_operands(cuda, 8, 384, 1536)
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(x[:, :96].contiguous(), w1[:96].contiguous(), b1,
               w2[:, :96].contiguous(), b2[:96], gamma[:96], beta[:96])
        with pytest.raises(ValueError, match="F step"):
            fn(x, w1[:, :1528].contiguous(), b1[:1528],
               w2[:1528].contiguous(), b2, gamma, beta)
        with pytest.raises(ValueError, match="bf16"):
            fn(x, w1.float(), b1, w2.float(), b2, gamma, beta)


# ---------------------------------------------------------------------------
# MIMIC-CXR: the train step and the level-1 engine at the MIMIC shapes
# ---------------------------------------------------------------------------

def _mimic_config(tmp_path, source, rows, **kw):
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.mimic_files import write_mimic_files
    paths = write_mimic_files(str(tmp_path / "files"), images=96,
                              questions={"train": 64, "val": 16, "test": 16},
                              seed=3)
    return Config.for_model("small", layer=2, img_feat_size=1024,
                            img_feat_pad_size=rows, mimic_feat_source=source,
                            batch_size=64, ckpts_dir=str(tmp_path / "ck"),
                            log_path=str(tmp_path / "log"), verbose=False,
                            **paths, **kw)


def test_mimic_npy_bank_feeds_a_fused_train_step_at_86_rows(cuda, tmp_path):
    """``MIMICDataset`` over the .npy banks ("both": 60 region + 26 anatomy
    rows of 1024 features) into one B=64 step of the fused engine with
    in-kernel dropout at hidden 512 (2 layers): the loss within 1e-3 of
    the plain blocks' from the same weights and generator state, the SGA
    and SA train kernels each launched once a layer."""
    from mcan_vqa_tpu_torch.data.mimic import MIMICDataset
    from mcan_vqa_tpu_torch.train.fused_engine import \
        make_fused_train_forward
    from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    cfg = _mimic_config(tmp_path, "both", 86)
    ds = MIMICDataset(cfg, "train")
    assert isinstance(ds.image_features, np.memmap)
    trainer = Trainer(cfg, ds, device=cuda)
    assert trainer.fused and trainer.in_kernel_dropout
    batch = next(iter(trainer.loader()))
    assert batch["img"].shape == (64, 86, 1024)
    state = trainer.state
    state.seed_step()
    plain = make_fused_train_forward(
        cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
        sga_block="plain", fused_encoder=True, dropout_bits=cfg.dropout_bits,
        in_kernel_dropout=True)
    g = torch.Generator(device=cuda)
    g.set_state(state.generator.get_state())
    with torch.no_grad():
        ref = float(bce_with_logits_sum(plain(state.model, batch["img"],
                                              batch["ques"], g),
                                        batch["target"]))
    K.reset_launches()
    loss = float(trainer.step_fn(state, batch)["loss"])
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["sga_train_fwd_prng"] == counts["sa_train_fwd_prng"] == 2
    assert counts["sga_train_bwd_att_prng"] == 2
    assert np.isfinite(loss) and abs(loss - ref) <= 1e-3 * abs(ref)


@pytest.mark.parametrize("source,rows", [("anatomy", 26), ("both", 86)])
def test_mimic_level1_engine_matches_plain(cuda, tmp_path, source, rows):
    """The int8 level-1 eval engine over 26 and 86 image rows of MIMIC
    features and 15 labels (2 layers) against the plain model on the
    sigmoid, within the int8 bound (2e-2), with a fully padded image."""
    from mcan_vqa_tpu_torch.data.mimic import MIMICDataset
    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops.serving import build_production_engine
    cfg = _mimic_config(tmp_path, source, rows)
    ds = MIMICDataset(cfg, "val")
    net = MCANet(cfg, ds.token_size, ds.ans_size,
                 pretrained_emb=ds.pretrained_emb,
                 generator=torch.Generator().manual_seed(4)).to(cuda).eval()
    ex = [ds.example(i) for i in range(len(ds))]
    img = torch.from_numpy(np.stack([e["img"] for e in ex])).to(cuda)
    ques = torch.from_numpy(np.stack([e["ques"] for e in ex])).to(cuda)
    img[3] = 0.0
    fwd, prep = build_production_engine(net.state_dict(), cfg.layer,
                                        cfg.multi_head, device=cuda)
    K.reset_launches()
    with torch.no_grad():
        out = torch.sigmoid(fwd(prep, img, ques).float())
        ref = torch.sigmoid(net(img, ques).float())
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["fused_qffn_sa_block"] == counts["fused_qffn_sga_block"] \
        == cfg.layer
    assert out.shape == (len(ds), 15) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 2e-2
