"""The train blocks' in-kernel gradients on the card: the SGA and SA train
blocks against the same blocks in plain ops differentiated by autograd
(the port's counterpart of tools/validate_inkernel_dw.py; ``chip_smoke.py``
runs ``check_train_block`` as its ``[train block]`` phase).

    python -m mcan_vqa_tpu_torch.cli.validate_inkernel_dw

``check_train_block``: at full width with fully padded samples, dropout
rate 0.1 on external masks,

  * the MCAN-small SGA train block (forward, FFN backward, attention
    backward: ``sga_train.fused_sga_block_train``) and its plain twin;
  * the MCAN-small SA train block (``sa_train.fused_sa_block_train``),
    save_acts both ways;
  * MCAN-large's SGA block (micro-batch 32, D 1024, 8 heads of 128) with
    att_saves and bf16_saves;

each gated in its output (6e-2) and every gradient (3e-2 relative L2 and
1e-1 of max|ref| elementwise), two runs of the kernels bit for bit; then
each piece's device time beside its plain version's and its bound, with
external masks and seeded. Every gate fails the run: a FAIL line on
stderr and exit 1. The kernels' rows (errors, times, bounds) print as one
JSON line, then the card. Needs a CUDA device: there is no CPU fallback.
"""

from __future__ import annotations

import functools

from mcan_vqa_tpu_torch.cli.card_check import (BATCH, LARGE_STEP, PRNG_SEED,
                                               SEED, STEP, TPU_SA_TRAIN,
                                               TPU_TRAIN, bound_parts,
                                               device_ms, fail, gate,
                                               max_err, pad_mask, plain_path,
                                               prng_rows, say, time_pieces)


def train_block_inputs(torch, dev, B, Lv=60, Lq=14, D=512, F=2048,
                       H=8):
    """Random weights of LN-scale activations (std 0.05 at D = 512, scaled
    by sqrt(512 / D) so that every product's outputs keep that spread at
    another width), ragged pads with fully padded image and question
    samples, the six masks at rate 0.1."""
    from mcan_vqa_tpu_torch.ops import sga_train as st
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    s0 = 0.05 * (512 / D) ** 0.5

    def mat(*shape, s=s0):
        return torch.randn(*shape, generator=g, device=dev) * s

    w = {"wqkv": mat(D, 3 * D), "bqkv": mat(3 * D), "wm1": mat(D, D),
         "bm1": mat(D), "ln1_s": 1 + mat(D), "ln1_b": mat(D),
         "wq2": mat(D, D), "bq2": mat(D), "wm2": mat(D, D), "bm2": mat(D),
         "ln2_s": 1 + mat(D), "ln2_b": mat(D), "w1": mat(D, F),
         "b1": mat(F), "w2": mat(F, D), "b2": mat(D), "ln3_s": 1 + mat(D),
         "ln3_b": mat(D)}
    x = torch.randn(B, Lv, D, generator=g, device=dev)
    kq = torch.randn(B, H, Lq, D // H, generator=g, device=dev)
    vq = torch.randn(B, H, Lq, D // H, generator=g, device=dev)
    v_mask = pad_mask(torch, B, Lv, [(i * 17) % (Lv + 1) for i in range(B)],
                      dev)
    q_mask = pad_mask(torch, B, Lq, [(i * 5) % (Lq + 1) for i in range(B)],
                      dev)
    masks, inv = st.make_dropout_masks(g, 0.1, B, Lv, Lq, D, F, H)
    probe = torch.randn(B, Lv, D, generator=g, device=dev)
    return x, kq, vq, v_mask, q_mask, masks, w, inv, probe


def sa_block_inputs(torch, dev, B, L=14, D=512, F=2048, H=8):
    """The SA block's weights drawn as ``train_block_inputs`` draws them,
    the 14-token question stream with all-PAD questions among ragged
    ones, the four masks at rate 0.1."""
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    g = torch.Generator(device=dev).manual_seed(SEED + 22)

    def mat(*shape, s=0.05):
        return torch.randn(*shape, generator=g, device=dev) * s

    w = {"wqkv": mat(D, 3 * D), "bqkv": mat(3 * D), "wm": mat(D, D),
         "bm": mat(D), "ln1_s": 1 + mat(D), "ln1_b": mat(D),
         "w1": mat(D, F), "b1": mat(F), "w2": mat(F, D), "b2": mat(D),
         "ln2_s": 1 + mat(D), "ln2_b": mat(D)}
    x = torch.randn(B, L, D, generator=g, device=dev)
    mask = pad_mask(torch, B, L, [(i * 5) % (L + 1) for i in range(B)], dev)
    masks, inv = sa.make_sa_dropout_masks(g, 0.1, B, L, D, F, H)
    probe = torch.randn(B, L, D, generator=g, device=dev)
    return x, mask, masks, w, inv, probe


def block_vs_plain(torch, label, fused, plain, leaves, w, names, probe,
                   call, rows, row_of, leaf_names):
    """The kernel block and its plain twin under autograd from the same
    leaves: gates the output and every gradient, then checks that two runs
    of the kernel block give the same bits.

    Tolerances: every kernel matches its plain version call by call
    ([kernels]); composed over a block, sums in another order move bf16
    roundings and ReLU gates, which the LayerNorm and softmax backwards
    carry on: the output within the serving block tolerance (6e-2), every
    gradient within 3e-2 in relative norm and within 1e-1 of its max|ref|
    elementwise (the 3e-2 max|ref| gate of tests/test_sga_train.py holds
    on the CPU, where both sides sum in one order)."""
    def run(block):
        ls = [t.clone().requires_grad_() for t in leaves]
        ws = {k: t.clone().requires_grad_() for k, t in w.items()}
        out = call(block, ls, ws)
        (out * probe).sum().backward()
        return out.detach(), [t.grad for t in ls] + [ws[n].grad
                                                     for n in names]

    out, grads = run(fused)
    ref, rgrads = run(plain)
    torch.cuda.synchronize()
    e_fwd = max_err(out, ref)
    gate(f"{label} output", e_fwd, 6e-2)
    rows.err(row_of(None), e_fwd)
    for name, a, b in zip(leaf_names + tuple(names), grads, rgrads):
        rel = float((a - b).norm() / b.norm())
        scaled = max_err(a, b) / (float(b.abs().max()) + 1e-12)
        rows.err(row_of(name), max_err(a, b))
        ok = rel <= 3e-2 and scaled <= 1e-1
        say(f"  d{name}: |err|/|ref| {rel:.3e} <= 3e-2, max|err|/max|ref| "
            f"{scaled:.3e} <= 1e-1 {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"{label}: gradient {name} disagrees")
    out2, grads2 = run(fused)
    if not (torch.equal(out, out2)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2))):
        fail(f"{label}: two runs of the kernels differ")
    say(f"  two runs of the kernel block: the output and all {len(grads)} "
        f"gradients equal bit for bit")


def check_train_block(torch, dev, rows) -> None:
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    from mcan_vqa_tpu_torch.ops import sga_train as st
    B, Lv, Lq, D, F, H = BATCH, 60, 14, 512, 2048, 8
    M = B * Lv
    rows.row("sga_train_fwd", "mcan_vqa_tpu_torch/ops/sga_train.py",
             TPU_TRAIN + ":977", STEP)
    rows.row("sga_train_bwd_ffn", "mcan_vqa_tpu_torch/ops/sga_train.py",
             TPU_TRAIN + ":1081", STEP)
    rows.row("sga_train_bwd_att", "mcan_vqa_tpu_torch/ops/sga_train.py",
             TPU_TRAIN + ":1139", STEP)
    rows.row("sa_train_fwd", "mcan_vqa_tpu_torch/ops/sa_train.py",
             TPU_SA_TRAIN + ":389", STEP)
    rows.row("sa_train_bwd", "mcan_vqa_tpu_torch/ops/sa_train.py",
             TPU_SA_TRAIN + ":487", STEP)
    rows.row("sga_train_bwd_att_sav", "mcan_vqa_tpu_torch/ops/sga_train.py",
             TPU_TRAIN + ":1272", LARGE_STEP)
    prng_rows(rows)
    ffn_grads = {"w1", "b1", "w2", "b2", "ln3_s", "ln3_b"}

    say("[train block] fused_sga_block_train (the kernels) vs "
        "fused_sga_block_train_plain (plain ops, autograd): MCAN-small, "
        f"B={B}, rate 0.1, samples with no regions and with an all-PAD "
        "question")
    x, kq, vq, vm, qm, masks, w, inv, probe = train_block_inputs(torch, dev,
                                                                 B=B)
    block_vs_plain(
        torch, "SGA train block", st.fused_sga_block_train,
        st.fused_sga_block_train_plain, (x, kq, vq), w, st.WEIGHT_NAMES,
        probe, lambda blk, ls, ws: blk(*ls, vm, qm, masks, ws, num_heads=H,
                                       inv_keep=inv), rows,
        lambda n: "sga_train_fwd" if n is None else "sga_train_bwd_ffn"
        if n in ffn_grads else "sga_train_bwd_att", ("x", "kq", "vq"))

    # times of the three pieces, each the sequence of kernels against the
    # same sequence of plain versions (the wrappers' CPU path, forced)
    wk = st._kernel_weights([w[n] for n in st.WEIGHT_NAMES])
    xs = x.contiguous()
    v3, saves = st._forward(xs, kq, vq, vm, qm, masks, wk, inv, H)
    gflat = probe.reshape(M, D).contiguous()
    gv2 = st._bwd_ffn(gflat, saves, masks, wk, inv)[0]
    pieces = {
        "sga_train_fwd": lambda: st._forward(xs, kq, vq, vm, qm, masks, wk,
                                             inv, H),
        "sga_train_bwd_ffn": lambda: st._bwd_ffn(gflat, saves, masks, wk,
                                                 inv),
        "sga_train_bwd_att": lambda: st._bwd_att(gv2, xs, kq, vq, vm, qm,
                                                 saves, masks, wk, inv, H)}
    # bytes: inputs read once, outputs written once; operations: every
    # product the TPU kernel runs (recomputes included)
    Wmats = 2 * (3 * D * D + 3 * D * D + 2 * D * F)
    mask_b = B * H * Lv * (Lv + Lq) + 3 * M * D + M * F
    att_f = 4 * B * H * Lv * (Lv + Lq) * 64
    fwd_f = 2 * M * D * (3 * D + 3 * D + 2 * F) + att_f
    work = {
        "sga_train_fwd": (
            fwd_f, 4 * M * D + 8 * B * H * Lq * 64 + Wmats + mask_b
            + B * (Lv + Lq) + 4 * M * D * 4 + 2 * M * F),
        "sga_train_bwd_ffn": (
            8 * M * D * F, 4 * M * D * 4 + 2 * M * F + 4 * D * F + M * D
            + 4 * (2 * D * F + F + 3 * D)),
        "sga_train_bwd_att": (
            2 * M * D * 6 * D + att_f + 2 * M * D * 6 * D
            + 10 * B * H * Lv * (Lv + Lq) * 64 + 2 * M * D * 6 * D,
            4 * M * D * 4 + 8 * B * H * Lq * 64 * 2 + 2 * 6 * D * D
            + mask_b - M * F - M * D + 4 * 6 * D * D + 4 * 12 * D)}
    time_pieces(torch, K, rows, pieces, work, 6)
    # the seeded pieces (in-kernel dropout): the same kernels drawing each
    # site's bits from Philox, so the same work without the mask bytes
    ps, pinv = st.prng_sites(PRNG_SEED, 0.1, Lv)
    _, psaves = st._forward(xs, kq, vq, vm, qm, ps, wk, pinv, H)
    pgv2 = st._bwd_ffn(gflat, psaves, ps, wk, pinv)[0]
    no_mask = {"sga_train_fwd": mask_b, "sga_train_bwd_ffn": M * D,
               "sga_train_bwd_att": mask_b - M * F - M * D}
    time_pieces(torch, K, rows, {
        "sga_train_fwd_prng": lambda: st._forward(xs, kq, vq, vm, qm, ps,
                                                  wk, pinv, H),
        "sga_train_bwd_ffn_prng": lambda: st._bwd_ffn(gflat, psaves, ps, wk,
                                                      pinv),
        "sga_train_bwd_att_prng": lambda: st._bwd_att(
            pgv2, xs, kq, vq, vm, qm, psaves, ps, wk, pinv, H)},
        {k + "_prng": (f, b - no_mask[k]) for k, (f, b) in work.items()}, 6)

    say("[train block] fused_sa_block_train (the kernels) vs "
        "fused_sa_block_train_plain (plain ops, autograd): the MCAN-small "
        f"encoder block, B={B}, 14 tokens, rate 0.1, all-PAD questions "
        "among ragged ones")
    xq, qmask, sam, sw, inv, sprobe = sa_block_inputs(torch, dev, B)
    for save_acts in (True, False):
        say(f"  save_acts={save_acts}")
        block_vs_plain(
            torch, f"SA train block (save_acts={save_acts})",
            sa.fused_sa_block_train, sa.fused_sa_block_train_plain, (xq,),
            sw, sa.SA_WEIGHT_NAMES, sprobe,
            lambda blk, ls, ws: blk(*ls, qmask, sam, ws, num_heads=H,
                                    inv_keep=inv, save_acts=save_acts),
            rows, lambda n: "sa_train_fwd" if n is None else "sa_train_bwd",
            ("x",))
    swk = st._kernel_weights([sw[n] for n in sa.SA_WEIGHT_NAMES],
                             sa.SA_WEIGHT_NAMES, sa.SA_MATMUL_WEIGHTS)
    xqs = xq.contiguous()
    Mq = B * Lq
    _, ssaves = sa._forward(xqs, qmask, sam, swk, inv, H)
    gq = sprobe.reshape(Mq, D).contiguous()
    pieces = {
        "sa_train_fwd": lambda: sa._forward(xqs, qmask, sam, swk, inv, H),
        "sa_train_bwd": lambda: sa._backward(gq, xqs, qmask, ssaves, sam,
                                             swk, inv, H)}
    sa_att_f = 4 * B * H * Lq * Lq * 64
    sa_mats = 2 * (4 * D * D + 2 * D * F)
    sa_masks = B * H * Lq * Lq + 2 * Mq * D + Mq * F
    work = {
        # in: x, the pads, masks, weights; out: x2, x1, r2 (f32), h1d
        "sa_train_fwd": (
            2 * Mq * D * (4 * D + 2 * F) + sa_att_f,
            4 * Mq * D + B * Lq + sa_masks + sa_mats + 4 * 10 * D
            + 3 * 4 * Mq * D + 2 * Mq * F),
        # recompute of qkv, merge and attention; 4 dX and 4 dW products;
        # the attention backward. in: x, x1, g, r2 (f32), h1d, masks but
        # h1, weights; out: dx and the 12 weight gradients (f32)
        "sa_train_bwd": (
            2 * Mq * D * 4 * D + sa_att_f + 2 * 2 * Mq * D * (4 * D + 2 * F)
            + 10 * B * H * Lq * Lq * 64,
            4 * 4 * Mq * D + 2 * Mq * F + B * Lq + sa_masks - Mq * F
            + sa_mats + 4 * 8 * D + 4 * Mq * D + 4 * (4 * D * D + 2 * D * F)
            + 4 * (10 * D + F))}
    time_pieces(torch, K, rows, pieces, work, 6)
    sps, spinv = st.prng_sites(PRNG_SEED, 0.1, Lq, sa.SA_SITES)
    _, pssaves = sa._forward(xqs, qmask, sps, swk, spinv, H)
    no_mask = {"sa_train_fwd": sa_masks, "sa_train_bwd": sa_masks - Mq * F}
    time_pieces(torch, K, rows, {
        "sa_train_fwd_prng": lambda: sa._forward(xqs, qmask, sps, swk, spinv,
                                                 H),
        "sa_train_bwd_prng": lambda: sa._backward(gq, xqs, qmask, pssaves,
                                                  sps, swk, spinv, H)},
        {k + "_prng": (f, b - no_mask[k]) for k, (f, b) in work.items()}, 6)
    # _bwd_kernel and its seeded body _bwd_kernel_prng (save_acts=False:
    # the FFN recomputed from x1), on no Trainer path: timed beside
    # _bwd_kernel_sav, not in the rows. Their work: _bwd_kernel_sav's plus
    # the recomputed x1 . W1 and h1d . W2 products, x1 (f32) read in place
    # of r2 (f32) and h1d, and no mask bytes when seeded
    flops, nbytes = work["sa_train_bwd"]
    for label, m, iv, no_mask in (("_bwd_kernel", sam, inv, 0),
                                  ("_bwd_kernel_prng", sps, spinv,
                                   sa_masks - Mq * F)):
        _, rsaves = sa._forward(xqs, qmask, m, swk, iv, H, save_acts=False)
        recompute = functools.partial(sa._backward, gq, xqs, qmask, rsaves,
                                      m, swk, iv, H)
        bound = max(bound_parts(flops + 4 * Mq * D * F,
                                nbytes - 2 * Mq * F - no_mask))
        say(f"  sa_train_bwd from save_acts=False ({label}): "
            f"{device_ms(torch, recompute, iters=10):.4f} ms vs plain "
            f"{device_ms(torch, plain_path(K, recompute), iters=5):.4f} ms "
            f"per block; bound {bound:.4f} ms")

    Bl, Dl, Fl = BATCH // 2, 1024, 4096
    Ml = Bl * Lv
    say("[train block] fused_sga_block_train(att_saves=True, bf16_saves="
        "True) (the kernels) vs fused_sga_block_train_plain (plain ops, "
        f"autograd, f32 saves): MCAN-large, one micro-batch B={Bl}, D={Dl}, "
        f"F={Fl}, 8 heads of 128, rate 0.1 (bf16_saves moves the gradients "
        "by its roundings of r1 / r2 / r3 / gv2, 2^-8 relative each)")
    x, kq, vq, vm, qm, masks, w, inv, probe = train_block_inputs(
        torch, dev, B=Bl, D=Dl, F=Fl)
    sav = functools.partial(st.fused_sga_block_train, att_saves=True,
                            bf16_saves=True)
    block_vs_plain(
        torch, "SGA train block, att_saves + bf16_saves", sav,
        st.fused_sga_block_train_plain, (x, kq, vq), w, st.WEIGHT_NAMES,
        probe, lambda blk, ls, ws: blk(*ls, vm, qm, masks, ws, num_heads=H,
                                       inv_keep=inv), rows,
        lambda n: "sga_train_bwd_att_sav", ("x", "kq", "vq"))
    wk = st._kernel_weights([w[n] for n in st.WEIGHT_NAMES])
    xs = x.contiguous()
    _, lsaves = st._forward(xs, kq, vq, vm, qm, masks, wk, inv, H,
                            att_saves=True, save_dtype=torch.bfloat16)
    gflat = probe.reshape(Ml, Dl).contiguous()
    gv2 = st._bwd_ffn(gflat, lsaves, masks, wk, inv, torch.bfloat16)[0]
    pieces = {"sga_train_bwd_att_sav": lambda: st._bwd_att_sav(
        gv2, xs, kq, vq, vm, qm, lsaves, masks, wk, inv, H)}
    att_l = Bl * H * Lv * (Lv + Lq) * 128
    # the attention recompute (P.V) and backward; 4 dX and 4 dW products
    # over the 6 D^2 weights; in: x (f32), v1, qkv, qx, r1, r2, gv2 (bf16),
    # kq / vq (f32), pads, masks att1 / att2 / y1 / y2, wqkv / wm1 / wq2 /
    # wm2 (bf16), ln1_s / ln2_s; out: dx, dkq, dvq and the 12 weight
    # gradients (f32)
    work = {"sga_train_bwd_att_sav": (
        4 * att_l + 10 * att_l + 2 * 2 * Ml * Dl * 6 * Dl,
        4 * Ml * Dl + 2 * Ml * Dl * 8 + 2 * 4 * Bl * H * Lq * 128
        + Bl * (Lv + Lq) + Bl * H * Lv * (Lv + Lq) + 2 * Ml * Dl
        + 2 * 6 * Dl * Dl + 4 * 2 * Dl + 4 * Ml * Dl
        + 2 * 4 * Bl * H * Lq * 128 + 4 * 6 * Dl * Dl + 4 * 10 * Dl)}
    time_pieces(torch, K, rows, pieces, work, 12)
    ps, pinv = st.prng_sites(PRNG_SEED, 0.1, Lv)
    _, lpsaves = st._forward(xs, kq, vq, vm, qm, ps, wk, pinv, H,
                             att_saves=True, save_dtype=torch.bfloat16)
    pgv2 = st._bwd_ffn(gflat, lpsaves, ps, wk, pinv, torch.bfloat16)[0]
    flops, nbytes = work["sga_train_bwd_att_sav"]
    time_pieces(torch, K, rows, {
        "sga_train_bwd_att_sav_prng": lambda: st._bwd_att_sav(
            pgv2, xs, kq, vq, vm, qm, lpsaves, ps, wk, pinv, H)},
        {"sga_train_bwd_att_sav_prng": (
            flops, nbytes - Bl * H * Lv * (Lv + Lq) - 2 * Ml * Dl)}, 12)


def main(argv=None) -> None:
    from mcan_vqa_tpu_torch.cli.card_check import run_check
    run_check(check_train_block, argv, __doc__)


if __name__ == "__main__":
    main()
