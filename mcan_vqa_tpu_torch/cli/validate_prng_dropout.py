"""In-kernel dropout on the card: the CUDA Philox and the mask dump against
their plain versions, and the seeded train blocks against the blocks fed
their dumped masks (the port's counterpart of
tools/validate_prng_dropout.py; ``chip_smoke.py`` runs ``check_prng`` as
its ``[prng]`` phase).

    python -m mcan_vqa_tpu_torch.cli.validate_prng_dropout

``check_prng``:

  * ``kernels.philox_words`` (Philox4x32-10) against ``philox4x32_plain``
    bit for bit, twice, on 16 x 2^17 words and the plan's edges;
  * the mask dump (``dump_prng_masks``) against its plain version bit for
    bit, twice, at the SGA block's MCAN-small and MCAN-large shapes, the SA
    block's, and the plan's edges (rows with n % 4 != 0, one and six sites,
    B = 1 and 65,537), each dump's keep rate within 5 sigma of t / 2^32;
  * each dump unit's and the words' time, plan and registers beside the
    plain version, torch.rand + the compare, and the bound of their
    integer work;
  * the seeded SGA blocks (MCAN-small; MCAN-large with att_saves and
    bf16_saves) and the seeded SA block against the external-mask blocks
    fed the dump, bit for bit in the output and every gradient, and
    against their plain twins (6e-2 output, 3e-2 relative L2 a gradient).

Every gate fails the run: a FAIL line on stderr and exit 1. The kernels'
rows print as one JSON line, then the card. Needs a CUDA device: there is
no CPU fallback.
"""

from __future__ import annotations

from mcan_vqa_tpu_torch.cli.card_check import (BATCH, KEEP_OPS, PHILOX_OPS,
                                               PRNG_SEED, SRC, TPU_TRAIN,
                                               bound_parts, device_ms, fail,
                                               gate, max_err, prng_rows, say)
from mcan_vqa_tpu_torch.cli.validate_inkernel_dw import (sa_block_inputs,
                                                         train_block_inputs)


def keep_rate_gate(label, masks, t) -> None:
    """The keep fraction over every mask within 5 sigma of t / 2^32."""
    n = sum(m.numel() for m in masks)
    kept = sum(int(m.sum()) for m in masks)
    p = t / 2 ** 32
    sigma = (p * (1 - p) / n) ** 0.5
    z = (kept / n - p) / sigma
    ok = abs(z) <= 5
    say(f"  {label}: keep fraction {kept / n:.6f} over {n} decisions, "
        f"expected {p:.6f}: {z:+.2f} sigma (|z| <= 5) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{label}: keep rate {kept / n} is {z:.1f} sigma from {p}")


def seeded_vs_dump(torch, label, seeded, fed, plain, leaves, leaf_names, w,
                   names, probe, rows, row_of) -> None:
    """The seeded block, the external-mask block fed the seed's dump, and
    the seeded block's plain twin, under autograd from the same leaves:
    the first two equal bit for bit in the output and every gradient; the
    plain twin within block_vs_plain's tolerances."""
    def run(block):
        ls = [t.clone().requires_grad_() for t in leaves]
        ws = {k: t.clone().requires_grad_() for k, t in w.items()}
        out = block(ls, ws)
        (out * probe).sum().backward()
        return [out.detach()] + [t.grad for t in ls] + [ws[n].grad
                                                        for n in names]

    got, want, ref = run(seeded), run(fed), run(plain)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(got, want)]
    say(f"  {label}: seeded block vs the external-mask block fed the dump: "
        f"output and {len(got) - 1} gradients equal bit for bit: "
        f"{all(same)} ({sum(same)}/{len(same)})")
    if not all(same):
        fail(f"{label}: the seeded block differs from the block fed its dump")
    e_out = max_err(got[0], ref[0])
    gate(f"{label} output vs plain", e_out, 6e-2)
    rows.err(row_of(None), e_out)
    worst = 0.0
    for name, a, b in zip(leaf_names + names, got[1:], ref[1:]):
        rel = float((a - b).norm() / b.norm())
        worst = max(worst, rel)
        if not rel <= 3e-2:
            fail(f"{label}: gradient {name} vs plain, |err|/|ref| {rel}")
        rows.err(row_of(name), max_err(a, b))
    say(f"  {label}: every gradient within {worst:.3e} <= 3e-2 of the plain "
        f"twin in relative norm")


# (B, [(site code, heads, n)]): the dump's plan edges, as in the card tests
# (tests/test_torch_kernels_gpu.py::PRNG_EDGES): rows with n % 4 != 0,
# att2's n = 840, one site and six, B = 1, B = 65,537 with one small site;
# and (B, n) of philox_words'
PRNG_EDGES = (
    (7, [(0x100, 3, 5), (0x200, 1, 3), (0x301, 2, 4099), (0x302, 1, 842)]),
    (64, [(0x200, 8, 840)]),
    (3, [(0x303, 1, 122880)]),
    (3, [(0x100, 8, 3600), (0x200, 8, 840), (0x301, 1, 1), (0x302, 16, 5),
         (0x303, 1, 4099), (0x304, 1, 30720)]),
    (1, [(0x100, 8, 3600), (0x303, 1, 7)]),
    (65537, [(0x303, 1, 5)]))
WORD_EDGES = ((1, 1), (3, 5), (7, 4099), (5, 842), (2, 122880), (65537, 3))


def prng_report(torch, K) -> None:
    """prng_masks.cu's two instances: registers and local (spilled) bytes a
    thread as compiled (cudaFuncGetAttributes, in any process)."""
    import ctypes

    from mcan_vqa_tpu_torch.ops import _build
    info = (ctypes.c_int * 3)()
    for words, kind in ((0, "dump_prng_masks"), (1, "philox_words")):
        rc = _build.load_library().mcan_prng_kernel_attrs(words, info)
        if rc != 0:
            fail(f"prng_kernel ({kind}): cudaFuncGetAttributes error {rc}")
        say(f"  [registers] prng_kernel ({kind}): {info[0]} registers, "
            f"{info[1]} local bytes a thread, __launch_bounds__("
            f"{K.PRNG_THREADS}, {K.PRNG_BLOCKS_PER_SM})")


def prng_plan_line(plan, per_sm: int) -> str:
    """kernels.prng_plan of one prng_masks.cu launch."""
    return (f"[plan] grid {plan.grid} x {plan.threads} (one wave: at most "
            f"{per_sm} CTAs an SM), {plan.chunks} chunks of 16 "
            f"elements ({plan.per_sample} a sample, stride {plan.step}), "
            f"store widths {plan.width} bytes")


def check_prng(torch, dev, rows) -> None:
    """Philox and the dump against their plain versions bit for bit, twice
    with equal bits, at the block shapes and the plan's edges; the keep
    rate; each dump unit's and the words' time, plan and registers beside
    the plain version, torch.rand + the compare and the bound; the seeded
    SGA and SA blocks against the external-mask blocks fed the dump
    (MCAN-small B=64; MCAN-large micro-batch 32 with att_saves and
    bf16_saves), bit for bit in the output and every gradient."""
    from mcan_vqa_tpu_torch.cli.bench_prng import dump_specs
    from mcan_vqa_tpu_torch.ops import kernels as K
    from mcan_vqa_tpu_torch.ops import sa_train as sa
    from mcan_vqa_tpu_torch.ops import sga_train as st
    prng_rows(rows)
    src, replaces = SRC + "prng_masks.cu", TPU_TRAIN + ":1530"
    rows.row("dump_prng_masks", src, replaces, "one call at each of the "
             "three dump units of [prng]: the MCAN-small SGA and SA blocks "
             "at B=64, the MCAN-large SGA block at micro-batch 32")
    rows.row("philox_words", src, replaces, "one call of 16 x 2^17 words")
    before = {k: K.LAUNCHES[k] for k in ("dump_prng_masks", "philox_words")}
    rate, seed = 0.1, PRNG_SEED
    t, inv = st.prng_keep_params(rate)
    say(f"[prng] Philox4x32-10, key (seed, site), counter (e >> 2, b); keep "
        f"iff word < t = {t}, kept x 2^32 / t = {inv!r} (1 / (1 - rate) = "
        f"{1 / (1 - rate)!r})")
    prng_report(torch, K)
    Bw, n = 16, 1 << 17
    for B_, n_ in ((Bw, n),) + WORD_EDGES:
        words = K.philox_words(seed, 0x303, B_, n_, dev)
        again = K.philox_words(seed, 0x303, B_, n_, dev)
        ref = K.philox_words_plain(seed, 0x303, B_, n_, dev)
        torch.cuda.synchronize()
        same = torch.equal(words, ref) and torch.equal(words, again)
        say(f"  philox_words [{B_}, {n_}] vs philox4x32_plain: equal bit for "
            f"bit, twice {same}")
        if not same:
            fail(f"the CUDA Philox differs from philox4x32_plain at "
                 f"[{B_}, {n_}]")
    rows.err("philox_words", 0.0)

    B, Lv, Lq, D, F, H = BATCH, 60, 14, 512, 2048, 8
    Bl, Dl, Fl = BATCH // 2, 1024, 4096
    dumps = (("SGA block, MCAN-small", st.dump_prng_masks,
              st.dump_prng_masks_plain, (B, Lv, Lq, D, F, H)),
             ("SA block, MCAN-small", sa.dump_sa_prng_masks,
              sa.dump_sa_prng_masks_plain, (B, Lq, D, F, H)),
             ("SGA block, MCAN-large", st.dump_prng_masks,
              st.dump_prng_masks_plain, (Bl, Lv, Lq, Dl, Fl, H)))
    for label, dump, plain, shape in dumps:
        got, g_inv = dump(seed, rate, *shape, device=dev)
        again, _ = dump(seed, rate, *shape, device=dev)
        want, w_inv = plain(seed, rate, *shape, device=dev)
        torch.cuda.synchronize()
        same = all(torch.equal(got[k], want[k]) and torch.equal(got[k],
                                                                again[k])
                   for k in want)
        sizes = {k: tuple(v.shape) for k, v in got.items()}
        say(f"  dump_prng_masks, {label} {tuple(shape)}: {sizes} equal to "
            f"the plain dump bit for bit, twice {same}, inv_keep "
            f"{g_inv == w_inv == inv}")
        if not (same and g_inv == w_inv == inv):
            fail(f"dump_prng_masks ({label}) differs from its plain version")
        keep_rate_gate(label, list(got.values()), t)
    for B_, sites in PRNG_EDGES:
        got = K.dump_prng_masks(seed, t, B_, sites, dev)
        again = K.dump_prng_masks(seed, t, B_, sites, dev)
        want = K.dump_prng_masks_plain(seed, t, B_, sites, dev)
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) and torch.equal(g, a)
                   for g, a, w in zip(got, again, want))
        say(f"  dump_prng_masks, edge B={B_} sites {sites}: equal to the "
            f"plain dump bit for bit, twice {same}; grid "
            f"{K.LAST_GRID['dump_prng_masks']}")
        if not same:
            fail(f"dump_prng_masks differs from its plain version at B={B_}, "
                 f"{sites}")
    rows.err("dump_prng_masks", 0.0)

    # the times (on no main path: the dump is what makes the seeded path
    # testable), beside torch.rand + the compare over the same shapes (the
    # default generator: a graph capture takes no other) and the bound of
    # the integer work
    sms = K.GEMM_SMS
    for unit, (B_, sites) in dump_specs(("sga", "sa", "large")).items():
        plan = K.prng_plan(B_, tuple((h, n_) for _, h, n_ in sites), sms)
        shapes = [(B_, h, n_) for _, h, n_ in sites]
        t_k = device_ms(torch, lambda: K.dump_prng_masks(seed, t, B_, sites,
                                                         dev))
        t_p = device_ms(torch, lambda: K.dump_prng_masks_plain(
            seed, t, B_, sites, dev), iters=3)
        t_l = device_ms(torch, lambda: [torch.rand(s, device=dev) >= rate
                                        for s in shapes])
        ops = (PHILOX_OPS + KEEP_OPS) * plan.counters
        op, by = bound_parts(0.0, plan.out_bytes, int_ops=ops)
        say(f"  dump_prng_masks, unit {unit} (B={B_}: {plan.out_bytes} keep "
            f"bytes, {plan.counters} counters): {t_k:.4f} ms vs plain "
            f"{t_p:.4f} ms, library (torch.rand + the compare, "
            f"{len(shapes)} masks) {t_l:.4f} ms; bound {max(op, by):.4f} ms "
            f"({'operations' if op >= by else 'bytes'}: {ops} integer "
            f"operations {op:.4f} ms, bytes written {by:.4f} ms)")
        say(f"    {prng_plan_line(plan, K.PRNG_BLOCKS_PER_SM)}")
        rows.add("dump_prng_masks", 1, t_k, t_p, 0.0, plan.out_bytes,
                 library_ms=t_l, int_ops=ops)
    plan = K.prng_plan(Bw, ((1, n),), sms, 4)
    # the kernel alone: raw, the uint32 words without the wrapper's int64 copy
    t_k = device_ms(torch, lambda: K.philox_words(seed, 0x303, Bw, n, dev,
                                                  raw=True))
    t_p = device_ms(torch, lambda: K.philox_words_plain(seed, 0x303, Bw, n,
                                                        dev), iters=3)
    t_l = device_ms(torch, lambda: torch.randint(
        -2 ** 31, 2 ** 31, (Bw, n), dtype=torch.int32, device=dev))
    ops = PHILOX_OPS * plan.counters
    op, by = bound_parts(0.0, plan.out_bytes, int_ops=ops)
    say(f"  philox_words [{Bw}, {n}] ({plan.out_bytes} bytes, raw): {t_k:.4f} ms "
        f"vs plain {t_p:.4f} ms, library (torch.randint of as many int32) "
        f"{t_l:.4f} ms; bound {max(op, by):.4f} ms ({ops} integer operations "
        f"{op:.4f} ms, bytes written {by:.4f} ms)")
    say(f"    {prng_plan_line(plan, K.PRNG_BLOCKS_PER_SM)}")
    rows.add("philox_words", 1, t_k, t_p, 0.0, plan.out_bytes,
             library_ms=t_l, int_ops=ops)
    for k, v in before.items():
        rows.rows[k]["calls_in_prng"] = K.LAUNCHES[k] - v

    say("[prng] the seeded blocks against the external-mask blocks fed the "
        "dump, and against their plain twins (autograd)")
    ffn = {"w1", "b1", "w2", "b2", "ln3_s", "ln3_b"}
    for label, Bx, Dx, Fx, saves in (("MCAN-small", B, D, F, False),
                                     ("MCAN-large", Bl, Dl, Fl, True)):
        x, kq, vq, vm, qm, _, w, _, probe = train_block_inputs(
            torch, dev, B=Bx, D=Dx, F=Fx)
        masks, inv_d = st.dump_prng_masks(seed, rate, Bx, Lv, Lq, Dx, Fx, H,
                                          device=dev)
        kw = dict(num_heads=H, att_saves=saves, bf16_saves=saves)
        if saves:
            row_of = (lambda n: "sga_train_bwd_att_sav_prng")  # noqa: E731
        else:
            row_of = (lambda n: "sga_train_fwd_prng" if n is None  # noqa: E731
                      else "sga_train_bwd_ffn_prng" if n in ffn
                      else "sga_train_bwd_att_prng")
        seeded_vs_dump(
            torch, f"SGA train block, {label}",
            lambda ls, ws: st.fused_sga_block_train_prng(
                *ls, vm, qm, seed, ws, rate=rate, **kw),
            lambda ls, ws: st.fused_sga_block_train(
                *ls, vm, qm, masks, ws, inv_keep=inv_d, **kw),
            lambda ls, ws: st.fused_sga_block_train_prng_plain(
                *ls, vm, qm, seed, ws, num_heads=H, rate=rate),
            (x, kq, vq), ("x", "kq", "vq"), w, st.WEIGHT_NAMES, probe, rows,
            row_of)
    xq, qmask, _, sw, _, sprobe = sa_block_inputs(torch, dev, B)
    masks, inv_d = sa.dump_sa_prng_masks(seed, rate, B, Lq, D, F, H,
                                         device=dev)
    seeded_vs_dump(
        torch, "SA train block, MCAN-small",
        lambda ls, ws: sa.fused_sa_block_train(*ls, qmask, seed, ws,
                                               num_heads=H, rate=rate),
        lambda ls, ws: sa.fused_sa_block_train(*ls, qmask, masks, ws,
                                               num_heads=H, inv_keep=inv_d),
        lambda ls, ws: sa.fused_sa_block_train_plain(
            *ls, qmask, seed, ws, num_heads=H, rate=rate),
        (xq,), ("x",), sw, sa.SA_WEIGHT_NAMES, sprobe, rows,
        lambda n: "sa_train_fwd_prng" if n is None else "sa_train_bwd_prng")


def main(argv=None) -> None:
    from mcan_vqa_tpu_torch.cli.card_check import run_check
    run_check(check_prng, argv, __doc__)


if __name__ == "__main__":
    main()
