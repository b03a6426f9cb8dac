"""The in-kernel dropout of the port's train blocks on the CPU.

The TPU kernels draw their keep bits from the TPU's hardware PRNG, which no
other machine reproduces; the port draws them from Philox4x32-10
(``kernels.philox4x32_plain`` here, csrc/common.cuh on the card). So the
seeded route is held against JAX through its masks: ``dump_prng_masks``
writes the masks a seed draws, and JAX's external-mask blocks in interpret
mode, fed those masks with the seeded route's inv_keep = 2^32 / t, must
give what the port's seeded blocks give. On the CPU the port's blocks run
their kernel sequences with the kernels' plain versions; the CUDA kernels
are held against those on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py ``[prng]``).

Tolerances against JAX, as tests/test_torch_sga_train.py states them:
forward 1e-3 absolute on LayerNorm-scale outputs, gradients 3e-2 of
max|ref| per tensor. Within the port: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import sa_train as jsa
from mcan_vqa_tpu.ops import sga_train as jst
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import sa_train as sa
from mcan_vqa_tpu_torch.ops import sga_train as st
from mcan_vqa_tpu_torch.train import fused_engine as fe

B, Lv, Lq, D, H, F = 4, 10, 6, 32, 4, 64
FWD_TOL, GRAD_TOL = 1e-3, 3e-2
SEED, RATE = 20240607, 0.1


# ---------------------------------------------------------------------------
# Philox and the keep decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_matches_random123_known_answers(ctr, key, want):
    out = K.philox4x32_plain(torch.tensor([ctr], dtype=torch.int64), key)
    assert tuple(int(w) for w in out[0]) == want


def test_philox_words_take_word_e_mod_4_of_counter_e_div_4():
    words = K.philox_words_plain(SEED, 0x303, 3, 10)
    for b in range(3):
        for e in range(10):
            ctr = torch.tensor([[e >> 2, b, 0, 0]], dtype=torch.int64)
            assert int(words[b, e]) == int(
                K.philox4x32_plain(ctr, (SEED, 0x303))[0, e & 3])


@pytest.mark.parametrize("rate", [1e-9, 0.1, 0.25, 0.5, 0.999])
def test_prng_keep_params_match_jax(rate):
    assert st.prng_keep_params(rate) == jst.prng_keep_params(rate)


def test_dumped_masks_are_deterministic_and_keyed():
    shape = (B, Lv, Lq, D, F, H)
    a, inv = st.dump_prng_masks_plain(SEED, RATE, *shape)
    b, _ = st.dump_prng_masks_plain(SEED, RATE, *shape)
    c, _ = st.dump_prng_masks_plain(SEED + 1, RATE, *shape)
    assert inv == 2 ** 32 / st.prng_keep_params(RATE)[0]
    for name, shp in st.mask_shapes(*shape).items():
        assert a[name].shape == shp and a[name].dtype == torch.uint8
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
    # another site, head and sample draw other bits
    assert not torch.equal(a["y1"], a["y3"])
    assert not torch.equal(a["att1"][:, 0], a["att1"][:, 1])
    assert not torch.equal(a["h1"][0], a["h1"][1])
    sam, _ = sa.dump_sa_prng_masks_plain(SEED, RATE, B, Lv, D, F, H)
    assert not torch.equal(sam["y1"], a["y1"])      # SA codes are disjoint


def test_keep_rate_and_adjacent_pairs_are_binomial():
    """At rate 0.1 the keep fraction is within 5 sigma of t / 2^32, and
    neighbouring elements are kept together at p^2 (no correlation between
    the words of one counter or of neighbouring counters)."""
    t, _ = st.prng_keep_params(RATE)
    p = t / 2 ** 32
    keep = torch.cat([K.dump_prng_masks_plain(SEED, t, 16, [(site, 1, 4099)])
                      [0].reshape(-1) for site in (0x301, 0x303, 0x502)])
    n = keep.numel()
    assert abs(float(keep.float().mean()) - p) <= 5 * (p * (1 - p) / n) ** 0.5
    pairs = keep.reshape(-1, 4099)
    both = (pairs[:, 1:] & pairs[:, :-1]).float()
    m, q = both.numel(), p * p
    assert abs(float(both.mean()) - q) <= 5 * (q * (1 - q) / m) ** 0.5


# ---------------------------------------------------------------------------
# the seeded blocks against JAX's external-mask blocks fed the dump
# ---------------------------------------------------------------------------

def _sga_inputs(seed=0):
    rng = np.random.default_rng(seed)

    def mat(shape, s=0.2):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x = rng.normal(size=(B, Lv, D)).astype(np.float32)
    kq = rng.normal(size=(B, H, Lq, D // H)).astype(np.float32)
    vq = rng.normal(size=(B, H, Lq, D // H)).astype(np.float32)
    v_mask = (np.arange(Lv)[None] >= np.array([7, 10, 0, 4])[:, None])
    q_mask = (np.arange(Lq)[None] >= np.array([6, 0, 6, 2])[:, None])
    w = {"wqkv": mat((D, 3 * D)), "bqkv": mat((3 * D,)),
         "wm1": mat((D, D)), "bm1": mat((D,)),
         "ln1_s": 1 + mat((D,), 0.05), "ln1_b": mat((D,)),
         "wq2": mat((D, D)), "bq2": mat((D,)),
         "wm2": mat((D, D)), "bm2": mat((D,)),
         "ln2_s": 1 + mat((D,), 0.05), "ln2_b": mat((D,)),
         "w1": mat((D, F)), "b1": mat((F,)),
         "w2": mat((F, D)), "b2": mat((D,)),
         "ln3_s": 1 + mat((D,), 0.05), "ln3_b": mat((D,))}
    probe = rng.normal(size=(B, Lv, D)).astype(np.float32)
    return (x, kq, vq, v_mask[:, None, None], q_mask[:, None, None], w,
            probe)


def _sa_inputs(seed=1):
    rng = np.random.default_rng(seed)

    def mat(shape, s=0.2):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x = rng.normal(size=(B, Lq, D)).astype(np.float32)
    mask = (np.arange(Lq)[None] >= np.array([6, 0, 3, 5])[:, None])
    w = {"wqkv": mat((D, 3 * D)), "bqkv": mat((3 * D,)),
         "wm": mat((D, D)), "bm": mat((D,)),
         "ln1_s": 1 + mat((D,), 0.05), "ln1_b": mat((D,)),
         "w1": mat((D, F)), "b1": mat((F,)),
         "w2": mat((F, D)), "b2": mat((D,)),
         "ln2_s": 1 + mat((D,), 0.05), "ln2_b": mat((D,))}
    probe = rng.normal(size=(B, Lq, D)).astype(np.float32)
    return x, mask[:, None, None], w, probe


def _port_sga(inp, block, arg, **kw):
    x, kq, vq, vm, qm, w, probe = inp
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, kq, vq)]
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out = block(*leaves, torch.from_numpy(vm), torch.from_numpy(qm), arg, wt,
                num_heads=H, **kw)
    (out * torch.from_numpy(probe)).sum().backward()
    return [out.detach()] + [t.grad for t in leaves] + \
        [wt[n].grad for n in st.WEIGHT_NAMES]


def _port_sa(inp, block, arg, **kw):
    x, mask, w, probe = inp
    xt = torch.from_numpy(x).requires_grad_()
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out = block(xt, torch.from_numpy(mask), arg, wt, num_heads=H, **kw)
    (out * torch.from_numpy(probe)).sum().backward()
    return [out.detach(), xt.grad] + [wt[n].grad for n in sa.SA_WEIGHT_NAMES]


def _close_to_jax(got, out, grads):
    np.testing.assert_allclose(got[0].numpy(), out, rtol=0, atol=FWD_TOL)
    assert len(got) - 1 == len(grads)
    for a, b in zip(got[1:], grads):
        b = np.asarray(b)
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=GRAD_TOL)


@pytest.fixture(scope="module")
def jax_sga_fed_the_dump():
    """JAX's external-mask SGA block (interpret mode) fed the port's dump:
    the output and the gradients of x, kq, vq and every weight."""
    x, kq, vq, vm, qm, w, probe = _sga_inputs()
    masks, inv = st.dump_prng_masks(SEED, RATE, B, Lv, Lq, D, F, H, "cpu")
    jmasks = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}

    def f(x, kq, vq, w):
        return jst.fused_sga_block_train(
            x, kq, vq, jnp.asarray(vm), jnp.asarray(qm), jmasks, w,
            num_heads=H, group=1, inv_keep=inv, interpret=True)

    out, vjp = jax.vjp(f, x, kq, vq, w)
    dx, dkq, dvq, dw = vjp(jnp.asarray(probe))
    return np.asarray(out), [dx, dkq, dvq] + [dw[n] for n in st.WEIGHT_NAMES]


@pytest.mark.parametrize("block", [st.fused_sga_block_train_prng,
                                   st.fused_sga_block_train_prng_plain])
def test_seeded_sga_block_matches_jax_fed_the_dump(block,
                                                   jax_sga_fed_the_dump):
    got = _port_sga(_sga_inputs(), block, SEED, rate=RATE)
    _close_to_jax(got, *jax_sga_fed_the_dump)


@pytest.fixture(scope="module")
def jax_sa_fed_the_dump():
    """JAX's external-mask SA block (interpret mode) fed the port's dump:
    the output and the gradients of x and every weight."""
    x, mask, w, probe = _sa_inputs()
    masks, inv = sa.dump_sa_prng_masks(SEED, RATE, B, Lq, D, F, H, "cpu")
    jmasks = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}

    def f(x, w):
        return jsa.fused_sa_block_train(x, jnp.asarray(mask), jmasks, w,
                                        num_heads=H, group=1, inv_keep=inv,
                                        interpret=True)

    out, vjp = jax.vjp(f, x, w)
    dx, dw = vjp(jnp.asarray(probe))
    return np.asarray(out), [dx] + [dw[n] for n in sa.SA_WEIGHT_NAMES]


@pytest.mark.parametrize("plain", [False, True])
def test_seeded_sa_block_matches_jax_fed_the_dump(plain, jax_sa_fed_the_dump):
    block = sa.fused_sa_block_train_plain if plain else sa.fused_sa_block_train
    got = _port_sa(_sa_inputs(), block, SEED, rate=RATE)
    _close_to_jax(got, *jax_sa_fed_the_dump)


# ---------------------------------------------------------------------------
# within the port: the seeded route equals the external route fed the dump
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plain,saves", [(False, False), (False, True),
                                         (True, False)])
def test_seeded_sga_block_equals_the_block_fed_the_dump(plain, saves):
    inp = _sga_inputs(2)
    masks, inv = st.dump_prng_masks_plain(SEED, RATE, B, Lv, Lq, D, F, H)
    if plain:
        got = _port_sga(inp, st.fused_sga_block_train_prng_plain, SEED,
                        rate=RATE)
        want = _port_sga(inp, st.fused_sga_block_train_plain, masks,
                         inv_keep=inv)
    else:
        kw = dict(att_saves=saves, bf16_saves=saves)
        got = _port_sga(inp, st.fused_sga_block_train_prng, SEED, rate=RATE,
                        **kw)
        want = _port_sga(inp, st.fused_sga_block_train, masks, inv_keep=inv,
                         **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("plain,save_acts", [(False, True), (False, False),
                                             (True, True)])
def test_seeded_sa_block_equals_the_block_fed_the_dump(plain, save_acts):
    """save_acts=False: the backward recomputes the FFN (the TPU's
    _bwd_kernel_prng), drawing the h1 site again from the seed."""
    inp = _sa_inputs(3)
    masks, inv = sa.dump_sa_prng_masks_plain(SEED, RATE, B, Lq, D, F, H)
    block = sa.fused_sa_block_train_plain if plain else sa.fused_sa_block_train
    got = _port_sa(inp, block, SEED, rate=RATE, save_acts=save_acts)
    want = _port_sa(inp, block, masks, inv_keep=inv, save_acts=save_acts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_seeded_block_saves_no_mask_for_its_backward():
    inp = _sga_inputs(4)
    x, kq, vq, vm, qm, w, _ = inp
    seen = {}
    real = st.SGABlockTrain.backward

    def spy(ctx, g):
        seen.update(ctx.masks)
        return real(ctx, g)

    st.SGABlockTrain.backward = staticmethod(spy)
    try:
        _port_sga(inp, st.fused_sga_block_train_prng, SEED, rate=RATE)
    finally:
        st.SGABlockTrain.backward = staticmethod(real)
    assert set(seen) == set(st.MASK_NAMES)
    assert all(isinstance(m, K.Philox) and m.seed == SEED
               for m in seen.values())


# ---------------------------------------------------------------------------
# the engine: in-kernel dropout against the external route fed the dumps
# ---------------------------------------------------------------------------

def _engine_model():
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import MCANet
    cfg = Config(hidden_size=D, layer=2, multi_head=H, ff_size=F,
                 img_feat_size=24, img_feat_pad_size=Lv, flat_mlp_size=16,
                 flat_out_size=D)
    net = MCANet(cfg, 40, 11, generator=torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.normal(size=(B, Lv, 24)).astype(np.float32))
    img[2, 4:] = 0.0
    ques = torch.from_numpy(rng.integers(1, 40, (B, 14)))
    ques[1, 5:] = 0
    target = torch.from_numpy((rng.random((B, 11)) < 0.2).astype(np.float32))
    return net, img, ques, target


def _loss_grads(net, fwd, img, ques, target, generator):
    from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
    net.zero_grad()
    loss = bce_with_logits_sum(fwd(net, img, ques, generator), target)
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in net.parameters()]


@pytest.mark.parametrize("fused_encoder", [True, False])
def test_in_kernel_engine_equals_the_external_engine_fed_the_dumps(
        monkeypatch, fused_encoder):
    """One forward and backward of the engine with in_kernel_dropout (its
    kernel sequences on the CPU) against the same engine whose seeded
    blocks are the external-mask blocks fed their seed's dump with its
    inv_keep: the same loss and gradients, bit for bit; and the plain
    sites draw the same generator masks in both."""
    net, img, ques, target = _engine_model()
    kw = dict(dropout_rate=RATE, fused_encoder=fused_encoder,
              in_kernel_dropout=True)
    got = _loss_grads(net, fe.make_fused_train_forward(2, H, **kw), img,
                      ques, target, torch.Generator().manual_seed(8))

    def sga_fed(x, kq, vq, vm, qm, seed, w, *, num_heads, rate, **skw):
        Bx, L, Dx = x.shape
        masks, inv = st.dump_prng_masks_plain(seed, rate, Bx, L, kq.shape[2],
                                              Dx, w["w1"].shape[1],
                                              num_heads)
        return st.fused_sga_block_train(x, kq, vq, vm, qm, masks, w,
                                        num_heads=num_heads, inv_keep=inv,
                                        **skw)

    def sa_fed(x, xm, m, w, *, num_heads, inv_keep, rate=None):
        if rate is not None:
            Bx, L, Dx = x.shape
            m, inv_keep = sa.dump_sa_prng_masks_plain(
                m, rate, Bx, L, Dx, w["w1"].shape[1], num_heads)
        return sa.fused_sa_block_train(x, xm, m, w, num_heads=num_heads,
                                       inv_keep=inv_keep)

    monkeypatch.setitem(fe.SGA_BLOCKS, "fused",
                        (st.fused_sga_block_train, sga_fed))
    monkeypatch.setitem(fe.SA_BLOCKS, "fused", sa_fed)
    want = _loss_grads(net, fe.make_fused_train_forward(2, H, **kw), img,
                       ques, target, torch.Generator().manual_seed(8))
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_in_kernel_engine_draws_seeds_not_masks_for_the_blocks(monkeypatch):
    """The seeded engine asks the generator for the plain sites' masks only
    (AttFlat's two; the encoder's four per layer when it is plain), and for
    one host int seed per train block; its plain twin draws the same."""
    drawn = []
    real = fe.keep_masks

    def spy(generator, rate, shapes, bit_width=32):
        drawn.extend(shapes)
        return real(generator, rate, shapes, bit_width)

    monkeypatch.setattr(fe, "keep_masks", spy)
    net, img, ques, target = _engine_model()
    seeds = []
    real_seeds = fe.draw_seeds
    monkeypatch.setattr(fe, "draw_seeds", lambda g, n: seeds.append(n) or
                        real_seeds(g, n))
    for fused_encoder, want in ((True, []), (False, list(sa.SA_MASK_NAMES)
                                             * 2)):
        drawn.clear()
        seeds.clear()
        fwd = fe.make_fused_train_forward(2, H, dropout_rate=RATE,
                                          fused_encoder=fused_encoder,
                                          in_kernel_dropout=True)
        fwd(net, img, ques, torch.Generator().manual_seed(0))
        assert drawn == want + ["lang", "img"]
        assert seeds == ([2, 2] if fused_encoder else [2])
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for sga_block, g in (("fused", g1), ("plain", g2)):
        fe.make_fused_train_forward(2, H, dropout_rate=RATE,
                                    sga_block=sga_block, fused_encoder=True,
                                    in_kernel_dropout=True)(net, img, ques, g)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_draw_seeds_is_a_function_of_the_generator_state():
    from mcan_vqa_tpu_torch.ops.dropout import SEED_MAX, draw_seeds
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    a = draw_seeds(g, 12)
    after = g.get_state()
    g.set_state(state)
    assert draw_seeds(g, 12) == a and torch.equal(g.get_state(), after)
    assert len(set(a)) == 12 and all(0 <= s < SEED_MAX for s in a)
    assert draw_seeds(g, 12) != a
