"""The port's SGA train block (mcan_vqa_tpu_torch/ops/sga_train.py) against
the JAX custom-VJP block ``fused_sga_block_train`` in interpret mode, on
the same numpy inputs and JAX's own dropout masks, unpacked per sample.

On the CPU the port's block runs its kernel sequence with the kernels'
plain versions; the CUDA kernels themselves are held against those on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py).

Tolerances: forward 1e-3 absolute on LayerNorm-scale outputs (JAX holds
its kernel to 2e-4 against its own composition; the two frameworks round
bf16 operands and the LayerNorm at the same places but sum in another
order). Gradients: 3e-2 of max|ref| per tensor, the gate
tests/test_sga_train.py uses for the bf16-operand kernels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import sga_train as jst
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import sga_train as st

B, Lv, Lq, D, H, F = 4, 10, 6, 32, 4, 64
Dh = D // H
FWD_TOL, GRAD_TOL = 1e-3, 3e-2


def _inputs(seed, rate, group, v_len, q_len, D=D, H=H, F=F):
    rng = np.random.default_rng(seed)
    Dh = D // H

    def mat(shape, s=0.2):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x = rng.normal(size=(B, Lv, D)).astype(np.float32)
    kq = rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)
    vq = rng.normal(size=(B, H, Lq, Dh)).astype(np.float32)
    v_mask = (np.arange(Lv)[None] >= np.asarray(v_len)[:, None])[:, None,
                                                                 None]
    q_mask = (np.arange(Lq)[None] >= np.asarray(q_len)[:, None])[:, None,
                                                                 None]
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
    masks, inv_keep = jst.make_dropout_masks(
        jax.random.PRNGKey(seed + 99), rate, B, Lv, Lq, D, F, H, group)
    masks = {k: np.asarray(v) for k, v in masks.items()}
    return x, kq, vq, v_mask, q_mask, w, probe, masks, inv_keep


def _unpack(masks, group):
    """JAX's packed [B//G, ..., G*rows, (G*cols)] masks -> the port's
    per-sample layout (tests/test_sga_train.py::_unpack_mask)."""
    def take(m, b, rows, cols=None):
        blk, j = m[b // group], b % group
        r = slice(j * rows, (j + 1) * rows)
        return blk[..., r, :] if cols is None else \
            blk[..., r, slice(j * cols, (j + 1) * cols)]

    out = {"att1": [take(masks["att1"], b, Lv, Lv) for b in range(B)],
           "att2": [take(masks["att2"], b, Lv, Lq) for b in range(B)]}
    for n in ("y1", "y2", "h1", "y3"):
        out[n] = [take(masks[n], b, Lv) for b in range(B)]
    return {n: torch.from_numpy(np.stack(v)).bool() for n, v in out.items()}


def _jax_block(inp, group):
    """JAX output and gradients of sum(out * probe) w.r.t. x, kq, vq, w."""
    x, kq, vq, vm, qm, w, probe, masks, inv = inp

    def f(x, kq, vq, w):
        return jst.fused_sga_block_train(
            x, kq, vq, jnp.asarray(vm), jnp.asarray(qm), masks, w,
            num_heads=H, group=group, inv_keep=inv, interpret=True)

    out, vjp = jax.vjp(f, x, kq, vq, w)
    grads = vjp(jnp.asarray(probe))
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _port_block(inp, masks, block=st.fused_sga_block_train, heads=H):
    x, kq, vq, vm, qm, w, probe, _, inv = inp
    xt, kqt, vqt = (torch.from_numpy(a).requires_grad_() for a in (x, kq, vq))
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out = block(xt, kqt, vqt, torch.from_numpy(vm), torch.from_numpy(qm),
                masks, wt, num_heads=heads, inv_keep=inv)
    (out * torch.from_numpy(probe)).sum().backward()
    grads = (xt.grad.numpy(), kqt.grad.numpy(), vqt.grad.numpy(),
             {k: t.grad.numpy() for k, t in wt.items()})
    return out.detach().numpy(), grads


def _close_fwd(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def _close_grads(got, want):
    names = ["dx", "dkq", "dvq"]
    pairs = list(zip(names, got[:3], want[:3]))
    pairs += [(k, got[3][k], want[3][k]) for k in want[3]]
    assert len(pairs) == 21
    for name, a, b in pairs:
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


PARTIAL = ([7, 10, 10, 4], [6, 4, 6, 2])     # ragged, no sample empty
EMPTY = ([7, 10, 0, 4], [6, 4, 6, 0])         # sample 2: no regions;
#                                               sample 3: an all-PAD question

CASES = {"rate0-G2": (0, 0.0, 2, PARTIAL),
         "rate0.25-G2": (1, 0.25, 2, PARTIAL),
         "empty-G1": (2, 0.25, 1, EMPTY),
         "empty-G2": (2, 0.25, 2, EMPTY)}


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, (seed, rate, group, (vl, ql)) in CASES.items():
        inp = _inputs(seed, rate, group, vl, ql)
        masks = _unpack(inp[7], group) if rate > 0 else \
            {n: None for n in st.MASK_NAMES}
        out[name] = (inp, masks, _jax_block(inp, group),
                     _port_block(inp, masks))
    return out


@pytest.mark.parametrize("case", ["rate0-G2", "rate0.25-G2", "empty-G1"])
def test_forward_matches_jax(results, case):
    _, _, (jout, _), (tout, _) = results[case]
    assert tout.shape == (B, Lv, D) and np.isfinite(tout).all()
    _close_fwd(tout, jout)


@pytest.mark.parametrize("case", ["rate0-G2", "rate0.25-G2", "empty-G1"])
def test_gradients_match_jax(results, case):
    _, _, (_, jgrads), (_, tgrads) = results[case]
    _close_grads(tgrads, jgrads)


def test_all_pad_question_differs_from_jax_at_group_2(results):
    """At G = 2 the JAX kernel's collapsed cross mask lets sample 3 (an
    all-PAD question) attend to sample 2's real question keys; the port,
    per sample, stays uniform over sample 3's own keys -- the JAX G = 1
    result, which the port matches at either group."""
    _, _, (j1, _), (t1, _) = results["empty-G1"]
    _, _, (j2, _), (t2, _) = results["empty-G2"]
    # samples with real question keys agree with JAX at G = 2 ...
    _close_fwd(t2[:3], j2[:3])
    # ... sample 3 does not: JAX leaks the neighbour's keys
    assert np.abs(t2[3] - j2[3]).max() > 100 * FWD_TOL
    _close_fwd(t1, j1)


@pytest.mark.parametrize("case", ["rate0.25-G2", "empty-G1"])
def test_kernel_sequence_matches_plain_autograd(results, case):
    """The autograd.Function (forward and hand-written backward) against
    the same block in plain ops differentiated by torch."""
    inp, masks, _, (tout, tgrads) = results[case]
    pout, pgrads = _port_block(inp, masks, st.fused_sga_block_train_plain)
    _close_fwd(tout, pout)
    _close_grads(tgrads, pgrads)


def test_cpu_run_launches_no_kernel(results):
    before = K.launch_counts()
    inp, masks, _, _ = results["rate0.25-G2"]
    _port_block(inp, masks)
    assert K.launch_counts() == before


def test_masks_per_sample_layout_and_rate():
    g = torch.Generator().manual_seed(0)
    masks, inv_keep = st.make_dropout_masks(g, 0.1, 64, 60, 14, 512, 2048, 8)
    shapes = st.mask_shapes(64, 60, 14, 512, 2048, 8)
    assert {n: tuple(m.shape) for n, m in masks.items()} == shapes
    assert all(m.dtype == torch.bool for m in masks.values())
    assert inv_keep == pytest.approx(1 / 0.9)
    # 7.9 M draws: the keep rate within 6 binomial standard deviations
    h1 = masks["h1"].float()
    sd = (0.9 * 0.1 / h1.numel()) ** 0.5
    assert abs(float(h1.mean()) - 0.9) < 6 * sd
    none, one = st.make_dropout_masks(g, 0.0, 2, 3, 4, 8, 16, 2)
    assert one == 1.0 and all(m is None for m in none.values())
    with pytest.raises(ValueError):
        st.make_dropout_masks(g, 1.0, 2, 3, 4, 8, 16, 2)


# ---------------------------------------------------------------------------
# att_saves / bf16_saves, the decoder block of the JAX Trainer at hidden >
# 512, at 128-wide heads (MCAN-large's Dh = 1024 / 8) on a narrow block
# ---------------------------------------------------------------------------

WIDE = dict(D=256, H=2, F=512)          # Dh = 128


SAVES = {"att+bf16": (True, True), "att": (True, False),
         "bf16": (False, True)}


@pytest.fixture(scope="module")
def wide_results():
    inp = _inputs(3, 0.25, 1, *EMPTY, **WIDE)
    masks = _unpack(inp[7], 1)
    x, kq, vq, vm, qm, w, probe, jmasks, inv = inp
    out = {}
    for name, (att, b16) in SAVES.items():
        def f(x, kq, vq, w):
            return jst.fused_sga_block_train(
                x, kq, vq, jnp.asarray(vm), jnp.asarray(qm), jmasks, w,
                num_heads=WIDE["H"], group=1, inv_keep=inv, interpret=True,
                att_saves=att, bf16_saves=b16)

        jout, vjp = jax.vjp(f, x, kq, vq, w)
        jgrads = jax.tree.map(np.asarray, vjp(jnp.asarray(probe)))
        port = functools.partial(st.fused_sga_block_train, att_saves=att,
                                 bf16_saves=b16)
        out[name] = (np.asarray(jout), jgrads,
                     _port_block(inp, masks, port, heads=WIDE["H"]))
    out["plain"] = _port_block(inp, masks, st.fused_sga_block_train_plain,
                               heads=WIDE["H"])
    return out


@pytest.mark.parametrize("case", list(SAVES))
def test_saves_match_jax_at_head_width_128(wide_results, case):
    """v3 and all 21 gradients against JAX with the same saves: the port
    rounds the saved r1 / r2 / r3 / v1 and gv2 to bf16 where the JAX
    kernels do, so the CPU gates hold as at f32 saves."""
    jout, jgrads, (tout, tgrads) = wide_results[case]
    assert tout.shape == (B, Lv, WIDE["D"]) and np.isfinite(tout).all()
    _close_fwd(tout, jout)
    _close_grads(tgrads, jgrads)


def test_att_saves_match_plain_autograd(wide_results):
    """att_saves only moves where the backward reads qkv / qx / r1 / r2
    from: against the block in plain ops under autograd the gates hold."""
    _, _, (tout, tgrads) = wide_results["att"]
    pout, pgrads = wide_results["plain"]
    _close_fwd(tout, pout)
    _close_grads(tgrads, pgrads)
