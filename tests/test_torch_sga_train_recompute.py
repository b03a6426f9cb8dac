"""The port's SGA train block with ``save_acts=False`` -- the FFN backward
that recomputes h1 and y3 from the saved v2 (the TPU's ``_bwd_ffn_kernel``
and ``_bwd_ffn_kernel_prng``, mcan_vqa_tpu/ops/sga_train.py:561 / :568) --
against the JAX block ``fused_sga_block_train(save_acts=False)`` in
interpret mode, on the same numpy inputs and JAX's own dropout masks,
unpacked per sample.

On the CPU the port's block runs its kernel sequence with the kernels'
plain versions; the CUDA kernels are held against those on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py ``[last sites]``).

Tolerances against JAX, as tests/test_torch_sga_train.py states them:
forward 1e-3 absolute on LayerNorm-scale outputs, gradients 3e-2 of
max|ref| per tensor. Within the port: the recompute draws the forward's
bits again, so save_acts=False equals save_acts=True bit for bit at f32
saves, and the seeded block equals the block fed its dumped masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import sga_train as jst
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import sga_train as st
from tests.test_torch_sga_train import B, D, EMPTY, F, H, Lq, Lv, PARTIAL, \
    _close_fwd, _close_grads, _inputs, _unpack

SEED, RATE = 20240611, 0.1

# case: (seed, rate, group, (v_len, q_len), bf16_saves)
CASES = {"rate0-G2": (5, 0.0, 2, PARTIAL, False),
         "rate0.25-G2": (6, 0.25, 2, PARTIAL, False),
         "empty-G1": (7, 0.25, 1, EMPTY, False),
         "empty-G1-bf16": (7, 0.25, 1, EMPTY, True)}


def _port(inp, masks, save_acts, bf16_saves, block=st.fused_sga_block_train,
          **kw):
    x, kq, vq, vm, qm, w, probe, _, inv = inp
    xt, kqt, vqt = (torch.from_numpy(a).requires_grad_() for a in (x, kq, vq))
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out = block(xt, kqt, vqt, torch.from_numpy(vm), torch.from_numpy(qm),
                masks, wt, num_heads=H, save_acts=save_acts,
                bf16_saves=bf16_saves, **(kw or dict(inv_keep=inv)))
    (out * torch.from_numpy(probe)).sum().backward()
    return [out.detach(), xt.grad, kqt.grad, vqt.grad] + [
        wt[n].grad for n in st.WEIGHT_NAMES]


def _as_np(got):
    """The port's [out, dx, dkq, dvq, *dw] -> (out, the _close_grads
    layout)."""
    a = [t.numpy() for t in got]
    return a[0], (a[1], a[2], a[3], dict(zip(st.WEIGHT_NAMES, a[4:])))


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, (seed, rate, group, (vl, ql), b16) in CASES.items():
        inp = _inputs(seed, rate, group, vl, ql)
        x, kq, vq, vm, qm, w, probe, jmasks, inv = inp

        def f(x, kq, vq, w):
            return jst.fused_sga_block_train(
                x, kq, vq, jnp.asarray(vm), jnp.asarray(qm), jmasks, w,
                num_heads=H, group=group, inv_keep=inv, interpret=True,
                save_acts=False, bf16_saves=b16)

        jout, vjp = jax.vjp(f, x, kq, vq, w)
        jgrads = jax.tree.map(np.asarray, vjp(jnp.asarray(probe)))
        masks = _unpack(jmasks, group) if rate > 0 else \
            {n: None for n in st.MASK_NAMES}
        out[name] = (inp, masks, b16, (np.asarray(jout), jgrads),
                     _port(inp, masks, False, b16))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_recompute_backward_matches_jax(results, case):
    """v3 and all 21 gradients against JAX's save_acts=False block: the
    rate-0 and rate-0.25 masks, packing group 1 and 2, bf16_saves both
    ways, and samples with no regions or an all-PAD question (at G = 1,
    where JAX's packed mask agrees with the port's per-sample one)."""
    _, _, _, (jout, jgrads), got = results[case]
    tout, tgrads = _as_np(got)
    assert tout.shape == (B, Lv, D) and np.isfinite(tout).all()
    _close_fwd(tout, jout)
    _close_grads(tgrads, jgrads)


@pytest.mark.parametrize("case", ["rate0.25-G2", "empty-G1"])
def test_recompute_equals_saved_activations_at_f32_saves(results, case):
    """The recompute runs the forward's own FFN calls on the same v2 and
    forms r3 = v2 + drop(y3 + b2) as the forward's LayerNorm did, so the
    two backwards agree to the bit."""
    inp, masks, b16, _, got = results[case]
    assert not b16
    want = _port(inp, masks, True, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_recompute_near_saved_activations_at_bf16_saves(results):
    """Under bf16_saves save_acts=True reads r3 rounded to bf16, the
    recompute forms it in f32 from the bf16 v2 (as the two JAX kernels
    do): the gates of the JAX comparison hold between the two."""
    inp, masks, b16, _, got = results["empty-G1-bf16"]
    assert b16
    tout, tgrads = _as_np(got)
    sout, sgrads = _as_np(_port(inp, masks, True, True))
    _close_fwd(tout, sout)
    _close_grads(tgrads, sgrads)


@pytest.mark.parametrize("saves", [False, True])
def test_seeded_recompute_equals_the_block_fed_the_dump(saves):
    """The seeded block (the TPU's _bwd_ffn_kernel_prng route): the FFN
    recompute draws the h1 and y3 sites from the seed again, so it equals
    the external-mask block fed dump_prng_masks bit for bit."""
    inp = _inputs(8, 0.0, 1, *EMPTY)
    masks, inv = st.dump_prng_masks_plain(SEED, RATE, B, Lv, Lq, D, F, H)
    got = _port(inp, SEED, False, saves, st.fused_sga_block_train_prng,
                rate=RATE)
    want = _port(inp, masks, False, saves, inv_keep=inv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_recompute_counts_no_kernel_on_the_cpu(results):
    before = K.launch_counts()
    inp, masks, _, _, _ = results["rate0.25-G2"]
    _port(inp, masks, False, False)
    assert K.launch_counts() == before


def test_att_saves_without_save_acts_raises():
    inp = _inputs(9, 0.0, 1, *PARTIAL)
    masks = {n: None for n in st.MASK_NAMES}
    with pytest.raises(ValueError, match="att_saves requires save_acts"):
        _port(inp, masks, False, False, att_saves=True, inv_keep=1.0)
    with pytest.raises(ValueError, match="att_saves requires save_acts"):
        _port(inp, SEED, False, False, st.fused_sga_block_train_prng,
              att_saves=True, rate=RATE)
