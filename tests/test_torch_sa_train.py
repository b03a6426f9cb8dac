"""The port's SA train block (mcan_vqa_tpu_torch/ops/sa_train.py) against
the JAX custom-VJP block ``fused_sa_block_train`` in interpret mode, on the
same numpy inputs and JAX's own dropout masks, unpacked per sample.

On the CPU the port's block runs its kernel sequence with the kernels'
plain versions; the CUDA kernels themselves are held against those on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py).

Tolerances, as tests/test_torch_sga_train.py states them: forward 1e-3
absolute on LayerNorm-scale outputs; gradients 3e-2 of max|ref| per
tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import sa_train as jsa
from mcan_vqa_tpu.ops.sga_train import _flat_pad
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.ops import sa_train as sa

B, L, D, H, F = 4, 6, 32, 4, 64
FWD_TOL, GRAD_TOL = 1e-3, 3e-2


def _inputs(seed, rate, group, lengths, n=B):
    rng = np.random.default_rng(seed)

    def mat(shape, s=0.2):
        return (rng.normal(size=shape) * s).astype(np.float32)

    x = rng.normal(size=(n, L, D)).astype(np.float32)
    mask = (np.arange(L)[None] >= np.asarray(lengths)[:, None])[:, None,
                                                                None]
    w = {"wqkv": mat((D, 3 * D)), "bqkv": mat((3 * D,)),
         "wm": mat((D, D)), "bm": mat((D,)),
         "ln1_s": 1 + mat((D,), 0.05), "ln1_b": mat((D,)),
         "w1": mat((D, F)), "b1": mat((F,)),
         "w2": mat((F, D)), "b2": mat((D,)),
         "ln2_s": 1 + mat((D,), 0.05), "ln2_b": mat((D,))}
    probe = rng.normal(size=(n, L, D)).astype(np.float32)
    masks, inv_keep = jsa.make_sa_dropout_masks(
        jax.random.PRNGKey(seed + 7), rate, n, L, D, F, H, group)
    masks = {k: np.asarray(v) for k, v in masks.items()}
    return x, mask, w, probe, masks, inv_keep


def _unpack(masks, group, n=B):
    """JAX's packed [n//G, ..., G*L, (G*L)] masks -> the port's per-sample
    layout (the diagonal blocks of the attention map)."""
    def take(m, b, square):
        blk, j = m[b // group], b % group
        r = slice(j * L, (j + 1) * L)
        return blk[..., r, r] if square else blk[..., r, :]

    out = {"att": [take(masks["att"], b, True) for b in range(n)]}
    for name in ("y1", "h1", "y2"):
        out[name] = [take(masks[name], b, False) for b in range(n)]
    return {k: torch.from_numpy(np.stack(v)).bool() for k, v in out.items()}


def _jax_block(inp, group, save_acts=True, grads=True):
    """JAX output and gradients of sum(out * probe) w.r.t. x and w."""
    x, mask, w, probe, masks, inv = inp
    f = jsa.make_sa_block_train(H, group, interpret=True, inv_keep=inv,
                                save_acts=save_acts)
    pad = _flat_pad(jnp.asarray(mask), x.shape[0], group, L)

    def block(x, w):
        return f(x, pad, masks, w)

    if not grads:
        return np.asarray(block(x, w)), None
    out, vjp = jax.vjp(block, x, w)
    return np.asarray(out), jax.tree.map(np.asarray, vjp(jnp.asarray(probe)))


def _port_block(inp, masks, save_acts=True, block=sa.fused_sa_block_train):
    x, mask, w, probe, _, inv = inp
    xt = torch.from_numpy(x).requires_grad_()
    wt = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    out = block(xt, torch.from_numpy(mask), masks, wt, num_heads=H,
                inv_keep=inv, save_acts=save_acts)
    (out * torch.from_numpy(probe)).sum().backward()
    return out.detach().numpy(), (xt.grad.numpy(),
                                  {k: t.grad.numpy() for k, t in wt.items()})


def _close_fwd(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL)


def _close_grads(got, want):
    pairs = [("dx", got[0], want[0])]
    pairs += [(k, got[1][k], want[1][k]) for k in want[1]]
    assert len(pairs) == 13
    for name, a, b in pairs:
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg=name)


PARTIAL = [6, 4, 1, 5]         # ragged, no question empty
EMPTY = [6, 0, 3, 6]           # sample 1: an all-PAD question

CASES = {"rate0-sav": (0, 0.0, PARTIAL, True),
         "rate0.25-sav": (1, 0.25, PARTIAL, True),
         "rate0.25-recompute": (1, 0.25, PARTIAL, False),
         "empty-sav": (2, 0.25, EMPTY, True),
         "empty-recompute": (2, 0.25, EMPTY, False)}


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, (seed, rate, lengths, save_acts) in CASES.items():
        inp = _inputs(seed, rate, 1, lengths)
        masks = _unpack(inp[4], 1) if rate > 0 else \
            {n: None for n in sa.SA_MASK_NAMES}
        out[name] = (inp, masks, save_acts, _jax_block(inp, 1, save_acts),
                     _port_block(inp, masks, save_acts))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(results, case):
    _, _, _, (jout, _), (tout, _) = results[case]
    assert tout.shape == (B, L, D) and np.isfinite(tout).all()
    _close_fwd(tout, jout)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(results, case):
    """dx and all 12 weight gradients, save_acts both ways (the JAX
    block's ``_bwd_kernel_sav`` and ``_bwd_kernel``)."""
    _, _, _, (_, jgrads), (_, tgrads) = results[case]
    _close_grads(tgrads, jgrads)


def test_save_acts_changes_no_value(results):
    """The recompute backward gives what the saved-activation one gives."""
    _, _, _, _, (o1, g1) = results["empty-sav"]
    _, _, _, _, (o2, g2) = results["empty-recompute"]
    _close_fwd(o1, o2)
    _close_grads(g1, g2)


@pytest.mark.parametrize("case", ["rate0.25-sav", "empty-recompute"])
def test_kernel_sequence_matches_plain_autograd(results, case):
    """The autograd.Function (forward and hand-written backward) against
    the same block in plain ops differentiated by torch."""
    inp, masks, save_acts, _, (tout, tgrads) = results[case]
    pout, pgrads = _port_block(inp, masks, save_acts,
                               sa.fused_sa_block_train_plain)
    _close_fwd(tout, pout)
    _close_grads(tgrads, pgrads)


def test_all_pad_question_differs_from_jax_at_group_16():
    """The JAX Trainer packs 16 questions per kernel step
    (``encoder_group=16``). Under the collapsed mask an all-PAD question
    (samples 3 and 9) spreads its attention over its 15 neighbours' real
    tokens; the port, per sample, stays uniform over the question's own
    keys -- the JAX group-1 result, which the port matches on every
    sample. Samples with real tokens agree with JAX at either group."""
    n = 16
    lengths = [6, 2, 5, 0, 4, 6, 1, 3, 6, 0, 2, 5, 6, 4, 3, 1]
    inp = _inputs(5, 0.0, 16, lengths, n)
    j16, _ = _jax_block(inp, 16, grads=False)
    inp1 = inp[:4] + (jsa.make_sa_dropout_masks(
        jax.random.PRNGKey(0), 0.0, n, L, D, F, H, 1)[0], 1.0)
    j1, _ = _jax_block(inp1, 1, grads=False)
    x, mask, w, *_ = inp
    with torch.no_grad():
        port = sa.fused_sa_block_train(
            torch.from_numpy(x), torch.from_numpy(mask),
            {k: None for k in sa.SA_MASK_NAMES},
            {k: torch.from_numpy(v) for k, v in w.items()},
            num_heads=H).numpy()
    real = [i for i, n_tok in enumerate(lengths) if n_tok > 0]
    empty = [3, 9]
    _close_fwd(port[real], j16[real])
    for i in empty:
        assert np.abs(port[i] - j16[i]).max() > 100 * FWD_TOL
    _close_fwd(port, j1)


def test_cpu_run_launches_no_kernel(results):
    before = K.launch_counts()
    inp, masks, save_acts, _, _ = results["rate0.25-sav"]
    _port_block(inp, masks, save_acts)
    assert K.launch_counts() == before


def test_params_from_an_sa_module():
    """prepare_sa_train_params lays out an ``SA`` block's parameters as
    the JAX ``prepare_sa_train_params`` does, and gradients reach them."""
    from mcan_vqa_tpu_torch.models.mca import SA
    blk = SA(D, H, F, generator=torch.Generator().manual_seed(0))
    p = dict(blk.named_parameters())
    w = sa.prepare_sa_train_params(p)
    assert set(w) == set(sa.SA_WEIGHT_NAMES)
    qkv = [p[f"mhatt.linear_{n}.weight"].t() for n in "qkv"]
    assert torch.equal(w["wqkv"], torch.cat(qkv, dim=1))
    assert w["w1"].shape == (D, F) and w["w2"].shape == (F, D)
    x = torch.randn(2, L, D)
    mask = torch.zeros(2, 1, 1, L, dtype=torch.bool)
    sa.fused_sa_block_train(x, mask, {k: None for k in sa.SA_MASK_NAMES}, w,
                            num_heads=H).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in blk.parameters())


def test_masks_per_sample_layout_and_rate():
    g = torch.Generator().manual_seed(0)
    masks, inv_keep = sa.make_sa_dropout_masks(g, 0.1, 64, 14, 512, 2048, 8)
    shapes = sa.mask_shapes(64, 14, 512, 2048, 8)
    assert {n: tuple(m.shape) for n, m in masks.items()} == shapes
    assert all(m.dtype == torch.bool for m in masks.values())
    assert inv_keep == pytest.approx(1 / 0.9)
    h1 = masks["h1"].float()
    sd = (0.9 * 0.1 / h1.numel()) ** 0.5
    assert abs(float(h1.mean()) - 0.9) < 6 * sd
    none, one = sa.make_sa_dropout_masks(g, 0.0, 2, 3, 8, 16, 2)
    assert one == 1.0 and all(m is None for m in none.values())
    with pytest.raises(ValueError):
        sa.make_sa_dropout_masks(g, 1.0, 2, 3, 8, 16, 2)
