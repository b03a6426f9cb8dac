"""The Trainer's optimizer and logging knobs in the port
(mcan_vqa_tpu_torch/train/{optim,step}.py, utils/profiling.py, configs.py)
against the JAX package's (mcan_vqa_tpu/train/{optim,step}.py,
configs/config.py): ``opt_betas`` / ``opt_eps`` / ``weight_decay`` and
``opt_mu_dtype="bfloat16"`` against optax ``adamw`` on the linear harness
of tests/test_torch_train_step.py, ``opt_mu_dtype=""`` bit for bit with
``torch.optim.AdamW``, ``param_grad_norms`` against JAX's
``per_param_norms``, and ``trace``.

Tolerances: f32 steps on both sides agree to 1e-6 in the parameters (the
two optimizers order their f32 arithmetic differently); the bf16 first
moment is the same bf16 value on both sides; the per-parameter norms agree
to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.train import optim as joptim
from mcan_vqa_tpu.train import step as jstep
from mcan_vqa_tpu.train.train_state import TrainState as JTrainState
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.train import optim as toptim
from mcan_vqa_tpu_torch.train import step as tstep
from mcan_vqa_tpu_torch.train.train_state import TrainState
from mcan_vqa_tpu_torch.utils.profiling import StepTimer, trace

B, IN, OUT = 8, 6, 5


class Linear(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


def _logits(w, b, img):
    return img.reshape(img.shape[0], -1) @ w + b


def _data(seed=3):
    rng = np.random.default_rng(seed)
    w, b, img, tgt = (rng.normal(size=s).astype(np.float32) for s in
                      ((IN, OUT), (OUT,), (B, 2, 3), (B, OUT)))
    return w, b, img, (tgt > 0).astype(np.float32)


def _adam_state(opt_state):
    """The ScaleByAdamState inside an optax chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for x in opt_state:
            found = _adam_state(x)
            if found is not None:
                return found
    return None


def _run_both(knobs, steps, accu=1, clip=0.0, per_param_norms=False):
    """``steps`` steps of the port and of JAX on the linear harness with
    the optimizer knobs ``knobs`` -> (port state, JAX state, port metrics,
    JAX metrics), the last step's."""
    w, b, img, tgt = _data()
    ques = np.zeros((B, 4), np.int32)
    cfg = Config(lr_base=1e-2, batch_size=B, grad_accu_steps=accu,
                 grad_norm_clip=clip, **knobs)
    sched = (cfg.lr_base, 4 * B, B, (1,), 0.2)
    model = Linear(w, b)
    state = TrainState.create(model, toptim.make_optimizer(
        model.parameters(), cfg))
    step = tstep.make_train_step(
        lambda m, i, q, g: _logits(m.w, m.b, i), accu,
        lr_schedule=toptim.make_lr_schedule(*sched), grad_norm_clip=clip,
        per_param_norms=per_param_norms)
    jcfg = JConfig(lr_base=1e-2, batch_size=B, grad_accu_steps=accu,
                   grad_norm_clip=clip, lr_decay_list=[1], **knobs)
    tx = joptim.make_optimizer(jcfg, 4 * B)
    jstate = JTrainState.create({"w": w, "b": b}, tx, rng_impl="threefry")
    jfn = jax.jit(jstep.make_train_step(
        None, tx, grad_accu_steps=accu,
        lr_schedule=joptim.make_lr_schedule(*sched),
        forward_fn=lambda p, i, q, r: _logits(p["w"], p["b"], i),
        per_param_norms=per_param_norms, grad_norm_clip=clip))
    batch = {"img": torch.from_numpy(img), "ques": torch.from_numpy(ques),
             "target": torch.from_numpy(tgt)}
    for _ in range(steps):
        m = step(state, batch)
        jstate, jm = jfn(jstate, {"img": img, "ques": ques, "target": tgt})
        for name in ("w", "b"):
            np.testing.assert_allclose(
                getattr(model, name).detach().numpy(),
                np.asarray(jstate.params[name]), rtol=1e-6, atol=1e-6,
                err_msg=name)
    assert state.step == int(jstate.step) == steps
    return state, jstate, m, jm


@pytest.mark.parametrize("knobs", [
    dict(opt_betas=(0.8, 0.99)), dict(opt_eps=1e-3),
    dict(weight_decay=0.05),
    dict(opt_betas=(0.5, 0.9), opt_eps=1e-6, weight_decay=0.0)],
    ids=["betas", "eps", "weight_decay", "all"])
def test_optimizer_knobs_match_optax(knobs):
    state, jstate, _, _ = _run_both(knobs, steps=6)
    group = state.optimizer.param_groups[0]
    assert isinstance(state.optimizer, torch.optim.AdamW)
    cfg = Config(**knobs)
    assert (group["betas"], group["eps"], group["weight_decay"]) == \
        (tuple(cfg.opt_betas), cfg.opt_eps, cfg.weight_decay)


def test_bf16_first_moment_matches_optax_mu_dtype():
    """``opt_mu_dtype="bfloat16"`` against ``adamw(mu_dtype=bfloat16)``
    over 3 steps of the linear harness, optax fed the port's gradients
    (autograd's and JAX's differ in their last bits, and a bf16 moment
    turns such a difference into a whole bf16 unit): the parameters to
    1e-6, the bf16 first moments equal, the f32 second moments to f32
    rounding, and the state laid out as torch AdamW's."""
    w, b, img, tgt = _data()
    cfg = Config(lr_base=1e-2, batch_size=B, opt_mu_dtype="bfloat16")
    sched = (cfg.lr_base, 4 * B, B, (1,), 0.2)
    model = Linear(w, b)
    state = TrainState.create(model, toptim.make_optimizer(
        model.parameters(), cfg))
    opt = state.optimizer
    assert isinstance(opt, toptim.AdamWMuBF16)
    step = tstep.make_train_step(lambda m, i, q, g: _logits(m.w, m.b, i),
                                 lr_schedule=toptim.make_lr_schedule(*sched))
    batch = {"img": torch.from_numpy(img),
             "ques": torch.zeros(B, 4, dtype=torch.int32),
             "target": torch.from_numpy(tgt)}
    tx = joptim.make_optimizer(JConfig(lr_base=1e-2, batch_size=B,
                                       lr_decay_list=[1],
                                       opt_mu_dtype="bfloat16"), 4 * B)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    opt_state = tx.init(params)
    for t in range(3):
        step(state, batch)
        grads = {n: jnp.asarray(getattr(model, n).grad.numpy())
                 for n in ("w", "b")}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        adam = _adam_state(opt_state)
        assert adam.mu["w"].dtype == jnp.bfloat16
        for name in ("w", "b"):
            p = getattr(model, name)
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[name]), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            s = opt.state[p]
            assert s["exp_avg"].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                s["exp_avg"].float().numpy(),
                np.asarray(adam.mu[name].astype(jnp.float32)),
                err_msg=f"step {t} {name}")
            np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                       np.asarray(adam.nu[name]), rtol=1e-6)
            assert float(s["step"]) == t + 1 == int(adam.count)
    sd = opt.state_dict()
    assert set(sd["state"]) == {0, 1} and len(sd["param_groups"]) == 1
    assert set(sd["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}


def test_default_mu_dtype_is_torch_adamw_bit_for_bit():
    """``opt_mu_dtype=""`` builds torch's AdamW with the reference's
    hyperparameters: the same bits as one built by hand."""
    w, b, _, _ = _data()
    cfg = Config(lr_base=1e-3)
    mine, ref = Linear(w, b), Linear(w, b)
    opt = toptim.make_optimizer(mine.parameters(), cfg)
    assert type(opt) is torch.optim.AdamW
    hand = torch.optim.AdamW(ref.parameters(), lr=1e-3, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
    g = torch.Generator().manual_seed(0)
    for _ in range(4):
        grads = [torch.randn(p.shape, generator=g) for p in mine.parameters()]
        for model, o in ((mine, opt), (ref, hand)):
            for p, gr in zip(model.parameters(), grads):
                p.grad = gr.clone()
            o.step()
    for p, q in zip(mine.parameters(), ref.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(mine.parameters(), ref.parameters()):
        for m in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][m], hand.state[q][m])


@pytest.mark.parametrize("accu,clip", [(1, 0.0), (2, 0.0), (1, 0.5),
                                       (2, 0.5)])
def test_param_grad_norms_match_jax(accu, clip):
    """``param_grad_norms``: each gradient's norm x the clip's scale x
    grad_accu_steps, keyed by the parameter's name, as JAX's
    ``per_param_norms``."""
    _, _, m, jm = _run_both({}, steps=2, accu=accu, clip=clip,
                            per_param_norms=True)
    norms = m["param_grad_norms"]
    assert list(norms) == ["w", "b"]
    for name, v in norms.items():
        np.testing.assert_allclose(float(v),
                                   float(jm["param_grad_norms"][name]),
                                   rtol=1e-6, err_msg=name)


def test_trace_writes_a_chrome_trace_only_with_a_directory(tmp_path):
    out = tmp_path / "prof"
    with trace(str(out)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(out.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in files[0].read_text()
    before = sorted(tmp_path.rglob("*"))
    with trace(""):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert sorted(tmp_path.rglob("*")) == before
    timer = StepTimer(alpha=0.5)
    assert timer.tick() is None and timer.tick() >= 0.0


def test_config_knobs_default_as_jax_and_are_validated():
    """The new fields keep the JAX Config's names and defaults, and bad
    values are refused."""
    mine, theirs = Config(), JConfig()
    for name in ("resume", "keep_last_ckpts", "ckpt_async", "ckpt_calibrate",
                 "opt_eps", "weight_decay", "opt_mu_dtype",
                 "grad_norm_log_every", "profile_dir"):
        assert getattr(mine, name) == getattr(theirs, name), name
    assert tuple(mine.opt_betas) == tuple(theirs.opt_betas)
    for bad in (dict(opt_mu_dtype="float16"), dict(opt_betas=(0.9,)),
                dict(opt_betas=(0.9, 1.0)), dict(opt_eps=-1.0),
                dict(weight_decay=-1e-4), dict(keep_last_ckpts=-1),
                dict(grad_norm_log_every=-2)):
        with pytest.raises(ValueError):
            Config(**bad)
