"""The port's train step (mcan_vqa_tpu_torch/train/{step,optim}.py)
against the JAX package's (mcan_vqa_tpu/train/{step,optim}.py): the loss
and penalties, the learning-rate table, and whole AdamW steps -- with
gradient accumulation and with the global-norm clip -- from the same
parameters and batch.

Tolerances: the loss functions and the schedule agree to f32 rounding
(1e-6 relative). Whole steps on a linear model (f32 on both sides) agree
to 1e-6 in the new parameters. A whole MCAN step runs bf16 products on
both sides, summed in other orders: loss and grad_norm agree within 1e-3;
AdamW's first update is about lr * sign(g), so a parameter whose gradient
is within rounding noise of 0 (the key-projection biases are exactly 0 in
exact arithmetic) may move the other way: elsewhere the new parameters
agree within 1e-6, there within 2 lr.
"""

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.train import optim as joptim
from mcan_vqa_tpu.train import step as jstep
from mcan_vqa_tpu.train.train_state import TrainState as JTrainState
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.train import optim as toptim
from mcan_vqa_tpu_torch.train import step as tstep
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params
from mcan_vqa_tpu_torch.train.fused_engine import make_fused_train_forward
from mcan_vqa_tpu_torch.train.train_state import TrainState


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_losses_and_penalties_match_jax():
    logits, target = _arrays(0, (8, 50), (8, 50))
    target = (target > 0.5).astype(np.float32)
    logits[0, :3] = [80.0, -80.0, 0.0]         # the stable form's edges
    t = tstep.bce_with_logits_sum(torch.from_numpy(logits),
                                  torch.from_numpy(target))
    j = jstep.bce_with_logits_sum(logits, target)
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
    params = _arrays(1, (7, 3), (3,), (4, 4))
    params[0][0, 0] = 1.5                      # both sides of the Huber knee
    tp = [torch.from_numpy(p) for p in params]
    np.testing.assert_allclose(float(tstep.l1_l2_penalty(tp)),
                               float(jstep.l1_l2_penalty(params)), rtol=1e-6)
    np.testing.assert_allclose(float(tstep.smooth_l1_penalty(tp)),
                               float(jstep.smooth_l1_penalty(params)),
                               rtol=1e-6)


@pytest.mark.parametrize("data_size,batch_size,decays", [
    (6400, 64, (8, 12)), (1000, 64, (2, 3)), (10, 64, (1,)),
    (640, 64, ())])
def test_lr_schedule_table_matches_jax(data_size, batch_size, decays):
    t = toptim.make_lr_schedule(1e-4, data_size, batch_size, decays, 0.2)
    j = joptim.make_lr_schedule(1e-4, data_size, batch_size, decays, 0.2)
    spe = max(data_size // batch_size, 1)
    for count in range(0, 14 * spe + 3):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6,
                                   err_msg=f"count {count}")


# ---------------------------------------------------------------------------
# whole steps on a linear model: the same gradients on both sides
# ---------------------------------------------------------------------------

B, IN, OUT = 8, 6, 5


class Linear(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


def _linear_logits(w, b, img):
    return img.reshape(img.shape[0], -1) @ w + b


@pytest.mark.parametrize("accu,clip,reg", [(1, 0.0, 0.0), (2, 0.0, 0.0),
                                           (1, 0.5, 0.0), (2, 0.5, 1e-3)])
def test_linear_steps_match_jax(accu, clip, reg):
    w, b, img, tgt = _arrays(3, (IN, OUT), (OUT,), (B, 2, 3), (B, OUT))
    tgt = (tgt > 0).astype(np.float32)
    ques = np.zeros((B, 4), np.int32)
    cfg = Config(lr_base=1e-2, grad_accu_steps=accu, grad_norm_clip=clip,
                 reg_factor=reg, batch_size=B)
    sched_args = (cfg.lr_base, 4 * B, B, (1,), 0.2)
    # port
    model = Linear(w, b)
    state = TrainState.create(model, toptim.make_optimizer(
        model.parameters(), cfg))
    step = tstep.make_train_step(
        lambda m, i, q, g: _linear_logits(m.w, m.b, i), accu, reg,
        toptim.make_lr_schedule(*sched_args), grad_norm_clip=clip)
    batch = {"img": torch.from_numpy(img), "ques": torch.from_numpy(ques),
             "target": torch.from_numpy(tgt)}
    # JAX
    # the optimizer's own schedule (optax) comes from the config: the same
    # decay epochs as sched_args
    jcfg = JConfig(lr_base=1e-2, grad_accu_steps=accu, grad_norm_clip=clip,
                   reg_factor=reg, batch_size=B, lr_decay_list=[1])
    tx = joptim.make_optimizer(jcfg, 4 * B)
    jstate = JTrainState.create({"w": w, "b": b}, tx, rng_impl="threefry")
    jfn = jax.jit(jstep.make_train_step(
        None, tx, grad_accu_steps=accu, reg_factor=reg,
        lr_schedule=joptim.make_lr_schedule(*sched_args),
        forward_fn=lambda p, i, q, r: _linear_logits(p["w"], p["b"], i),
        grad_norm_clip=clip))
    jbatch = {"img": img, "ques": ques, "target": tgt}
    for _ in range(6):                           # through warmup and decay
        m = step(state, batch)
        jstate, jm = jfn(jstate, jbatch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(model.w.detach().numpy(),
                                   np.asarray(jstate.params["w"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(model.b.detach().numpy(),
                                   np.asarray(jstate.params["b"]),
                                   rtol=1e-6, atol=1e-6)
    assert state.step == int(jstate.step) == 6


def test_batch_must_split_into_micro_batches():
    w, b = _arrays(4, (IN, OUT), (OUT,))
    model = Linear(w, b)
    state = TrainState.create(model, toptim.make_optimizer(
        model.parameters(), Config(batch_size=4)))
    step = tstep.make_train_step(lambda m, i, q, g: i @ m.w + m.b, 3)
    batch = {"img": torch.zeros(4, IN), "ques": torch.zeros(4, 1),
             "target": torch.zeros(4, OUT)}
    with pytest.raises(ValueError, match="micro-batches"):
        step(state, batch)


# ---------------------------------------------------------------------------
# one whole MCAN step at rate 0 against make_train_step over model.apply
# ---------------------------------------------------------------------------

MB, Lv, TOKENS, ANSWERS = 4, 12, 40, 11
ARCH = dict(hidden_size=32, layer=2, multi_head=4, flat_mlp_size=16,
            flat_out_size=32, img_feat_size=24, img_feat_pad_size=Lv)


@pytest.mark.parametrize("accu,clip", [(1, 0.0), (2, 0.0), (1, 1.0)])
def test_mcan_step_matches_jax(accu, clip):
    jcfg = JConfig(**ARCH, use_glove=False, dropout_rate=0.0,
                   grad_accu_steps=accu, grad_norm_clip=clip,
                   batch_size=MB).finalize()
    model = build_mcan(jcfg, token_size=TOKENS, answer_size=ANSWERS)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(MB, Lv, 24)).astype(np.float32)
    img[0, -4:] = 0.0
    ques = rng.integers(1, TOKENS, (MB, jcfg.max_token)).astype(np.int32)
    ques[1, -3:] = 0
    target = (rng.random((MB, ANSWERS)) < 0.2).astype(np.float32)
    params = jax.device_get(model.init({"params": jax.random.PRNGKey(3)},
                                       img, ques)["params"])
    data_size = 4 * MB
    sched = (jcfg.lr_base, data_size, MB, tuple(jcfg.lr_decay_list), 0.2)
    tx = joptim.make_optimizer(jcfg, data_size)
    jstate = JTrainState.create(params, tx, rng_impl="threefry")
    jfn = jax.jit(jstep.make_train_step(
        model, tx, grad_accu_steps=accu,
        lr_schedule=joptim.make_lr_schedule(*sched), grad_norm_clip=clip))
    new_j, jm = jfn(jstate, {"img": img, "ques": ques, "target": target})
    jgrads = jax.grad(lambda p: jstep.bce_with_logits_sum(model.apply(
        {"params": p}, img, ques, deterministic=True)["logits"], target))(
            params)

    cfg = Config(**ARCH, ff_size=128, dropout_rate=0.0,
                 grad_accu_steps=accu, grad_norm_clip=clip, batch_size=MB)
    net = MCANet(cfg, TOKENS, ANSWERS)
    net.load_state_dict(state_dict_from_params(params), strict=True)
    state = TrainState.create(net, toptim.make_optimizer(net.parameters(),
                                                         cfg))
    step = tstep.make_train_step(
        make_fused_train_forward(2, 4, dropout_rate=0.0), accu,
        lr_schedule=toptim.make_lr_schedule(*sched), grad_norm_clip=clip)
    m = step(state, {"img": torch.from_numpy(img),
                     "ques": torch.from_numpy(ques),
                     "target": torch.from_numpy(target)})

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    lr = float(jm["lr"])
    old = state_dict_from_params(params)
    new_t = net.state_dict()
    new_j = state_dict_from_params(jax.device_get(new_j.params))
    gj = {k: v.numpy() for k, v in
          state_dict_from_params(jax.device_get(jgrads)).items()}
    global_max = max(float(np.abs(g_).max()) for g_ in gj.values())
    for name, b_ in new_j.items():
        a_, g_, b_ = new_t[name].numpy(), gj[name], b_.numpy()
        assert not np.array_equal(a_, old[name].numpy()), name
        # gradients clear of rounding noise: above 1% of the largest one
        clear = np.abs(g_) > 1e-2 * global_max
        d = np.abs(a_ - b_)
        assert d[clear].max(initial=0.0) <= 1e-6 + 1e-5 * np.abs(b_).max(), \
            name
        assert d.max() <= 2.05 * lr, name
