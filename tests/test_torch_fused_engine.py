"""The port's training forward (mcan_vqa_tpu_torch/train/fused_engine.py)
against the JAX engine in interpret mode and against JAX ``model.apply``:
the loss and the gradient of every parameter, from the same weights
(``state_dict_from_params``) and numpy inputs, with dropout off -- with
the encoder plain and through the SA train blocks (``fused_encoder``), and
with the decoder's ``att_saves`` / ``bf16_saves``. With dropout on, every
engine of the port draws the same masks from the same generator state.

Gradient gate (tests/test_fused_engine.py's): per tensor, max|a - b|
over max(max|ref|, 1% of the largest gradient anywhere) within 4e-2 --
the floor because some bias gradients are zero in exact arithmetic and
only rounding noise on both sides. Loss: 1e-3 relative.
"""

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.train.fused_engine import \
    make_fused_train_forward as jmake_forward
from mcan_vqa_tpu.train.step import bce_with_logits_sum as jbce
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops import kernels as K
from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params
from mcan_vqa_tpu_torch.train.fused_engine import make_fused_train_forward
from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum

B, Lv, TOKENS, ANSWERS = 4, 12, 40, 11
ARCH = dict(hidden_size=32, layer=2, multi_head=4, flat_mlp_size=16,
            flat_out_size=32, img_feat_size=24, img_feat_pad_size=Lv)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig(**ARCH, use_glove=False).finalize()
    model = build_mcan(jcfg, token_size=TOKENS, answer_size=ANSWERS)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, Lv, 24)).astype(np.float32)
    img[0, -4:] = 0.0
    img[2] = 0.0                                 # no regions at all
    ques = rng.integers(1, TOKENS, (B, jcfg.max_token)).astype(np.int32)
    ques[1, -3:] = 0
    ques[3] = 0                                  # an all-PAD question
    target = (rng.random((B, ANSWERS)) < 0.2).astype(np.float32)
    params = jax.device_get(model.init({"params": jax.random.PRNGKey(3)},
                                       img, ques)["params"])
    cfg = Config(**ARCH, ff_size=4 * 32)
    net = MCANet(cfg, TOKENS, ANSWERS)
    net.load_state_dict(state_dict_from_params(params), strict=True)
    return jcfg, model, params, net, img, ques, target


@pytest.fixture(scope="module")
def setup_real_questions(setup):
    """The same model and batch, question 3 given real tokens: with an
    all-PAD question the train blocks' additive pad mask and model.apply's
    replaced scores differ in the score gradient (see
    test_fused_encoder_follows_the_jax_engine_on_an_all_pad_question)."""
    jcfg, model, params, net, img, ques, target = setup
    ques = ques.copy()
    ques[3] = np.arange(1, jcfg.max_token + 1) % TOKENS
    return jcfg, model, params, net, img, ques, target


def _jax_loss_grads(loss_fn, params):
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: v.numpy() for k, v in
                         state_dict_from_params(jax.device_get(grads)).items()}


@pytest.fixture(scope="module")
def jax_engine(setup):
    jcfg, _, params, _, img, ques, target = setup
    # group 1: with a fully padded sample in a packing group of 2 the JAX
    # kernel's collapsed cross mask leaks its neighbour's keys
    # (tests/test_torch_sga_train.py pins that); the port computes
    # attention per sample, which is the JAX engine at group 1
    fwd = jmake_forward(jcfg.layer, jcfg.multi_head, dropout_rate=0.0,
                        group=1, interpret=True, fused_encoder=False)
    return _jax_loss_grads(lambda p: jbce(fwd(p, img, ques,
                                              jax.random.PRNGKey(9)),
                                          target), params)


@pytest.fixture(scope="module")
def jax_engine_fused_encoder(setup):
    jcfg, _, params, _, img, ques, target = setup
    # group / encoder_group 1: the port's per-sample attention (the JAX
    # packing leaks a fully padded sample's attention, see
    # tests/test_torch_sa_train.py)
    fwd = jmake_forward(jcfg.layer, jcfg.multi_head, dropout_rate=0.0,
                        group=1, interpret=True, fused_encoder=True,
                        encoder_group=1)
    return _jax_loss_grads(lambda p: jbce(fwd(p, img, ques,
                                              jax.random.PRNGKey(9)),
                                          target), params)


def _model_apply_loss_grads(setup):
    _, model, params, _, img, ques, target = setup
    return _jax_loss_grads(lambda p: jbce(model.apply(
        {"params": p}, img, ques, deterministic=True)["logits"], target),
        params)


@pytest.fixture(scope="module")
def jax_model(setup):
    return _model_apply_loss_grads(setup)


@pytest.fixture(scope="module")
def jax_model_real_questions(setup_real_questions):
    return _model_apply_loss_grads(setup_real_questions)


def _port_loss_grads(setup, sga_block="fused", rate=0.0, seed=0, **kw):
    _, _, _, net, img, ques, target = setup
    fwd = make_fused_train_forward(2, 4, dropout_rate=rate,
                                   sga_block=sga_block, **kw)
    net.zero_grad()
    logits = fwd(net, torch.from_numpy(img), torch.from_numpy(ques),
                 torch.Generator().manual_seed(seed))
    loss = bce_with_logits_sum(logits, torch.from_numpy(target))
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone().numpy()
                         for k, p in net.named_parameters()}


def _close(got, want):
    (lg, gg), (lw, gw) = got, want
    assert abs(lg - lw) / max(1.0, abs(lw)) < 1e-3
    assert set(gg) == set(gw)
    global_max = max(float(np.abs(v).max()) for v in gw.values())
    for name, a in gg.items():
        b = gw[name]
        assert np.isfinite(a).all(), name
        scale = max(1e-2 * global_max, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=4e-2,
                                   err_msg=name)


def test_logits_match_the_jax_engine_and_model_apply(setup):
    """Logits within 1e-2 of the largest |logit| (bf16 products summed in
    another order through 2 + 2 blocks and the head)."""
    jcfg, model, params, net, img, ques, _ = setup
    jfwd = jmake_forward(jcfg.layer, jcfg.multi_head, dropout_rate=0.0,
                         group=1, interpret=True, fused_encoder=False)
    engine = np.asarray(jfwd(params, img, ques, jax.random.PRNGKey(9)))
    apply = np.asarray(model.apply({"params": params}, img, ques,
                                   deterministic=True)["logits"])
    with torch.no_grad():
        port = make_fused_train_forward(2, 4, dropout_rate=0.0)(
            net, torch.from_numpy(img), torch.from_numpy(ques), None).numpy()
    assert port.shape == (B, ANSWERS) and np.isfinite(port).all()
    for ref in (engine, apply):
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=1e-2 * np.abs(ref).max())


def test_loss_and_every_gradient_match_the_jax_engine(setup, jax_engine):
    _close(_port_loss_grads(setup), jax_engine)


def test_loss_and_every_gradient_match_jax_model_apply(setup, jax_model):
    _close(_port_loss_grads(setup), jax_model)


def test_plain_block_engine_matches_jax_model_apply(setup, jax_model):
    _close(_port_loss_grads(setup, "plain"), jax_model)


def test_fused_and_plain_engines_draw_the_same_masks(setup):
    """At rate 0.2 from one generator state the two engines see the same
    masks: on the CPU the kernel sequence and the plain block compute the
    same forward, so the losses agree to f32 rounding."""
    fused = _port_loss_grads(setup, "fused", rate=0.2, seed=5)
    plain = _port_loss_grads(setup, "plain", rate=0.2, seed=5)
    other = _port_loss_grads(setup, "fused", rate=0.2, seed=6)
    _close(fused, plain)
    assert fused[0] != other[0]
    assert abs(fused[0] - plain[0]) <= 1e-5 * abs(plain[0])


def test_cpu_engine_launches_no_kernel(setup):
    before = K.launch_counts()
    _port_loss_grads(setup, rate=0.1)
    assert K.launch_counts() == before


def test_fused_encoder_matches_the_jax_engine(setup,
                                              jax_engine_fused_encoder):
    _close(_port_loss_grads(setup, fused_encoder=True),
           jax_engine_fused_encoder)


def test_fused_encoder_matches_jax_model_apply(setup_real_questions,
                                               jax_model_real_questions):
    _close(_port_loss_grads(setup_real_questions, fused_encoder=True),
           jax_model_real_questions)


def test_plain_blocks_with_fused_encoder_match_jax_model_apply(
        setup_real_questions, jax_model_real_questions):
    _close(_port_loss_grads(setup_real_questions, "plain",
                            fused_encoder=True), jax_model_real_questions)


def test_fused_encoder_follows_the_jax_engine_on_an_all_pad_question(
        setup, jax_engine_fused_encoder, jax_model):
    """Question 3 is all PAD. The JAX SA train kernel adds the pad mask to
    the scores, so that row's score gradient is the softmax's (nonzero);
    model.apply replaces the scores, so it is 0 there. The second encoder
    layer's q / k projection gradients then differ by several % of their
    scale between the JAX fused engine and model.apply; the port follows
    the JAX engine."""
    port = _port_loss_grads(setup, fused_encoder=True)
    _close(port, jax_engine_fused_encoder)
    name = "backbone.enc_list.1.mhatt.linear_k.weight"
    a, b = jax_engine_fused_encoder[1][name], jax_model[1][name]
    assert np.abs(a - b).max() > 4e-2 * np.abs(b).max()
    np.testing.assert_allclose(port[1][name], a, rtol=0,
                               atol=4e-2 * np.abs(a).max())


def test_att_saves_and_bf16_saves_match_jax_model_apply(setup, jax_model):
    """The MCAN-large decoder route on the tiny model: the saves move
    where the backward reads from and round r1 / r2 / r3 / gv2 to bf16."""
    _close(_port_loss_grads(setup, att_saves=True, bf16_saves=True),
           jax_model)


def test_every_encoder_route_draws_the_same_masks(setup):
    """At rate 0.2 from one generator state, the fused encoder (kernel
    sequence and plain block) and the plain encoder read the same four
    masks per layer (``SA_MASK_NAMES``): their losses agree to the
    LayerNorm's rounding (reciprocal multiply vs division). (The plain
    encoder's gradients differ at the all-PAD question, as model.apply's
    do: test_fused_encoder_follows_the_jax_engine_on_an_all_pad_question.)
    """
    fused = _port_loss_grads(setup, rate=0.2, seed=5, fused_encoder=True)
    plain = _port_loss_grads(setup, "plain", rate=0.2, seed=5,
                             fused_encoder=True)
    enc_plain = _port_loss_grads(setup, rate=0.2, seed=5)
    other = _port_loss_grads(setup, rate=0.2, seed=6, fused_encoder=True)
    _close(fused, plain)
    assert abs(fused[0] - plain[0]) <= 1e-5 * abs(plain[0])
    assert abs(fused[0] - enc_plain[0]) <= 1e-4 * abs(enc_plain[0])
    assert fused[0] != other[0]


def test_unknown_block_raises():
    with pytest.raises(ValueError):
        make_fused_train_forward(2, 4, sga_block="other")
