"""How the port's Trainer chooses and builds its train engine, against the
JAX Trainer: the choice of engine (``use_fused_train`` against JAX's
``_use_fused_train``, trainer.py:540-567, with ``jax.default_backend``
patched as the JAX package's own routing tests patch it), ``dropout_bits``
at the generator-mask sites, and the widths the CUDA kernels now take --
hidden 256 at 8 heads (Dh 32) and 86 image rows (MIMIC "both") -- through
the plain engine, the fused engine (its kernels' plain versions on the CPU)
and the serving forward, against ``model.apply`` on the same weights.

Gradient gate, as tests/test_torch_fused_engine.py's: per tensor, max|a -
b| over max(max|ref|, 1% of the largest gradient anywhere) within 4e-2;
loss 1e-3 relative. Serving: the bf16 engine within 1e-2 and int8 level 1
within 2e-2 of model.apply's sigmoid (PERF.md section 2's bounds).
"""

import types

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.ops import dropout as jdrop
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu.train.step import bce_with_logits_sum as jbce
from mcan_vqa_tpu.train.trainer import Trainer as JTrainer
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops.serving import build_production_engine
from mcan_vqa_tpu_torch.train import fused_engine as fe
from mcan_vqa_tpu_torch.train.step import bce_with_logits_sum
from mcan_vqa_tpu_torch.train.trainer import use_fused_train


# ---------------------------------------------------------------------------
# the choice of engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("engine", ["auto", "fused", "plain"])
@pytest.mark.parametrize("hidden", [64, 256, 512, 1024, 1536])
def test_engine_choice_matches_jax(monkeypatch, hidden, engine, device):
    """The port on a CUDA device decides as the JAX Trainer on a TPU, and
    on the CPU as the JAX Trainer on the CPU."""
    monkeypatch.setattr(jax, "default_backend",
                        lambda: "tpu" if device == "cuda" else "cpu")
    jcfg = types.SimpleNamespace(train_engine=engine, hidden_size=hidden,
                                 mesh_shape=(("data", 1), ("model", 1)),
                                 fused_qkv=False)
    want = JTrainer._use_fused_train(types.SimpleNamespace(cfg=jcfg))
    cfg = Config(hidden_size=hidden, multi_head=8, train_engine=engine)
    assert use_fused_train(cfg, torch.device(device)) == want


def test_config_refuses_unknown_engines_and_bit_widths():
    with pytest.raises(ValueError, match="train_engine"):
        Config(train_engine="xla")
    with pytest.raises(ValueError, match="dropout_bits"):
        Config(dropout_bits=12)
    assert Config().train_engine == "auto" and Config().dropout_bits == 32


def test_trainer_on_the_cpu_takes_the_plain_engine(tmp_path):
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.train.trainer import Trainer, engine_line
    cfg = Config(hidden_size=32, ff_size=128, layer=1, multi_head=4,
                 img_feat_size=16, img_feat_pad_size=8, max_token=6,
                 flat_out_size=32, flat_mlp_size=16, batch_size=4,
                 max_epoch=1, dropout_bits=16, ckpts_dir=str(tmp_path),
                 log_path=str(tmp_path), verbose=False)
    trainer = Trainer(cfg, SyntheticVQADataset(cfg, size=8), device="cpu")
    assert not trainer.fused and not trainer.in_kernel_dropout
    trainer.train()
    log = (tmp_path / f"log_run_{cfg.run_version}.txt").read_text()
    assert engine_line(32, False, False, 16) in log
    assert "dropout_bits=16" in log


# ---------------------------------------------------------------------------
# dropout_bits at the generator-mask sites
# ---------------------------------------------------------------------------

def _tiny_model(hidden=32, heads=4, rows=12):
    cfg = Config(hidden_size=hidden, layer=2, multi_head=heads,
                 ff_size=4 * hidden, img_feat_size=24,
                 img_feat_pad_size=rows, flat_mlp_size=16, flat_out_size=32)
    net = MCANet(cfg, 40, 11, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.normal(size=(3, rows, 24)).astype(np.float32))
    ques = torch.from_numpy(rng.integers(1, 40, (3, 14)))
    return net, img, ques


@pytest.mark.parametrize("bits", [8, 16])
def test_dropout_bits_reach_every_generator_site(monkeypatch, bits):
    """Every mask the engine draws takes ``bits`` bits per element, with
    JAX's threshold, and every site scales by JAX's exact 2^bits / t."""
    rate = 0.1
    _, j_inv = jdrop.random_keep_mask(jax.random.PRNGKey(0), rate, (4,),
                                      bits)
    widths, scales = [], []
    real_keep, real_drop = fe.keep_masks, fe._drop

    def keep_spy(generator, r, shapes, bit_width=32):
        widths.append(bit_width)
        masks, inv = real_keep(generator, r, shapes, bit_width)
        scales.append(inv)
        return masks, inv

    def drop_spy(x, mask, inv_keep):
        scales.append(inv_keep)
        return real_drop(x, mask, inv_keep)

    monkeypatch.setattr(fe, "keep_masks", keep_spy)
    monkeypatch.setattr(fe, "_drop", drop_spy)
    net, img, ques = _tiny_model()
    for sga_block, fused_encoder in (("plain", False), ("fused", True)):
        fwd = fe.make_fused_train_forward(2, 4, dropout_rate=rate,
                                          sga_block=sga_block,
                                          fused_encoder=fused_encoder,
                                          dropout_bits=bits)
        g = torch.Generator().manual_seed(3)
        fwd(net, img, ques, g)
    assert widths and set(widths) == {bits}
    assert scales and set(scales) == {j_inv}
    # the masks are the generator's draws at that width, JAX's threshold
    t = max(1, min((1 << bits) - 1, round((1 - rate) * (1 << bits))))
    g, ref = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    keep, _ = real_keep(g, rate, {"a": (2, 3, 5)}, bits)
    r = torch.randint(0, 1 << bits, (2, 3, 5), generator=ref,
                      dtype=torch.int32)
    assert torch.equal(keep["a"], r < t)


# ---------------------------------------------------------------------------
# hidden 256 at 8 heads (Dh 32) and 86 image rows against model.apply
# ---------------------------------------------------------------------------

WIDE = dict(hidden_size=256, layer=2, multi_head=8, img_feat_size=32,
            img_feat_pad_size=86, flat_mlp_size=32, flat_out_size=64)
Bw, TOKENS, ANSWERS = 2, 30, 11


@pytest.fixture(scope="module")
def wide():
    cfg = Config(**WIDE, ff_size=1024)
    net = MCANet(cfg, TOKENS, ANSWERS,
                 generator=torch.Generator().manual_seed(7))
    rng = np.random.default_rng(8)
    img = np.abs(rng.normal(size=(Bw, 86, 32))).astype(np.float32)
    img[1, 51:] = 0.0
    ques = rng.integers(1, TOKENS, (Bw, 14)).astype(np.int32)
    ques[0, 9:] = 0
    target = (rng.random((Bw, ANSWERS)) < 0.2).astype(np.float32)
    jcfg = JConfig(**WIDE, use_glove=False).finalize()
    model = build_mcan(jcfg, token_size=TOKENS, answer_size=ANSWERS)
    params = import_torch_state_dict(net.state_dict())

    def loss_fn(p):
        logits = model.apply({"params": p}, img, ques,
                             deterministic=True)["logits"]
        return jbce(logits, target), logits

    # one compiled program: op by op, every op compiles on its own
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    from mcan_vqa_tpu_torch.train.checkpoint import state_dict_from_params
    grads = {k: v.numpy() for k, v in
             state_dict_from_params(jax.device_get(grads)).items()}
    probs = 1 / (1 + np.exp(-np.asarray(logits, np.float64)))
    return cfg, net, img, ques, target, float(loss), grads, probs


@pytest.mark.parametrize("sga_block,fused_encoder", [("plain", False),
                                                     ("fused", True)])
def test_train_engines_at_hidden_256_and_86_rows_match_model_apply(
        wide, sga_block, fused_encoder):
    cfg, net, img, ques, target, jloss, jgrads, _ = wide
    fwd = fe.make_fused_train_forward(cfg.layer, cfg.multi_head,
                                      dropout_rate=0.0, sga_block=sga_block,
                                      fused_encoder=fused_encoder)
    net.zero_grad()
    loss = bce_with_logits_sum(fwd(net, torch.from_numpy(img),
                                   torch.from_numpy(ques), None),
                               torch.from_numpy(target))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) / max(1.0, abs(jloss)) < 1e-3
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    assert set(grads) == set(jgrads)
    top = max(float(np.abs(v).max()) for v in jgrads.values())
    for name, a in grads.items():
        b = jgrads[name]
        assert np.isfinite(a).all(), name
        scale = max(1e-2 * top, float(np.abs(b).max()))
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=4e-2,
                                   err_msg=name)


@pytest.mark.parametrize("qffn,bound", [(0, 1e-2), (1, 2e-2)])
def test_serving_at_hidden_256_and_86_rows_matches_model_apply(wide, qffn,
                                                               bound):
    cfg, net, img, ques, _, _, _, ref = wide
    fwd, prep = build_production_engine(net.state_dict(), cfg.layer,
                                        cfg.multi_head, qffn=qffn,
                                        device="cpu")
    with torch.no_grad():
        out = fwd(prep, torch.from_numpy(img), torch.from_numpy(ques))
    probs = torch.sigmoid(out.float()).numpy()
    assert probs.shape == ref.shape and np.isfinite(probs).all()
    assert float(np.abs(probs - ref).max()) <= bound
