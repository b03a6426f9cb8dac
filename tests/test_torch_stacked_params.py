"""The stacked parameter layout (``ops/stacked_params.py``) on the CPU:
its leaves against the JAX package's ``to_stacked`` of the same weights,
the round trips of the weights and of the AdamW state, the Trainer's
stacked steps against its standard ones (the fused engine's kernels in
their plain versions), and the standard checkpoint at the boundary.

Tolerances: at the defaults (no clip, no penalty) the stacked and the
standard runs are held equal bit for bit in every weight and moment: the
gradient of a concatenation is a split of the same tensor, the kernels read
the same operands, AdamW is elementwise. With a gradient clip or the L1 +
L2 penalty the global sums over the leaves run in another order (57 stacked
leaves against 107 standard ones at these sizes), so there the runs are
held to a relative L2 of 1e-6 over every weight and moment."""

import numpy as np
import pytest
import torch

from mcan_vqa_tpu.ops import stacked_params as jsp
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops import stacked_params as sp
from mcan_vqa_tpu_torch.train.trainer import Trainer

TINY = dict(hidden_size=32, ff_size=128, layer=2, multi_head=4,
            img_feat_size=16, img_feat_pad_size=8, max_token=6,
            flat_out_size=32, flat_mlp_size=16, batch_size=4,
            train_engine="fused", eval_engine="plain", word_embed_size=8,
            ckpt_calibrate=False, eval_every_epoch=False, verbose=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (ROADMAP, "Thread oversubscription")."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _net(hidden=64, layers=2, seed=0):
    cfg = Config(hidden_size=hidden, ff_size=4 * hidden, layer=layers,
                 multi_head=4, img_feat_size=16, flat_mlp_size=16,
                 flat_out_size=hidden, word_embed_size=8)
    return MCANet(cfg, 30, 12, generator=torch.Generator().manual_seed(seed))


def _config(tmp_path, tag, **kw):
    return Config(**dict(TINY, ckpts_dir=str(tmp_path / "ckpts"),
                         log_path=str(tmp_path / f"log_{tag}"),
                         version=tag, **kw))


def _trainer(cfg):
    data = SyntheticVQADataset(cfg, size=8, answer_size=12, seed=cfg.seed)
    return Trainer(cfg, data, device="cpu"), data


def _batch(data, n=4, start=0):
    ex = [data.example(i) for i in range(start, start + n)]
    return {"img": torch.tensor(np.stack([e["img"] for e in ex])),
            "ques": torch.tensor(np.stack([e["ques"] for e in ex])),
            "target": torch.tensor(np.stack([e["target"] for e in ex]))}


def _moments(opt, model):
    names = [n for n, _ in model.named_parameters()]
    sd = opt.state_dict()["state"]
    return {(names[int(i)], m): s[m] for i, s in sd.items()
            for m in sp.MOMENTS}


def test_stacked_leaves_equal_jax_to_stacked():
    """Every stack equals JAX's ``to_stacked`` of the same weights; the
    cross k / v are held in Dense's [out, in] orientation, the transpose of
    JAX's [in, out] (the module docstring says why)."""
    net = _net()
    sd = net.state_dict()
    ours = sp.to_stacked(sd)
    jax_tree = jsp.to_stacked(import_torch_state_dict(sd), 2)
    stacks = jax_tree[jsp.STACKED_KEY]
    for side, prefix in (("enc", sp.ENC), ("dec", sp.DEC)):
        assert set(stacks[side]) == {k[len(prefix):] for k in ours
                                     if k.startswith(prefix)}
        for role, want in stacks[side].items():
            got = ours[prefix + role].numpy()
            if side == "dec" and role in sp.CROSS_KV and role[0] == "w":
                got = got.transpose(0, 2, 1)
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"{side}.{role}")
    passed = {k for k in ours if not k.startswith("backbone.")}
    assert passed == {k for k in sd if not k.startswith("backbone.")}


@pytest.mark.parametrize("encoder", [True, False],
                         ids=["encoder-stacked", "encoder-plain"])
def test_weights_round_trip_bit_for_bit(encoder):
    sd = _net().state_dict()
    stacked = sp.to_stacked(sd, encoder)
    assert sp.is_stacked(stacked) and not sp.is_stacked(sd)
    assert any(k.startswith(sp.ENC) for k in stacked) == encoder
    back = sp.from_stacked(stacked)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    for i in range(2):
        views = sp.dec_block({k[len(sp.DEC):]: v for k, v in stacked.items()
                              if k.startswith(sp.DEC)}, i)
        assert torch.equal(views["wk2"],
                           sd[f"backbone.dec_list.{i}.mhatt2.linear_k.weight"])


@pytest.mark.parametrize("mu_dtype", ["", "bfloat16"])
def test_optimizer_state_round_trips_bit_for_bit(tmp_path, mu_dtype):
    """After a step, to_stacked_state then from_stacked_state gives the
    same weights, moments (AdamW's f32, or the bf16 first moment) and
    step count."""
    cfg = _config(tmp_path, "rt", opt_mu_dtype=mu_dtype)
    trainer, data = _trainer(cfg)
    trainer.step_fn(trainer.state, _batch(data))
    weights = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    moments = {k: v.clone() for k, v in _moments(
        trainer.state.optimizer, trainer.model).items()}
    st = trainer.stacked_state()
    assert isinstance(st.model, sp.StackedMCANet)
    assert st.step == 1 and len(list(st.model.parameters())) < len(weights)
    # the backbone's standard leaves are stale until the sync (the other
    # modules are shared)
    for name, p in trainer.model.named_parameters():
        if name.startswith("backbone."):
            p.data.zero_()
    back = trainer.sync_state(st)
    assert back is trainer.state and back.step == 1
    for k, v in weights.items():
        assert torch.equal(trainer.model.state_dict()[k], v), k
    got = _moments(back.optimizer, trainer.model)
    assert set(got) == set(moments)
    for k, v in moments.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _run(tmp_path, tag, stacked, steps=2, **kw):
    cfg = _config(tmp_path, tag, stacked_params="on" if stacked else "off",
                  **kw)
    trainer, data = _trainer(cfg)
    st = trainer.stacked_state() if stacked else trainer.state
    for i in range(steps):
        trainer.step_fn(st, _batch(data, start=4 * (i % 2)))
    trainer.sync_state(st)
    return trainer


# hidden 640 (5 heads of 128): past 512 the Trainer's route trains the
# encoder in plain ops (its leaves stay standard) and the decoder with
# att_saves / bf16_saves
WIDE = dict(hidden_size=640, ff_size=2560, multi_head=5, layer=1)


@pytest.mark.parametrize("knobs", [{}, dict(grad_norm_clip=0.05,
                                            reg_factor=1e-3), WIDE],
                         ids=["defaults", "clip-and-penalty",
                              "hidden-640-encoder-plain"])
def test_stacked_steps_equal_standard_steps(tmp_path, knobs):
    """Two steps on the fused engine from the same weights and seed: every
    weight and moment bit for bit at the defaults (at hidden 32 and 640);
    relative L2 <= 1e-6 over all of them with the clip and the penalty
    (see the docstring)."""
    std = _run(tmp_path, "std", False, **knobs)
    stk = _run(tmp_path, "stk", True, **knobs)
    assert stk.stacked and not std.stacked
    assert stk.stacked_state().model.encoder_stacked == (
        knobs.get("hidden_size", 32) <= 512)
    knobs = {} if knobs is WIDE else knobs
    pairs = [(k, v, stk.model.state_dict()[k])
             for k, v in std.model.state_dict().items()]
    m_std = _moments(std.state.optimizer, std.model)
    m_stk = _moments(stk.state.optimizer, stk.model)
    pairs += [(k, v, m_stk[k]) for k, v in m_std.items()]
    assert std.state.step == stk.state.step == 2
    if not knobs:
        for k, a, b in pairs:
            assert torch.equal(a, b), k
        return
    num = sum(float((a.double() - b.double()).square().sum())
              for _, a, b in pairs)
    den = sum(float(a.double().square().sum()) for _, a, _ in pairs)
    assert (num / den) ** 0.5 <= 1e-6


def test_stacked_trainer_checkpoint_resumes_standard(tmp_path):
    """A Trainer with stacked_params="on" trains an epoch and writes the
    standard pickle; a standard Trainer resumes it with the same weights,
    moments and step; the log says the layout was on."""
    cfg = _config(tmp_path, "ckpt", stacked_params="on", max_epoch=1)
    trainer, _ = _trainer(cfg)
    state = trainer.train()
    assert state is trainer.state and not isinstance(state.model,
                                                     sp.StackedMCANet)
    log = (tmp_path / "log_ckpt" / "log_run_ckpt.txt").read_text()
    assert "stacked_params: on" in log
    resumed_cfg = _config(tmp_path, "ckpt", stacked_params="off",
                          resume=True, ckpt_epoch=1, max_epoch=1)
    resumed, _ = _trainer(resumed_cfg)
    rstate = resumed.ensure_state()
    assert rstate.step == state.step == 2
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    want = _moments(state.optimizer, trainer.model)
    got = _moments(rstate.optimizer, resumed.model)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("engine", ["plain", "classify"])
def test_on_is_ignored_off_the_fused_vqa_engine(tmp_path, engine):
    kw = dict(train_engine="plain") if engine == "plain" else {}
    cfg = _config(tmp_path, engine, stacked_params=True, max_epoch=1, **kw)
    if engine == "classify":
        from mcan_vqa_tpu_torch.data.mimic import SyntheticMIMICDataset
        data = SyntheticMIMICDataset(cfg, size=8, answer_size=5, seed=0)
        trainer = Trainer(cfg, data, task="classify", device="cpu")
    else:
        trainer, _ = _trainer(cfg)
    assert trainer.stacked_requested and not trainer.stacked
    trainer.train()
    log = (tmp_path / f"log_{engine}" / f"log_run_{engine}.txt").read_text()
    assert "stacked_params='on' ignored" in log


@pytest.mark.parametrize("value", ["auto", "on", "off", True, False])
def test_config_takes_the_three_words_and_bools(value):
    assert Config(stacked_params=value).stacked_params == value


def test_config_refuses_other_values():
    with pytest.raises(ValueError, match="stacked_params"):
        Config(stacked_params="yes")
