"""The visualization port (``utils/visualize.py``, ``MCANet.
forward_outputs``, ``run_vqa --run visualize``) against the JAX package on
the CPU.

Tolerances: ``calc_mats`` / ``calc_mats_v2`` are numpy on both sides and
equal bit for bit on the same dictionary. ``forward_outputs`` against
``model.apply`` at hidden 64, 2 layers, with f32 matmul operands on both
sides (``operand_dtype(torch.float32)``, JAX's compute_dtype="float32"):
every float key within 1e-4 (rtol and atol; only the summation order
differs), the masks exactly. With bf16 operands on both sides a rounding
one step apart in some block moves a logit by ~1e-3, so there the logits
are held within 1e-2 and their argmax exactly. Its "logits" equal
``forward``'s bit for bit (one code path)."""

import os

import jax
import numpy as np
import pytest
import torch

from mcan_vqa_tpu.configs import Config as JaxConfig
from mcan_vqa_tpu.models.net import build_mcan
from mcan_vqa_tpu.train.checkpoint import import_torch_state_dict
from mcan_vqa_tpu.utils import visualize as jvis
from mcan_vqa_tpu_torch.cli import run_vqa
from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.vqa_dataset import VQADataset
from mcan_vqa_tpu_torch.data.vqa_files import write_vqa_files
from mcan_vqa_tpu_torch.models.layers import operand_dtype
from mcan_vqa_tpu_torch.models.net import ClassifierNet, MCANet
from mcan_vqa_tpu_torch.train.checkpoint import save_checkpoint
from mcan_vqa_tpu_torch.train.trainer import Trainer
from mcan_vqa_tpu_torch.utils import visualize as vis

DIMS = dict(hidden_size=64, layer=2, multi_head=4, img_feat_size=32,
            img_feat_pad_size=12, max_token=7, flat_out_size=48,
            flat_mlp_size=24)
TOKENS, ANSWERS, B = 50, 20, 5
KEYS = ("logits", "v", "v_mask", "v_w", "q", "q_mask", "q_w", "fused")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (ROADMAP, "Thread oversubscription")."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, 12, 32)).astype(np.float32)
    img[0, 8:] = 0.0
    img[3, 2:] = 0.0
    ques = rng.integers(1, TOKENS, size=(B, 7)).astype(np.int32)
    ques[1, 4:] = 0
    ques[4, 1:] = 0
    return img, ques


@pytest.fixture(scope="module")
def outputs():
    """The port's forward_outputs and JAX's model.apply dictionary on the
    same weights (a seeded port MCANet, carried across by
    import_torch_state_dict) and inputs, with f32 and with bf16 operands:
    {operands: (ours, ref)}, and the port's bf16 ``forward`` logits."""
    cfg = Config(ff_size=4 * DIMS["hidden_size"], word_embed_size=300,
                 **DIMS)
    net = MCANet(cfg, TOKENS, ANSWERS,
                 generator=torch.Generator().manual_seed(0))
    img, ques = _inputs()
    params = import_torch_state_dict(net.state_dict())
    got = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with torch.no_grad(), operand_dtype(dtype):
            ours = net.forward_outputs(torch.from_numpy(img),
                                       torch.from_numpy(ques))
        model = build_mcan(JaxConfig(
            use_glove=False, compute_dtype="float32" if name == "f32"
            else "bfloat16", **DIMS).finalize(),
            token_size=TOKENS, answer_size=ANSWERS)
        ref = jax.jit(lambda p, i, q: model.apply({"params": p}, i, q))(
            params, img, ques)
        got[name] = ({k: v.numpy() for k, v in ours.items()},
                     {k: np.asarray(v) for k, v in ref.items()})
    with torch.no_grad():
        got["forward"] = net(torch.from_numpy(img),
                             torch.from_numpy(ques)).numpy()
    return got


def test_forward_outputs_match_model_apply(outputs):
    ours, ref = outputs["f32"]
    assert set(ours) == set(ref) == set(KEYS)
    for k in KEYS:
        assert ours[k].shape == ref[k].shape, k
        if ref[k].dtype == bool:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(ours[k], np.float32(ref[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_forward_outputs_bf16_logits_match_model_apply(outputs):
    ours, ref = outputs["bf16"]
    np.testing.assert_allclose(ours["logits"], np.float32(ref["logits"]),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(ours["logits"].argmax(-1),
                                  ref["logits"].argmax(-1))


def test_forward_outputs_logits_are_forward_bit_for_bit(outputs):
    np.testing.assert_array_equal(outputs["bf16"][0]["logits"],
                                  outputs["forward"])


def test_classifier_forward_outputs():
    cfg = Config(ff_size=256, **DIMS)
    net = ClassifierNet(cfg, 7, generator=torch.Generator().manual_seed(1))
    img = torch.from_numpy(_inputs()[0])
    with torch.no_grad():
        out = net.forward_outputs(img)
        logits = net(img)
    assert set(out) == {"logits", "v", "v_mask", "v_w", "fused"}
    assert torch.equal(out["logits"], logits)
    assert out["v_w"].shape == (B, 12, 1)
    torch.testing.assert_close(out["v_w"].sum(1), torch.ones(B, 1))


def _seeded_out(n=3, T=6, R=9, D=8, F=8, G=2, seed=3):
    rng = np.random.default_rng(seed)
    q_mask = np.zeros((n, 1, 1, T), bool)
    v_mask = np.zeros((n, 1, 1, R), bool)
    q_mask[0, 0, 0, 4:] = True
    v_mask[1, 0, 0, 3:] = True           # 3 regions: top-7 clamps to 3
    return {"q": rng.normal(size=(n, T, D)).astype(np.float32),
            "v": rng.normal(size=(n, R, D)).astype(np.float32),
            "q_w": rng.random((n, T, G)).astype(np.float32),
            "v_w": rng.random((n, R, G)).astype(np.float32),
            "q_mask": q_mask, "v_mask": v_mask,
            "fused": rng.normal(size=(n, F)).astype(np.float32),
            "logits": rng.normal(size=(n, 5)).astype(np.float32)}


@pytest.mark.parametrize("index", [0, 1, 2])
@pytest.mark.parametrize("recipe", ["calc_mats", "calc_mats_v2"])
def test_score_matrices_equal_jax(recipe, index):
    out = _seeded_out()
    got = getattr(vis, recipe)(out, index)
    want = getattr(jvis, recipe)(out, index)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if index == 1:
        assert len(got["va_indices"]) == 3     # top-k clamped to 3 regions
    if recipe == "calc_mats_v2":
        g1 = vis.calc_mats_v2(out, index, top_k=2, glimpse=1)
        w1 = jvis.calc_mats_v2(out, index, top_k=2, glimpse=1)
        for k in w1:
            np.testing.assert_array_equal(g1[k], w1[k], err_msg=k)


def test_calc_mats_needs_flat_out_equal_to_hidden():
    out = _seeded_out(F=5)
    for mod in (vis, jvis):
        with pytest.raises(ValueError, match="flat_out_size == hidden_size"):
            mod.calc_mats(out, 0)


def test_renderers_write_pngs(tmp_path):
    out = _seeded_out()
    boxes = np.random.default_rng(0).uniform(0, 1, (9, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    paths = [vis.visualize_example(out, 0, str(tmp_path / "a.png"),
                                   question_tokens=list("abcdef"),
                                   answer="yes", bboxes=boxes),
             vis.render_reference_panels(out, 1, str(tmp_path / "b.png"),
                                         preds=["yes"], answers=["no"],
                                         bboxes=boxes),
             vis.render_reference_panels(out, 2, str(tmp_path / "c.png"),
                                         mats="v1")]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_renderers_name_matplotlib_when_missing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        vis.visualize_example(_seeded_out(), 0, "unused.png")


def test_run_vqa_visualize_from_a_checkpoint(tmp_path, capsys):
    """run_vqa --run visualize --device cpu on the miniature val set (6
    images, 12 questions) from an epoch pickle: the two sheets of each of
    the first 8 examples, and the outputs those sheets read equal the
    restored model's forward_outputs."""
    paths = write_vqa_files(str(tmp_path / "files"), feat_dim=16,
                            regions=(3, 9))
    tiny = dict(hidden_size=32, layer=1, multi_head=4, img_feat_size=16,
                img_feat_pad_size=9, max_token=6, flat_out_size=32,
                flat_mlp_size=16)
    cfg = Config(**paths, **tiny, ff_size=128,
                 vocab_cache_path=str(tmp_path / "vocab.npz"),
                 ckpts_dir=str(tmp_path / "ckpts"),
                 log_path=str(tmp_path / "log"), version="viz",
                 use_glove=False)
    ds = VQADataset(cfg, "val")
    trainer = Trainer(cfg, eval_datasets={"val": ds}, device="cpu")
    save_checkpoint(trainer.state, cfg.ckpts_dir, "viz", 1, cfg.lr_base)
    result = tmp_path / "result"
    argv = ["--run", "visualize", "--device", "cpu", "--version", "viz",
            "--ckpt_epoch", "1",
            "--result_path", str(result) + "/",
            "--images_dir", str(tmp_path / "no_photos"),
            "--compile_cache", "off",
            "--vocab_cache_path", cfg.vocab_cache_path,
            "--ckpts_dir", cfg.ckpts_dir, "--log_path", cfg.log_path,
            "--dataset_path", cfg.dataset_path,
            "--feature_path", cfg.feature_path]
    for k, v in tiny.items():
        argv += [f"--{k}", str(v)]
    seen = {}
    real = vis.visualization_outputs

    def spy(*a, **k):
        seen["out"] = real(*a, **k)
        return seen["out"]

    vis.visualization_outputs = spy
    try:
        assert run_vqa.main(argv) == 0
    finally:
        vis.visualization_outputs = real
    assert "wrote 8 visualizations" in capsys.readouterr().out
    names = sorted(os.listdir(result / "val_imgs"))
    assert names == sorted([f"example_{i}.png" for i in range(8)]
                           + [f"example_{i}_mats.png" for i in range(8)])
    n = 8
    img = torch.tensor(np.stack([ds.example(i)["img"] for i in range(n)]))
    ques = torch.tensor(np.stack([ds.example(i)["ques"] for i in range(n)]))
    with torch.no_grad():
        want = trainer.model.forward_outputs(img, ques)
    for k in KEYS:
        np.testing.assert_array_equal(seen["out"][k], want[k].numpy(),
                                      err_msg=k)
