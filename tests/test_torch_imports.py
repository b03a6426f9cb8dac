"""Import hygiene of the PyTorch port: no module of the port and not
chip_smoke.py imports JAX, the JAX stack (flax / optax / orbax / yaml) or
anything of the JAX package ``mcan_vqa_tpu`` -- not even its
framework-neutral host modules: the port keeps its own copies
(mcan_vqa_tpu_torch/data/). chip_smoke.py refuses to run without a CUDA
device: it exits non-zero and prints no result. A world of one (no
process group, the mesh {1, 1}) calls no collective of torch.distributed
on the single-card paths."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mcan_vqa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml",
             "mcan_vqa_tpu")


def _imported_modules(path: Path):
    """The modules each import statement of the file loads;
    ``from <package> import <name>`` counts as ``<package>.<name>``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def _violations(path: Path):
    """The file's imports of the JAX stack and of the JAX package."""
    return [mod for mod in _imported_modules(path)
            if mod.split(".")[0] in FORBIDDEN]


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for expected in ("mcan_vqa_tpu_torch/api.py",
                     "mcan_vqa_tpu_torch/data/__init__.py",
                     "mcan_vqa_tpu_torch/data/text.py",
                     "mcan_vqa_tpu_torch/ops/sga_block.py",
                     "mcan_vqa_tpu_torch/ops/quant.py",
                     "mcan_vqa_tpu_torch/ops/sga_train.py",
                     "mcan_vqa_tpu_torch/train/trainer.py",
                     "mcan_vqa_tpu_torch/cli/run_vqa.py",
                     "mcan_vqa_tpu_torch/evals/vqa_eval.py",
                     "mcan_vqa_tpu_torch/evals/roc_auc.py",
                     "mcan_vqa_tpu_torch/evals/compat.py",
                     "mcan_vqa_tpu_torch/data/vqa_dataset.py",
                     "mcan_vqa_tpu_torch/data/vqa_files.py",
                     "mcan_vqa_tpu_torch/cli/validate_serving_accuracy.py",
                     "mcan_vqa_tpu_torch/cli/pack_features.py",
                     "mcan_vqa_tpu_torch/cli/run_classify.py",
                     "mcan_vqa_tpu_torch/data/mimic.py",
                     "mcan_vqa_tpu_torch/data/filter_train_data.py",
                     "mcan_vqa_tpu_torch/cli/run_mimic.py",
                     "mcan_vqa_tpu_torch/cli/sweep.py",
                     "mcan_vqa_tpu_torch/parallel/__init__.py",
                     "mcan_vqa_tpu_torch/parallel/mesh.py",
                     "mcan_vqa_tpu_torch/parallel/sharding.py",
                     "mcan_vqa_tpu_torch/artifact.py",
                     "mcan_vqa_tpu_torch/batching.py",
                     "mcan_vqa_tpu_torch/ops/library.py",
                     "mcan_vqa_tpu_torch/cli/serve.py",
                     "mcan_vqa_tpu_torch/cli/bench_serve_http.py",
                     "mcan_vqa_tpu_torch/utils/visualize.py",
                     "mcan_vqa_tpu_torch/utils/compile_cache.py",
                     "mcan_vqa_tpu_torch/ops/stacked_params.py",
                     "mcan_vqa_tpu_torch/cli/build_answer_dict.py",
                     "mcan_vqa_tpu_torch/cli/ab_timer.py",
                     "mcan_vqa_tpu_torch/cli/bench_serving_ab.py",
                     "mcan_vqa_tpu_torch/cli/bench_classifier_serve.py",
                     "mcan_vqa_tpu_torch/cli/bench_train_ab.py",
                     "mcan_vqa_tpu_torch/cli/bench_host_feed.py",
                     "mcan_vqa_tpu_torch/cli/param_footprint.py",
                     "mcan_vqa_tpu_torch/cli/train_roofline.py",
                     "mcan_vqa_tpu_torch/cli/card_check.py",
                     "mcan_vqa_tpu_torch/cli/validate_prng_dropout.py",
                     "mcan_vqa_tpu_torch/cli/validate_inkernel_dw.py",
                     "chip_smoke.py"):
        assert expected in names
    assert not (PORT / "data.py").exists()


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = _violations(path)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("line", [
    "import jax.numpy as jnp", "from flax import linen", "import yaml",
    "from mcan_vqa_tpu.ops import serving",
    "from mcan_vqa_tpu import api", "import mcan_vqa_tpu.models.net",
    "from mcan_vqa_tpu.configs.config import Config",
    # the framework-neutral host modules count as well
    "from mcan_vqa_tpu.data import answers, text",
    "from mcan_vqa_tpu import request_prep",
    "from mcan_vqa_tpu.request_prep import pad_to_bucket",
    "import mcan_vqa_tpu.data.features"])
def test_checker_catches_forbidden_imports(tmp_path, line):
    src = tmp_path / "bad.py"
    src.write_text(line + "\n")
    assert _violations(src)


def test_checker_passes_the_port_package_itself(tmp_path):
    src = tmp_path / "ok.py"
    src.write_text("import torch\nimport mcan_vqa_tpu_torch.data.text\n"
                   "from mcan_vqa_tpu_torch.data import build_vocab\n")
    assert _violations(src) == []


def test_port_loads_no_jax_module():
    """Importing the port adds no module of the JAX stack or of the JAX
    package to sys.modules (in a fresh interpreter; anything its startup
    pre-imported is ignored)."""
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import mcan_vqa_tpu_torch.api, mcan_vqa_tpu_torch.ops.serving\n"
            "import mcan_vqa_tpu_torch.ops.quant\n"
            "import mcan_vqa_tpu_torch.train.checkpoint\n"
            "import mcan_vqa_tpu_torch.train.trainer\n"
            "import mcan_vqa_tpu_torch.cli.run_vqa\n"
            "import mcan_vqa_tpu_torch.cli.run_classify\n"
            "import mcan_vqa_tpu_torch.data.mimic\n"
            "import mcan_vqa_tpu_torch.data.filter_train_data\n"
            "import mcan_vqa_tpu_torch.cli.run_mimic\n"
            "import mcan_vqa_tpu_torch.cli.sweep\n"
            "import mcan_vqa_tpu_torch.parallel\n"
            "import mcan_vqa_tpu_torch.artifact, mcan_vqa_tpu_torch.batching\n"
            "import mcan_vqa_tpu_torch.ops.library\n"
            "import mcan_vqa_tpu_torch.cli.serve\n"
            "import mcan_vqa_tpu_torch.cli.bench_serve_http\n"
            "import mcan_vqa_tpu_torch.utils.visualize\n"
            "import mcan_vqa_tpu_torch.utils.compile_cache\n"
            "import mcan_vqa_tpu_torch.ops.stacked_params\n"
            "import mcan_vqa_tpu_torch.cli.build_answer_dict\n"
            "import mcan_vqa_tpu_torch.cli.bench_serving_ab\n"
            "import mcan_vqa_tpu_torch.cli.bench_classifier_serve\n"
            "import mcan_vqa_tpu_torch.cli.bench_train_ab\n"
            "import mcan_vqa_tpu_torch.cli.bench_host_feed\n"
            "import mcan_vqa_tpu_torch.cli.param_footprint\n"
            "import mcan_vqa_tpu_torch.cli.train_roofline\n"
            "import mcan_vqa_tpu_torch.cli.validate_prng_dropout\n"
            "import mcan_vqa_tpu_torch.cli.validate_inkernel_dw\n"
            "new = set(sys.modules) - before\n"
            f"bad = sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in-the-checkout", "alone-in-a-directory"])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    import shutil

    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_world_of_one_calls_no_collective(tmp_path, monkeypatch):
    """With no process group the mesh is {1, 1} with no group, and a
    Trainer trains (the fused engine, two micro-batches, the L1 + L2
    penalty, the gradient-norm log), checkpoints, resumes and evaluates
    without calling any collective: every torch.distributed entry point
    raises here."""
    import torch
    import torch.distributed as dist

    from mcan_vqa_tpu_torch.parallel import make_mesh

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was called in a world of one")

    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "new_group", "init_process_group", "reduce_scatter"):
        monkeypatch.setattr(dist, name, refuse)
    assert not dist.is_initialized()
    mesh = make_mesh()
    assert (mesh.shape, mesh.distributed, mesh.data_group,
            mesh.model_group) == ({"data": 1, "model": 1}, False, None, None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train_resume_predict(tmp_path)
    finally:
        torch.set_num_threads(threads)


def _train_resume_predict(tmp_path):
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    base = dict(hidden_size=32, ff_size=128, layer=1, multi_head=4,
                img_feat_size=16, img_feat_pad_size=8, max_token=6,
                flat_out_size=32, flat_mlp_size=16, batch_size=8,
                grad_accu_steps=2, reg_factor=1e-4, grad_norm_log_every=1,
                train_engine="fused", eval_engine="fused", verbose=False,
                eval_every_epoch=False, ckpts_dir=str(tmp_path / "ck"),
                log_path=str(tmp_path / "log"))
    ds = SyntheticVQADataset(Config(**base), size=16, token_size=20,
                             answer_size=6)
    trainer = Trainer(Config(**base, max_epoch=1), ds, device="cpu")
    assert trainer.mesh.size == 1 and trainer.fused and trainer.fused_eval
    assert trainer.train().step == 2
    resumed = Trainer(Config(**base, max_epoch=2, resume=True,
                             ckpt_epoch=1), ds, device="cpu")
    assert resumed.train().step == 4
    assert resumed.predict(ds)["probs"].shape == (16, 6)
