"""VQA command line of the port (mcan_vqa_tpu/cli/run_vqa.py; reference
run.py:18-148).

    python -m mcan_vqa_tpu_torch.cli.run_vqa --run train [--model large] \
        [--split train+val+vg] [--eval_ee true] [--synthetic] \
        [--ckpt_async true]
    python -m mcan_vqa_tpu_torch.cli.run_vqa --run train --resume true \
        --ckpt_epoch 1 [--ckpt_version V | --ckpt_path epoch1.pkl]
    python -m mcan_vqa_tpu_torch.cli.run_vqa --run val --ckpt_version V \
        --ckpt_epoch 13                      # or --ckpt_path epoch13.pkl
    python -m mcan_vqa_tpu_torch.cli.run_vqa --run test --ckpt_path ...
    python -m mcan_vqa_tpu_torch.cli.run_vqa --run parity --ckpt_path ...

on the CUDA device (``--device cpu`` runs the kernels' plain versions on
the CPU instead, for tiny architecture flags). The VQA-v2 files are read
from ``--dataset_path`` / ``--feature_path`` (and a packed feature cache
under ``--feature_cache_path``, ``cli/pack_features.py``); a missing file
is listed and the command exits 1. ``--synthetic`` trains on generated data
instead and evaluates on the JAX package's synthetic val set (seed 1, with
targets, so ROC-AUC is printed).

  train   trains (evaluating the val split after each epoch under
          ``--eval_ee``), then evaluates val once more; with ``--resume
          true`` it goes on from the checkpoint ``--ckpt_*`` names (its
          weights, AdamW moments and step count) at epoch ``--ckpt_epoch``;
  val     scores the checkpoint on val with the official evaluator and
          writes the EvalAI file ``<result_path>/result_run_<version>.json``;
  test    writes that file for test2015;
  parity  scores val (``..._val.json``), then writes the test-dev file
          (``..._testdev.json``), the reference's val-then-test sequence in
          one command;
  visualize  restores the checkpoint ``--ckpt_*`` names and renders the
          first 8 val examples (``utils/visualize.py``):
          ``<result_path>/val_imgs/example_{i}.png`` (AttFlat panels) and
          ``example_{i}_mats.png`` (the reference's six-figure sheet), over
          the COCO photographs under ``--images_dir`` where they resolve;
          rendering needs matplotlib.

Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) every rank
joins the process group before the Trainer is built (each on
``cuda:LOCAL_RANK``, or the CPU with ``--device cpu``) and trains on the
mesh ``--mesh_shape`` names, JAX's ``mesh_shape`` (data x model ranks):

    torchrun --nproc_per_node=2 -m mcan_vqa_tpu_torch.cli.run_vqa \
        --run train --synthetic --mesh_shape data=2,model=1

Rank 0 prints, logs and writes the checkpoints. Without torchrun nothing
changes. ``--gpu`` is accepted and ignored, as in the JAX CLI: the ranks
and the mesh choose the devices. So is ``--compile_cache``
(``utils/compile_cache.py``: nothing here compiles through a cache it
could point).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Dict, Optional, Sequence

from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.utils import compile_cache

ARCH_KNOBS = ("hidden_size", "layer", "multi_head", "img_feat_size",
              "img_feat_pad_size", "flat_out_size", "flat_mlp_size",
              "max_token")
TRAIN_KNOBS = {"batch_size": int, "max_epoch": int, "seed": int,
               "version": str, "lr_base": float, "ckpts_dir": str,
               "log_path": str}
PATH_KNOBS = ("dataset_path", "feature_path", "feature_cache_path",
              "vocab_cache_path", "result_path", "pred_path")
CKPT_KNOBS = {"ckpt_version": str, "ckpt_epoch": int, "ckpt_path": str}
# flag -> Config field, as the JAX CLI names them (--resume trains on from
# the checkpoint --ckpt_* names; --ckpt_async writes the epoch pickles on a
# background thread)
BOOL_KNOBS = {"eval_ee": "eval_every_epoch", "save_pred": "test_save_pred",
              "preload": "preload", "verbose": "verbose", "resume": "resume",
              "ckpt_async": "ckpt_async"}
OTHER_KNOBS = ("grad_accu_steps", "lr_decay_list", "train_engine",
               "eval_engine", "dropout_bits", "train_split", "mesh_shape")


def _bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def parse_mesh_shape(text: str) -> Dict[str, int]:
    """"data=2,model=2" -> {"data": 2, "model": 2}."""
    shape = {}
    for part in text.split(","):
        axis, sep, size = part.partition("=")
        if not sep:
            raise argparse.ArgumentTypeError(
                f"mesh_shape takes axis=size pairs, got {text!r}")
        shape[axis.strip()] = int(size)
    return shape


def add_mesh_flags(p: argparse.ArgumentParser) -> None:
    """--mesh_shape, and --gpu (ignored, as in the JAX CLI)."""
    p.add_argument("--mesh_shape", type=parse_mesh_shape,
                   help="data=D,model=M: the mesh of a torchrun launch "
                        "(data x model ranks; default data=1,model=1)")
    p.add_argument("--gpu", help="accepted for CLI compatibility; ignored "
                                 "(torchrun's ranks and --mesh_shape choose "
                                 "the devices)")
    add_compile_cache_flag(p)


def add_compile_cache_flag(p: argparse.ArgumentParser) -> None:
    """--compile_cache, accepted and resolved as the JAX CLIs take it, and
    ignored (``utils/compile_cache.enable`` says why)."""
    p.add_argument("--compile_cache", default=None,
                   help="accepted for CLI compatibility; ignored (the "
                        "kernels' build directory is keyed by their "
                        "sources' hash)")


@contextlib.contextmanager
def mesh_launch(device: str):
    """Under torchrun (WORLD_SIZE > 1) join the process group before any
    Trainer exists and leave it at the end; yields (this rank's device,
    print on rank 0 only). Without torchrun (device, print)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        yield device, print
        return
    import torch.distributed as dist

    from mcan_vqa_tpu_torch.parallel.mesh import init_distributed
    dev = init_distributed(device=None if device == "cuda" else device)
    try:
        yield dev, print if dist.get_rank() == 0 else \
            (lambda *a, **k: None)
    finally:
        dist.destroy_process_group()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="MCAN-VQA, PyTorch/CUDA port")
    p.add_argument("--run", dest="run_mode", required=True,
                   choices=["train", "val", "test", "visualize", "parity"])
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--synthetic", action="store_true",
                   help="generated data (no dataset files), 3129 answers "
                        "as VQA-v2's")
    p.add_argument("--synthetic_size", type=int, default=512)
    p.add_argument("--split", dest="train_split",
                   choices=["train", "train+val", "train+val+vg"])
    p.add_argument("--grad_accu", dest="grad_accu_steps", type=int)
    p.add_argument("--lr_decay_list", type=lambda s: tuple(
        int(x) for x in s.split(",") if x.strip()))
    p.add_argument("--train_engine", choices=["auto", "fused", "plain"],
                   help="auto (default): the fused kernels on the card at "
                        "hidden % 128 == 0 and <= 1024, else plain ops")
    p.add_argument("--eval_engine", choices=["auto", "fused", "plain"],
                   help="auto (default): the int8 serving engine on the "
                        "card, else the plain model")
    p.add_argument("--dropout_bits", type=int, choices=[8, 16, 32])
    for flag in BOOL_KNOBS:
        p.add_argument(f"--{flag}", type=_bool)
    for knob in ARCH_KNOBS:
        p.add_argument(f"--{knob}", type=int)
    for knob, typ in {**TRAIN_KNOBS, **CKPT_KNOBS}.items():
        p.add_argument(f"--{knob}", type=typ)
    for knob in PATH_KNOBS:
        p.add_argument(f"--{knob}", type=str)
    p.add_argument("--images_dir", default=None,
                   help="visualize: the COCO photographs (flat or in "
                        "train2014 / val2014 / test2015 subdirectories)")
    add_mesh_flags(p)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    overrides = {}
    for knob in (ARCH_KNOBS + tuple(TRAIN_KNOBS) + tuple(CKPT_KNOBS)
                 + PATH_KNOBS + OTHER_KNOBS):
        value = getattr(args, knob)
        if value is not None:
            overrides[knob] = value
    for flag, field in BOOL_KNOBS.items():
        value = getattr(args, flag)
        if value is not None:
            overrides[field] = value
    return Config.for_model(args.model, **overrides)


def load_datasets(cfg: Config, args: argparse.Namespace):
    """{name: dataset} of the splits the run mode reads, or None when a
    VQA-v2 path is missing (listed on stderr)."""
    if args.synthetic:
        from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
        n = args.synthetic_size
        # the val set keeps run_mode "train": its examples carry targets,
        # so ROC-AUC is computed (the JAX CLI's synthetic val set)
        return {"train": SyntheticVQADataset(cfg, size=n, answer_size=3129,
                                             seed=cfg.seed),
                "val": SyntheticVQADataset(cfg, size=max(64, n // 4),
                                           answer_size=3129, seed=1)}
    missing = cfg.check_vqa_paths()
    if missing:
        print("missing dataset paths:\n  " + "\n  ".join(missing),
              file=sys.stderr)
        return None
    from mcan_vqa_tpu_torch.data.vqa_dataset import VQADataset
    mode = args.run_mode
    datasets = {}
    if mode == "train":
        datasets["train"] = VQADataset(cfg, "train")
    if mode in ("train", "val", "parity", "visualize"):
        datasets["val"] = VQADataset(cfg, "val")
    if mode in ("test", "parity"):
        datasets["test"] = VQADataset(cfg, "test")
    return datasets


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    compile_cache.enable(args.compile_cache)
    cfg = build_config(args)
    datasets = load_datasets(cfg, args)
    if datasets is None:
        return 1
    with mesh_launch(args.device) as (device, say):
        return run(args, cfg, datasets, device, say)


def run(args, cfg: Config, datasets, device, say) -> int:
    """The run mode on ``device`` (this rank's under torchrun); ``say``
    prints the results (rank 0's)."""
    from mcan_vqa_tpu_torch.train.checkpoint import load_params
    from mcan_vqa_tpu_torch.train.trainer import Trainer, eval_engine_line
    mode = args.run_mode
    if mode == "train":
        trainer = Trainer(cfg, datasets["train"],
                          eval_datasets={"val": datasets["val"]}
                          if cfg.eval_every_epoch else {},
                          device=device)
        trainer.train()
        say("final val:", trainer.evaluate(datasets["val"]))
        return 0
    ds = datasets.get(mode) or datasets["val"]
    trainer = Trainer(cfg, eval_datasets={mode: ds}, device=device)
    if mode == "visualize":
        from mcan_vqa_tpu_torch.utils.visualize import run_visualization
        out_dir = os.path.join(cfg.result_path, "val_imgs")
        n = run_visualization(trainer, ds, out_dir, limit=8,
                              images_dir=args.images_dir)
        say(f"wrote {n} visualizations to {out_dir}")
        return 0
    trainer.model.load_state_dict(trainer.local_state_dict(load_params(cfg)))
    trainer.logger.write(f"{eval_engine_line(trainer.fused_eval)} (device "
                         f"{trainer.device})")
    base = os.path.join(cfg.result_path, f"result_run_{cfg.run_version}")
    if mode in ("val", "test"):
        res = trainer.evaluate(ds, dump_path=base + ".json")
        say(f"{mode}:", res)
        return 0
    res = trainer.evaluate(datasets["val"], dump_path=base + "_val.json")
    say(f"parity val: {res}")
    if res.get("accuracy") is not None:
        say(f"parity val accuracy (official evaluator): "
            f"{res['accuracy']:.2f}  (reference MCAN-small val ~67, "
            f"test-dev 70.70)")
    test_ds = datasets.get("test") or datasets["val"]
    trainer.evaluate(test_ds, dump_path=base + "_testdev.json")
    say(f"parity test-dev EvalAI dump: {base}_testdev.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
