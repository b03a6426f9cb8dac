"""Image-only multi-label classification command line of the port
(mcan_vqa_tpu/cli/run_classify.py; the reference's ExecClassify,
core/exec.py:757-1066): ``ClassifierNet`` over region features, SmoothL1
regularization under ``--reg_factor``, the in-epoch evaluation every
``--eval_interval`` steps, ROC-AUC micro / macro.

    python -m mcan_vqa_tpu_torch.cli.run_classify --run train --synthetic \
        [--model large] [--eval_interval 100]
    python -m mcan_vqa_tpu_torch.cli.run_classify --run val --synthetic \
        --ckpt_version V --ckpt_epoch 13       # or --ckpt_path epoch13.pkl

on the CUDA device (``--device cpu`` runs the kernels' plain versions on
the CPU instead, for tiny architecture flags). Without ``--synthetic`` it
trains and evaluates on the MIMIC-CXR files (``data/mimic.py::
MIMICDataset``, the train and val splits, their labels; the paths as
``run_mimic`` takes them, ``--cxr_data_path``, ``--cxr_img_feat_path``,
``--ana_pool_finding_path``, and the image rows by
``--mimic_feat_source``): a missing path is listed after ``missing MIMIC
paths:`` on stderr and the command exits 1. ``--synthetic`` trains and
evaluates on ``SyntheticMIMICDataset`` instead (14 labels; the val set
seed 1). ``img_feat_size`` defaults to 1024, the MIMIC region features'
width. The JAX CLI's ``--compute_dtype`` sets an XLA option and is not
accepted here, as ``run_vqa`` does not accept it; ``--compile_cache`` is
accepted and ignored, as in ``run_vqa`` (``utils/compile_cache.py``).
Under ``torchrun`` the ranks train on ``--mesh_shape``'s mesh as
``run_vqa``'s do.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from mcan_vqa_tpu_torch.cli.run_vqa import _bool, add_mesh_flags, \
    mesh_launch
from mcan_vqa_tpu_torch.configs import MIMIC_FEAT_SOURCES, Config
from mcan_vqa_tpu_torch.utils import compile_cache

INT_KNOBS = ("batch_size", "max_epoch", "layer", "seed", "ckpt_epoch",
             "eval_interval", "img_feat_size", "hidden_size", "multi_head",
             "img_feat_pad_size", "flat_out_size", "flat_mlp_size",
             "max_token")
FLOAT_KNOBS = ("lr_base", "reg_factor")
STR_KNOBS = ("version", "ckpt_version", "ckpt_path", "ckpts_dir", "log_path",
             "result_path", "cxr_data_path", "cxr_img_feat_path",
             "ana_pool_finding_path")
BOOL_KNOBS = ("resume", "ckpt_async", "verbose")
LABELS = 14                     # the classify task's CheXpert-style labels


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="MCAN image classifier, PyTorch/CUDA port")
    p.add_argument("--run", dest="run_mode", required=True,
                   choices=["train", "val", "test"])
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--synthetic", action="store_true",
                   help="SyntheticMIMICDataset (14 labels) instead of the "
                        "MIMIC-CXR files")
    p.add_argument("--synthetic_size", type=int, default=256)
    p.add_argument("--mimic_feat_source", choices=MIMIC_FEAT_SOURCES)
    p.add_argument("--train_engine", choices=["auto", "fused", "plain"])
    p.add_argument("--eval_engine", choices=["auto", "fused", "plain"])
    for knob in INT_KNOBS:
        p.add_argument(f"--{knob}", type=int)
    for knob in FLOAT_KNOBS:
        p.add_argument(f"--{knob}", type=float)
    for knob in STR_KNOBS:
        p.add_argument(f"--{knob}", type=str)
    for knob in BOOL_KNOBS:
        p.add_argument(f"--{knob}", type=_bool)
    add_mesh_flags(p)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    overrides = {k: getattr(args, k) for k in
                 INT_KNOBS + FLOAT_KNOBS + STR_KNOBS + BOOL_KNOBS
                 + ("train_engine", "eval_engine", "mimic_feat_source",
                    "mesh_shape")
                 if getattr(args, k) is not None}
    overrides.setdefault("img_feat_size", 1024)
    return Config.for_model(args.model, **overrides)


def load_datasets(cfg: Config, args: argparse.Namespace):
    """(train or None, val), or None when a MIMIC path is missing (listed
    on stderr, as run_mimic lists them). The val split shares the train
    split's vocabulary (the classifier reads no question)."""
    if args.synthetic:
        from mcan_vqa_tpu_torch.data.mimic import SyntheticMIMICDataset
        n = args.synthetic_size
        train = SyntheticMIMICDataset(cfg, size=n, answer_size=LABELS,
                                      run_mode="train") \
            if args.run_mode == "train" else None
        return train, SyntheticMIMICDataset(
            cfg, size=max(48, n // 4), answer_size=LABELS, run_mode="val",
            seed=1)
    from mcan_vqa_tpu_torch.cli.run_mimic import load_datasets as mimic
    return mimic(cfg, args, splits=("val",))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    compile_cache.enable(args.compile_cache)
    cfg = build_config(args)
    datasets = load_datasets(cfg, args)
    if datasets is None:
        return 1
    train_ds, val_ds = datasets
    from mcan_vqa_tpu_torch.train.checkpoint import load_params
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    with mesh_launch(args.device) as (device, say):
        if args.run_mode == "train":
            trainer = Trainer(cfg, train_ds,
                              eval_datasets={"val": val_ds}
                              if cfg.eval_every_epoch else {},
                              task="classify", device=device)
            trainer.train()
            say("val:", trainer.evaluate(val_ds))
            return 0
        trainer = Trainer(cfg, eval_datasets={args.run_mode: val_ds},
                          task="classify", device=device)
        trainer.model.load_state_dict(
            trainer.local_state_dict(load_params(cfg)))
        say(f"{args.run_mode}:", trainer.evaluate(val_ds))
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
