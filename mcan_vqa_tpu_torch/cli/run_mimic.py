"""MIMIC-CXR medical VQA command line of the port
(mcan_vqa_tpu/cli/run_mimic.py; the reference's run_mimic.py:21-176).

    python -m mcan_vqa_tpu_torch.cli.run_mimic --run train \
        [--warm_start VQA_EPOCH.pkl] [--train_eval_every 2] \
        [--mimic_feat_source regions|anatomy|both]
    python -m mcan_vqa_tpu_torch.cli.run_mimic --run val --ckpt_epoch 13 \
        [--ckpt_version V | --ckpt_path epoch13.pkl]

on the CUDA device (``--device cpu`` runs the kernels' plain versions on
the CPU instead, for tiny architecture flags). The MIMIC-CXR files are
read from ``--cxr_data_path`` (the prefix of the pickles
``ans2label_full.pkl``, ``label2ans_full.pkl``,
``dataset_{train,val,test}_full.pkl``), ``--cxr_img_feat_path`` (the
region bank) and ``--ana_pool_finding_path`` (the anatomy bank), each bank
HDF5 or a ``.npy`` array (``data/mimic.py::write_npy_bank``); a missing
path is listed after ``missing MIMIC paths:`` on stderr and the command
exits 1. ``--synthetic`` trains on ``SyntheticMIMICDataset`` instead.

  train   trains MCAN on the train split (task "vqa": multi-hot targets,
          the L1 + L2 penalty under ``--reg_factor``), evaluating val and
          test after every epoch and the train split every
          ``--train_eval_every`` epochs (0: never; the reference's cadence,
          core/exec.py:664-679), then prints the ``val:`` and ``test:``
          ROC-AUC lines (the reference's train -> val -> test);
          ``--warm_start`` loads the shape-compatible tensors of a VQA
          reference pickle first (core/exec.py:468-475);
  val     scores the checkpoint ``--ckpt_*`` names on val;
  test    on test.

Every split encodes its questions with one vocabulary, the train split's.
The flags are the JAX CLI's with its defaults (``img_feat_size`` 1024, the
MIMIC features' width) plus ``--device``, the data paths and
``--mimic_feat_source``; its ``--compute_dtype`` sets an XLA option and
is not accepted, as ``run_vqa`` does not accept it; ``--compile_cache`` is
accepted and ignored, as in ``run_vqa`` (``utils/compile_cache.py``).
Under ``torchrun`` the ranks train on ``--mesh_shape``'s mesh as
``run_vqa``'s do.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from mcan_vqa_tpu_torch.cli.run_vqa import _bool, add_mesh_flags, \
    mesh_launch
from mcan_vqa_tpu_torch.configs import MIMIC_FEAT_SOURCES, Config
from mcan_vqa_tpu_torch.utils import compile_cache

INT_KNOBS = ("batch_size", "max_epoch", "layer", "seed", "ckpt_epoch",
             "eval_interval", "mutan_gamma", "img_feat_size", "hidden_size",
             "multi_head", "img_feat_pad_size", "flat_out_size",
             "flat_mlp_size", "max_token")
FLOAT_KNOBS = ("lr_base", "reg_factor")
STR_KNOBS = ("version", "ckpt_version", "ckpt_path", "ckpts_dir", "log_path",
             "result_path", "cxr_data_path", "cxr_img_feat_path",
             "ana_pool_finding_path")
BOOL_KNOBS = ("resume", "ckpt_async", "verbose")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="MIMIC-CXR medical VQA, PyTorch/CUDA port")
    p.add_argument("--run", dest="run_mode", required=True,
                   choices=["train", "val", "test"])
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--grad_accu", dest="grad_accu_steps", type=int)
    p.add_argument("--warm_start", type=str,
                   help="VQA reference pickle to warm-start from")
    p.add_argument("--train_eval_every", type=int, default=2,
                   help="ROC-eval the train split every N epochs during "
                        "training; 0 disables it")
    p.add_argument("--synthetic", action="store_true",
                   help="SyntheticMIMICDataset instead of the MIMIC-CXR "
                        "files")
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
                 + ("grad_accu_steps", "mimic_feat_source", "train_engine",
                    "eval_engine", "mesh_shape")
                 if getattr(args, k) is not None}
    # MIMIC features are 1024-d (reference core/data/load_data.py:168)
    overrides.setdefault("img_feat_size", 1024)
    return Config.for_model(args.model, **overrides)


def load_datasets(cfg: Config, args: argparse.Namespace,
                  splits: Sequence[str] = ("val", "test")):
    """(train or None, *splits), or None when a MIMIC path is missing
    (listed on stderr). Every split shares the train split's vocabulary."""
    if args.synthetic:
        from mcan_vqa_tpu_torch.data.mimic import SyntheticMIMICDataset
        n, m = args.synthetic_size, max(64, args.synthetic_size // 4)
        return (SyntheticMIMICDataset(cfg, size=n, run_mode="train"),
                *(SyntheticMIMICDataset(cfg, size=m, run_mode=split)
                  for split in splits))
    missing = cfg.check_mimic_paths()
    if missing:
        print("missing MIMIC paths:\n  " + "\n  ".join(missing),
              file=sys.stderr)
        return None
    from mcan_vqa_tpu_torch.data.mimic import MIMICDataset
    train = MIMICDataset(cfg, "train") if args.run_mode == "train" else None
    out = [train]
    vocab = (train.token_to_ix, train.pretrained_emb) if train else None
    for split in splits:
        out.append(MIMICDataset(cfg, split, vocab=vocab))
        vocab = (out[-1].token_to_ix, out[-1].pretrained_emb)
    return tuple(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    compile_cache.enable(args.compile_cache)
    cfg = build_config(args)
    datasets = load_datasets(cfg, args)
    if datasets is None:
        return 1
    train_ds, val_ds, test_ds = datasets

    with mesh_launch(args.device) as (device, say):
        return run(args, cfg, train_ds, val_ds, test_ds, device, say)


def run(args, cfg: Config, train_ds, val_ds, test_ds, device, say) -> int:
    """The run mode on ``device`` (this rank's under torchrun); ``say``
    prints the results (rank 0's)."""
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    if args.run_mode == "train":
        eval_datasets = {"val": val_ds, "test": test_ds}
        eval_cadence = {}
        if args.train_eval_every > 0:
            # the train split's ROC on epochs 0, N, 2N, ... beside the
            # every-epoch val / test evaluations
            eval_datasets = {"train": train_ds, **eval_datasets}
            eval_cadence["train"] = args.train_eval_every
        trainer = Trainer(cfg, train_ds,
                          eval_datasets=eval_datasets
                          if cfg.eval_every_epoch else {},
                          eval_cadence=eval_cadence, device=device)
        if args.warm_start:
            trainer.warm_start(args.warm_start)
        trainer.train()
        say("val:", trainer.evaluate(val_ds))
        say("test:", trainer.evaluate(test_ds))
        return 0
    ds = val_ds if args.run_mode == "val" else test_ds
    trainer = Trainer(cfg, eval_datasets={args.run_mode: ds},
                      device=device)
    trainer.ensure_state(resume=True)
    say(f"{args.run_mode}:", trainer.evaluate(ds))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
