"""VQA command line of the port (mcan_vqa_tpu/cli/run_vqa.py).

    python -m mcan_vqa_tpu_torch.cli.run_vqa --run train --synthetic \
        [--model large]

trains MCAN-small (or MCAN-large) on generated data on the CUDA device;
``--device cpu`` runs the kernels' plain versions on the CPU instead, for
tiny architecture flags. Training on the VQA-v2 files and the val / test /
visualize / parity modes are not ported: those raise.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from mcan_vqa_tpu_torch.configs import Config

ARCH_KNOBS = ("hidden_size", "layer", "multi_head", "img_feat_size",
              "img_feat_pad_size", "flat_out_size", "flat_mlp_size",
              "max_token")
TRAIN_KNOBS = {"batch_size": int, "max_epoch": int, "seed": int,
               "version": str, "lr_base": float, "ckpts_dir": str,
               "log_path": str}
NOT_PORTED = ("resume", "ckpt_version", "ckpt_epoch", "ckpt_path")


def _bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="MCAN-VQA, PyTorch/CUDA port")
    p.add_argument("--run", dest="run_mode", required=True,
                   choices=["train", "val", "test", "visualize", "parity"])
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated data (no dataset files), "
                        "3129 answers as VQA-v2's")
    p.add_argument("--synthetic_size", type=int, default=512)
    p.add_argument("--grad_accu", dest="grad_accu_steps", type=int)
    p.add_argument("--lr_decay_list", type=lambda s: tuple(
        int(x) for x in s.split(",") if x.strip()))
    p.add_argument("--verbose", type=_bool)
    p.add_argument("--train_engine", choices=["auto", "fused", "plain"],
                   help="auto (default): the fused kernels on the card at "
                        "hidden % 128 == 0 and <= 1024, else plain ops")
    p.add_argument("--dropout_bits", type=int, choices=[8, 16, 32])
    for knob in ARCH_KNOBS:
        p.add_argument(f"--{knob}", type=int)
    for knob, typ in TRAIN_KNOBS.items():
        p.add_argument(f"--{knob}", type=typ)
    for knob in NOT_PORTED:
        p.add_argument(f"--{knob}", type=str)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> Config:
    overrides = {}
    for knob in ARCH_KNOBS + tuple(TRAIN_KNOBS) + ("grad_accu_steps",
                                                    "lr_decay_list",
                                                    "verbose",
                                                    "train_engine",
                                                    "dropout_bits"):
        value = getattr(args, knob)
        if value is not None:
            overrides[knob] = value
    return Config.for_model(args.model, **overrides)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.run_mode != "train":
        raise NotImplementedError(
            f"--run {args.run_mode}: only training is ported so far")
    if not args.synthetic:
        raise NotImplementedError(
            "training on the VQA-v2 files is not ported yet; pass "
            "--synthetic")
    given = [k for k in NOT_PORTED if getattr(args, k) is not None]
    if given:
        raise NotImplementedError(f"{given}: resume is not ported yet")
    cfg = build_config(args)

    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    train_ds = SyntheticVQADataset(cfg, size=args.synthetic_size,
                                   answer_size=3129, seed=cfg.seed)
    trainer = Trainer(cfg, train_ds, device=args.device)
    trainer.train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
