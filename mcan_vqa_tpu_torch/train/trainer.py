"""Training orchestration for VQA (mcan_vqa_tpu/train/trainer.py; the
reference's Execution, core/exec.py:27-426).

``Trainer(cfg, train_dataset).train()`` runs the epochs: a shuffled,
drop-last loader onto the device, one train step per batch (the fused
forward, the BCE loss, AdamW under the warmup / decay schedule), a
reference pickle after every epoch and one log line per epoch.

The train engine is chosen as the JAX Trainer chooses it
(``_use_fused_train``, mcan_vqa_tpu/train/trainer.py:540-567, a CUDA
device standing where JAX has a TPU): ``cfg.train_engine`` "plain" -> the
plain engine; "fused" -> the fused engine (on the CPU its kernels' plain
versions, the test-only route); "auto" -> the fused engine on a CUDA
device at hidden % 128 == 0 and hidden <= 1024, else the plain one. The
plain engine is the model in plain PyTorch ops under autograd, with
dropout. The fused engine is ``make_fused_train_forward``, routed by width
as the JAX Trainer routes it (trainer.py:264-281): every decoder block
through the SGA train kernels; at hidden <= 512 (MCAN-small) every encoder
block through the SA train kernels too; at hidden > 512 (MCAN-large) the
encoder plain and the decoder blocks saving their projections
(``att_saves``) and their saves in bf16 (``bf16_saves``). On a CUDA device
its blocks draw their dropout inside the kernels (``in_kernel_dropout``,
JAX's ``on_tpu``, trainer.py:243, :280); on the CPU they read external
masks.
Evaluation, resume, the classifier and MIMIC tasks and preemption handling
are not ported: asking for them raises.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, Optional

import torch

from mcan_vqa_tpu_torch.data.pipeline import BatchLoader
from mcan_vqa_tpu_torch.device import resolve_device
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.train.checkpoint import save_checkpoint
from mcan_vqa_tpu_torch.train.fused_engine import make_fused_train_forward
from mcan_vqa_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from mcan_vqa_tpu_torch.train.step import make_train_step
from mcan_vqa_tpu_torch.train.train_state import TrainState
from mcan_vqa_tpu_torch.utils.logging import RunLogger


def engine_route(hidden_size: int) -> dict:
    """The JAX Trainer's choice of train engine by width
    (trainer.py:264-281): the fused SA encoder at hidden <= 512, the
    decoder's att_saves and bf16_saves above."""
    wide = hidden_size > 512
    return dict(fused_encoder=not wide, att_saves=wide, bf16_saves=wide)


def use_fused_train(cfg, device: torch.device) -> bool:
    """The JAX Trainer's ``_use_fused_train`` (trainer.py:540-567) on this
    device: "plain" never, "fused" always, "auto" on a CUDA device (JAX: a
    TPU) at hidden % 128 == 0 and hidden <= 1024."""
    if cfg.train_engine == "plain":
        return False
    if cfg.train_engine == "fused":
        return True
    return (device.type == "cuda" and cfg.hidden_size % 128 == 0
            and cfg.hidden_size <= 1024)


def engine_line(hidden_size: int, fused: bool = True,
                in_kernel_dropout: bool = False,
                dropout_bits: int = 32) -> str:
    """The log line that says which engine runs (trainer.py:246, :284)."""
    if not fused:
        return (f"train engine: plain (autograd over plain ops, "
                f"dropout_bits={dropout_bits})")
    if engine_route(hidden_size)["fused_encoder"]:
        return (f"train engine: fused SGA train blocks + fused SA encoder "
                f"(in_kernel_dropout={in_kernel_dropout})")
    return (f"train engine: fused SGA train blocks (att_saves, bf16_saves), "
            f"encoder plain (in_kernel_dropout={in_kernel_dropout})")


class Trainer:
    def __init__(self, cfg, train_dataset, eval_datasets: Optional[Dict] = None,
                 task: str = "vqa", device="cuda"):
        """cfg: a ``Config``; train_dataset: a dataset with ``example(i)``,
        ``token_size``, ``ans_size`` and ``pretrained_emb`` (for example
        ``SyntheticVQADataset``). device: "cuda" by default; with no CUDA
        device it raises unless the caller passes device="cpu"."""
        if task != "vqa":
            raise NotImplementedError(
                f"task={task!r}: only VQA training is ported so far")
        if eval_datasets:
            raise NotImplementedError("evaluation is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_dataset = train_dataset
        self.model = MCANet(
            cfg, train_dataset.token_size, train_dataset.ans_size,
            pretrained_emb=getattr(train_dataset, "pretrained_emb", None),
            generator=torch.Generator().manual_seed(cfg.seed)
        ).to(self.device)
        self.lr_schedule = make_lr_schedule(
            cfg.lr_base, len(train_dataset), cfg.batch_size,
            decay_epochs=tuple(cfg.lr_decay_list),
            decay_rate=cfg.lr_decay_rate)
        self.state = TrainState.create(
            self.model, make_optimizer(self.model.parameters(), cfg),
            seed=cfg.seed)
        self.fused = use_fused_train(cfg, self.device)
        self.build_step(self.fused and self.device.type == "cuda")
        self.logger = RunLogger(cfg.log_path, cfg.run_version, cfg.to_dict(),
                                echo=cfg.verbose)

    def build_step(self, in_kernel_dropout: bool) -> None:
        """The train forward and step of the chosen engine, the fused
        blocks' dropout drawn inside their kernels (the Trainer's choice
        on the card) or read from generator masks (the CPU's route;
        ``cli/profile_train.py --in_kernel_dropout 0`` times it on the
        card)."""
        cfg = self.cfg
        self.in_kernel_dropout = self.fused and in_kernel_dropout
        route = (engine_route(cfg.hidden_size) if self.fused
                 else dict(sga_block="plain", fused_encoder=False))
        self.forward_fn = make_fused_train_forward(
            cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
            dropout_bits=cfg.dropout_bits,
            in_kernel_dropout=self.in_kernel_dropout, **route)
        self.step_fn = make_train_step(
            self.forward_fn, grad_accu_steps=cfg.grad_accu_steps,
            reg_factor=cfg.reg_factor, lr_schedule=self.lr_schedule,
            grad_norm_clip=cfg.grad_norm_clip)

    def loader(self) -> BatchLoader:
        return BatchLoader(self.train_dataset, self.cfg.batch_size,
                           self.device, shuffle=True, drop_last=True,
                           seed=self.cfg.seed)

    def train(self) -> TrainState:
        """Epochs 0 .. max_epoch - 1 from a fresh state: this version's
        earlier checkpoints and logs are cleared first (the reference's
        fresh run, core/exec.py:96-102)."""
        cfg = self.cfg
        ckpt_dir = os.path.join(cfg.ckpts_dir, f"ckpt_{cfg.run_version}")
        if os.path.isdir(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        self.logger.clear()
        self.logger.write(f"NOW TIME: {time.strftime('%Y-%m-%d %H:%M:%S')}")
        line = engine_line(cfg.hidden_size, self.fused,
                           self.in_kernel_dropout, cfg.dropout_bits)
        self.logger.write(f"{line} (device {self.device})")
        loader = self.loader()
        state = self.state
        for epoch in range(cfg.max_epoch):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            loss_sum, n_steps, lr = 0.0, 0, 0.0
            for batch in loader:
                metrics = self.step_fn(state, batch)
                loss_sum += float(metrics["loss"])
                lr = float(metrics["lr"])
                n_steps += 1
            path = save_checkpoint(state, cfg.ckpts_dir, cfg.run_version,
                                   epoch + 1, cfg.lr_base)
            self.logger.epoch(epoch, {
                "loss": loss_sum / max(n_steps, 1), "lr": lr,
                "steps": n_steps, "wall_s": time.perf_counter() - t0,
                "checkpoint": path})
        return state
