"""Training and evaluation for VQA and for the image-only classifier
(mcan_vqa_tpu/train/trainer.py; the reference's Execution,
core/exec.py:27-426, and ExecClassify, :757-1066).

``Trainer(cfg, train_dataset, eval_datasets).train()`` runs the epochs: a
shuffled, drop-last loader onto the device, one train step per batch (the
fused forward, the BCE loss, AdamW under the warmup / decay schedule), a
reference pickle after every epoch, then (``cfg.eval_every_epoch``) an
evaluation of each eval dataset on its cadence, one log line each, and one
log line per epoch. ``predict`` and ``evaluate`` score a dataset on the
current weights: every example once, in order, in batches of
``cfg.eval_batch_size`` with the last one repeat-padded; ``evaluate`` adds
the official VQA accuracy where the dataset carries annotations, ROC-AUC
where its examples carry targets, the EvalAI dump and the prediction dump.

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

``cfg.stacked_params="on"`` (JAX's trainer.py:265-304; "auto" resolves
off) trains the fused VQA engine from the stacked layout
(``ops/stacked_params.py``): ``train`` turns the standard state into the
stacked one after restoring it (``stacked_state``), and back into the
standard ``self.state`` at each boundary (``sync_state``): before every
epoch pickle, and so before the evaluations and the calibration that
follow it, and before it returns. The pickles keep the standard format.
Elsewhere (the plain engine, the classifier, a model axis > 1) "on" is
ignored with a log line, as in JAX.

The eval engine is chosen as the JAX Trainer's ``_use_fused_eval``
(trainer.py:569-585): ``cfg.eval_engine`` "plain" -> the plain model with
dropout off (``make_eval_step``); "fused" -> the shipped serving engine,
``build_production_engine`` at int8 level 1 with the bf16 stream (on the
CPU its kernels' plain versions, the test-only route); "auto" -> the
serving engine on a CUDA device, else plain. The serving engine is built
again from the current weights at each ``predict``, as JAX prepares its
parameters per call (trainer.py:602-668): mid-training evaluations see the
weights of that epoch.

The checkpoint lifecycle is the JAX Trainer's (trainer.py:108-537): under
``cfg.resume`` the state is restored from the pickle the ``ckpt_*``
fields name (weights, AdamW moments, step count: ``train/checkpoint.py::
resume_state``) and the epochs go on from ``ckpt_epoch``; each step's
dropout depends only on the seed and the step count, so the resumed run
trains as the unbroken one. SIGTERM / SIGINT ask for a checkpoint at the
next step boundary and a clean return. ``ckpt_async`` writes the pickles
on a worker thread, ``keep_last_ckpts`` prunes the older ones, and
``ckpt_calibrate`` stores static int8 activation scales calibrated on the
last train batch beside the last pickle, which ``Predictor.
from_checkpoint`` serves at level 3.

``task="classify"`` (trainer.py:38-77) trains ``ClassifierNet``, the
image-only multi-label classifier, on batches whose "ques" it does not
read: the fused engine is ``make_fused_classifier_forward`` (every SA
block through the SA train kernels at every width the fused engine takes,
the same ``use_fused_train`` rule), the penalty under ``reg_factor`` is
SmoothL1 (trainer.py:309), and every ``cfg.eval_interval`` steps each eval
dataset is scored in the epoch, one ``  [step N] <name>: {...}`` log line
each (trainer.py:385-394). Its fused eval engine is
``build_production_classifier_engine`` at level 1, and its end-of-train
calibration stores the level-3 scales of that engine.

MIMIC-CXR medical VQA trains as the JAX package trains it: task "vqa" on a
``MIMICDataset`` (a few labels, multi-hot targets, 1024-d image rows), the
L1 + L2 penalty under ``reg_factor``, ROC-AUC in ``evaluate``, and
``warm_start`` from a VQA checkpoint (``cli/run_mimic.py``).

``cfg.mesh_shape`` (JAX's field, trainer.py:81) builds the mesh over the
process group the caller joined (``parallel/mesh.py``; a world of one
without one). Each data rank loads its rows of every global batch (the
data index and size into ``BatchLoader``) and runs the whole step on them:
the fused engine per data rank, as JAX's ``shard_map`` runs it
(trainer.py:286-322), its in-kernel seeds from the rank-folded generator;
the loss and gradients summed over the data group (``train/step.py``). At
a model axis > 1 the model is this rank's Megatron shard
(``shard_module_``) and the engines are the plain ones: the fused engines
refuse tensor parallelism and more than one node, where JAX refuses a
model axis and more than one process (trainer.py:550-554, :578).
``predict`` runs each rank's slice and gathers probabilities, qids,
valid and targets in rank order on the CPU backend, so every rank returns
the full result (JAX's ``process_allgather``, trainer.py:683-700). Rank 0
alone writes the logs, the pickles (the unsharded one a single card
writes, ``full_state_dicts``) and the end-of-train calibration (itself
only at tp = 1 on one node, trainer.py:462-468). SIGTERM on any rank stops
every rank at the same step boundary: one ``all_reduce(MAX)`` of the stop
flag per step.
"""

from __future__ import annotations

import os
import shutil
import signal
import sys
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mcan_vqa_tpu_torch.data.pipeline import BatchLoader
from mcan_vqa_tpu_torch.device import resolve_device
from mcan_vqa_tpu_torch.evals import vqa_eval
from mcan_vqa_tpu_torch.evals.roc_auc import multilabel_roc_auc
from mcan_vqa_tpu_torch.models.net import ClassifierNet, MCANet
from mcan_vqa_tpu_torch.ops.quant import calibrate_classifier_act_scales
from mcan_vqa_tpu_torch.ops.stacked_params import (from_stacked_state,
                                                   to_stacked_state)
from mcan_vqa_tpu_torch.ops.serving import (
    build_production_classifier_engine, build_production_engine,
    calibrate_serving_scales, prepare_production_classifier_params)
from mcan_vqa_tpu_torch.parallel.mesh import make_mesh
from mcan_vqa_tpu_torch.parallel.sharding import (all_gather_rows,
                                                  shard_dim, shard_module_,
                                                  shard_tensor)
from mcan_vqa_tpu_torch.train.checkpoint import (
    AsyncCheckpointSaver, checkpoint_path, full_state_dicts,
    load_reference_checkpoint, merge_compatible, prune_checkpoints,
    resume_state, save_act_scales, save_checkpoint)
from mcan_vqa_tpu_torch.train.fused_engine import (
    make_fused_classifier_forward, make_fused_train_forward)
from mcan_vqa_tpu_torch.train.optim import make_lr_schedule, make_optimizer
from mcan_vqa_tpu_torch.train.step import make_eval_step, make_train_step
from mcan_vqa_tpu_torch.train.train_state import TrainState
from mcan_vqa_tpu_torch.utils.logging import RunLogger, StepMeter
from mcan_vqa_tpu_torch.utils.profiling import StepTimer, trace


def engine_route(hidden_size: int) -> dict:
    """The JAX Trainer's choice of train engine by width
    (trainer.py:264-281): the fused SA encoder at hidden <= 512, the
    decoder's att_saves and bf16_saves above."""
    wide = hidden_size > 512
    return dict(fused_encoder=not wide, att_saves=wide, bf16_saves=wide)


def use_fused_train(cfg, device: torch.device, mesh=None) -> bool:
    """The JAX Trainer's ``_use_fused_train`` (trainer.py:540-567) on this
    device: "plain" never; never on a mesh with a model axis > 1 or over
    more than one node (JAX: more than one process); "fused" else always,
    "auto" on a CUDA device (JAX: a TPU) at hidden % 128 == 0 and hidden
    <= 1024."""
    if cfg.train_engine == "plain":
        return False
    if mesh is not None and (mesh.tp > 1 or mesh.nodes > 1):
        return False
    if cfg.train_engine == "fused":
        return True
    return (device.type == "cuda" and cfg.hidden_size % 128 == 0
            and cfg.hidden_size <= 1024)


def make_train_forward(cfg, fused: bool, in_kernel_dropout: bool,
                       image_only: bool = False, model_group=None):
    """The train forward of the chosen engine: the fused blocks routed by
    width (``engine_route``), their dropout drawn inside the kernels or read
    from generator masks, or the plain engine (tensor-parallel over
    ``model_group``). image_only: the classifier's
    (``make_fused_classifier_forward``: no routing by width)."""
    if image_only:
        return make_fused_classifier_forward(
            cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
            sa_block="fused" if fused else "plain",
            dropout_bits=cfg.dropout_bits,
            in_kernel_dropout=fused and in_kernel_dropout,
            model_group=model_group)
    route = (engine_route(cfg.hidden_size) if fused
             else dict(sga_block="plain", fused_encoder=False))
    return make_fused_train_forward(
        cfg.layer, cfg.multi_head, dropout_rate=cfg.dropout_rate,
        dropout_bits=cfg.dropout_bits,
        in_kernel_dropout=fused and in_kernel_dropout,
        model_group=model_group, **route)


def use_fused_eval(cfg, device: torch.device, mesh=None) -> bool:
    """The JAX Trainer's ``_use_fused_eval`` (trainer.py:569-585) on this
    device: "plain" never; never on a mesh with a model axis > 1; "fused"
    else always, "auto" on a CUDA device (JAX: a TPU) on one node (JAX:
    one process)."""
    if cfg.eval_engine == "plain":
        return False
    if mesh is not None and mesh.tp > 1:
        return False
    if cfg.eval_engine == "fused":
        return True
    return device.type == "cuda" and (mesh is None or mesh.nodes == 1)


def eval_engine_line(fused: bool, image_only: bool = False) -> str:
    """The log line that says which eval engine runs."""
    if fused:
        build_fn = ("build_production_classifier_engine" if image_only
                   else "build_production_engine")
        return (f"eval engine: fused ({build_fn}, int8 level 1, bf16 stream; "
                f"rebuilt from the weights at each evaluation)")
    return "eval engine: plain (the model's forward, f32, no dropout)"


def engine_line(hidden_size: int, fused: bool = True,
                in_kernel_dropout: bool = False,
                dropout_bits: int = 32, image_only: bool = False) -> str:
    """The log line that says which engine runs (trainer.py:246, :284)."""
    if not fused:
        return (f"train engine: plain (autograd over plain ops, "
                f"dropout_bits={dropout_bits})")
    if image_only:
        return (f"train engine: fused SA blocks (classifier, "
                f"in_kernel_dropout={in_kernel_dropout})")
    if engine_route(hidden_size)["fused_encoder"]:
        return (f"train engine: fused SGA train blocks + fused SA encoder "
                f"(in_kernel_dropout={in_kernel_dropout})")
    return (f"train engine: fused SGA train blocks (att_saves, bf16_saves), "
            f"encoder plain (in_kernel_dropout={in_kernel_dropout})")


class Trainer:
    def __init__(self, cfg, train_dataset=None,
                 eval_datasets: Optional[Dict] = None,
                 eval_cadence: Optional[Dict[str, int]] = None,
                 task: str = "vqa", device="cuda"):
        """cfg: a ``Config``; train_dataset / the eval datasets: datasets
        with ``example(i)``, ``token_size``, ``ans_size`` and
        ``pretrained_emb`` (``VQADataset``, ``SyntheticVQADataset``,
        ``MIMICDataset``, ``SyntheticMIMICDataset``); the model is sized
        by the train dataset, else by the first eval dataset. eval_datasets: {name:
        dataset} evaluated after each epoch under ``cfg.eval_every_epoch``
        (and with task "classify" every ``cfg.eval_interval`` steps);
        eval_cadence: {name: N}, that dataset only every N epochs (epochs
        0, N, 2N, ...; the others every epoch). task: "vqa" (``MCANet``) or
        "classify" (``ClassifierNet``, image only). device: "cuda" by
        default; with no CUDA device it raises unless the caller passes
        device="cpu"; on a mesh this rank's device (``init_distributed``
        gives it)."""
        if task not in ("vqa", "classify"):
            raise ValueError(f"task must be 'vqa' or 'classify', got "
                             f"{task!r}")
        self.cfg = cfg
        self.task = task
        self.image_only = task == "classify"
        self.device = resolve_device(device)
        self.mesh = mesh = make_mesh(dict(cfg.mesh_shape))
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside the "
                             f"{mesh.dp}x{mesh.tp} mesh {cfg.mesh_shape}")
        self.rank0 = mesh.rank == 0
        if train_dataset is not None and \
                (cfg.batch_size // mesh.dp) % cfg.grad_accu_steps:
            raise ValueError(
                f"batch_size {cfg.batch_size} over {mesh.dp} data ranks "
                f"does not split into {cfg.grad_accu_steps} micro-batches")
        self.train_dataset = train_dataset
        self.eval_datasets = dict(eval_datasets or {})
        self.eval_cadence = dict(eval_cadence or {})
        ref = train_dataset if train_dataset is not None else next(
            iter(self.eval_datasets.values()), None)
        if ref is None:
            raise ValueError("Trainer needs a train_dataset or eval_datasets")
        self.ix_to_ans = getattr(ref, "ix_to_ans", None)
        generator = torch.Generator().manual_seed(cfg.seed)
        if self.image_only:
            model = ClassifierNet(cfg, ref.ans_size, generator=generator)
        else:
            model = MCANet(
                cfg, ref.token_size, ref.ans_size,
                pretrained_emb=getattr(ref, "pretrained_emb", None),
                generator=generator)
        self.model = shard_module_(model, mesh.tp, mesh.model_index,
                                   mesh.model_group).to(self.device)
        self.data_size = len(train_dataset) if train_dataset is not None \
            else cfg.batch_size
        self.lr_schedule = make_lr_schedule(
            cfg.lr_base, self.data_size, cfg.batch_size,
            decay_epochs=tuple(cfg.lr_decay_list),
            decay_rate=cfg.lr_decay_rate)
        self.state = TrainState.create(
            self.model, make_optimizer(self.model.parameters(), cfg),
            seed=cfg.seed)
        self._state_settled = False    # resumed or warm-started already
        self.fused = use_fused_train(cfg, self.device, mesh)
        # the stacked layout rides the fused VQA train engine only
        # (trainer.py:265-301); "auto" resolves off
        self.stacked_requested = cfg.stacked_params in ("on", True)
        self.stacked = self.stacked_requested and self.fused \
            and not self.image_only
        self.build_step(self.fused and self.device.type == "cuda")
        self.fused_eval = use_fused_eval(cfg, self.device, mesh)
        self.eval_step = make_eval_step(self.model)
        self.logger = RunLogger(cfg.log_path, cfg.run_version, cfg.to_dict(),
                                echo=cfg.verbose, enabled=self.rank0)

    def build_step(self, in_kernel_dropout: bool) -> None:
        """The train forward and step of the chosen engine, the fused
        blocks' dropout drawn inside their kernels (the Trainer's choice
        on the card) or read from generator masks (the CPU's route;
        ``cli/profile_train.py --in_kernel_dropout 0`` times it on the
        card)."""
        cfg = self.cfg
        self.in_kernel_dropout = self.fused and in_kernel_dropout
        self.forward_fn = make_train_forward(cfg, self.fused,
                                             in_kernel_dropout,
                                             self.image_only,
                                             self.mesh.model_group)
        self.step_fn = make_train_step(
            self.forward_fn, grad_accu_steps=cfg.grad_accu_steps,
            reg_factor=cfg.reg_factor, lr_schedule=self.lr_schedule,
            reg_mode="smooth_l1" if self.image_only else "l1l2",
            grad_norm_clip=cfg.grad_norm_clip,
            per_param_norms=cfg.grad_norm_log_every > 0,
            image_only=self.image_only, data_group=self.mesh.data_group,
            model_group=self.mesh.model_group)

    def stacked_state(self) -> TrainState:
        """The train state in the stacked layout
        (``ops/stacked_params.to_stacked_state``) of the current standard
        one: its encoder stacked where the SA train blocks run it."""
        return to_stacked_state(
            self.ensure_state(),
            encoder=engine_route(self.cfg.hidden_size)["fused_encoder"])

    def sync_state(self, state: TrainState) -> TrainState:
        """The standard state brought up to ``state`` (stacked, or the
        standard one itself): the boundary before a checkpoint, an
        evaluation, the calibration and the return of ``train``."""
        return from_stacked_state(state, into=self.state)

    def loader(self) -> BatchLoader:
        """This data rank's rows of every shuffled global batch."""
        return BatchLoader(self.train_dataset, self.cfg.batch_size,
                           self.device, shuffle=True, drop_last=True,
                           seed=self.cfg.seed,
                           process_index=self.mesh.data_index,
                           process_count=self.mesh.dp)

    def local_state_dict(self, sd):
        """An unsharded state_dict -> this model rank's shard of each
        tensor that splits (a tensor of another shape is left whole, for
        ``merge_compatible`` to skip)."""
        tp, index = self.mesh.tp, self.mesh.model_index
        out = {}
        for k, v in sd.items():
            dim = shard_dim(k)
            out[k] = v if dim is None or v.dim() <= dim or v.shape[dim] % tp \
                else shard_tensor(v, dim, tp, index)
        return out

    def ensure_state(self, resume: Optional[bool] = None) -> TrainState:
        """The train state, restored once from the checkpoint the config
        names when ``resume`` (None: ``cfg.resume``) asks for it
        (trainer.py:108-120)."""
        do_resume = self.cfg.resume if resume is None else resume
        if do_resume and not self._state_settled:
            resume_state(self.state, self.cfg, self.data_size, self.logger,
                         self.mesh)
            self._state_settled = True
        return self.state

    def warm_start(self, path: str) -> None:
        """Shape-compatible weights from a reference pickle, the rest kept
        (``merge_compatible``), with a fresh optimizer and step 0
        (trainer.py:167-179; the MIMIC warm start from the VQA zoo,
        core/exec.py:468-475)."""
        if not path.endswith((".pkl", ".pt", ".pth")):
            raise NotImplementedError(
                f"{path}: only reference pickles load into the port")
        self.model.load_state_dict(merge_compatible(
            self.model.state_dict(),
            self.local_state_dict(load_reference_checkpoint(path)),
            self.logger))
        self.state = TrainState.create(
            self.model, make_optimizer(self.model.parameters(), self.cfg),
            seed=self.cfg.seed)
        self._state_settled = True

    def _save_epoch(self, saver, state, epoch: int) -> str:
        """The epoch pickle, through the async saver or at once, then the
        pruning of older epochs. On a mesh every rank calls this: the
        unsharded state goes to rank 0's writer (its saver, the only one),
        then a barrier."""
        cfg = self.cfg
        args = (cfg.ckpts_dir, cfg.run_version, epoch, cfg.lr_base)
        mesh = self.mesh if self.mesh.distributed else None
        if saver is not None:
            path = saver.save_dicts(*full_state_dicts(state, mesh), *args,
                                    keep_last=cfg.keep_last_ckpts)
            if mesh is not None:
                mesh.barrier()
            return path
        path = save_checkpoint(state, *args, mesh=mesh)
        if self.rank0:
            prune_checkpoints(cfg.ckpts_dir, cfg.run_version,
                              cfg.keep_last_ckpts)
        return path

    def train(self, start_epoch: int = 0) -> TrainState:
        """Epochs ``start_epoch`` .. max_epoch - 1 (trainer.py:182-484).
        A fresh run (not ``cfg.resume``, start epoch 0, no state restored
        or warm-started yet) clears this version's earlier checkpoints and
        logs first (core/exec.py:96-102);
        under ``cfg.resume`` the state is restored (``ensure_state``) and
        the loop starts at max(start_epoch, cfg.ckpt_epoch).

        Preemption-safe: SIGTERM / SIGINT set a flag, and the next step
        boundary saves the epoch's checkpoint, logs ``preempted_at_step``
        and returns; the old handlers come back on the way out (a thread
        other than the main one runs without handlers). ``ckpt_async``
        writes the pickles on a worker thread, flushed on the way out: its
        error is raised on a clean exit and logged while another exception
        unwinds. ``keep_last_ckpts`` prunes; ``grad_norm_log_every`` writes
        ``grad_norm_sums`` JSONL lines; the epochs run inside
        ``trace(cfg.profile_dir)``. With task "classify" each eval dataset
        is scored every ``cfg.eval_interval`` steps of an epoch, one
        ``  [step N] <name>: {...}`` line each. Last, under
        ``ckpt_calibrate``, the
        serving scales from the last train batch go beside the last pickle
        (``_save_serving_calibration``), best-effort: a failure is logged
        and the run kept."""
        cfg = self.cfg
        if self.train_dataset is None:
            raise ValueError("train() needs a train_dataset")
        # a state already restored or warm-started keeps the version's
        # log (its warm-start skip lines) and checkpoints, as the JAX
        # Trainer keeps them once its state exists (trainer.py:192)
        if not cfg.resume and start_epoch == 0 and not self._state_settled:
            ckpt_dir = os.path.join(cfg.ckpts_dir, f"ckpt_{cfg.run_version}")
            if self.rank0 and os.path.isdir(ckpt_dir):
                shutil.rmtree(ckpt_dir)
            self.logger.clear()
            self.logger.header()
            self.mesh.barrier()
        state = self.ensure_state()
        line = engine_line(cfg.hidden_size, self.fused,
                           self.in_kernel_dropout, cfg.dropout_bits,
                           self.image_only)
        mesh_note = (f", mesh {self.mesh.dp}x{self.mesh.tp}"
                     if self.mesh.size > 1 else "")
        self.logger.write(f"{line} (device {self.device}{mesh_note})")
        if self.stacked:
            state = self.stacked_state()
            self.logger.write("stacked_params: on (the block weights train "
                              "as [L, ...] leaves in the kernels' layout)")
        elif self.stacked_requested:
            # say so: the layout rides the fused VQA train engine only
            self.logger.write(
                "stacked_params='on' ignored: the stacked layout applies "
                "only to the fused VQA train engine (not plain/classifier "
                "paths)")
        in_epoch_eval = (self.image_only and cfg.eval_interval > 0
                         and self.eval_datasets)
        if (cfg.eval_every_epoch or in_epoch_eval) and self.eval_datasets:
            self.logger.write(eval_engine_line(self.fused_eval,
                                               self.image_only))
        if cfg.resume:
            start_epoch = max(start_epoch, cfg.ckpt_epoch)
        loader = self.loader()
        stop = {"flag": False}

        def request_stop(signum, frame):
            stop["flag"] = True
            self.logger.write(f"signal {signum}: checkpoint-and-exit "
                              f"requested")

        old_handlers = {}
        saver = None
        last_inputs: Optional[Tuple[torch.Tensor, ...]] = None
        last_saved = None
        try:
            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    old_handlers[sig] = signal.signal(sig, request_stop)
            except ValueError:
                pass                  # not the main thread: no handlers
            saver = AsyncCheckpointSaver() \
                if cfg.ckpt_async and self.rank0 else None
            with trace(cfg.profile_dir):
                for epoch in range(start_epoch, cfg.max_epoch):
                    loader.set_epoch(epoch)
                    t0 = time.perf_counter()
                    meter = StepMeter(len(loader), enabled=cfg.verbose)
                    timer = StepTimer()
                    loss_sum, n_steps, lr = 0.0, 0, 0.0
                    norm_sums: Dict[str, float] = {}
                    for batch in loader:
                        # every rank stops at the same step boundary
                        if self.mesh.any_rank(stop["flag"]):
                            stop["flag"] = True
                            break
                        last_inputs = self._inputs(batch)
                        metrics = self.step_fn(state, batch)
                        loss_sum += float(metrics["loss"])
                        lr = float(metrics["lr"])
                        n_steps += 1
                        if "param_grad_norms" in metrics:
                            norms = metrics["param_grad_norms"]
                            values = torch.stack(list(norms.values()))
                            for name, v in zip(norms, values.tolist()):
                                norm_sums[name] = norm_sums.get(name, 0.0) + v
                            if n_steps % cfg.grad_norm_log_every == 0:
                                self.logger.jsonl({
                                    "epoch": epoch, "step": n_steps,
                                    "grad_norm_sums": norm_sums})
                        timer.tick()
                        meter.update({"loss": metrics["loss"], "lr": lr})
                        # the classifier's in-epoch evaluation
                        # (core/exec.py:940-951)
                        if in_epoch_eval and \
                                n_steps % cfg.eval_interval == 0:
                            for name, ds in self.eval_datasets.items():
                                self.logger.write(
                                    f"  [step {n_steps}] {name}: "
                                    f"{self.evaluate(ds)}")
                    if norm_sums:
                        self.logger.jsonl({"epoch": epoch, "step": n_steps,
                                           "grad_norm_sums": norm_sums,
                                           "final": True})
                    path = self._save_epoch(saver, self.sync_state(state),
                                            epoch + 1)
                    last_saved = epoch + 1
                    metrics = {"loss": loss_sum / max(n_steps, 1), "lr": lr,
                               "steps": n_steps,
                               "wall_s": time.perf_counter() - t0,
                               "step_ema_s": timer.ema or 0.0,
                               "checkpoint": path}
                    stop["flag"] = self.mesh.any_rank(stop["flag"])
                    if stop["flag"]:
                        self.logger.epoch(epoch, {
                            **metrics, "preempted_at_step": n_steps})
                        break
                    if cfg.eval_every_epoch:
                        for name, ds in self.eval_datasets.items():
                            if epoch % max(int(self.eval_cadence.get(name,
                                                                     1)), 1):
                                continue
                            res = self.evaluate(ds)
                            self.logger.write(f"epoch {epoch} eval {name}: "
                                              f"{res}")
                            metrics.update({f"{name}/{k}": v
                                            for k, v in res.items()
                                            if isinstance(v, float)})
                    self.logger.epoch(epoch, metrics)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
            if saver is not None:
                unwinding = sys.exc_info()[0] is not None
                try:
                    saver.close()
                except Exception:
                    if not unwinding:
                        raise
                    self.logger.write(
                        "async checkpoint flush failed during error unwind "
                        "(original exception propagates)")
        state = self.sync_state(state)
        # JAX's guard (trainer.py:462-468): no model axis, one node
        if cfg.ckpt_calibrate and last_inputs is not None \
                and last_saved is not None and self.rank0 \
                and self.mesh.tp == 1 and self.mesh.nodes == 1:
            try:
                self._save_serving_calibration(last_inputs, last_saved)
            except Exception as e:  # noqa: BLE001 (the run is kept)
                self.logger.write(
                    f"end-of-train serving calibration failed (the "
                    f"training run itself is unaffected): {e!r}")
        return state

    def _inputs(self, batch) -> Tuple[torch.Tensor, ...]:
        """The model's inputs of a batch: the image alone for the
        classifier, else the image and the question."""
        return (batch["img"],) if self.image_only else \
            (batch["img"], batch["ques"])

    def _save_serving_calibration(self, inputs, epoch: int) -> None:
        """Static int8 activation scales of the shipped serving engine from
        the last real train batch, the "aux" tuple from a second replay
        (``calibrate_serving_scales``), written beside epoch ``epoch``'s
        pickle (``save_act_scales``) so that ``Predictor.from_checkpoint``
        serves level 3 with no calibration step (trainer.py:463-537). The
        classifier's: the level-3 classifier engine's scales
        (``calibrate_classifier_act_scales``, trainer.py:497-510), which
        ``build_production_classifier_engine(act_scales=...)`` takes.
        Skipped, with a log line, at a width with no int8 site."""
        cfg = self.cfg
        sd = self.model.state_dict()
        if self.image_only:
            prepared = prepare_production_classifier_params(
                sd, cfg.layer, qffn=3, device=self.device)
            scales = None
            if "_mk" in prepared["backbone"]["enc_0"]:
                scales = calibrate_classifier_act_scales(
                    prepared, inputs[0], cfg.layer, cfg.multi_head)
        else:
            scales = calibrate_serving_scales(sd, *inputs, cfg.layer,
                                              cfg.multi_head, self.device)
        if scales is None:
            self.logger.write(
                "serving calibration skipped: model dims are outside the "
                "megakernel VMEM envelope (no int8 quant sites)")
            return
        path = save_act_scales(
            checkpoint_path(cfg.ckpts_dir, cfg.run_version, epoch), scales)
        self.logger.write(f"serving calibration scales -> {path}")

    def predict(self, dataset) -> Dict[str, np.ndarray]:
        """{"probs": [N, A] f32, "qids": [N]} and, where the examples carry
        targets, "targets" [N, A]: every example once, in order, through
        the eval engine on the current weights (the classifier's: its
        level-1 engine, or the plain eval step on the image). On a mesh
        each data rank runs its rows of every batch and every rank
        returns the whole result."""
        cfg = self.cfg
        if self.fused_eval:
            build = (build_production_classifier_engine if self.image_only
                     else build_production_engine)
            serve, prepared = build(self.model.state_dict(), cfg.layer,
                                    cfg.multi_head, device=self.device)

            def probs_of(*inputs):
                return torch.sigmoid(serve(prepared, *inputs).float())
        else:
            probs_of = self.eval_step
        mesh = self.mesh
        loader = BatchLoader(dataset, cfg.eval_batch_size, self.device,
                             shuffle=False, drop_last=False, seed=cfg.seed,
                             pad_final=True, process_index=mesh.data_index,
                             process_count=mesh.dp)
        probs_all, qids_all, targets_all = [], [], []
        with torch.no_grad():
            for batch in loader:
                rows = {"probs": probs_of(*self._inputs(batch)).cpu().numpy(),
                        "valid": batch["valid"], "qid": batch["qid"]}
                if "target" in batch:
                    rows["target"] = batch["target"].cpu().numpy()
                # the data ranks' rows in rank order (JAX's
                # process_allgather): every rank holds the whole batch
                rows = {k: all_gather_rows(np.asarray(v), mesh.data_group)
                        for k, v in rows.items()}
                valid = rows["valid"]
                probs_all.append(rows["probs"][valid])
                qids_all.append(rows["qid"][valid])
                if "target" in rows:
                    targets_all.append(rows["target"][valid])
        out = {"probs": np.concatenate(probs_all),
               "qids": np.concatenate(qids_all)}
        if targets_all:
            out["targets"] = np.concatenate(targets_all)
        return out

    def evaluate(self, dataset, dump_path: Optional[str] = None
                 ) -> Dict[str, Any]:
        """``predict``, then (trainer.py:715-775): the probabilities to
        ``<pred_path>/pred_run_<version>.npz`` under ``cfg.test_save_pred``;
        the top-1 answers to the EvalAI file ``dump_path``; ROC-AUC micro /
        macro where the examples carry targets; the official accuracy and
        its per-answer-type split over the dataset's annotations. An
        annotated question without a prediction is a warning in the log,
        or an error under ``cfg.eval_strict``."""
        cfg = self.cfg
        out = self.predict(dataset)
        results: Dict[str, Any] = {}
        if cfg.test_save_pred:
            pred_file = os.path.join(cfg.pred_path,
                                     f"pred_run_{cfg.run_version}.npz")
            if self.rank0:
                os.makedirs(cfg.pred_path, exist_ok=True)
                np.savez_compressed(pred_file, probs=out["probs"],
                                    qids=out["qids"])
            results["pred_path"] = pred_file

        answers = None
        if self.ix_to_ans:
            # str keys (the frozen VQA dictionary) or int keys
            def decode(i):
                i = int(i)
                return self.ix_to_ans.get(str(i),
                                          self.ix_to_ans.get(i, str(i)))
            answers = [decode(i) for i in out["probs"].argmax(axis=1)]
        if dump_path and answers is not None:
            if self.rank0:
                vqa_eval.dump_results(out["qids"], answers, dump_path)
            results["dump_path"] = dump_path

        if "targets" in out:
            roc = multilabel_roc_auc(out["targets"] > 0.5, out["probs"])
            results["roc_micro"] = roc["micro"]
            results["roc_macro"] = roc["macro"]

        ans_list = getattr(dataset, "ans_list", None)
        if ans_list and answers is not None:
            gts = {a["question_id"]: {
                "answers": [x["answer"] for x in a["answers"]],
                "question_type": a.get("question_type", "unknown"),
                "answer_type": a.get("answer_type", "unknown")}
                for a in ans_list}
            res_map = dict(zip((int(q) for q in out["qids"]), answers))
            common = {q: g for q, g in gts.items() if q in res_map}
            if len(common) != len(gts):
                msg = (f"evaluate: predictions cover {len(common)}/{len(gts)}"
                       f" annotated questions; accuracy is over the"
                       f" intersection only")
                if cfg.eval_strict:
                    raise ValueError(msg)
                self.logger.write(f"WARNING: {msg}")
            if common:
                acc = vqa_eval.evaluate(common, res_map)
                results["accuracy"] = acc["overall"]
                results["perAnswerType"] = acc["perAnswerType"]
        return results
