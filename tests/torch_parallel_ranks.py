"""Rank workers of tests/test_torch_parallel.py: the port on a gloo process
group of CPU ranks, with no JAX in the process (the parent holds the
results against the JAX package).

    python tests/torch_parallel_ranks.py --rank R --world 4 --out DIR

Every rank joins one process group (gloo, a FileStore in DIR, one torch
thread), then runs every case in one order, each case's meshes made by
every rank (``new_group`` is collective): the train steps of ``STEP_CASES``
(SGD(1.0), so a parameter's change is its gradient; the plain engine's
operands in f32, the regime of JAX's compute_dtype="float32" oracles),
then the dp2 x tp2 Trainer (train, checkpoint, resume, evaluate), a
SIGTERM on one rank of it, then the fused dp2 classifier and MIMIC runs.
Rank 0 writes each case's numbers to DIR/<case>.npz; each rank writes its
own ``predict`` result, and DIR/done_<rank> at the end. The inputs are
made from seeds with numpy, as the parent makes JAX's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(hidden_size=32, ff_size=128, layer=2, multi_head=4,
            img_feat_size=16, flat_out_size=32, flat_mlp_size=16)
TOKENS, ANSWERS, BATCH, REGIONS, QLEN = 30, 10, 16, 6, 5
# name -> (mesh shape, grad_accu_steps, train engine, reg_factor)
STEP_CASES = {
    "dp2": ({"data": 2, "model": 1}, 1, "plain", 0.0),
    "tp2": ({"data": 1, "model": 2}, 1, "plain", 0.0),
    "dp2tp2": ({"data": 2, "model": 2}, 2, "plain", 0.0),
    "dp2_reg_accu1": ({"data": 2, "model": 1}, 1, "plain", 1e-3),
    "dp2_reg_accu2": ({"data": 2, "model": 1}, 2, "plain", 1e-3),
    "fused_dp2_reg": ({"data": 2, "model": 1}, 2, "fused", 1e-3),
}
TRAINER = dict(hidden_size=32, ff_size=128, layer=1, multi_head=4,
               img_feat_size=16,
               img_feat_pad_size=8, max_token=6, flat_out_size=32,
               flat_mlp_size=16, batch_size=16, lr_base=3e-3,
               verbose=False, eval_every_epoch=False, use_glove=False)


def step_batch():
    """The batch of the JAX package's sharding tests (test_parallel.py)."""
    rng = np.random.default_rng(0)
    return {
        "img": rng.normal(size=(BATCH, REGIONS, 16)).astype(np.float32),
        "ques": rng.integers(1, TOKENS, size=(BATCH, QLEN)).astype(np.int32),
        "target": (rng.random((BATCH, ANSWERS)) < 0.2).astype(np.float32)}


def step_config(accu: int, reg: float):
    from mcan_vqa_tpu_torch.configs import Config
    return Config(**TINY, batch_size=BATCH, grad_accu_steps=accu,
                  dropout_rate=0.0, reg_factor=reg, use_glove=False)


def step_model(cfg):
    """The seeded MCANet every case starts from (the parent carries its
    weights into JAX)."""
    import torch

    from mcan_vqa_tpu_torch.models.net import MCANet
    return MCANet(cfg, TOKENS, ANSWERS,
                  generator=torch.Generator().manual_seed(0))


def full_grads(model, mesh):
    """{key: the unsharded gradient} (gathered over the model group)."""
    from mcan_vqa_tpu_torch.parallel.sharding import gather_shards, shard_dim
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    if mesh.tp > 1:
        grads.update(gather_shards(
            {n: (g, shard_dim(n)) for n, g in grads.items()
             if shard_dim(n) is not None}, mesh.model_group, mesh.tp))
    return {n: g.numpy() for n, g in grads.items()}


def run_step(name: str, out: Path) -> None:
    import torch

    from mcan_vqa_tpu_torch.models.layers import operand_dtype
    from mcan_vqa_tpu_torch.parallel.mesh import make_mesh
    from mcan_vqa_tpu_torch.parallel.sharding import shard_module_
    from mcan_vqa_tpu_torch.train.fused_engine import make_fused_train_forward
    from mcan_vqa_tpu_torch.train.step import make_train_step
    from mcan_vqa_tpu_torch.train.train_state import TrainState
    shape, accu, engine, reg = STEP_CASES[name]
    mesh = make_mesh(shape)
    if not mesh.member:
        return
    cfg = step_config(accu, reg)
    model = shard_module_(step_model(cfg), mesh.tp, mesh.model_index,
                          mesh.model_group)
    state = TrainState.create(model, torch.optim.SGD(model.parameters(),
                                                     lr=1.0))
    fused = engine == "fused"
    forward = make_fused_train_forward(
        cfg.layer, cfg.multi_head, dropout_rate=0.0,
        sga_block="fused" if fused else "plain", fused_encoder=fused,
        model_group=mesh.model_group)
    step = make_train_step(forward, grad_accu_steps=accu, reg_factor=reg,
                           data_group=mesh.data_group,
                           model_group=mesh.model_group)
    per = BATCH // mesh.dp
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    batch = {k: torch.from_numpy(v[rows]) for k, v in step_batch().items()}
    with operand_dtype(torch.float32):
        metrics = step(state, batch)
    grads = full_grads(model, mesh)
    if mesh.rank == 0:
        np.savez(out / f"{name}.npz", loss=float(metrics["loss"]),
                 grad_norm=float(metrics["grad_norm"]),
                 **{f"grad/{k}": v for k, v in grads.items()})


def run_trainer(out: Path, rank: int) -> None:
    """dp2 x tp2 Trainer on SyntheticVQADataset: 2 epochs (8 steps), the
    epoch pickles, a resume from epoch 2 for a third epoch, evaluate."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    base = dict(TRAINER, mesh_shape={"data": 2, "model": 2},
                ckpts_dir=str(out / "ckpts"), log_path=str(out / "log"),
                version="mesh")
    cfg = Config(**base, max_epoch=2)
    ds = SyntheticVQADataset(cfg, size=64, token_size=40, answer_size=8)
    trainer = Trainer(cfg, train_dataset=ds, device="cpu")
    state = trainer.train()
    res = trainer.evaluate(ds)
    pred = trainer.predict(ds)
    np.savez(out / f"trainer_predict_{rank}.npz", **pred)
    resumed = Trainer(Config(**base, max_epoch=3, resume=True,
                             ckpt_epoch=2), train_dataset=ds, device="cpu")
    rstate = resumed.train()
    if rank == 0:
        np.savez(out / "trainer.npz", steps=state.step,
                 resumed_steps=rstate.step, roc_micro=res["roc_micro"],
                 fused=trainer.fused, fused_eval=trainer.fused_eval)


def run_preempt(out: Path, rank: int) -> None:
    """SIGTERM on rank 3 alone inside step 2 of a dp2 x tp2 epoch of 4:
    every rank stops at the same step boundary (a rank that stopped alone
    would hang the others in their next reduce)."""
    import signal

    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.vqa_dataset import SyntheticVQADataset
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    cfg = Config(**TRAINER, mesh_shape={"data": 2, "model": 2},
                 max_epoch=2, ckpts_dir=str(out / "preempt" / "ckpts"),
                 log_path=str(out / "preempt" / "log"), version="stop")
    ds = SyntheticVQADataset(cfg, size=64, token_size=40, answer_size=8)
    trainer = Trainer(cfg, train_dataset=ds, device="cpu")
    step_fn = trainer.step_fn

    def step(state, batch):
        metrics = step_fn(state, batch)
        if rank == 3 and state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    trainer.step_fn = step
    state = trainer.train()
    (out / f"preempt_{rank}.json").write_text(json.dumps(
        {"step": state.step}))


def run_fused_dp2(out: Path, rank: int, task: str) -> None:
    """The fused engines per data rank (dryrun_multichip): the classifier
    and MIMIC-flavoured VQA (multi-hot targets, L1 + L2 penalty), one step
    each at dp2 (ranks 2 and 3 make the mesh and sit out)."""
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.data.mimic import SyntheticMIMICDataset
    from mcan_vqa_tpu_torch.parallel.mesh import make_mesh
    from mcan_vqa_tpu_torch.train.trainer import Trainer
    shape = {"data": 2, "model": 1}
    if rank >= 2:
        make_mesh(shape)
        return
    cfg = Config(hidden_size=64, ff_size=256, layer=1, multi_head=4,
                 flat_mlp_size=32,
                 flat_out_size=64, img_feat_size=32, img_feat_pad_size=8,
                 max_token=6, batch_size=4, max_epoch=1, use_glove=False,
                 verbose=False, eval_interval=0, mesh_shape=shape,
                 train_engine="fused", eval_engine="fused",
                 reg_factor=1e-5 if task == "mimic" else 0.0,
                 ckpts_dir=str(out / task / "ckpts"),
                 log_path=str(out / task / "log"))
    ds = SyntheticMIMICDataset(cfg, size=4, answer_size=14,
                               run_mode="train")
    trainer = Trainer(cfg, train_dataset=ds, device="cpu",
                      task="classify" if task == "classify" else "vqa")
    state = trainer.train()
    res = trainer.evaluate(ds)
    pred = trainer.predict(ds)
    if rank == 0:
        np.savez(out / f"{task}.npz", steps=state.step,
                 fused=trainer.fused, fused_eval=trainer.fused_eval,
                 probs=pred["probs"], roc_micro=res["roc_micro"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)

    from mcan_vqa_tpu_torch.parallel.mesh import init_distributed
    out = Path(args.out)
    init_distributed(device="cpu", backend="gloo",
                     init_method=f"file://{out / 'store'}", rank=args.rank,
                     world_size=args.world)
    times = {}
    for name in STEP_CASES:
        t0 = time.perf_counter()
        run_step(name, out)
        times[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_trainer(out, args.rank)
    times["trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_preempt(out, args.rank)
    times["preempt"] = time.perf_counter() - t0
    for task in ("classify", "mimic"):
        t0 = time.perf_counter()
        run_fused_dp2(out, args.rank, task)
        times[task] = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    (out / f"done_{args.rank}").write_text(json.dumps(times))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
