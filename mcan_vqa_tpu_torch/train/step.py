"""The train step: loss, gradient accumulation, global-norm clip, AdamW
update; and the eval step (mcan_vqa_tpu/train/step.py).

Loss: BCE with logits, summed (reference core/model/net.py:373,
core/exec.py:67). Gradient accumulation: the batch is cut into
``grad_accu_steps`` micro-batches whose losses and gradients are summed
before one optimizer step (core/exec.py:163-208). An optional L1 + L2 or
smooth-L1 penalty is added to every micro-batch loss (core/exec.py:598-607,
922-926).

On a mesh (``parallel/``) the step follows JAX's ``data_axis``
(step.py:102-150) with explicit collectives, not
``DistributedDataParallel`` (which averages, where JAX sums a summed BCE):
each rank runs its local batch in micro-batches, the penalty divided by
the data size (every data rank holds the whole parameters), then the loss
and every gradient summed over the data group in one flat buffer before
the clip and AdamW, so the update is the same on every rank. Under tensor
parallelism the norms (the clip's, ``per_param_norms``) take each sharded
leaf's squares summed over the model group and each replicated leaf once,
and so does the penalty's value.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch

from mcan_vqa_tpu_torch.parallel.sharding import (all_reduce_,
                                                  all_reduce_flat_,
                                                  group_rank, group_size,
                                                  shard_dim)
from mcan_vqa_tpu_torch.train.train_state import TrainState


def bce_with_logits_sum(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """Sum-reduced binary cross-entropy on logits, in the stable form
    max(x, 0) - x z + log1p(exp(-|x|))."""
    x, z = logits.float(), targets.float()
    return (x.clamp_min(0.0) - x * z + torch.log1p(torch.exp(-x.abs()))).sum()


def l1_l2_penalty(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """sum |p| + sum p^2 over all parameters (core/exec.py:1298-1303)."""
    params = list(params)
    return (sum(p.abs().sum() for p in params)
            + sum(p.square().sum() for p in params))


def smooth_l1_penalty(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """sum over parameters of mean Huber(p, 0) (core/exec.py:922-926)."""
    def huber_mean(p):
        a = p.abs()
        return torch.where(a < 1.0, 0.5 * p * p, a - 0.5).mean()
    return sum(huber_mean(p) for p in params)


PENALTIES = {"l1l2": l1_l2_penalty, "smooth_l1": smooth_l1_penalty}


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over all gradients (optax.global_norm)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def make_train_step(forward_fn: Callable, grad_accu_steps: int = 1,
                    reg_factor: float = 0.0,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    reg_mode: str = "l1l2", grad_norm_clip: float = 0.0,
                    per_param_norms: bool = False, image_only: bool = False,
                    data_group=None, model_group=None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """-> step(state, batch) -> metrics, updating ``state`` in place.

    batch: {"img": [B, R, F] f32, "ques": [B, T] int, "target": [B, A] f32}
    on the model's device, B = grad_accu_steps x micro-batch.
    forward_fn(net, img, ques, generator) -> logits draws its dropout
    masks from ``state.generator``, which the step first re-seeds from the
    run's seed and its step count (``TrainState.seed_step``: JAX's
    ``fold_in(dropout_rng, step)``, step.py:118). grad_norm_clip > 0
    scales the gradients to that global norm where it is exceeded
    (optax.clip_by_global_norm); the reported grad_norm is the one before
    the clip. lr_schedule maps the step count before the update to the
    learning rate. per_param_norms: the metrics also hold
    "param_grad_norms", {parameter name: the L2 norm of its gradient x the
    clip's scale x grad_accu_steps} (JAX's bookkeeping, step.py:160-173,
    the reference's, core/exec.py:199-202). image_only: the classifier's
    step (JAX's ``image_only``, step.py:74-77): the forward is
    forward_fn(net, img, generator) and "ques" is not read; the classifier
    trains with ``reg_mode="smooth_l1"``. data_group / model_group: the
    mesh's (``parallel/mesh.py``; None where the axis has size 1): batch
    holds this rank's rows, the generator is seeded with the data index
    too (``TrainState.seed_step``), the loss and gradients are summed over
    the data group; ``state.model`` is this model rank's shard."""
    penalty = PENALTIES[reg_mode]
    dp, tp = group_size(data_group), group_size(model_group)
    data_index = group_rank(data_group) if dp > 1 else None
    # a sharded leaf's smooth-L1 mean is its shard's mean / tp
    shard_scale = 1.0 / tp if reg_mode == "smooth_l1" else 1.0

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        named = [(n, p) for n, p in state.model.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        sharded = [tp > 1 and shard_dim(n) is not None for n, _ in named]
        for p in params:
            p.grad = None
        state.seed_step(data_index)
        n = batch["img"].shape[0]
        if n % grad_accu_steps:
            raise ValueError(f"batch of {n} does not split into "
                             f"{grad_accu_steps} micro-batches")
        mb = n // grad_accu_steps
        loss_sum = torch.zeros((), device=batch["img"].device)
        shard_pen = torch.zeros((), device=batch["img"].device)
        for i in range(grad_accu_steps):
            sl = slice(i * mb, (i + 1) * mb)
            inputs = (batch["img"][sl],) if image_only else \
                (batch["img"][sl], batch["ques"][sl])
            logits = forward_fn(state.model, *inputs, state.generator)
            loss = bce_with_logits_sum(logits, batch["target"][sl])
            if reg_factor > 0.0 and tp > 1:
                pen_sh = reg_factor * shard_scale / dp * penalty(
                    [p for p, s in zip(params, sharded) if s])
                loss = loss + pen_sh + reg_factor / dp * penalty(
                    [p for p, s in zip(params, sharded) if not s])
                shard_pen += pen_sh.detach()
            elif reg_factor > 0.0:
                pen = reg_factor * penalty(params)
                loss = loss + (pen / dp if dp > 1 else pen)
            loss.backward()
            loss_sum += loss.detach()
        if tp > 1 and reg_factor > 0.0:
            # the loss counts the other model ranks' parts of the sharded
            # leaves' penalty too
            loss_sum += all_reduce_(shard_pen.clone(), model_group) \
                - shard_pen
        grads = [p.grad for p in params]
        all_reduce_flat_([loss_sum.view(1)] + grads, data_group)
        if tp > 1:
            mask = torch.tensor(sharded, device=loss_sum.device)
            sq = torch.stack([g.float().square().sum() for g in grads])
            part = all_reduce_(torch.where(mask, sq, 0.0), model_group)
            leaf_norms = torch.where(mask, part, sq).sqrt()
            gnorm = torch.linalg.vector_norm(leaf_norms)
        else:
            gnorm = global_norm(grads)
        metrics = {"loss": loss_sum, "grad_norm": gnorm}
        if per_param_norms:
            scale = float(grad_accu_steps)
            if grad_norm_clip > 0:
                scale = torch.clamp(grad_norm_clip / torch.clamp(
                    gnorm, min=1e-12), max=1.0) * scale
            norms = (leaf_norms if tp > 1 else torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads])) \
                * scale
            metrics["param_grad_norms"] = dict(
                zip((n for n, _ in named), norms.unbind()))
        if grad_norm_clip > 0:
            scale = torch.where(gnorm < grad_norm_clip, 1.0,
                                grad_norm_clip / gnorm)
            for g in grads:
                g.mul_(scale)
        lr = lr_schedule(state.step) if lr_schedule is not None else None
        if lr is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        if lr is not None:
            metrics["lr"] = torch.tensor(lr)
        return metrics

    return step


def make_eval_step(model: torch.nn.Module) -> Callable[..., torch.Tensor]:
    """-> eval_step(img [B, R, F] f32, ques [B, T] int) -> the sigmoid of
    the model's f32 logits [B, A], with no dropout and no autograd
    (step.py:185-200: the boundary where the reference's in-graph sigmoid
    sits, core/model/net.py:373). ``model`` is an ``MCANet``, or a
    ``ClassifierNet``, whose eval_step(img) takes the image alone (JAX's
    ``image_only``): the forward is the plain engine and draws no
    dropout."""

    def eval_step(*inputs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.sigmoid(model(*inputs).float())

    return eval_step
