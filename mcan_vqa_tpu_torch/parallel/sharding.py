"""The Megatron sharding rule over the port's state-dict keys, and the
collectives the mesh runs (mcan_vqa_tpu/parallel/sharding.py).

``param_spec`` is the JAX ``param_pspec`` (sharding.py:32-68) on the
reference key of each parameter: in every attention block (``mhatt``,
``mhatt1``, ``mhatt2``) linear_q / linear_k / linear_v are
column-parallel and linear_merge row-parallel; the FFN's up projection
(``ffn.mlp.fc.linear``) column-parallel and its down projection
(``ffn.mlp.linear``) row-parallel; everything else (embedding, LSTM,
image projection, AttFlat, norms, the head) replicated. A torch
``Linear.weight`` is [out, in], JAX's kernel [in, out]: a column-parallel
weight and its bias split on dim 0, a row-parallel weight on dim 1, and a
row-parallel bias stays whole, added after the reduce. A column shard
holds whole heads (the heads are contiguous column blocks), so the head
count must divide by tp (sharding.py:16-18).

The collectives: ``all_reduce_`` (in place over a group, nothing without
one), ``all_reduce_flat_`` (many tensors through one buffer: MCAN-small
has ~800 gradient tensors, and gloo pays per call), ``gather_shards`` (one
``all_gather`` of one host buffer per call, the unsharded tensors back)
and ``all_gather_rows`` (host arrays concatenated in group-rank order,
JAX's ``process_allgather(tiled=True)``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

MODEL = "model"
REPLICATED: Tuple[Optional[str], ...] = ()
_COLUMN = ("linear_q", "linear_k", "linear_v")


def param_spec(name: str) -> Tuple[Optional[str], ...]:
    """The partition of the tensor keyed ``name`` over the "model" axis,
    one entry per torch dim (trailing dims unsharded may be left out):
    ("model", None) / ("model",) for a column-parallel weight / bias,
    (None, "model") for a row-parallel weight, () replicated."""
    parts = name.split(".")
    if len(parts) < 2:
        return REPLICATED
    module, leaf = parts[-2], parts[-1]
    in_mhatt = any(p.startswith("mhatt") for p in parts[:-2])
    column = (in_mhatt and module in _COLUMN) or ".ffn.mlp.fc.linear." in \
        f".{name}"
    row = (in_mhatt and module == "linear_merge") or \
        ".ffn.mlp.linear." in f".{name}"
    if column:
        return {"weight": (MODEL, None), "bias": (MODEL,)}.get(leaf,
                                                               REPLICATED)
    if row and leaf == "weight":
        return (None, MODEL)
    return REPLICATED


def shard_dim(name: str) -> Optional[int]:
    """The torch dim that ``name`` splits on, or None (replicated)."""
    spec = param_spec(name)
    return spec.index(MODEL) if MODEL in spec else None


def shard_tensor(t: torch.Tensor, dim: Optional[int], tp: int,
                 index: int) -> torch.Tensor:
    """Shard ``index`` of ``tp`` along ``dim`` (a contiguous copy; the
    tensor itself where dim is None or tp is 1)."""
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does not "
                         f"split into {tp} shards")
    return t.chunk(tp, dim=dim)[index].contiguous()


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp: int, index: int
                     ) -> Dict[str, torch.Tensor]:
    """An unsharded state_dict -> model rank ``index``'s of ``tp``."""
    return {k: shard_tensor(v, shard_dim(k), tp, index)
            for k, v in sd.items()}


def shard_module_(model: torch.nn.Module, tp: int, index: int,
                  group) -> torch.nn.Module:
    """Shard ``model`` in place for model rank ``index`` of ``tp``: each
    sharded parameter replaced by its shard, each attention module
    (``MHAtt``) left with num_heads / tp local heads, and every module
    with a ``model_group`` attribute (``MHAtt``, ``FFN``) given the group,
    so its forward runs f / g around its products."""
    if tp == 1:
        return model
    for m in model.modules():
        heads = getattr(m, "num_heads", None)
        if heads is not None and hasattr(m, "model_group") and heads % tp:
            raise ValueError(f"{heads} heads do not split over a model axis "
                             f"of {tp}")
    for name, p in list(model.named_parameters()):
        dim = shard_dim(name)
        if dim is None:
            continue
        owner, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
            shard_tensor(p.detach(), dim, tp, index).clone(),
            requires_grad=p.requires_grad))
    for m in model.modules():
        if hasattr(m, "model_group"):
            m.model_group = group
            if hasattr(m, "num_heads"):
                m.num_heads //= tp
    return model


def group_size(group) -> int:
    """The ranks of ``group``; 1 for no group."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``; 0 for no group."""
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed (``op``) over ``group`` in place -> t; without a group
    nothing is called."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_flat_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum every tensor over ``group`` in place through one flat buffer
    (one collective, not one per tensor)."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def gather_shards(shards: Mapping[str, Tuple[torch.Tensor, int]], group,
                  tp: int) -> Dict[str, torch.Tensor]:
    """{key: (this rank's shard, dim)} -> {key: the unsharded tensor} on
    the CPU, in the shard's dtype: every shard sent as f32 in one host
    buffer through one ``all_gather`` over the model group, the pieces
    concatenated in group-rank order."""
    if not shards:
        return {}
    host = {k: t.detach().to("cpu", torch.float32).contiguous()
            for k, (t, _) in shards.items()}
    flat = torch.cat([t.reshape(-1) for t in host.values()])
    bufs = [torch.empty_like(flat) for _ in range(tp)]
    dist.all_gather(bufs, flat, group=group)
    out, offset = {}, 0
    for k, (t, dim) in shards.items():
        n = host[k].numel()
        pieces = [b[offset:offset + n].view(host[k].shape) for b in bufs]
        out[k] = torch.cat(pieces, dim=dim).to(t.dtype)
        offset += n
    return out


def all_gather_rows(x: np.ndarray, group) -> np.ndarray:
    """Host rows of every rank of ``group`` concatenated in group-rank
    order (bool carried as uint8); without a group ``x`` itself."""
    if group is None:
        return x
    is_bool = x.dtype == np.bool_
    t = torch.from_numpy(np.ascontiguousarray(
        x.astype(np.uint8) if is_bool else x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    rows = torch.cat(out).numpy()
    return rows.astype(np.bool_) if is_bool else rows
