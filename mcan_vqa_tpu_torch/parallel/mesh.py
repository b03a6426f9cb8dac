"""The port's device mesh: data x tensor parallelism over a
``torch.distributed`` process group (mcan_vqa_tpu/parallel/mesh.py).

The JAX package builds a ``jax.sharding.Mesh`` with a "data" axis (batch
sharding, a gradient sum per step) and a "model" axis (Megatron tensor
parallelism over the heads and the FFN hidden). The port keeps both axes
and maps JAX's concepts onto ``torch.distributed``:

  * a device of a mesh -> a rank of a process group, one CUDA device each;
  * a process (host), ``jax.process_count()`` -> a node
    (``LOCAL_WORLD_SIZE < WORLD_SIZE``);
  * ``psum`` over "data" / "model" -> ``all_reduce(SUM)`` on the data
    group / the model group;
  * ``process_allgather`` -> ``all_gather`` of host arrays on the CPU
    backend.

Ranks lie on JAX's grid, tp on the minor axis: rank = d * tp + m, so the
model group of data index d is ranks d * tp .. d * tp + tp - 1 and the
data group of model index m is ranks m, tp + m, 2 tp + m, ... The first
dp x tp ranks form the mesh, as JAX takes the first dp x tp devices; a
rank past them gets a mesh it is not a member of.

A world of one (no process group, shape {1, 1}) is the degenerate mesh:
no group at all, so no collective is ever called and every single-card
path runs as it did before the mesh existed.

``make_mesh(shape, devices=[...])`` builds the single-process serving mesh
of ``Predictor(mesh=...)`` instead: one engine replica per listed device,
no process group. A device may be listed more than once (``["cpu",
"cpu"]`` in the CPU tests, ``["cuda:0", "cuda:0"]`` on one card), which
holds the row split without a second card.

``init_distributed`` joins the process group (``torchrun``'s environment,
or rank / world size / ``init_method`` from the caller): by default every
rank on ``cuda:LOCAL_RANK`` with the backend "cpu:gloo,cuda:nccl" (gloo
for host tensors, NCCL for the card's). NCCL takes one device per rank,
so it raises when a node's ranks outnumber its cards, unless the caller
names the device and the backend: the tests and ``chip_smoke.py`` run
every rank over gloo, several on one card. A ``file://`` init method
(a ``FileStore``) needs no TCP port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mcan_vqa_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_BACKEND = "cpu:gloo,cuda:nccl"


def validate_shape(shape: Dict[str, int]) -> Tuple[int, int]:
    """(dp, tp) of ``shape`` (dp may be -1), with the JAX ``make_mesh``'s
    checks and messages that need no device count (mesh.py:37-52): an
    unknown axis, tp < 1, dp neither positive nor -1."""
    unknown = set(shape) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)}: valid axes are "
            f'"{DATA_AXIS}" and "{MODEL_AXIS}" (a typo here would silently '
            f"build a 1x1 single-device mesh)")
    dp = int(shape.get(DATA_AXIS, 1))
    tp = int(shape.get(MODEL_AXIS, 1))
    if tp < 1:
        raise ValueError(
            f"model axis must be a positive size, got {tp} (-1 inference is "
            f"supported for the data axis only)")
    if dp != -1 and dp < 1:
        raise ValueError(f"data axis must be positive or -1, got {dp}")
    return dp, tp


def check_shape(shape: Optional[Dict[str, int]], n: int) -> Tuple[int, int]:
    """(dp, tp) of ``shape`` over ``n`` devices or ranks, with the JAX
    ``make_mesh``'s checks and messages (mesh.py:37-60): those of
    ``validate_shape``, data -1 inferred, dp x tp no larger than n."""
    if shape is None:
        shape = {DATA_AXIS: n, MODEL_AXIS: 1}
    dp, tp = validate_shape(shape)
    if dp == -1:
        if n % tp:
            raise ValueError(f"{n} devices do not split into model axis {tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs more than {n} devices")
    return dp, tp


@dataclass(frozen=True)
class Mesh:
    """dp x tp ranks (or serving devices). ``data_group`` / ``model_group``
    are None where their axis has size 1, so no collective runs there;
    ``group`` spans the mesh's ranks (None in a world of one)."""
    dp: int = 1
    tp: int = 1
    rank: int = 0                     # global rank; 0 without a group
    member: bool = True               # this rank is one of the dp x tp
    group: Any = None
    data_group: Any = None
    model_group: Any = None
    nodes: int = 1
    devices: Tuple[torch.device, ...] = field(default_factory=tuple)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def distributed(self) -> bool:
        """True where collectives run: a process group spans the mesh."""
        return self.group is not None

    def barrier(self) -> None:
        """Every rank of the mesh waits for the others (an all-reduce of a
        host int, so the CPU backend carries it)."""
        if self.group is not None:
            dist.all_reduce(torch.zeros(1, dtype=torch.int32),
                            group=self.group)

    def any_rank(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any of them (one
        ``all_reduce(MAX)`` of a host int)."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group -> this rank's device. rank / world_size
    default to ``RANK`` / ``WORLD_SIZE`` (torchrun's), init_method to
    "env://". With neither device nor backend named, the rank runs on
    ``cuda:LOCAL_RANK`` (made the current device) over
    "cpu:gloo,cuda:nccl", and a node with more ranks (``LOCAL_WORLD_SIZE``)
    than CUDA devices raises: NCCL refuses two ranks on one device. Naming
    both (device "cpu" or "cuda:0", backend "gloo") skips that check; a
    CPU device alone takes gloo."""
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else int(world_size)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    if device is None:
        device = f"cuda:{local_rank}"
        if backend is None:
            _check_cards(local_world)
    dev = resolve_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else DEFAULT_BACKEND
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend,
                                init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return dev


def _check_cards(local_world: int) -> None:
    n = torch.cuda.device_count()
    if local_world > n:
        raise RuntimeError(
            f"{local_world} ranks on this node but {n} CUDA device(s): NCCL "
            f"takes one device per rank; name the device and a backend "
            f"(gloo) to put several ranks on one device")


def _nodes(world: int) -> int:
    local = _env_int("LOCAL_WORLD_SIZE", world)
    return max(1, -(-world // max(local, 1)))


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh. shape None puts every rank (device) on
    the data axis. devices: the single-process serving mesh over these
    devices (see the module docstring). Otherwise the mesh spans the
    process group when one is initialised (every rank must call
    ``make_mesh`` with the same shape, in the same order as its other
    group calls: the subgroups are made by ``new_group``), else the world
    of one. A group with an NCCL backend and more ranks on this node than
    CUDA devices raises."""
    if devices is not None:
        devs = tuple(resolve_device(d) for d in devices)
        dp, tp = check_shape(shape, len(devs))
        return Mesh(dp=dp, tp=tp, devices=devs[:dp * tp])
    if not dist.is_initialized():
        dp, tp = check_shape(shape, 1)
        return Mesh(dp=dp, tp=tp)
    world = dist.get_world_size()
    rank = dist.get_rank()
    dp, tp = check_shape(shape, world)
    if "nccl" in str(dist.get_backend()):
        _check_cards(_env_int("LOCAL_WORLD_SIZE", world))
    n = dp * tp
    # every rank makes every group, in one order (new_group is collective)
    mesh_group = dist.group.WORLD if n == world else \
        dist.new_group(list(range(n)))
    data_groups = [dist.new_group(list(range(m, n, tp))) if dp > 1 else None
                   for m in range(tp)]
    model_groups = [dist.new_group(list(range(d * tp, d * tp + tp)))
                    if tp > 1 else None for d in range(dp)]
    member = rank < n
    return Mesh(dp=dp, tp=tp, rank=rank, member=member,
                group=mesh_group if member else None,
                data_group=data_groups[rank % tp] if member else None,
                model_group=model_groups[rank // tp] if member else None,
                nodes=_nodes(world))
