"""Checkpoints of the port: weight carry-over in, the per-epoch training
checkpoint out, and its lifecycle (the orbax format is not ported: the
port's own format is the reference pickle).

  * ``state_dict_from_params``: JAX params (a nested dict of arrays, as
    ``model.init(...)["params"]`` or an orbax restore gives them) -> the
    reference-shaped state_dict that ``MCANet.load_state_dict`` (or
    ``ClassifierNet.load_state_dict``) takes. It
    is the mapping of ``mcan_vqa_tpu/train/checkpoint.py::
    export_torch_state_dict`` (checkpoint.py:608-657), without JAX.
  * ``load_reference_checkpoint``: a reference ``{state_dict, ...}``
    pickle (core/exec.py:241-245) -> state_dict, "module." prefixes of
    DataParallel stripped.
  * ``load_params``: the pickle a ``Config`` names (``ckpt_path``, else
    ``ckpts_dir`` / ``ckpt_version`` / ``ckpt_epoch``) -> state_dict, the
    weights ``run_vqa --run val / test / parity`` evaluates.
  * ``save_checkpoint``: a train state -> that pickle,
    ``{state_dict, optimizer, lr_base}`` with the AdamW state indexed in
    Net2's parameter order, at ``<ckpts_dir>/ckpt_<version>/epoch<N>.pkl``
    (core/exec.py:241-253); a bf16 first moment (``opt_mu_dtype``) is
    stored f32, which is exact. The JAX ``import_torch_checkpoint``,
    ``import_torch_opt_state`` and ``Predictor.from_checkpoint`` read it.
    ``AsyncCheckpointSaver`` writes the same pickle on a worker thread.
  * ``resume_state``: the trajectory-faithful resume (the JAX Trainer's
    ``_resume``, trainer.py:122-146): the weights through
    ``merge_compatible``, the AdamW moments and the step count.
  * ``latest_epoch`` / ``prune_checkpoints`` and the activation-scale side
    file ``epoch<N>.act_scales.json`` beside a pickle
    (checkpoint.py:149-231), which ``Predictor.from_checkpoint`` loads.

On a mesh (``parallel/``) the pickle is the one a single card writes:
``save_checkpoint(..., mesh=)`` gathers the weights and AdamW moments of
a tensor-parallel model over the model group (``full_state_dicts``),
global rank 0 alone writes, then every rank waits at a barrier; the
async saver runs on rank 0 only. ``resume_state(..., mesh=)`` reads the
whole pickle on every rank and keeps each rank's shard, so both packages
and every mesh read every pickle.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from mcan_vqa_tpu_torch.parallel.sharding import (gather_shards,
                                                  shard_dim,
                                                  shard_state_dict,
                                                  shard_tensor)

_NORMS = ("norm1", "norm2", "norm3", "proj_norm")
_LSTM = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
         "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}


def _linear(p):
    return [f"{p}.weight", f"{p}.bias"]


def _norm(p):
    return [f"{p}.a_2", f"{p}.b_2"]


def _mhatt(p):
    return (_linear(f"{p}.linear_v") + _linear(f"{p}.linear_k")
            + _linear(f"{p}.linear_q") + _linear(f"{p}.linear_merge"))


def _mlp(p):
    return _linear(f"{p}.fc.linear") + _linear(f"{p}.linear")


def _encoder_keys(num_layers: int) -> List[str]:
    keys = []
    for i in range(num_layers):
        p = f"backbone.enc_list.{i}"
        keys += (_mhatt(f"{p}.mhatt") + _mlp(f"{p}.ffn.mlp")
                 + _norm(f"{p}.norm1") + _norm(f"{p}.norm2"))
    return keys


def classifier_param_keys(num_layers: int) -> List[str]:
    """ClassifierNet's state_dict keys in registration order (the order of
    ``ClassifierNet.state_dict()``: img_feat_linear, the encoder blocks,
    attflat_img, proj_norm, proj)."""
    return (_linear("img_feat_linear") + _encoder_keys(num_layers)
            + _mlp("attflat_img.mlp") + _linear("attflat_img.linear_merge")
            + _norm("proj_norm") + _linear("proj"))


def reference_param_keys(num_layers: int) -> List[str]:
    """Net2's state_dict keys in registration order (the order of
    ``MCANet.state_dict()``)."""
    linear, norm, mhatt, mlp = _linear, _norm, _mhatt, _mlp
    keys = ["embedding.weight", "lstm.weight_ih_l0", "lstm.weight_hh_l0",
            "lstm.bias_ih_l0", "lstm.bias_hh_l0"]
    keys += linear("img_feat_linear") + _encoder_keys(num_layers)
    for i in range(num_layers):
        p = f"backbone.dec_list.{i}"
        keys += (mhatt(f"{p}.mhatt1") + mhatt(f"{p}.mhatt2")
                 + mlp(f"{p}.ffn.mlp") + norm(f"{p}.norm1")
                 + norm(f"{p}.norm2") + norm(f"{p}.norm3"))
    for af in ("attflat_img", "attflat_lang"):
        keys += mlp(f"{af}.mlp") + linear(f"{af}.linear_merge")
    keys += norm("proj_norm") + linear("proj")
    return keys


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v, np.float32)
    return flat


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """JAX param path -> (reference key, needs transpose)."""
    *parts, leaf = path
    parts = [("enc_list." + p[4:]) if p.startswith("enc_") else
             ("dec_list." + p[4:]) if p.startswith("dec_") else p
             for p in parts]
    joined = ".".join(parts)
    joined = joined.replace("FCLayer_0.Dense_0", "fc.linear")
    joined = joined.replace("mlp.Dense_0", "mlp.linear")
    if leaf == "kernel":
        return f"{joined}.weight", True
    if leaf == "embedding":
        return f"{joined}.weight", False
    if leaf == "bias":
        return (f"{joined}.b_2" if joined.endswith(_NORMS)
                else f"{joined}.bias"), False
    if leaf == "scale":
        return f"{joined}.a_2", False
    if leaf in _LSTM:
        return f"{joined}.{_LSTM[leaf]}", leaf.startswith("w_")
    raise KeyError(f"unrecognized param leaf: {'/'.join(path)}")


def state_dict_from_params(params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """JAX MCANet or ClassifierNet params -> reference state_dict of f32
    CPU tensors, in the model's registration order when the tree is a
    whole MCANet (``reference_param_keys``) or a whole ClassifierNet
    (``classifier_param_keys``)."""
    out = {}
    for path, arr in _flatten(params).items():
        key, transpose = _torch_key(path)
        if transpose:
            arr = arr.T
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    enc_ids = [int(k.split(".")[2]) for k in out
               if k.startswith("backbone.enc_list.")]
    if enc_ids:
        for keys_of in (reference_param_keys, classifier_param_keys):
            expected = keys_of(max(enc_ids) + 1)
            if set(expected) == set(out):
                return {k: out[k] for k in expected}
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Reference pickle ``{state_dict, optimizer, lr_base}`` (or a bare
    state_dict) -> state_dict on the CPU. Loaded with
    ``weights_only=True``: tensors and plain containers only."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = blob["state_dict"] if "state_dict" in blob else blob
    return {k.removeprefix("module."): v for k, v in state_dict.items()}


def checkpoint_path(ckpts_dir: str, version: str, epoch: int) -> str:
    return os.path.join(ckpts_dir, f"ckpt_{version}", f"epoch{epoch}.pkl")


def named_checkpoint(cfg) -> str:
    """The pickle ``cfg`` names: ``cfg.ckpt_path`` (a reference pickle,
    .pkl / .pt / .pth), else the port's epoch pickle
    ``<ckpts_dir>/ckpt_<ckpt_version or run_version>/epoch<ckpt_epoch>.pkl``
    (the JAX Trainer's ``_resume``, trainer.py:122-170). Raises when it is
    absent."""
    path = cfg.ckpt_path
    if path:
        if not path.endswith((".pkl", ".pt", ".pth")):
            raise NotImplementedError(
                f"{path}: only reference pickles load into the port (orbax "
                f"checkpoints: convert with state_dict_from_params)")
    else:
        if cfg.ckpt_epoch <= 0:
            raise ValueError("name the checkpoint to load: ckpt_path, or "
                             "ckpt_epoch (with ckpt_version)")
        path = checkpoint_path(cfg.ckpts_dir,
                               cfg.ckpt_version or cfg.run_version,
                               cfg.ckpt_epoch)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return path


def load_params(cfg) -> Dict[str, torch.Tensor]:
    """The weights of the checkpoint ``cfg`` names (``named_checkpoint``)."""
    return load_reference_checkpoint(named_checkpoint(cfg))


def _map(obj, fn):
    """``fn`` applied to every tensor of a nested container."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(v, fn) for v in obj)
    return obj


def _to_cpu(obj, f32: bool = False):
    """Tensors of a nested container moved to the CPU; ``f32`` also casts
    bf16 tensors to f32 (exact)."""
    def host(t):
        t = t.detach().cpu()
        return t.float() if f32 and t.dtype == torch.bfloat16 else t
    return _map(obj, host)


def _blob(model_sd, optimizer_sd, lr_base: float) -> Dict[str, Any]:
    """The pickle's content on the CPU: {state_dict, optimizer, lr_base},
    the optimizer's bf16 moments as f32 (the JAX ``import_torch_opt_state``
    reads f32 only)."""
    return {"state_dict": _to_cpu(model_sd),
            "optimizer": _to_cpu(optimizer_sd, f32=True),
            "lr_base": float(lr_base)}


_MOMENTS = ("exp_avg", "exp_avg_sq")


def full_state_dicts(state, mesh=None):
    """-> (weights, optimizer) state dicts of ``state`` as a single card
    holds them, on the rank that writes the pickle (rank 0 of ``mesh``, or
    the only one), None on the others. At tp > 1 the model ranks of data
    index 0 gather their shards of the weights and of the AdamW moments
    in one ``all_gather`` (a collective: each of them calls this)."""
    rank0 = mesh is None or mesh.rank == 0
    model_sd = state.model.state_dict()
    optim_sd = state.optimizer.state_dict()
    if mesh is None or mesh.tp == 1:
        return (model_sd, optim_sd) if rank0 else None
    if mesh.data_index != 0:
        return None
    names = list(dict(state.model.named_parameters()))
    shards = {("w", k): (v, shard_dim(k)) for k, v in model_sd.items()
              if shard_dim(k) is not None}
    for i, st in optim_sd["state"].items():
        dim = shard_dim(names[int(i)])
        if dim is not None:
            shards.update({(m, i): (st[m], dim) for m in _MOMENTS})
    full = gather_shards(shards, mesh.model_group, mesh.tp)
    if not rank0:
        return None
    model_sd = {k: full.get(("w", k), v) for k, v in model_sd.items()}
    optim_sd = dict(optim_sd, state={
        i: {m: full.get((m, i), v) for m, v in st.items()}
        for i, st in optim_sd["state"].items()})
    return model_sd, optim_sd


def save_checkpoint(state, ckpts_dir: str, version: str, epoch: int,
                    lr_base: float, mesh=None) -> str:
    """Write the reference pickle of ``state`` (a TrainState over an
    MCANet or a ClassifierNet, whose parameters register in the order of
    ``reference_param_keys`` / ``classifier_param_keys``, so the
    optimizer's indices are that order's) -> its path. Tensors are saved
    on the CPU. mesh: every rank of it calls this; the unsharded state
    (``full_state_dicts``) is written by rank 0 alone, then a barrier."""
    path = checkpoint_path(ckpts_dir, version, epoch)
    dicts = full_state_dicts(state, mesh)
    if dicts is not None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(_blob(*dicts, lr_base), path)
    if mesh is not None:
        mesh.barrier()
    return path


# ---------------------------------------------------------------------------
# housekeeping and the activation-scale side file
# ---------------------------------------------------------------------------

_EPOCH = re.compile(r"epoch(\d+)\.pkl")


def _epochs(ckpts_dir: str, version: str) -> List[int]:
    d = os.path.join(ckpts_dir, f"ckpt_{version}")
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for n in os.listdir(d)
                  if (m := _EPOCH.fullmatch(n)))


def latest_epoch(ckpts_dir: str, version: str) -> Optional[int]:
    """The newest epoch pickle of ``version``, or None."""
    epochs = _epochs(ckpts_dir, version)
    return epochs[-1] if epochs else None


def prune_checkpoints(ckpts_dir: str, version: str, keep_last: int) -> int:
    """Keep only the newest ``keep_last`` epoch pickles (and their side
    files) -> the number removed; keep_last <= 0 keeps all
    (checkpoint.py:211-231)."""
    if keep_last <= 0:
        return 0
    removed = 0
    for e in _epochs(ckpts_dir, version)[:-keep_last]:
        path = checkpoint_path(ckpts_dir, version, e)
        for p in (path, act_scales_path(path)):
            if os.path.exists(p):
                os.remove(p)
        removed += 1
    return removed


def act_scales_path(ckpt_path: str) -> str:
    """The side file of the static activation scales beside a checkpoint
    pickle: ``.../epoch<N>.pkl`` -> ``.../epoch<N>.act_scales.json``."""
    return os.path.splitext(os.path.abspath(ckpt_path))[0] + \
        ".act_scales.json"


def save_act_scales(ckpt_path: str, scales: Mapping[str, tuple]) -> str:
    """Write ``scales`` ({"enc_i" / "dec_i" / "aux": tuple of floats}, as
    ``calibrate_qffn_act_scales`` returns them) beside the pickle, in the
    JAX side file's layout (checkpoint.py:149-165) -> its path."""
    path = act_scales_path(ckpt_path)
    with open(path, "w") as f:
        json.dump({k: list(v) for k, v in scales.items()}, f, indent=1)
    return path


def load_act_scales(ckpt_path: str) -> Optional[Dict[str, tuple]]:
    """The scales stored beside a checkpoint pickle, or None without a
    side file."""
    path = act_scales_path(ckpt_path)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    return {k: tuple(float(x) for x in v) for k, v in raw.items()}


# ---------------------------------------------------------------------------
# the background writer
# ---------------------------------------------------------------------------

def _tensors(obj) -> List[torch.Tensor]:
    found: List[torch.Tensor] = []
    _map(obj, found.append)
    return found


class AsyncCheckpointSaver:
    """Writes the epoch pickles on a worker thread while the next epoch
    trains (checkpoint.py:52-146).

    ``save`` first copies the weights and the optimizer state on their
    device: the optimizer updates the live tensors in place, so the worker
    must never read them. The copies are queued on the train stream (the
    current one) behind the step that produced the state, and an event
    recorded after them is what the worker waits for, on a stream of its
    own, before it moves the copy to the host; the copies are marked as
    used on that stream, so their memory is not reused under it. The
    worker then writes the pickle ``save_checkpoint`` writes and prunes
    (``keep_last``), so the directory changes on one thread only.

    The queue holds one pending snapshot (each is a full copy of the
    weights and both moments on the device): a ``save`` waits until the
    worker has picked up the one before. A failed write is raised again by
    the next ``save``, ``wait`` or ``close``; ``close`` joins the worker
    before it raises."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="mcan-async-ckpt")
        self._worker.start()

    def save(self, state, ckpts_dir: str, version: str, epoch: int,
             lr_base: float, keep_last: int = 0) -> str:
        return self.save_dicts(state.model.state_dict(),
                               state.optimizer.state_dict(), ckpts_dir,
                               version, epoch, lr_base, keep_last)

    def save_dicts(self, model_sd, optimizer_sd, ckpts_dir: str,
                   version: str, epoch: int, lr_base: float,
                   keep_last: int = 0) -> str:
        """``save`` of the two state dicts (``full_state_dicts``' on a
        mesh)."""
        self._reraise()
        snapshot = _map((model_sd, optimizer_sd),
                        lambda t: t.detach().clone())
        event = device = None
        cuda = [t for t in _tensors(snapshot) if t.is_cuda]
        if cuda:
            device = cuda[0].device
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        path = checkpoint_path(ckpts_dir, version, epoch)
        self._q.put((snapshot, event, device, float(lr_base), path,
                     ckpts_dir, version, keep_last))
        return path

    def wait(self) -> None:
        """Block until every queued checkpoint is on disk."""
        self._q.join()
        self._reraise()

    def close(self) -> None:
        """Flush, stop and join the worker; a stored write error is raised
        after the worker has ended."""
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._worker.join()

    def _reraise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            (snapshot, event, device, lr_base, path, ckpts_dir, version,
             keep_last) = item
            try:
                if event is not None:
                    stream = torch.cuda.Stream(device=device)
                    stream.wait_event(event)
                    for t in _tensors(snapshot):
                        if t.is_cuda:
                            t.record_stream(stream)
                    with torch.cuda.stream(stream):
                        blob = _blob(*snapshot, lr_base)
                else:
                    blob = _blob(*snapshot, lr_base)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                torch.save(blob, path)
                prune_checkpoints(ckpts_dir, version, keep_last)
            except Exception as e:  # noqa: BLE001 (raised on the next call)
                self._error = e
            finally:
                del snapshot
                self._q.task_done()


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

def merge_compatible(template: Mapping[str, torch.Tensor],
                     incoming: Mapping[str, torch.Tensor], logger=None
                     ) -> Dict[str, torch.Tensor]:
    """``incoming`` where its tensor has the template's shape, else the
    template's, with a log line (the JAX Trainer's ``_merge_compatible``,
    trainer.py:777-795: a changed vocabulary on a warm start)."""
    merged = {}
    for k, tv in template.items():
        iv = incoming.get(k)
        if iv is not None and tuple(iv.shape) == tuple(tv.shape):
            merged[k] = iv
        else:
            if logger is not None:
                logger.write(f"warm-start skip {k}: "
                             f"{None if iv is None else tuple(iv.shape)} vs "
                             f"{tuple(tv.shape)}")
            merged[k] = tv
    return merged


def _import_moments(state, optimizer_sd: Mapping[str, Any],
                    param_keys: List[str], tp: int = 1,
                    shard: int = 0) -> int:
    """The pickle's AdamW state (indexed in ``param_keys``' order, the
    pickle's state_dict order) into ``state.optimizer`` -> the step count;
    at tp > 1 model rank ``shard``'s shard of each moment. A moment whose
    parameter is absent or shaped otherwise raises, as the JAX
    ``import_torch_opt_state`` does (checkpoint.py:480-490)."""
    params = dict(state.model.named_parameters())
    index = {n: j for j, n in enumerate(params)}
    saved = optimizer_sd.get("state", {})
    moments, homeless, step = {}, [], 0
    for i, key in enumerate(param_keys):
        s = saved.get(i, saved.get(str(i)))
        if s is None:
            continue
        s = dict(s, **{m: shard_tensor(s[m], shard_dim(key), tp, shard)
                       for m in _MOMENTS if m in s})
        p = params.get(key)
        if p is None or any(tuple(s[m].shape) != tuple(p.shape)
                            for m in ("exp_avg", "exp_avg_sq")):
            homeless.append(key)
            continue
        moments[index[key]] = {
            "step": torch.as_tensor(s["step"], dtype=torch.float32).clone(),
            "exp_avg": s["exp_avg"], "exp_avg_sq": s["exp_avg_sq"]}
        step = max(step, int(float(s["step"])))
    if homeless:
        raise ValueError(
            f"{len(homeless)} optimizer moment(s) of the checkpoint have no "
            f"home in the model (e.g. {', '.join(homeless[:4])}): a "
            f"trajectory-faithful resume is impossible; match the model, or "
            f"resume the weights only (drop the pickle's 'optimizer' entry)")
    sd = state.optimizer.state_dict()
    sd["state"] = moments
    state.optimizer.load_state_dict(sd)
    return step


def resume_state(state, cfg, data_size: int, logger=None, mesh=None):
    """Restore ``state`` (a TrainState over an MCANet or a ClassifierNet)
    from the pickle ``cfg`` names (``named_checkpoint``), as the JAX
    Trainer's ``_resume`` does from a pickle (trainer.py:122-146): the
    weights through
    ``merge_compatible``; with an "optimizer" entry its AdamW moments and
    its step count; without one the step replayed from the epoch,
    int(data_size / batch_size x ckpt_epoch) (core/exec.py:90-94), and
    fresh moments. mesh: at tp > 1 ``state`` is a model rank's shard, and
    it takes its shard of the (unsharded) pickle. -> state."""
    path = named_checkpoint(cfg)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    has_sd = isinstance(blob, dict) and "state_dict" in blob
    incoming = {k.removeprefix("module."): v for k, v in
                (blob["state_dict"] if has_sd else blob).items()}
    tp, index = (mesh.tp, mesh.model_index) if mesh is not None else (1, 0)
    state.model.load_state_dict(merge_compatible(
        state.model.state_dict(), shard_state_dict(incoming, tp, index),
        logger))
    optimizer_sd = blob.get("optimizer") if has_sd else None
    if isinstance(optimizer_sd, dict):
        state.step = _import_moments(state, optimizer_sd, list(incoming),
                                     tp, index)
        msg = f"resume: restored AdamW moments @ step {state.step}"
    else:
        state.step = int(data_size / cfg.batch_size * cfg.ckpt_epoch)
        msg = (f"resume: weights only, step {state.step} from epoch "
               f"{cfg.ckpt_epoch}")
    if logger is not None:
        logger.write(f"{msg} ({path})")
    return state
