"""Checkpoints of the port: weight carry-over in, and the per-epoch
training checkpoint out (the orbax format is not ported).

  * ``state_dict_from_params``: JAX params (a nested dict of arrays, as
    ``model.init(...)["params"]`` or an orbax restore gives them) -> the
    reference-shaped state_dict that ``MCANet.load_state_dict`` takes. It
    is the mapping of ``mcan_vqa_tpu/train/checkpoint.py::
    export_torch_state_dict`` (checkpoint.py:608-657), without JAX.
  * ``load_reference_checkpoint``: a reference ``{state_dict, ...}``
    pickle (core/exec.py:241-245) -> state_dict, "module." prefixes of
    DataParallel stripped.
  * ``load_params``: the pickle a ``Config`` names (``ckpt_path``, else
    ``ckpts_dir`` / ``ckpt_version`` / ``ckpt_epoch``) -> state_dict, the
    weights ``run_vqa --run val / test / parity`` evaluates. Weights only:
    resuming the AdamW moments and the schedule is not ported.
  * ``save_checkpoint``: a train state -> that pickle,
    ``{state_dict, optimizer, lr_base}`` with the AdamW state indexed in
    Net2's parameter order, at ``<ckpts_dir>/ckpt_<version>/epoch<N>.pkl``
    (core/exec.py:241-253). The JAX ``import_torch_checkpoint`` and
    ``Predictor.from_checkpoint`` both read it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

_NORMS = ("norm1", "norm2", "norm3", "proj_norm")
_LSTM = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0",
         "b_ih": "bias_ih_l0", "b_hh": "bias_hh_l0"}


def reference_param_keys(num_layers: int) -> List[str]:
    """Net2's state_dict keys in registration order (the order of
    ``MCANet.state_dict()``)."""
    def linear(p):
        return [f"{p}.weight", f"{p}.bias"]

    def norm(p):
        return [f"{p}.a_2", f"{p}.b_2"]

    def mhatt(p):
        return (linear(f"{p}.linear_v") + linear(f"{p}.linear_k")
                + linear(f"{p}.linear_q") + linear(f"{p}.linear_merge"))

    def mlp(p):
        return linear(f"{p}.fc.linear") + linear(f"{p}.linear")

    keys = ["embedding.weight", "lstm.weight_ih_l0", "lstm.weight_hh_l0",
            "lstm.bias_ih_l0", "lstm.bias_hh_l0"]
    keys += linear("img_feat_linear")
    for i in range(num_layers):
        p = f"backbone.enc_list.{i}"
        keys += (mhatt(f"{p}.mhatt") + mlp(f"{p}.ffn.mlp")
                 + norm(f"{p}.norm1") + norm(f"{p}.norm2"))
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
    """JAX MCANet params -> reference state_dict of f32 CPU tensors, in
    Net2's key order when the tree is a whole MCANet."""
    out = {}
    for path, arr in _flatten(params).items():
        key, transpose = _torch_key(path)
        if transpose:
            arr = arr.T
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    enc_ids = [int(k.split(".")[2]) for k in out
               if k.startswith("backbone.enc_list.")]
    if enc_ids:
        expected = reference_param_keys(max(enc_ids) + 1)
        if set(expected) == set(out):
            out = {k: out[k] for k in expected}
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


def load_params(cfg) -> Dict[str, torch.Tensor]:
    """The weights of the checkpoint ``cfg`` names: ``cfg.ckpt_path`` (a
    reference pickle, .pkl / .pt / .pth), else the port's epoch pickle
    ``<ckpts_dir>/ckpt_<ckpt_version or run_version>/epoch<ckpt_epoch>.pkl``
    (the JAX Trainer's ``_resume``, trainer.py:122-170, minus the optimizer
    state)."""
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
    return load_reference_checkpoint(path)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(state, ckpts_dir: str, version: str, epoch: int,
                    lr_base: float) -> str:
    """Write the reference pickle of ``state`` (a TrainState over an
    MCANet, whose parameters register in Net2's order, so the optimizer's
    indices are the reference's) -> its path. Tensors are saved on the
    CPU."""
    path = checkpoint_path(ckpts_dir, version, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {"state_dict": _to_cpu(state.model.state_dict()),
            "optimizer": _to_cpu(state.optimizer.state_dict()),
            "lr_base": float(lr_base)}
    torch.save(blob, path)
    return path
