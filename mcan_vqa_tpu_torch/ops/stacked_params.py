"""The stacked parameter layout of the fused VQA train engine
(mcan_vqa_tpu/ops/stacked_params.py).

The SGA and SA train blocks read one block's weights in their train layout
(``sga_train.prepare_sga_train_params`` / ``sa_train.
prepare_sa_train_params``): wqkv [D, 3D], the merges, the cross q and the
FFN as [in, out], the LN vectors. From the standard ``MCANet`` parameters
that layout is built inside every differentiated step: the q / k / v
weights transposed and concatenated forward, the gradient split and
transposed back. Here the parameters live in that layout while training:
one [L, ...] leaf per weight role, each block's view a slice ``[i]`` of it
(``unbind``: no copy forward, one stack of the L gradients backward), and
AdamW runs over those leaves. AdamW is elementwise, and the kernels see the
same operands, so a stacked run equals the standard one bit for bit in
every weight and moment (the global sums of a gradient clip or a penalty
change order; the rest does not).

Keys (``StackedMCANet.named_parameters``): every non-backbone key as in
``MCANet``; the decoder's stacks ``backbone.dec.<role>`` with the roles of
``sga_train.WEIGHT_NAMES`` plus the cross k / v (``wk2``, ``bk2``, ``wv2``,
``bv2``); the encoder's ``backbone.enc.<role>`` with the roles of
``sa_train.SA_WEIGHT_NAMES`` where the encoder trains through the SA train
blocks (hidden <= 512). Two departures from JAX's map (:34-63), both to keep
the plain products' operand layout and so their bits: the cross k / v stay
in ``Dense``'s [out, in] orientation ([L, D, D] transposed against JAX's
[in, out]), because they run outside the kernels through ``Dense``'s
product; and where the encoder trains in plain ops (hidden > 512) its
blocks keep their standard leaves (``backbone.enc_list.{i}.*``), which no
step relays.

The standard layout exists only at the boundaries: ``from_stacked`` /
``from_stacked_state`` give the ``MCANet`` state_dict and the torch AdamW
state of the same run for checkpoints, resume, evaluation and calibration,
so the on-disk format does not change.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from mcan_vqa_tpu_torch.ops.sa_train import SA_WEIGHT_NAMES, \
    prepare_sa_train_params
from mcan_vqa_tpu_torch.ops.sga_train import WEIGHT_NAMES, \
    prepare_sga_train_params
from mcan_vqa_tpu_torch.train.train_state import TrainState

Params = Dict[str, torch.Tensor]

ENC, DEC = "backbone.enc.", "backbone.dec."
ENC_BLOCK, DEC_BLOCK = "backbone.enc_list.", "backbone.dec_list."
# the cross k / v: [out, in] as ``Dense`` holds them (see the docstring)
CROSS_KV = {"wk2": "mhatt2.linear_k.weight", "bk2": "mhatt2.linear_k.bias",
            "wv2": "mhatt2.linear_v.weight", "bv2": "mhatt2.linear_v.bias"}
DEC_ROLES = WEIGHT_NAMES + tuple(CROSS_KV)
ENC_ROLES = SA_WEIGHT_NAMES
# wqkv / bqkv concatenate the self-attention's projections in this order
_QKV = ("linear_q", "linear_k", "linear_v")


def _role_sources(role: str, att: str, sga: bool):
    """The standard keys (relative to a block) one role is built from, and
    whether each is transposed into the train layout. wqkv / bqkv
    concatenate the three projections along their output."""
    if role in ("wqkv", "bqkv"):
        kind = "weight" if role == "wqkv" else "bias"
        return [(f"{att}.{lin}.{kind}", kind == "weight") for lin in _QKV]
    if sga and role in CROSS_KV:
        return [(CROSS_KV[role], False)]
    names = {"wm": "mhatt.linear_merge", "wm1": "mhatt1.linear_merge",
             "wq2": "mhatt2.linear_q", "wm2": "mhatt2.linear_merge",
             "w1": "ffn.mlp.fc.linear", "w2": "ffn.mlp.linear"}
    if role[0] == "w":
        return [(names[role] + ".weight", True)]
    if role[0] == "b":
        return [(names["w" + role[1:]] + ".bias", False)]
    norm, part = role.split("_")          # ln1_s -> norm1.a_2
    return [(f"norm{norm[2:]}.{'a_2' if part == 's' else 'b_2'}", False)]


def _num_layers(params: Mapping[str, torch.Tensor], prefix: str) -> int:
    ids = {int(k[len(prefix):].split(".")[0]) for k in params
           if k.startswith(prefix)}
    return max(ids) + 1 if ids else 0


def _block(params, prefix, i):
    head = f"{prefix}{i}."
    return {k[len(head):]: v for k, v in params.items() if k.startswith(head)}


def to_stacked(params: Mapping[str, torch.Tensor],
               encoder: bool = True) -> Params:
    """An ``MCANet`` state_dict (or named parameters) -> the stacked
    layout's: the decoder blocks as ``backbone.dec.<role>`` [L, ...], the
    encoder blocks as ``backbone.enc.<role>`` where ``encoder`` (else they
    pass through), every other key as it is, in the standard order with the
    stacks where the backbone's keys stood. New tensors (stacks of the
    train layout), made with differentiable ops."""
    out: Params = {}
    L_dec = _num_layers(params, DEC_BLOCK)
    L_enc = _num_layers(params, ENC_BLOCK) if encoder else 0
    for key, value in params.items():
        if key.startswith(DEC_BLOCK) or (encoder and key.startswith(
                ENC_BLOCK)):
            if key.startswith(ENC_BLOCK) and ENC + ENC_ROLES[0] not in out:
                blocks = [prepare_sa_train_params(_block(params, ENC_BLOCK,
                                                         i))
                          for i in range(L_enc)]
                for role in ENC_ROLES:
                    out[ENC + role] = torch.stack([b[role] for b in blocks])
            if key.startswith(DEC_BLOCK) and DEC + DEC_ROLES[0] not in out:
                blocks = []
                for i in range(L_dec):
                    blk = _block(params, DEC_BLOCK, i)
                    w = prepare_sga_train_params(blk)
                    w.update({r: blk[k] for r, k in CROSS_KV.items()})
                    blocks.append(w)
                for role in DEC_ROLES:
                    out[DEC + role] = torch.stack([b[role] for b in blocks])
            continue
        out[key] = value
    return out


def _unstack(stacks: Mapping[str, torch.Tensor], prefix: str, roles,
             att: str, sga: bool) -> Params:
    out: Params = {}
    L = stacks[roles[0]].shape[0]
    for i in range(L):
        for role in roles:
            sources = _role_sources(role, att, sga)
            parts = (stacks[role][i].chunk(3, dim=-1) if len(sources) == 3
                     else (stacks[role][i],))
            for (key, transposed), part in zip(sources, parts):
                part = part.t() if transposed else part
                out[f"{prefix}{i}.{key}"] = part.contiguous().clone()
    return out


def from_stacked(params: Mapping[str, torch.Tensor]) -> Params:
    """The exact inverse of ``to_stacked``: the standard ``MCANet`` keys,
    each unstacked one a contiguous copy of its slice (the blocks' keys
    where the stacks stood, encoder before decoder, each block's in role
    order)."""
    enc = {k[len(ENC):]: v for k, v in params.items() if k.startswith(ENC)}
    dec = {k[len(DEC):]: v for k, v in params.items() if k.startswith(DEC)}
    out: Params = {}
    for key, value in params.items():
        if key.startswith(ENC):
            continue
        if key.startswith(DEC):
            if not any(k.startswith(DEC_BLOCK) for k in out):
                if enc:
                    out.update(_unstack(enc, ENC_BLOCK, ENC_ROLES, "mhatt",
                                        False))
                out.update(_unstack(dec, DEC_BLOCK, DEC_ROLES, "mhatt1",
                                    True))
            continue
        out[key] = value
    return out


def is_stacked(params: Mapping[str, torch.Tensor]) -> bool:
    return any(k.startswith(DEC) for k in params)


def block_views(stack: nn.ParameterDict) -> List[Dict[str, torch.Tensor]]:
    """Each block's weights as slices of the stacks, keyed by role: one
    ``unbind`` a stack (views; the backward stacks the L gradients once)."""
    per_role = {role: stack[role].unbind(0) for role in stack}
    L = len(next(iter(per_role.values())))
    return [{role: views[i] for role, views in per_role.items()}
            for i in range(L)]


def enc_block(stacks: Mapping[str, torch.Tensor], i: int
              ) -> Dict[str, torch.Tensor]:
    """Encoder block i in the ``prepare_sa_train_params`` layout: a slice
    of each stack."""
    return {k: v[i] for k, v in stacks.items()}


def dec_block(stacks: Mapping[str, torch.Tensor], i: int
              ) -> Dict[str, torch.Tensor]:
    """Decoder block i in the ``prepare_sga_train_params`` layout, the
    cross k / v riding along as wk2 / bk2 / wv2 / bv2."""
    return {k: v[i] for k, v in stacks.items()}


class StackedBackbone(nn.Module):
    """The backbone's leaves while training stacked: ``dec`` (and ``enc``
    where the encoder is stacked) a ParameterDict of [L, ...] roles, or
    ``enc_list``, the standard encoder blocks themselves."""

    def __init__(self, stacked: Mapping[str, torch.Tensor],
                 enc_list: Optional[nn.ModuleList] = None):
        super().__init__()
        if enc_list is not None:
            self.enc_list = enc_list
        else:
            self.enc = _stacks(stacked, ENC)
        self.dec = _stacks(stacked, DEC)


def _stacks(stacked: Mapping[str, torch.Tensor], prefix: str
            ) -> nn.ParameterDict:
    # pairs, not a dict: a ParameterDict sorts a dict's keys
    return nn.ParameterDict([(k[len(prefix):], nn.Parameter(v.detach()))
                             for k, v in stacked.items()
                             if k.startswith(prefix)])


class StackedMCANet(nn.Module):
    """An ``MCANet``'s training view in the stacked layout: its embedding,
    LSTM, image projection, AttFlats and head (the same modules, shared)
    and a ``StackedBackbone``. ``standard`` is the ``MCANet`` it was made
    from, whose backbone leaves ``from_stacked_state`` brings up to date;
    it is not a submodule (its leaves are not this module's)."""

    def __init__(self, net: nn.Module, encoder: bool = True):
        super().__init__()
        with torch.no_grad():
            stacked = to_stacked(dict(net.named_parameters()), encoder)
        for name, child in net.named_children():
            if name == "backbone":
                self.backbone = StackedBackbone(
                    stacked, None if encoder else child.enc_list)
            else:
                self.add_module(name, child)
        object.__setattr__(self, "standard", net)

    @property
    def encoder_stacked(self) -> bool:
        return hasattr(self.backbone, "enc")


MOMENTS = ("exp_avg", "exp_avg_sq")


def convert_opt_state(opt_sd: Mapping, names_in: List[str],
                      names_out: List[str],
                      convert: Callable[[Params], Params]) -> Dict:
    """A torch AdamW (or ``AdamWMuBF16``) state_dict over parameters
    ``names_in`` -> the one over ``names_out``: each moment relaid by
    ``convert`` (``to_stacked`` or ``from_stacked``), the step counts (one
    value: every leaf steps every step) given to every new leaf, the param
    group's hyperparameters kept. A state with no moments yet converts to
    an empty one."""
    state = opt_sd["state"]
    groups = opt_sd["param_groups"]
    if len(groups) != 1:
        raise ValueError("the stacked layout takes one param group")
    group = dict(groups[0], params=list(range(len(names_out))))
    if not state:
        return {"state": {}, "param_groups": [group]}
    if len(state) != len(names_in):
        raise ValueError(f"{len(state)} of {len(names_in)} parameters have "
                         f"optimizer state: convert before or after a "
                         f"step, not between")
    steps = {float(s["step"]) for s in state.values()}
    if len(steps) != 1:
        raise ValueError(f"the parameters' step counts differ: {steps}")
    step = next(iter(state.values()))["step"]
    moments = {m: convert({names_in[int(i)]: s[m] for i, s in state.items()})
               for m in MOMENTS}
    new_state = {}
    for j, name in enumerate(names_out):
        new_state[j] = {"step": step.clone()}
        for m in MOMENTS:
            new_state[j][m] = moments[m][name].contiguous().clone()
    return {"state": new_state, "param_groups": [group]}


def _optimizer_like(optimizer: torch.optim.Optimizer, params):
    """An optimizer of the same class and settings over ``params`` (the
    settings its constructor takes)."""
    cls = type(optimizer)
    takes = inspect.signature(cls.__init__).parameters
    return cls(params, **{k: v for k, v in optimizer.defaults.items()
                          if k in takes})


def to_stacked_state(state: TrainState, encoder: bool = True) -> TrainState:
    """A TrainState over an ``MCANet`` -> the same run in the stacked
    layout: a ``StackedMCANet`` sharing the non-backbone modules, an
    optimizer of the same class and settings over its leaves with the
    moments relaid, the same step count and generator."""
    net = state.model
    stacked = StackedMCANet(net, encoder)
    names_in = [n for n, _ in net.named_parameters()]
    names_out = [n for n, _ in stacked.named_parameters()]
    optimizer = _optimizer_like(state.optimizer, stacked.parameters())
    optimizer.load_state_dict(convert_opt_state(
        state.optimizer.state_dict(), names_in, names_out,
        lambda p: to_stacked(p, encoder)))
    return TrainState(model=stacked, optimizer=optimizer, step=state.step,
                      generator=state.generator, seed=state.seed)


def from_stacked_state(state: TrainState,
                       into: Optional[TrainState] = None) -> TrainState:
    """The standard TrainState of a stacked one (identity on a standard
    state): the backbone's leaves copied into the ``MCANet`` the stacked
    one was made from, the moments relaid into ``into``'s optimizer (or a
    new one of the same class), the step count. ``into``: the standard
    state to bring up to date in place (the Trainer's)."""
    net = state.model
    if not isinstance(net, StackedMCANet):
        return state
    standard = net.standard
    names_in = [n for n, _ in net.named_parameters()]
    names_out = [n for n, _ in standard.named_parameters()]
    with torch.no_grad():
        weights = from_stacked(dict(net.named_parameters()))
        params = dict(standard.named_parameters())
        for name, value in weights.items():
            if params[name] is not value:
                params[name].copy_(value)
    if into is None:
        into = TrainState(model=standard, optimizer=_optimizer_like(
            state.optimizer, standard.parameters()), step=state.step,
            generator=state.generator, seed=state.seed)
    elif into.model is not standard:
        raise ValueError("into is not the state the stacked one was made "
                         "from")
    into.optimizer.load_state_dict(convert_opt_state(
        state.optimizer.state_dict(), names_in, names_out, from_stacked))
    into.step = state.step
    return into
