"""The weight bytes each serving engine holds on its device, exactly (the
port's counterpart of tools/param_footprint.py).

    python -m mcan_vqa_tpu_torch.cli.param_footprint [--models small,large]
        [--device cpu]

For MCANet weights drawn from a seed (token_size 20000, 3129 answers) this
counts, per engine, the bytes of the distinct tensor storages in its
prepared tree (a view shares its base's storage and counts once):

    plain     the f32 state_dict (MCANet.forward)
    bf16      build_production_engine(qffn=0), the pruned tree that ships
    level1 / level3   the int8 engines (level 3 calibrated)
    level4 .. level7  the int4 engines (calibrated)
    q8aux     level 3 + the static-int8 aux sites
    int8      the full-int8 engine (quantize_params)

This is what the engine keeps resident, not what one forward reads: a
quantized block holds its bf16 block entries (``_mk``) beside its int8 or
int4 codes (``_qffn``) and reads only part of the two, the bf16 FFN
matrices only where a dynamic-scale block runs past ``QFFN_MAX_BATCH``
rows. The calibrated engines take their scales from two seeded requests.
One JSON line per model size: bytes and MiB per engine. Runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

TOKENS, ANSWERS = 20000, 3129
ENGINES = ("plain", "bf16", "level1", "level3", "level4", "level5",
           "level6", "level7", "q8aux", "int8")


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in a nested tree of
    dicts / lists / tuples (other leaves hold no weight)."""
    import torch
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            s = x.untyped_storage()
            seen[(s.device, s.data_ptr())] = s.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return sum(seen.values())


def footprint(cfg, device, token_size: int = TOKENS,
              answer_size: int = ANSWERS, engines=ENGINES) -> dict:
    """{engine: bytes} of the engines' prepared trees for one Config."""
    import torch

    from mcan_vqa_tpu_torch.models.net import MCANet
    from mcan_vqa_tpu_torch.ops.serving import (build_production_engine,
                                                quantize_params)
    net = MCANet(cfg, token_size, answer_size,
                 generator=torch.Generator().manual_seed(0))
    state = {k: v.to(device) for k, v in net.state_dict().items()}
    g = torch.Generator().manual_seed(1)
    img = torch.randn(2, cfg.img_feat_pad_size, cfg.img_feat_size,
                      generator=g).to(device)
    ques = torch.randint(1, token_size, (2, cfg.max_token),
                         generator=g).to(device)
    L, H = cfg.layer, cfg.multi_head
    out = {}
    for name in engines:
        if name == "plain":
            out[name] = tree_bytes(state)
            continue
        if name == "int8":
            out[name] = tree_bytes(quantize_params(state, L, device))
            continue
        kw = {"bf16": dict(qffn=0), "q8aux": dict(qffn=3, q8aux=True)}.get(
            name) or dict(qffn=int(name[len("level"):]))
        if kw["qffn"] >= 3:
            kw["act_scale_inputs"] = (img, ques)
        with torch.no_grad():
            _, prepared = build_production_engine(state, L, H, device=device,
                                                  **kw)
        out[name] = tree_bytes(prepared)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="small,large")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engines", default=",".join(ENGINES))
    args = ap.parse_args(argv)
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    records = []
    for model in args.models.split(","):
        cfg = Config.for_model(model)
        got = footprint(cfg, device, engines=args.engines.split(","))
        record = {"bench": "param_footprint", "model": model,
                  "device": str(device), "bytes": got,
                  "mib": {k: v / 2 ** 20 for k, v in got.items()}}
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
