"""Same-process interleaved A/B of the serving engines on the card (the
port's counterpart of tools/bench_serving_ab.py).

    python -m mcan_vqa_tpu_torch.cli.bench_serving_ab [CONFIG ...] \
        [--model small|large] [--batches 1,8,64] [--rounds 5] [--calls 10]

Every config goes through the construction path the ``Predictor`` uses
(``ops/serving.build_production_engine``), over MCANet weights drawn from
a seed (token_size 20000, 3129 answers), built once per model and timed at
each batch on the same device-resident inputs (ragged regions, 10..R valid;
ragged questions, 3..T tokens). Configs:

    plain     MCANet.forward (the f32-stream plain engine)
    bf16      the all-bf16 blocks (qffn=0)
    qffn      the shipped default: int8 FFN, dynamic per-row quant (level 1)
    qffn2     qkv int8 at every width, dynamic quant (level 2)
    qstatic   static activation scales calibrated on the B=64 inputs
              (level 3, Predictor(act_calibration=))
    qstaticN  calibrated at level N (2-7: 4 / 5 the int4 FFN / FFN + qkv
              weights, Predictor(engine="int4") is 5; 6 / 7 the same
              weights with bf16-dequant compute)
    qaux / qauxN  level 3 / N + the static-int8 aux sites (cross k/v, the
              AttFlat merges, the head; Predictor(q8aux=True))
    int8      the full-int8 engine (Predictor(engine="int8"))

JAX's ``@gN`` (the packing group) and ``@cN`` (chunking inside one jit)
modifiers have no counterpart: the port attends per sample and runs
eagerly. The defaults take every config above. Each (model, batch) prints
one JSON line of ``ab_timer.report``: per config the median / min / max ms
of a forward over the rounds, ``spread_pct`` and ``per_s`` (samples a
second), then the card. ``BENCH_MODEL``, ``BENCH_BATCH`` and
``BENCH_ROUNDS`` give the defaults of ``--model``, ``--batches`` and
``--rounds``, as the JAX tool reads them. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os

from mcan_vqa_tpu_torch.cli.ab_timer import interleaved, report, \
    require_cuda

CONFIGS = ("plain", "bf16", "qffn", "qffn2", "qstatic", "qstatic2",
           "qstatic3", "qstatic4", "qstatic5", "qstatic6", "qstatic7",
           "qaux", "qaux5", "int8")
TOKENS, ANSWERS = 20000, 3129


def engine_kwargs(name: str) -> dict:
    """build_production_engine's arguments of a named config (the
    calibration batch added by the caller where "calibrated")."""
    if name == "bf16":
        return dict(qffn=0)
    if name == "qffn":
        return dict(qffn=1)
    if name == "qffn2":
        return dict(qffn=2)
    for prefix, aux in (("qstatic", False), ("qaux", True)):
        if name.startswith(prefix):
            level = name[len(prefix):]
            return dict(qffn=int(level) if level else None, q8aux=aux,
                        calibrated=True)
    raise SystemExit(f"unknown config {name!r}")


def make_inputs(torch, cfg, B: int, dev, seed: int = 0):
    """[B, R, F] image rows with 10..R valid, [B, T] question ids with
    3..T tokens, on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    R, F, T = cfg.img_feat_pad_size, cfg.img_feat_size, cfg.max_token
    img = torch.randn(B, R, F, generator=g, device=dev)
    n = torch.randint(10, R + 1, (B, 1), generator=g, device=dev)
    img = img * (torch.arange(R, device=dev)[None, :, None] < n[..., None])
    ques = torch.randint(1, TOKENS, (B, T), generator=g, device=dev)
    q_len = torch.randint(3, T + 1, (B, 1), generator=g, device=dev)
    return img, ques * (torch.arange(T, device=dev)[None, :] < q_len)


def build(name, net, state, cfg, calib, dev):
    """-> a call(img, ques) of the named config."""
    from mcan_vqa_tpu_torch.ops.serving import (build_production_engine,
                                                make_quant_serving_fn,
                                                quantize_params)
    if name == "plain":
        return net
    if name == "int8":
        fwd = make_quant_serving_fn(cfg.layer, cfg.multi_head)
        prep = quantize_params(state, cfg.layer, dev)
        return lambda img, ques: fwd(prep, img, ques)
    kw = engine_kwargs(name)
    if kw.pop("calibrated", False):
        kw["act_scale_inputs"] = calib
    fwd, prep = build_production_engine(state, cfg.layer, cfg.multi_head,
                                        device=dev, **kw)
    return lambda img, ques: fwd(prep, img, ques)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--model", default=os.environ.get("BENCH_MODEL",
                                                      "small"),
                    choices=["small", "large"])
    ap.add_argument("--batches", default=os.environ.get("BENCH_BATCH",
                                                        "1,8,64"))
    ap.add_argument("--rounds", type=int,
                    default=int(os.environ.get("BENCH_ROUNDS", "5")))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    for name in args.configs:
        if name not in ("plain", "int8"):
            engine_kwargs(name)
    torch = require_cuda()
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import MCANet
    dev = torch.device("cuda")
    cfg = Config.for_model(args.model)
    net = MCANet(cfg, TOKENS, ANSWERS,
                 generator=torch.Generator().manual_seed(0)).to(dev).eval()
    state = net.state_dict()
    calib = make_inputs(torch, cfg, 64, dev, seed=1)
    engines = {name: build(name, net, state, cfg, calib, dev)
               for name in args.configs}
    for B in (int(b) for b in args.batches.split(",")):
        img, ques = make_inputs(torch, cfg, B, dev)

        def call(engine):
            def run():
                with torch.inference_mode():
                    return engine(img, ques)
            return run

        results = interleaved({n: call(e) for n, e in engines.items()},
                              rounds=args.rounds, calls=args.calls)
        report("serving_ab", results, per_call=B, model=args.model, B=B,
               rounds=args.rounds, calls=args.calls,
               unit="ms per forward")


if __name__ == "__main__":
    main()
