"""Same-process interleaved A/B of the classifier serving engines on the
card (the port's counterpart of tools/bench_classifier_serve.py).

    python -m mcan_vqa_tpu_torch.cli.bench_classifier_serve [CONFIG ...] \
        [--batch 64] [--layers 6] [--hidden 512] [--rounds 5] [--calls 10]

At the MIMIC-CXR dimensions: B=64 images of 60 regions, img_feat 1024,
hidden 512, 6 layers, 14 labels, a ``ClassifierNet`` drawn from a seed,
each engine built once through the construction path the Trainer's
classifier evaluation ships (``ops/serving.
build_production_classifier_engine``) and timed on the same
device-resident images (10..60 valid regions). Configs:

    plain     ClassifierNet.forward (the plain engine)
    bf16      the all-bf16 SA blocks (qffn=0)
    qffn      the shipped default: int8 FFN, dynamic quant (level 1)
    qffn2     qkv int8 too, dynamic quant (level 2)
    qstatic   static scales calibrated on the bench images (level 3,
              ``calibrate_classifier_act_scales``)
    qstaticN  calibrated at level N (1-7; 4-7 the int4 levels)

One JSON line of ``ab_timer.report``: per config the median / min / max ms
of a forward over the rounds, ``spread_pct`` and ``per_s`` (images a
second), then the card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

from mcan_vqa_tpu_torch.cli.ab_timer import interleaved, report, \
    require_cuda

CONFIGS = ("plain", "bf16", "qffn", "qffn2", "qstatic", "qstatic4",
           "qstatic5", "qstatic6", "qstatic7")
LABELS, REGIONS, IMG_FEAT = 14, 60, 1024


def level_of(name: str):
    """-> (qffn level or None, calibrated)."""
    if name == "bf16":
        return 0, False
    if name.startswith("qffn"):
        return int(name[4:] or 1), False
    if name.startswith("qstatic"):
        return (int(name[7:]) if name[7:] else None), True
    raise SystemExit(f"unknown config {name!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    for name in args.configs:
        if name != "plain":
            level_of(name)
    torch = require_cuda()
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.models.net import ClassifierNet
    from mcan_vqa_tpu_torch.ops.serving import \
        build_production_classifier_engine
    dev = torch.device("cuda")
    H = args.hidden
    cfg = Config(hidden_size=H, ff_size=4 * H, layer=args.layers,
                 multi_head=8, img_feat_size=IMG_FEAT,
                 img_feat_pad_size=REGIONS, flat_mlp_size=512,
                 flat_out_size=H)
    net = ClassifierNet(cfg, LABELS, generator=torch.Generator()
                        .manual_seed(0)).to(dev).eval()
    state = net.state_dict()
    g = torch.Generator(device=dev).manual_seed(0)
    B = args.batch
    img = torch.randn(B, REGIONS, IMG_FEAT, generator=g, device=dev)
    n = torch.randint(10, REGIONS + 1, (B, 1), generator=g, device=dev)
    img = img * (torch.arange(REGIONS, device=dev)[None, :, None]
                 < n[..., None])

    def engine(name):
        if name == "plain":
            return lambda: net(img)
        level, calibrated = level_of(name)
        fwd, prep = build_production_classifier_engine(
            state, cfg.layer, cfg.multi_head, qffn=level,
            act_scale_inputs=img if calibrated else None, device=dev)
        return lambda: fwd(prep, img)

    def inference(fn):
        def run():
            with torch.inference_mode():
                return fn()
        return run

    results = interleaved({n_: inference(engine(n_)) for n_ in args.configs},
                          rounds=args.rounds, calls=args.calls)
    report("classifier_serve_ab", results, per_call=B, B=B,
           layers=args.layers, hidden=H, regions=REGIONS, labels=LABELS,
           rounds=args.rounds, calls=args.calls, unit="ms per forward")


if __name__ == "__main__":
    main()
