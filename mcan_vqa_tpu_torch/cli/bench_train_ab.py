"""Same-process interleaved A/B of the train step's parameter layouts on
the card (the port's counterpart of tools/bench_train_ab.py).

    python -m mcan_vqa_tpu_torch.cli.bench_train_ab [standard stacked] \
        [--model small|large] [--batch 64] [--rounds 5] [--calls 10]

Configs, each a ``Trainer`` of its own over the same seed and weights on the
Trainer's shipped route on the card (``train_engine`` "auto": the fused
engine at hidden 512 and 1024, the encoder fused at 512 and plain at 1024,
att_saves / bf16_saves at 1024, dropout drawn in the kernels):

    standard  the MCANet leaves (275 at MCAN-small): each block's train
              layout built in the step (the q / k / v concatenation and
              the transposes forward, their splits backward)
    stacked   ``stacked_params="on"`` (ops/stacked_params.py): one [L, ...]
              leaf per weight role, each block's layout a slice of it

``--model large`` is MCAN-large (hidden 1024, two micro-batches of 32 at
B=64). Each turn is ``--calls`` train steps on one preloaded batch on the
device (random images with 10..60 valid regions, questions of 3..14
tokens, multi-hot targets), after three warm-up steps, timed by CUDA
events (``ab_timer``): the host's time counts, as the Trainer waits for
it. One JSON line of ``ab_timer.report``: per config the median / min /
max ms a step over the rounds, ``spread_pct`` and ``per_s`` (samples a
second), the leaf counts, then the card. ``cli/train_roofline.py --ab``
reads it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from mcan_vqa_tpu_torch.cli.ab_timer import interleaved, report, \
    require_cuda

CONFIGS = ("standard", "stacked")
TOKENS, ANSWERS = 20000, 3129


class _Data:
    """The size and vocabulary a Trainer reads from its train dataset; the
    batches come from ``batch`` (preloaded), not from a loader."""
    ix_to_ans = None
    pretrained_emb = None

    def __init__(self, n):
        self.n, self.token_size, self.ans_size = n, TOKENS, ANSWERS

    def __len__(self):
        return self.n


def batch(torch, cfg, B, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    R, F, T = cfg.img_feat_pad_size, cfg.img_feat_size, cfg.max_token
    img = torch.randn(B, R, F, generator=g, device=dev)
    n = torch.randint(10, R + 1, (B, 1), generator=g, device=dev)
    img = img * (torch.arange(R, device=dev)[None, :, None] < n[..., None])
    ques = torch.randint(1, TOKENS, (B, T), generator=g, device=dev)
    q_len = torch.randint(3, T + 1, (B, 1), generator=g, device=dev)
    ques = ques * (torch.arange(T, device=dev)[None, :] < q_len)
    target = (torch.rand(B, ANSWERS, generator=g, device=dev) < 0.002
              ).float()
    return {"img": img, "ques": ques, "target": target}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--model", default="small", choices=["small", "large"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    for name in args.configs:
        if name not in CONFIGS:
            raise SystemExit(f"unknown config {name!r}")
    torch = require_cuda()
    from mcan_vqa_tpu_torch.configs import Config
    from mcan_vqa_tpu_torch.train.trainer import Trainer, engine_line
    dev = torch.device("cuda")
    data = _Data(args.batch * 1000)
    steps, leaves = {}, {}
    logs = tempfile.mkdtemp()          # the Trainers' log headers
    for name in args.configs:
        cfg = Config.for_model(args.model, batch_size=args.batch,
                               stacked_params="on" if name == "stacked"
                               else "off", verbose=False, log_path=logs,
                               ckpts_dir=logs)
        trainer = Trainer(cfg, data, device=dev)
        state = trainer.stacked_state() if trainer.stacked \
            else trainer.ensure_state()
        leaves[name] = len(list(state.model.parameters()))
        b = batch(torch, cfg, args.batch, dev)
        steps[name] = (lambda t=trainer, s=state, b=b: t.step_fn(s, b))
        route = engine_line(cfg.hidden_size, trainer.fused,
                            trainer.in_kernel_dropout)
    results = interleaved(steps, rounds=args.rounds, calls=args.calls)
    for name, n in leaves.items():
        results[name]["leaves"] = n
    shutil.rmtree(logs, ignore_errors=True)
    report("train_ab", results, per_call=args.batch, model=args.model,
           B=args.batch, hidden=cfg.hidden_size, route=route,
           rounds=args.rounds, calls=args.calls, unit="ms per train step")


if __name__ == "__main__":
    main()
