"""Accuracy canary for every engine the Predictor ships (the port of
tools/validate_serving_accuracy.py).

Trains MCAN at production width on the card on a task it can learn (class
c of ``--classes`` is feature column c boosted by 5 on every region, its
answer the frozen-dictionary word 7 + 181 c), then scores each serving
engine on a held-out batch against the plain engine with the official VQA
evaluator (the ground truth built in memory from the frozen dictionary):

    reference  the plain engine (``make_eval_step``: the model's forward)
    fused      ``build_production_engine`` default: int8 level 1, dynamic
               scales (the Predictor's first engine)
    qstatic    level 3, static scales calibrated on a separate batch (the
               Predictor after its calibration)
    int8       the full-int8 engine (``Predictor(engine="int8")``)
    int4       level 5, calibrated (``Predictor(engine="int4")``)
    q8aux      level 3 with the static-int8 aux sites, calibrated
               (``Predictor(engine="fused", q8aux=True)``)
    bf16       ``qffn=0``, the all-bf16 blocks

Gate, as the JAX tool's (:219-220), for every engine but int4: top-1
agreement >= 99.5 %, |acc_engine - acc_ref| <= 0.1 points and acc_ref >=
95 (the model learnt the task). JAX gates no int4 engine on accuracy: int4
reports the same three numbers and is held to ``INT4_BOUND`` on the
softmax over the answers, the bound chip_smoke.py holds it to.

Training runs the port's ``make_train_step`` with AdamW (weight decay
1e-4) at a constant or linearly warmed-up lr through the Trainer's engine
on this device (on the card the fused train kernels with in-kernel
dropout; ``--train_engine plain`` the plain one). Every batch is made on
the device from a seeded ``torch.Generator``. Run on the card:

    python -m mcan_vqa_tpu_torch.cli.validate_serving_accuracy

Prints one line per engine, then one JSON line; exits 1 when a gate fails.
``--device cpu --hidden 64 --layers 1 --steps 20`` runs the same flow on
the CPU through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.answers import load_answer_dict
from mcan_vqa_tpu_torch.device import resolve_device
from mcan_vqa_tpu_torch.evals import vqa_eval
from mcan_vqa_tpu_torch.models.net import MCANet
from mcan_vqa_tpu_torch.ops.serving import (build_production_engine,
                                            make_quant_serving_fn,
                                            quantize_params)
from mcan_vqa_tpu_torch.train.optim import make_optimizer
from mcan_vqa_tpu_torch.train.step import make_eval_step, make_train_step
from mcan_vqa_tpu_torch.train.train_state import TrainState
from mcan_vqa_tpu_torch.train.trainer import (make_train_forward,
                                              use_fused_train)

ENGINES = ("fused", "qstatic", "int8", "int4", "q8aux", "bf16")
TOKENS = 64               # question token ids drawn in [1, TOKENS)
# the JAX package's int4 gate, 0.04 on the softmax over the answers
# (tests/test_quant.py:339-370); chip_smoke.py's INT4_BOUND
INT4_BOUND = 4e-2
AGREEMENT, ACC_DELTA, ACC_LEARNT = 0.995, 0.1, 95.0


def class_answers(classes: int) -> np.ndarray:
    """The frozen-dictionary answer index of each class."""
    return np.array([7 + 181 * c for c in range(classes)], np.int64)


def make_batch(cfg, g: torch.Generator, B: int, classes: int, n_ans: int,
               device) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """A batch of the task, drawn on the device from ``g`` -> ({"img",
    "ques", "target"}, class per row)."""
    R, F, T = cfg.img_feat_pad_size, cfg.img_feat_size, cfg.max_token
    cls = torch.randint(0, classes, (B,), generator=g, device=device)
    img = 0.1 * torch.randn(B, R, F, generator=g, device=device)
    img[torch.arange(B, device=device), :, cls] += 5.0
    ques = torch.randint(1, TOKENS, (B, T), generator=g, device=device,
                         dtype=torch.int32)
    ans = torch.as_tensor(class_answers(classes), device=device)[cls]
    target = torch.nn.functional.one_hot(ans, n_ans).float()
    return {"img": img, "ques": ques, "target": target}, cls


def official_accuracy(top: np.ndarray, cls: np.ndarray,
                      ix_to_ans: Dict[str, str], classes: int) -> float:
    """The official accuracy of top-1 answer indices against the classes'
    answers given by all 10 annotators."""
    ans = class_answers(classes)
    gts = {i: {"answers": [ix_to_ans[str(ans[c])]] * 10}
           for i, c in enumerate(cls)}
    res = {i: ix_to_ans[str(int(t))] for i, t in enumerate(top)}
    return vqa_eval.evaluate(gts, res)["overall"]


def build_engine(name: str, state_dict, cfg, cal_inputs, device
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """-> forward(img, ques) -> logits of the named engine, built as the
    Predictor builds it."""
    L, H = cfg.layer, cfg.multi_head
    if name == "int8":
        serve = make_quant_serving_fn(L, H)
        prepared = quantize_params(state_dict, L, device)
    else:
        kw = {"fused": {}, "qstatic": dict(act_scale_inputs=cal_inputs),
              "int4": dict(qffn=5, act_scale_inputs=cal_inputs),
              "q8aux": dict(q8aux=True, act_scale_inputs=cal_inputs),
              "bf16": dict(qffn=0)}[name]
        serve, prepared = build_production_engine(state_dict, L, H,
                                                  device=device, **kw)
    return lambda img, ques: serve(prepared, img, ques)


def softmax_delta(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((torch.softmax(a.double(), -1)
                  - torch.softmax(b.double(), -1)).abs().max())


def train(cfg, model, args, device, n_ans: int) -> Tuple[str, float]:
    """``args.steps`` steps on fresh batches -> (the train engine, the
    last loss)."""
    fused = args.train_engine == "auto" and use_fused_train(cfg, device)
    in_kernel = fused and device.type == "cuda"
    forward_fn = make_train_forward(cfg, fused, in_kernel)
    warmup = args.warmup

    def lr(count: int) -> float:
        return args.lr * min(1.0, count / warmup) if warmup > 0 else args.lr

    step = make_train_step(forward_fn, lr_schedule=lr)
    state = TrainState.create(model, make_optimizer(model.parameters(), cfg),
                              seed=args.seed)
    g = torch.Generator(device=device).manual_seed(args.seed + 100)
    loss = float("nan")
    for i in range(args.steps):
        batch, _ = make_batch(cfg, g, args.batch, args.classes, n_ans,
                              device)
        metrics = step(state, batch)
        if (i + 1) % 50 == 0 or i + 1 == args.steps:
            loss = float(metrics["loss"])
            print(f"step {i + 1}/{args.steps}: loss={loss:.3f}", flush=True)
    engine = (f"fused (in_kernel_dropout={in_kernel})" if fused
              else "plain")
    return engine, loss


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval_batch", type=int, default=256)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=0,
                    help="linear lr warmup steps (0: constant lr); hidden "
                         "1024 needs it to leave the all-zeros basin of "
                         "the summed BCE")
    ap.add_argument("--engines", default=",".join(ENGINES),
                    help=f"comma list of {ENGINES}")
    ap.add_argument("--train_engine", default="auto",
                    choices=["auto", "plain"],
                    help="auto: the Trainer's choice on this device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    names = [n.strip() for n in args.engines.split(",") if n.strip()]
    unknown = sorted(set(names) - set(ENGINES))
    if unknown:
        raise SystemExit(f"unknown engines {unknown}: expected {ENGINES}")
    device = resolve_device(args.device)
    cfg = Config().with_overrides(hidden_size=args.hidden, layer=args.layers,
                                  flat_out_size=args.hidden, use_glove=False)
    _, ix_to_ans = load_answer_dict()
    n_ans = len(ix_to_ans)
    model = MCANet(cfg, token_size=TOKENS, answer_size=n_ans,
                   generator=torch.Generator().manual_seed(args.seed)
                   ).to(device)
    t0 = time.perf_counter()
    train_engine, loss = train(cfg, model, args, device, n_ans)
    train_s = time.perf_counter() - t0

    g = torch.Generator(device=device).manual_seed(777)
    eval_batch, cls = make_batch(cfg, g, args.eval_batch, args.classes,
                                 n_ans, device)
    g = torch.Generator(device=device).manual_seed(555)
    cal, _ = make_batch(cfg, g, args.batch, args.classes, n_ans, device)
    cal_inputs = (cal["img"], cal["ques"])
    img, ques = eval_batch["img"], eval_batch["ques"]
    cls = cls.cpu().numpy()
    with torch.no_grad():
        logits_ref = model(img, ques).float()
    probs_ref = make_eval_step(model)(img, ques)
    top_r = probs_ref.argmax(1).cpu().numpy()
    acc_ref = official_accuracy(top_r, cls, ix_to_ans, args.classes)
    state_dict = model.state_dict()
    report = {"device": str(device), "hidden": args.hidden,
              "layers": args.layers, "steps": args.steps,
              "eval_batch": args.eval_batch, "train_engine": train_engine,
              "last_loss": round(loss, 4), "train_s": round(train_s, 1)}
    ok = True
    for name in names:
        t0 = time.perf_counter()
        forward = build_engine(name, state_dict, cfg, cal_inputs, device)
        with torch.no_grad():
            logits = forward(img, ques).float()
        probs = torch.sigmoid(logits)
        top_e = probs.argmax(1).cpu().numpy()
        max_d = float((probs - probs_ref).abs().max())
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        agreement = float((top_r == top_e).mean())
        acc_eng = official_accuracy(top_e, cls, ix_to_ans, args.classes)
        entry = {"agreement": round(agreement, 4),
                 "acc_ref": round(acc_ref, 2), "acc_engine": round(acc_eng, 2),
                 "max_prob_delta": round(max_d, 5)}
        if name == "int4":
            sm = softmax_delta(logits, logits_ref)
            entry["max_softmax_delta"] = round(sm, 5)
            gate = sm <= INT4_BOUND
            rule = f"softmax delta <= {INT4_BOUND}"
        else:
            gate = (agreement >= AGREEMENT
                    and abs(acc_ref - acc_eng) <= ACC_DELTA
                    and acc_ref >= ACC_LEARNT)
            rule = (f"agreement >= {AGREEMENT}, |dacc| <= {ACC_DELTA}, "
                    f"acc_ref >= {ACC_LEARNT}")
        ok &= gate
        entry.update(gate="PASS" if gate else "FAIL",
                     seconds=round(seconds, 2))
        report[name] = entry
        extra = (f" max_softmax_delta={entry['max_softmax_delta']:.5f}"
                 if name == "int4" else "")
        print(f"{name}: agreement={agreement:.4f} acc_ref={acc_ref:.2f} "
              f"acc_engine={acc_eng:.2f} max_prob_delta={max_d:.5f}{extra} "
              f"({rule}) -> {entry['gate']} in {seconds:.2f} s", flush=True)
    report["ok"] = bool(ok)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
