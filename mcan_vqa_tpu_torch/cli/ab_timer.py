"""Interleaved rounds: the timer of the port's A/B benches.

Processes on one card disagree by up to 1.4x on the same train step
(PERF.md §5), so two configurations are compared only inside one process,
each timed once per round, round after round:

    stats = interleaved({"a": call_a, "b": call_b}, rounds=5, calls=10)

Each turn is ``bench_stacks.median_ms`` for one round: three warm-up calls,
then CUDA events around ``calls`` eager calls of the config, so the host's
time to issue the launches counts where it exceeds the device's (what a
caller of the engine or the Trainer waits for). The inputs are on the
device before the first round. Per config: the median, min and max of
its rounds in ms and ``spread_pct`` = (max - min) / median x 100.
``report`` prints them as one JSON line with the card's name and power
limit. Used by ``bench_serving_ab``, ``bench_classifier_serve`` and
``bench_train_ab``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
from typing import Callable, Dict, List, Mapping, Optional


def stats(times: List[float]) -> Dict[str, float]:
    """median / min / max ms of the rounds and their spread in % of the
    median."""
    med = statistics.median(times)
    return {"ms": med, "min_ms": min(times), "max_ms": max(times),
            "spread_pct": (max(times) - min(times)) / med * 100.0
            if med else 0.0}


def interleaved(configs: Mapping[str, Callable[[], object]],
                rounds: int = 5, calls: int = 10,
                timer: Optional[Callable[[Callable], float]] = None
                ) -> Dict[str, Dict[str, float]]:
    """Every config timed once per round, in the given order, for
    ``rounds`` rounds -> {name: stats of its rounds, with "rounds" the
    list of ms}. timer(fn) -> ms per call of one turn (default: CUDA events
    around ``calls`` calls)."""
    if timer is None:
        import torch

        from mcan_vqa_tpu_torch.cli.bench_stacks import median_ms

        def timer(fn):
            return median_ms(torch, fn, rounds=1, calls=calls)
    times: Dict[str, List[float]] = {name: [] for name in configs}
    for _ in range(rounds):
        for name, fn in configs.items():
            times[name].append(timer(fn))
    return {name: dict(stats(ts), rounds=ts) for name, ts in times.items()}


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip() or smi.stderr.strip()


def report(bench: str, results: Mapping[str, Mapping[str, float]],
           per_call: Optional[int] = None, **fields) -> dict:
    """Print one JSON line: the bench, its fields, each config's stats
    (and "per_s", per_call items / its median seconds, where per_call is
    given), the card. -> the record."""
    configs = {}
    for name, s in results.items():
        row = dict(s)
        if per_call and s.get("ms"):
            row["per_s"] = per_call / (s["ms"] / 1e3)
        configs[name] = row
    record = dict(bench=bench, **fields, configs=configs, card=card())
    print(json.dumps(record), flush=True)
    return record


def require_cuda():
    """torch, after refusing without a CUDA device: these benches time the
    card's kernels and have no CPU fallback."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this bench times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch
