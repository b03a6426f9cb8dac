"""Run logging: a plain-text log file and its JSONL mirror
(mcan_vqa_tpu/utils/logging.py::RunLogger; reference core/exec.py:132-140,
216-235).

``log_run_<version>.txt`` starts with the time and the full config dump
(``header``, written by the constructor and again after a fresh run's
``clear``), then takes one line per epoch; ``log_run_<version>.jsonl``
holds the same epoch records as JSON objects. ``StepMeter`` prints the
step rate to the console.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    def __init__(self, log_dir: str, version: str,
                 cfg_dict: Optional[Dict] = None, echo: bool = True,
                 enabled: bool = True):
        """enabled False: a logger that writes and prints nothing (the
        ranks other than 0 of a mesh)."""
        self.path = os.path.join(log_dir, f"log_run_{version}.txt")
        self.echo = echo
        self.enabled = enabled
        self.cfg_dict = cfg_dict
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
        self.header()

    def header(self) -> None:
        """The time and the config dump (the reference's log head,
        core/exec.py:132-140)."""
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(f"NOW TIME: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
            if self.cfg_dict is not None:
                f.write(json.dumps(self.cfg_dict, default=str) + "\n")

    @property
    def jsonl_path(self) -> str:
        return self.path.replace(".txt", ".jsonl")

    def clear(self) -> None:
        """Remove this version's log and its JSONL mirror (the reference's
        empty_log on a fresh training run)."""
        if not self.enabled:
            return
        for p in (self.path, self.jsonl_path):
            if os.path.exists(p):
                os.remove(p)

    def write(self, line: str) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(line.rstrip("\n") + "\n")
        if self.echo:
            print(line, flush=True)

    def jsonl(self, obj: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(obj, default=str) + "\n")

    def epoch(self, epoch: int, metrics: Dict[str, Any]) -> None:
        parts = ", ".join(f"{k}={v:.6g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in metrics.items())
        self.write(f"epoch {epoch}: {parts}")
        self.jsonl({"epoch": epoch, **{
            k: (float(v) if isinstance(v, (int, float)) else v)
            for k, v in metrics.items()}})


class StepMeter:
    """Console step-rate meter (tqdm stand-in that is log-file friendly;
    mcan_vqa_tpu/utils/logging.py:69-90)."""

    def __init__(self, total: int, print_every: int = 50,
                 enabled: bool = True):
        self.total = total
        self.print_every = print_every
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.n = 0

    def update(self, metrics: Optional[Dict[str, Any]] = None) -> None:
        """One step; every ``print_every`` steps a line with the rate and
        ``metrics`` (tensors are read only then)."""
        self.n += 1
        if not self.enabled or self.n % self.print_every:
            return
        dt = time.perf_counter() - self.t0
        rate = self.n / dt if dt > 0 else 0.0
        extra = ""
        if metrics:
            extra = " " + " ".join(
                f"{k}={float(v):.4g}" for k, v in metrics.items())
        print(f"  step {self.n}/{self.total} ({rate:.1f} it/s){extra}",
              flush=True)
