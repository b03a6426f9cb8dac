"""Local grid sweep over layer x lr_base of the port
(mcan_vqa_tpu/cli/sweep.py; the reference's wandb sweep, run_mimic.py:
153-167, rebuilt offline).

    python -m mcan_vqa_tpu_torch.cli.sweep --task mimic --layers 4 6 \
        --lrs 1e-4 5e-5 --out results/sweep_summary.json -- \
        --run train --max_epoch 13 [any run_mimic / run_vqa flag]

Runs each grid point in this process, one after the other, through the
port's ``run_vqa`` or ``run_mimic`` with the unrecognized flags forwarded
and ``--layer``, ``--lr_base`` and ``--version sweep_l{layer}_lr{lr:g}``
added, and rewrites the summary JSON (one record per point: layer,
lr_base, version, returncode, and the error of a failed point) after every
point. A point that raises, or a forwarded flag the task refuses, is
recorded and the sweep goes on; the command exits 1 if any point failed.
Per-run logs land in the usual RunLogger files.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Any, Dict, List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="grid sweep over layer x lr_base")
    p.add_argument("--task", default="vqa", choices=["vqa", "mimic"])
    p.add_argument("--layers", type=int, nargs="+", default=[4, 6])
    p.add_argument("--lrs", type=float, nargs="+", default=[1e-4, 5e-5])
    p.add_argument("--out", default="./results/sweep_summary.json")
    # everything unrecognized is forwarded to the task's command line
    args, rest = p.parse_known_args(argv)
    args.base_args = [a for a in rest if a != "--"]
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.task == "vqa":
        from mcan_vqa_tpu_torch.cli.run_vqa import main as task_main
    else:
        from mcan_vqa_tpu_torch.cli.run_mimic import main as task_main

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    summary: List[Dict[str, Any]] = []

    def flush():
        # after every point: a crash keeps the finished points' records
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)

    failed = 0
    for layer, lr in itertools.product(args.layers, args.lrs):
        version = f"sweep_l{layer}_lr{lr:g}"
        argv_run = args.base_args + [f"--layer={layer}", f"--lr_base={lr}",
                                     f"--version={version}"]
        print(f"=== sweep point layer={layer} lr={lr:g} ===", flush=True)
        rec = {"layer": layer, "lr_base": lr, "version": version}
        try:
            rec["returncode"] = task_main(argv_run)
        except SystemExit as e:          # argparse refused a forwarded flag
            rec["returncode"] = int(e.code or 0)
            rec["error"] = "SystemExit (bad forwarded flag?)"
        except Exception as e:  # noqa: BLE001 (recorded; the sweep goes on)
            rec["returncode"] = 1
            rec["error"] = f"{type(e).__name__}: {e}"
            print(f"sweep point {version} FAILED: {rec['error']}",
                  flush=True)
        if rec.get("error") or rec["returncode"]:
            failed += 1
        summary.append(rec)
        flush()
    print(f"sweep summary -> {args.out} "
          f"({len(summary) - failed}/{len(summary)} points ok)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
