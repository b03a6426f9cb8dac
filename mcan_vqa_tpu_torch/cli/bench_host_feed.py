"""Host feed: how fast the port's loader assembles batches on the host
(the port's counterpart of tools/bench_host_feed.py).

    python -m mcan_vqa_tpu_torch.cli.bench_host_feed --target RATE \
        [--items 4000] [--batch 64] [--threads 1 2 4 8]
    python -m mcan_vqa_tpu_torch.cli.bench_host_feed --target-from AB.json

Builds a packed fp16 feature cache (``data/features.PackedFeatureCache``,
the layout ``cli/pack_features.py`` writes) of ``--items`` images at BUTD
serving dimensions (10..60 rows of 2048 each) in a temporary directory,
and times ``data/pipeline.BatchLoader._assemble`` -- the numpy assembly of
one batch from ``example(i)``: each image padded to 60 rows in f32, its
question's 14 ids, its 3129 soft scores -- with 1, 2, 4, 8 threads each
assembling batches of their own. Prints one JSON line: samples/s and GB/s
of images out per thread count, the best rate, its rate per thread, and
the threads it would take to feed ``--target`` samples/s. The target has
no default: give it, or ``--target-from`` a JSON line of
``bench_serving_ab`` (its fastest config's ``per_s``). Pure host work: no
CUDA device needed.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ANSWERS, TOKENS = 3129, 14


class _FeedSet:
    """``VQADataset.example``'s train form over a packed cache."""

    def __init__(self, cache, pad: int, rng):
        self.cache, self.pad = cache, pad
        n = len(cache.index)
        self.ques = rng.integers(1, 20000, (n, TOKENS)).astype(np.int32)
        self.answer = rng.integers(0, ANSWERS, n)

    def __len__(self):
        return len(self.cache.index)

    def example(self, i: int):
        target = np.zeros(ANSWERS, np.float32)
        target[self.answer[i]] = 1.0
        return {"img": self.cache.get_padded(str(i), self.pad),
                "ques": self.ques[i], "target": target}


def write_cache(path: str, items: int, dim: int, pad: int, rng):
    """A packed fp16 cache of ``items`` images of 10..pad rows."""
    from mcan_vqa_tpu_torch.data.features import PackedFeatureCache
    lens = rng.integers(10, pad + 1, items)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    rows = int(lens.sum())
    mm = np.memmap(os.path.join(path, "features.bin"), dtype=np.float16,
                   mode="w+", shape=(rows, dim))
    for lo in range(0, rows, 65536):
        hi = min(rows, lo + 65536)
        mm[lo:hi] = rng.standard_normal((hi - lo, dim), np.float32)
    mm.flush()
    with open(os.path.join(path, "index.json"), "w") as f:
        json.dump({"feat_dim": dim, "total_rows": rows,
                   "index": {str(i): [int(s), int(n)] for i, (s, n) in
                             enumerate(zip(starts, lens))}}, f)
    return PackedFeatureCache(path), rows


def target_from(path: str) -> float:
    """The fastest config's samples/s in a bench_serving_ab JSON line."""
    with open(path) as f:
        lines = [json.loads(x) for x in f if x.strip().startswith("{")]
    rates = [c["per_s"] for line in lines
             if line.get("bench") == "serving_ab"
             for c in line["configs"].values() if c.get("per_s")]
    if not rates:
        raise SystemExit(f"{path}: no bench_serving_ab line with per_s")
    return max(rates)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--items", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--pad", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20,
                    help="batches each thread count assembles")
    ap.add_argument("--threads", type=int, nargs="*", default=[1, 2, 4, 8])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--target", type=float,
                     help="the serving rate to feed, samples/s")
    src.add_argument("--target-from", dest="target_from",
                     help="a file holding a bench_serving_ab JSON line")
    args = ap.parse_args(argv)
    target = args.target if args.target is not None \
        else target_from(args.target_from)

    from mcan_vqa_tpu_torch.data.pipeline import BatchLoader
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        cache, rows = write_cache(tmp, args.items, args.dim, args.pad, rng)
        loader = BatchLoader(_FeedSet(cache, args.pad, rng), args.batch,
                             "cpu")
        valid = np.ones(args.batch, bool)

        def assemble(idx):
            return loader._assemble(idx, valid)

        assemble(rng.integers(0, args.items, args.batch))     # warm-up
        per = {}
        for nt in args.threads:
            batches = [rng.integers(0, args.items, args.batch)
                       for _ in range(args.iters * nt)]
            with ThreadPoolExecutor(nt) as pool:
                t0 = time.perf_counter()
                list(pool.map(assemble, batches))
                dt = time.perf_counter() - t0
            rate = len(batches) * args.batch / dt
            per[str(nt)] = {"samples_per_s": rate, "img_gb_per_s":
                            rate * args.pad * args.dim * 4 / 1e9}
    best_nt = int(max(per, key=lambda k: per[k]["samples_per_s"]))
    best = per[str(best_nt)]["samples_per_s"]
    record = {"bench": "host_feed", "items": args.items,
              "cache_rows": rows, "dim": args.dim, "pad": args.pad,
              "batch": args.batch, "host_cores": os.cpu_count(),
              "threads": per, "best_samples_per_s": best,
              "best_threads": best_nt, "per_thread": best / best_nt,
              "target_samples_per_s": target,
              "threads_for_target": target / (best / best_nt)}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
