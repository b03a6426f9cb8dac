"""Pack a split's per-image npz features into the fp16 memmap cache once
(the port's copy of mcan_vqa_tpu/cli/pack_features.py):

    python -m mcan_vqa_tpu_torch.cli.pack_features --split train \
        --split val --feature_path ./datasets/coco_extract \
        --cache_path ./datasets/feature_cache

``VQADataset`` then reads the split from ``<cache_path>/<split>`` instead
of opening one npz per image (reference core/data/load_data.py:113-118).
Exits 1 when a requested split's directory is missing.
"""

from __future__ import annotations

import argparse
import os

from mcan_vqa_tpu_torch.data.features import PackedFeatureCache

_SPLIT_DIRS = {"train": "train2014", "val": "val2014", "test": "test2015"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--split", action="append", required=True,
                   choices=list(_SPLIT_DIRS))
    p.add_argument("--feature_path", default="./datasets/coco_extract")
    p.add_argument("--cache_path", default="./datasets/feature_cache")
    p.add_argument("--feat_dim", type=int, default=2048)
    args = p.parse_args(argv)

    missing = 0
    for split in args.split:
        src = os.path.join(args.feature_path, _SPLIT_DIRS[split])
        dst = os.path.join(args.cache_path, split)
        if not os.path.isdir(src):
            print(f"skip {split}: {src} not found")
            missing += 1
            continue
        print(f"packing {split}: {src} -> {dst}")
        cache = PackedFeatureCache.build(src, dst, feat_dim=args.feat_dim)
        rows = sum(n for _, n in cache.index.values())
        print(f"  {len(cache.index)} images, {rows} rows, fp16")
    return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
