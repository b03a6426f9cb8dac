"""Offline answer-dictionary builder (the port's copy of
mcan_vqa_tpu/cli/build_answer_dict.py; reference utils/proc_ansdict.py).

Builds {answer: index} over the train + val annotations, keeping the
answers that occur more than --min_freq times, and writes the two-dict
JSON the dataset loads. The published 3129-answer dictionary ships with
the package (``data/answer_dict.json``); this tool regenerates it or
builds one for another corpus.

    python -m mcan_vqa_tpu_torch.cli.build_answer_dict \
        --dataset_path ./datasets/vqa/ [--min_freq 8] [--out answer_dict.json]
"""

from __future__ import annotations

import argparse
import json

from mcan_vqa_tpu_torch.configs import Config
from mcan_vqa_tpu_torch.data.answers import build_answer_dict


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_path", default="./datasets/vqa/")
    p.add_argument("--min_freq", type=int, default=8)
    p.add_argument("--out", default="answer_dict.json")
    args = p.parse_args(argv)

    cfg = Config(dataset_path=args.dataset_path)
    anns = []
    for split in ("train", "val"):
        with open(cfg.answer_path[split]) as f:
            anns += json.load(f)["annotations"]
    ans_to_ix, ix_to_ans = build_answer_dict(anns, min_freq=args.min_freq)
    with open(args.out, "w") as f:
        json.dump([ans_to_ix, ix_to_ans], f)
    print(f"wrote {len(ans_to_ix)} answers to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
