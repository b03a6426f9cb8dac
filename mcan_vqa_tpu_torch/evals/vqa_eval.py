"""The official VQA-v2 accuracy and its result files (the port's copy of
mcan_vqa_tpu/evals/vqa_eval.py).

Per question (reference utils/vqaEval.py:68-152): the mean over the 10
leave-one-out subsets of the annotators of min(1, matches among the other
nine / 3), with the official normalisation applied to the predicted
answer, and to the ground-truth answers in place only when they are not
all identical (the official quirk, kept). Aggregated overall, per question
type and per answer type.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Sequence

from mcan_vqa_tpu_torch.data.answers import (process_digit_article,
                                             process_punctuation)


def _norm_res(answer: str) -> str:
    a = answer.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(a))


def question_accuracy(gt_answers: Sequence[str], res_answer: str,
                      gt_prenormalized: bool = False) -> float:
    """The official soft accuracy of one prediction against the annotators'
    strings; those are punctuation-normalised only when they disagree
    (utils/vqaEval.py:94-96)."""
    res = _norm_res(res_answer)
    gts = list(gt_answers)
    if not gt_prenormalized and len(set(gts)) > 1:
        gts = [process_punctuation(g) for g in gts]
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matching = sum(1 for g in others if g == res)
        accs.append(min(1.0, matching / 3.0))
    return sum(accs) / len(accs)


def evaluate(gts: Dict[int, Dict[str, Any]], results: Dict[int, str],
             ndigits: int = 2) -> Dict[str, Any]:
    """gts: {question_id: {"answers": [str x10], "question_type",
    "answer_type"}}; results: {question_id: predicted answer}, which must
    cover every question of gts.

    -> {"overall", "perQuestionType", "perAnswerType", "perQuestion"} in
    percent, rounded to ``ndigits``."""
    acc_qa: List[float] = []
    acc_qt: Dict[str, List[float]] = {}
    acc_at: Dict[str, List[float]] = {}
    per_question: Dict[int, float] = {}
    for qid, gt in gts.items():
        if qid not in results:
            raise KeyError(f"missing result for question_id {qid}")
        acc = question_accuracy(gt["answers"], results[qid])
        acc_qa.append(acc)
        per_question[qid] = round(100 * acc, ndigits)
        acc_qt.setdefault(gt.get("question_type", "unknown"), []).append(acc)
        acc_at.setdefault(gt.get("answer_type", "unknown"), []).append(acc)

    def avg(xs):
        return round(100 * sum(xs) / len(xs), ndigits)

    return {
        "overall": avg(acc_qa) if acc_qa else 0.0,
        "perQuestionType": {k: avg(v) for k, v in acc_qt.items()},
        "perAnswerType": {k: avg(v) for k, v in acc_at.items()},
        "perQuestion": per_question,
    }


def load_annotations(annotation_json: str) -> Dict[int, Dict[str, Any]]:
    """v2_mscoco_*_annotations.json -> {question_id: ground-truth record}."""
    with open(annotation_json) as f:
        anns = json.load(f)["annotations"]
    return {
        a["question_id"]: {
            "answers": [x["answer"] for x in a["answers"]],
            "question_type": a.get("question_type", "unknown"),
            "answer_type": a.get("answer_type", "unknown"),
        }
        for a in anns
    }


def load_results(result_json: str) -> Dict[int, str]:
    """An EvalAI result file [{question_id, answer}] -> {question_id:
    answer}."""
    with open(result_json) as f:
        res = json.load(f)
    return {r["question_id"]: r["answer"] for r in res}


def dump_results(question_ids: Iterable[int], answers: Iterable[str],
                 path: str) -> None:
    """Write the EvalAI result file (the reference's upload format,
    cfgs/path_cfgs.py:58)."""
    payload = [{"question_id": int(q), "answer": str(a)}
               for q, a in zip(question_ids, answers)]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
