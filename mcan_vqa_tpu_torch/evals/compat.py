"""The reference's evaluation API over ``vqa_eval`` (the port's copy of
mcan_vqa_tpu/evals/compat.py): ``VQA(annFile, quesFile)``,
``vqa.loadRes(resFile, quesFile)`` and ``VQAEval(vqa, vqaRes).evaluate()``
(reference utils/vqa.py:24-182, utils/vqaEval.py:10-120), so scripts
written against it run unchanged."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from mcan_vqa_tpu_torch.evals import vqa_eval


def _listify(x) -> List[Any]:
    return x if isinstance(x, list) else [x] if x is not None else []


class VQA:
    """Annotations and questions indexed by question_id."""

    def __init__(self, annotation_file: Optional[str] = None,
                 question_file: Optional[str] = None):
        self.dataset: Dict[str, Any] = {}
        self.questions: Dict[str, Any] = {}
        self.qa: Dict[int, Any] = {}
        self.qqa: Dict[int, Any] = {}
        if annotation_file and question_file:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            with open(question_file) as f:
                self.questions = json.load(f)
            self.createIndex()

    def createIndex(self) -> None:
        self.qa = {a["question_id"]: a
                   for a in self.dataset.get("annotations", [])}
        self.qqa = {q["question_id"]: q
                    for q in self.questions.get("questions", [])}

    def getQuesIds(self, imgIds=None, quesTypes=None, ansTypes=None
                   ) -> List[int]:
        imgIds, quesTypes, ansTypes = map(_listify,
                                          (imgIds, quesTypes, ansTypes))
        anns = self.dataset.get("annotations", [])
        if imgIds:
            anns = [a for a in anns if a["image_id"] in imgIds]
        if quesTypes:
            anns = [a for a in anns if a["question_type"] in quesTypes]
        if ansTypes:
            anns = [a for a in anns if a["answer_type"] in ansTypes]
        return [a["question_id"] for a in anns]

    def getImgIds(self, quesIds=None, quesTypes=None, ansTypes=None
                  ) -> List[int]:
        quesIds, quesTypes, ansTypes = map(_listify,
                                           (quesIds, quesTypes, ansTypes))
        anns = self.dataset.get("annotations", [])
        if quesIds:
            anns = [self.qa[q] for q in quesIds if q in self.qa]
        if quesTypes:
            anns = [a for a in anns if a["question_type"] in quesTypes]
        if ansTypes:
            anns = [a for a in anns if a["answer_type"] in ansTypes]
        return [a["image_id"] for a in anns]

    def loadQA(self, ids) -> List[Any]:
        ids = ids if isinstance(ids, list) else [ids]
        return [self.qa[i] for i in ids]

    def loadRes(self, resFile: str, quesFile: str) -> "VQA":
        """A result file -> a VQA holding one record per question (the
        answer with the ground truth's image id and types). The results'
        question ids must be the annotations' (utils/vqa.py's assertion)."""
        res = VQA()
        with open(quesFile) as f:
            res.questions = json.load(f)
        with open(resFile) as f:
            results = json.load(f)
        res_ids = {r["question_id"] for r in results}
        gt_ids = set(self.qa)
        assert res_ids == gt_ids, (
            f"Results do not correspond to current VQA set: "
            f"{len(gt_ids - res_ids)} GT question(s) missing from the "
            f"results, {len(res_ids - gt_ids)} result id(s) unknown")
        anns = []
        for r in results:
            qid = r["question_id"]
            gt = self.qa.get(qid, {})
            anns.append({
                "question_id": qid,
                "answer": r["answer"],
                "image_id": gt.get("image_id"),
                "question_type": gt.get("question_type", "unknown"),
                "answer_type": gt.get("answer_type", "unknown"),
            })
        res.dataset = {"annotations": anns}
        res.createIndex()
        return res


class VQAEval:
    """The official evaluator's interface over ``vqa_eval.evaluate``."""

    def __init__(self, vqa: VQA, vqaRes: VQA, n: int = 2):
        self.n = n
        self.vqa = vqa
        self.vqaRes = vqaRes
        self.accuracy: Dict[str, Any] = {}
        self.evalQA: Dict[int, float] = {}
        self.evalQuesType: Dict[str, Dict[int, float]] = {}
        self.evalAnsType: Dict[str, Dict[int, float]] = {}
        self.params = {"question_id": list(vqa.qa.keys())}

    def evaluate(self, quesIds: Optional[List[int]] = None) -> None:
        if quesIds is None:
            quesIds = list(self.params["question_id"])
        gts = {}
        results = {}
        for qid in quesIds:
            a = self.vqa.qa[qid]
            gts[qid] = {
                "answers": [x["answer"] for x in a["answers"]],
                "question_type": a.get("question_type", "unknown"),
                "answer_type": a.get("answer_type", "unknown"),
            }
            results[qid] = self.vqaRes.qa[qid]["answer"]
        out = vqa_eval.evaluate(gts, results, ndigits=self.n)
        self.accuracy = {
            "overall": out["overall"],
            "perQuestionType": out["perQuestionType"],
            "perAnswerType": out["perAnswerType"],
        }
        self.evalQA = out["perQuestion"]
        for qid, acc in out["perQuestion"].items():
            a = self.vqa.qa[qid]
            self.evalQuesType.setdefault(
                a.get("question_type", "unknown"), {})[qid] = acc
            self.evalAnsType.setdefault(
                a.get("answer_type", "unknown"), {})[qid] = acc
