"""The port's copies of the JAX package's evaluation modules
(mcan_vqa_tpu_torch/evals/, and the answer normalisation and targets of
data/answers.py) against the originals on the same inputs: the official
accuracy, its result files and the reference ``VQA`` / ``VQAEval`` API
equal exactly; ROC-AUC to 1e-12, with ties and a one-sided class."""

import json
import math

import numpy as np
import pytest

from mcan_vqa_tpu.data import answers as janswers
from mcan_vqa_tpu.evals import compat as jcompat
from mcan_vqa_tpu.evals import roc_auc as jroc
from mcan_vqa_tpu.evals import vqa_eval as jeval
from mcan_vqa_tpu_torch.data import answers as tanswers
from mcan_vqa_tpu_torch.evals import compat as tcompat
from mcan_vqa_tpu_torch.evals import roc_auc as troc
from mcan_vqa_tpu_torch.evals import vqa_eval as teval

ANSWER_STRINGS = ["yes", "Yes.", "two", "2", "the cat", "a dog!", "isnt",
                  "dont know", "1,000", "3.5", "red,blue", "hot-dog",
                  "  tennis\tracket\n", "none", "ten", "an apple",
                  "he's", "(left)", "a/b", "100%", "no;", "why?"]
GT_SETS = [["yes"] * 10, ["cat"] * 3 + ["dog"] * 7, ["cat"] + ["dog"] * 9,
           ["two"] * 4 + ["2"] * 6, ["red,blue"] * 5 + ["red blue"] * 5,
           ["hot-dog"] * 2 + ["hot dog"] * 8, ["the cat"] * 10,
           ["dont"] * 3 + ["don't"] * 7]


@pytest.mark.parametrize("text", ANSWER_STRINGS)
def test_answer_normalisation_matches(text):
    assert tanswers.process_punctuation(text) == \
        janswers.process_punctuation(text)
    assert tanswers.process_digit_article(text) == \
        janswers.process_digit_article(text)
    assert tanswers.prep_ans(text) == janswers.prep_ans(text)


def test_targets_and_answer_dict_builder_match():
    a2i, _ = tanswers.load_answer_dict()
    rng = np.random.default_rng(0)
    for _ in range(20):
        given = [{"answer": ANSWER_STRINGS[i]}
                 for i in rng.integers(0, len(ANSWER_STRINGS), 10)]
        np.testing.assert_array_equal(tanswers.soft_scores(given, a2i),
                                      janswers.soft_scores(given, a2i))
    for n in range(12):
        assert tanswers.annotator_score(n) == janswers.annotator_score(n)
    np.testing.assert_array_equal(tanswers.multi_hot([0, 3, 3], 5),
                                  janswers.multi_hot([0, 3, 3], 5))
    anns = [{"multiple_choice_answer": ANSWER_STRINGS[i % 7]}
            for i in range(60)]
    for min_freq in (0, 7, 8):
        assert tanswers.build_answer_dict(anns, min_freq) == \
            janswers.build_answer_dict(anns, min_freq)


@pytest.mark.parametrize("gts", GT_SETS, ids=range(len(GT_SETS)))
def test_question_accuracy_matches(gts):
    for res in ANSWER_STRINGS + sorted(set(gts)):
        for pre in (False, True):
            assert teval.question_accuracy(gts, res, pre) == \
                jeval.question_accuracy(gts, res, pre)


def _gts_and_results(n=40, seed=0):
    rng = np.random.default_rng(seed)
    gts, res = {}, {}
    for q in range(n):
        gts[1000 + q] = {
            "answers": GT_SETS[int(rng.integers(len(GT_SETS)))],
            "question_type": ("what", "how many", "is the")[q % 3],
            "answer_type": ("other", "number", "yes/no")[q % 3]}
        res[1000 + q] = ANSWER_STRINGS[int(rng.integers(
            len(ANSWER_STRINGS)))]
    return gts, res


def test_evaluate_and_result_files_match(tmp_path):
    gts, res = _gts_and_results()
    for nd in (2, 4):
        assert teval.evaluate(gts, res, nd) == jeval.evaluate(gts, res, nd)
    missing = dict(list(res.items())[1:])
    with pytest.raises(KeyError):
        teval.evaluate(gts, missing)
    with pytest.raises(KeyError):
        jeval.evaluate(gts, missing)
    teval.dump_results(res, res.values(), str(tmp_path / "t" / "res.json"))
    jeval.dump_results(res, res.values(), str(tmp_path / "j" / "res.json"))
    assert (tmp_path / "t" / "res.json").read_text() == \
        (tmp_path / "j" / "res.json").read_text()
    assert teval.load_results(str(tmp_path / "t" / "res.json")) == \
        jeval.load_results(str(tmp_path / "j" / "res.json")) == res


def _official_files(tmp_path, n=30):
    gts, res = _gts_and_results(n, seed=1)
    anns = [{"question_id": q, "image_id": q // 3,
             "question_type": g["question_type"],
             "answer_type": g["answer_type"],
             "answers": [{"answer": a, "answer_id": i + 1}
                         for i, a in enumerate(g["answers"])]}
            for q, g in gts.items()]
    qs = [{"question_id": q, "image_id": q // 3, "question": "what?"}
          for q in gts]
    paths = {name: str(tmp_path / f"{name}.json")
             for name in ("ann", "ques", "res")}
    for name, obj in (("ann", {"annotations": anns}),
                      ("ques", {"questions": qs}),
                      ("res", [{"question_id": q, "answer": a}
                               for q, a in res.items()])):
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    return paths, gts


def test_load_annotations_matches(tmp_path):
    paths, gts = _official_files(tmp_path)
    assert teval.load_annotations(paths["ann"]) == \
        jeval.load_annotations(paths["ann"]) == gts


def test_compat_api_matches(tmp_path):
    paths, gts = _official_files(tmp_path)
    out = []
    for mod in (tcompat, jcompat):
        vqa = mod.VQA(paths["ann"], paths["ques"])
        res = vqa.loadRes(paths["res"], paths["ques"])
        ev = mod.VQAEval(vqa, res, n=2)
        ev.evaluate()
        part = mod.VQAEval(vqa, res, n=3)
        part.evaluate(list(gts)[:7])
        out.append((vqa.getQuesIds(), vqa.getQuesIds(imgIds=[340, 341]),
                    vqa.getQuesIds(quesTypes="how many", ansTypes=["number"]),
                    vqa.getImgIds(), vqa.getImgIds(quesIds=[1003, 1004]),
                    vqa.getImgIds(ansTypes="yes/no"), vqa.loadQA(1005),
                    res.dataset, ev.accuracy, ev.evalQA, ev.evalQuesType,
                    ev.evalAnsType, part.accuracy, part.evalQA))
    assert out[0] == out[1]
    assert out[0][8]["overall"] > 0


def test_compat_load_res_refuses_other_questions(tmp_path):
    paths, _ = _official_files(tmp_path)
    with open(paths["res"]) as f:
        res = json.load(f)
    with open(paths["res"], "w") as f:
        json.dump(res[1:] + [{"question_id": 1, "answer": "yes"}], f)
    for mod in (tcompat, jcompat):
        vqa = mod.VQA(paths["ann"], paths["ques"])
        with pytest.raises(AssertionError, match="do not correspond"):
            vqa.loadRes(paths["res"], paths["ques"])


def _same(a, b):
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= 1e-12


@pytest.mark.parametrize("case", ["random", "ties", "one_class", "nan",
                                  "coarse"])
def test_binary_roc_auc_matches(case):
    rng = np.random.default_rng(3)
    y = rng.random(200) < 0.3
    s = rng.random(200)
    if case == "ties":
        s = np.round(s * 4) / 4
    elif case == "one_class":
        y = np.ones(200, bool)
    elif case == "nan":
        s[17] = np.nan
    elif case == "coarse":
        s = (s > 0.5).astype(np.float32)
    t, j = troc.binary_roc_auc(y, s), jroc.binary_roc_auc(y, s)
    assert _same(t, j)
    assert math.isnan(t) == (case in ("one_class", "nan"))


def test_multilabel_roc_auc_matches():
    rng = np.random.default_rng(4)
    y = rng.random((120, 9)) < 0.2
    y[:, 2] = False                       # a class with no positive
    s = np.round(rng.random((120, 9)), 2)  # ties
    t, j = troc.multilabel_roc_auc(y, s), jroc.multilabel_roc_auc(y, s)
    assert all(_same(a, b) for a, b in zip(t["per_class"], j["per_class"]))
    assert _same(t["macro"], j["macro"]) and _same(t["micro"], j["micro"])
    assert math.isnan(t["per_class"][2])
    one = troc.multilabel_roc_auc(np.zeros((5, 2), bool), s[:5, :2])
    assert math.isnan(one["macro"]) and math.isnan(one["micro"])
