"""Answer normalisation, the answer dictionary, soft-score targets and
top-k answer strings (the port's copy of mcan_vqa_tpu/data/answers.py).

The contraction / digit / article / punctuation tables are the official
VQA evaluation's (reference core/data/ans_punct.py:10-106,
utils/vqaEval.py:20-65), so answers normalise as the reference pipeline
and the official evaluator normalise them. ``answer_dict.json`` beside
this file is the frozen published 3129-answer VQA-v2 dictionary
(reference core/data/load_data.py:84-96), a copy of the JAX package's.
Soft scores from the 10 annotators: core/data/data_utils.py:154-182;
multi-hot targets: :184-191; the offline dictionary builder:
utils/proc_ansdict.py:26-51.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = ("a", "an", "the")

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")

PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            words.append(word)
    return " ".join(CONTRACTIONS.get(w, w) for w in words)


def prep_ans(answer: str) -> str:
    """The full answer normalisation (reference
    core/data/ans_punct.py:103-106)."""
    answer = process_digit_article(process_punctuation(answer))
    return answer.replace(",", "")


_FROZEN_DICT = os.path.join(os.path.dirname(__file__), "answer_dict.json")


def load_answer_dict(path: str = _FROZEN_DICT
                     ) -> Tuple[Dict[str, int], Dict[str, str]]:
    """-> (ans_to_ix, ix_to_ans), the keys of ix_to_ans being strings."""
    with open(path) as f:
        ans_to_ix, ix_to_ans = json.load(f)
    return ans_to_ix, ix_to_ans


def build_answer_dict(annotations: Iterable[dict], min_freq: int = 8
                      ) -> Tuple[Dict[str, int], Dict[str, str]]:
    """The answers given more than ``min_freq`` times, in corpus order
    (reference utils/proc_ansdict.py:26-51)."""
    freq: Dict[str, int] = {}
    for ann in annotations:
        a = prep_ans(ann["multiple_choice_answer"])
        freq[a] = freq.get(a, 0) + 1
    ans_to_ix: Dict[str, int] = {}
    ix_to_ans: Dict[str, str] = {}
    for a, n in freq.items():
        if n > min_freq:
            ix_to_ans[str(len(ans_to_ix))] = a
            ans_to_ix[a] = len(ans_to_ix)
    return ans_to_ix, ix_to_ans

def annotator_score(occurrences: int) -> float:
    """The soft score of an answer given by ``occurrences`` annotators
    (reference core/data/data_utils.py:154-164)."""
    return (0.0, 0.3, 0.6, 0.9)[occurrences] if occurrences < 4 else 1.0


def soft_scores(answers: Sequence[dict], ans_to_ix: Dict[str, int]
                ) -> np.ndarray:
    """The soft target [answer_size] of the 10 annotators' answers
    (reference core/data/data_utils.py:167-182)."""
    target = np.zeros(len(ans_to_ix), dtype=np.float32)
    counts: Dict[str, int] = {}
    for a in answers:
        p = prep_ans(a["answer"])
        counts[p] = counts.get(p, 0) + 1
    for a, n in counts.items():
        ix = ans_to_ix.get(a)
        if ix is not None:
            target[ix] = annotator_score(n)
    return target


def multi_hot(labels: Sequence[int], answer_size: int) -> np.ndarray:
    """The multi-hot target of ``labels`` (reference
    core/data/data_utils.py:184-191)."""
    target = np.zeros(answer_size, dtype=np.float32)
    target[np.asarray(labels, dtype=np.int64)] = 1.0
    return target


def topk_answers(probs_row: np.ndarray, ix_to_ans: Dict, k: int) -> list:
    """Top-k (answer, probability) pairs of one probability row, highest
    first; k is clamped to [1, answer_size]. ix_to_ans keys may be str or
    int. k == 1 takes the plain argmax, so ties break as the evaluators
    break them."""
    row = np.asarray(probs_row)
    k = max(1, min(int(k), row.shape[-1]))
    if k == 1:
        order = [int(row.argmax())]
    else:
        part = np.argpartition(row, -k)[-k:]
        order = part[np.argsort(row[part])[::-1]]

    def name(i):
        return ix_to_ans.get(str(int(i)), ix_to_ans.get(int(i), str(int(i))))

    return [(name(i), float(row[int(i)])) for i in order]
