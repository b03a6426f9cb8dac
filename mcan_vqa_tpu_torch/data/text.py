"""Question text: cleaning, vocabulary, index encoding (the port's copy of
mcan_vqa_tpu/data/text.py, the parts the port uses).

Pure Python and numpy. The cleaning regex and the PAD / UNK layout follow
the reference (core/data/data_utils.py:53-82, 133-151), so vocabularies
and question-index arrays equal the JAX package's bit for bit
(tests/test_torch_data.py holds the two side by side).
"""

from __future__ import annotations

import hashlib
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

PAD_TOKEN = "PAD"
UNK_TOKEN = "UNK"
PAD_IX = 0
UNK_IX = 1

# strip sentence punctuation, split hyphen / slash compounds
_CLEAN_RE = re.compile(r"([.,'!?\"()*#:;])")


def clean_question(text: str) -> List[str]:
    """Lowercase, strip punctuation, split '-' / '/' compounds, split on
    whitespace."""
    return (_CLEAN_RE.sub("", text.lower())
            .replace("-", " ").replace("/", " ").split())


def build_vocab(questions: Iterable[str],
                glove_lookup: Optional[Callable[[str], np.ndarray]] = None,
                embed_dim: int = 300) -> Tuple[Dict[str, int], np.ndarray]:
    """{token: index} in corpus order with PAD=0 and UNK=1 first, and the
    [V, embed_dim] embedding table. Without ``glove_lookup`` each token's
    vector is a Gaussian seeded by the md5 of the token (not ``hash()``,
    which is salted per process)."""
    token_to_ix: Dict[str, int] = {PAD_TOKEN: PAD_IX, UNK_TOKEN: UNK_IX}

    def embed(word: str) -> np.ndarray:
        if glove_lookup is not None:
            return np.asarray(glove_lookup(word), dtype=np.float32)
        seed = int.from_bytes(hashlib.md5(word.encode()).digest()[:4],
                              "little")
        return np.random.default_rng(seed).normal(
            0, 1, embed_dim).astype(np.float32)

    vectors = [embed(PAD_TOKEN), embed(UNK_TOKEN)]
    for q in questions:
        for word in clean_question(q):
            if word not in token_to_ix:
                token_to_ix[word] = len(token_to_ix)
                vectors.append(embed(word))
    return token_to_ix, np.stack(vectors).astype(np.float32)


def encode_question(text: str, token_to_ix: Dict[str, int],
                    max_token: int) -> np.ndarray:
    """-> int32 [max_token]: unknown words UNK, the tail PAD."""
    ques_ix = np.zeros(max_token, dtype=np.int32)
    for ix, word in enumerate(clean_question(text)):
        if ix == max_token:
            break
        ques_ix[ix] = token_to_ix.get(word, UNK_IX)
    return ques_ix


def encode_questions(texts: Iterable[str], token_to_ix: Dict[str, int],
                     max_token: int) -> np.ndarray:
    """-> int32 [N, max_token]."""
    return np.stack([encode_question(t, token_to_ix, max_token)
                     for t in texts])
