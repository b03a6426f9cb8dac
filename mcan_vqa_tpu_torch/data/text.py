"""Question text: cleaning, vocabulary, index encoding and the vocabulary
cache (the port's copy of mcan_vqa_tpu/data/text.py).

Pure Python and numpy. The cleaning regex and the PAD / UNK layout follow
the reference (core/data/data_utils.py:53-82, 133-151), so vocabularies
and question-index arrays equal the JAX package's bit for bit
(tests/test_torch_data.py holds the two side by side). GloVe vectors come
from spaCy's ``en_core_web_lg`` where it is installed
(``spacy_glove_lookup``); without it every token gets a Gaussian seeded by
its md5, with a warning. A built vocabulary is cached as an npz
(``save_vocab`` / ``load_vocab``), so a run needs spaCy at most once.
"""

from __future__ import annotations

import hashlib
import json
import re
import warnings
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


def vocab_cache_file(path: str) -> str:
    """The file a vocabulary cache path names: np.savez appends ".npz" to
    a path without it, so the save and the caller's exists-check both go
    through this."""
    return path if path.endswith(".npz") else path + ".npz"


def save_vocab(path: str, token_to_ix: Dict[str, int], emb: np.ndarray,
               meta: Optional[dict] = None) -> None:
    """meta: an optional JSON-able record of what built the vocabulary
    (the question files, whether GloVe backed it), read back by
    ``load_vocab_meta`` to tell a stale cache."""
    tokens = sorted(token_to_ix, key=token_to_ix.get)
    np.savez_compressed(vocab_cache_file(path),
                        tokens=np.array(tokens, dtype=object), emb=emb,
                        meta=json.dumps(meta) if meta is not None else "")


def load_vocab(path: str) -> Tuple[Dict[str, int], np.ndarray]:
    """A cache ``save_vocab`` wrote (its token list is an object array, so
    only this program's own caches may be loaded)."""
    with np.load(vocab_cache_file(path), allow_pickle=True) as z:
        tokens = list(z["tokens"])
        return ({t: i for i, t in enumerate(tokens)},
                z["emb"].astype(np.float32))


def load_vocab_meta(path: str) -> Optional[dict]:
    """The record ``save_vocab`` stored, or None (a cache saved without
    one)."""
    with np.load(vocab_cache_file(path), allow_pickle=True) as z:
        raw = str(z["meta"]) if "meta" in z.files else ""
    return json.loads(raw) if raw else None


GLOVE_MODEL = "en_core_web_lg"


def glove_available() -> bool:
    """Whether ``spacy_glove_lookup`` can load its vectors: spaCy and its
    ``en_core_web_lg`` model both importable (probed, not loaded)."""
    from importlib.util import find_spec
    return find_spec("spacy") is not None and \
        find_spec(GLOVE_MODEL) is not None


def spacy_glove_lookup():
    """A token -> GloVe vector lookup through spaCy's en_core_web_lg, or
    None with a warning where it is not installed: the caller then falls
    back to the md5-seeded vectors, and the warning keeps such a run from
    passing for a GloVe one."""
    try:
        import spacy

        nlp = spacy.load(GLOVE_MODEL)
        return lambda word: nlp(word).vector
    except Exception as e:
        warnings.warn(
            f"spaCy GloVe lookup unavailable ({e!r}): use_glove falls "
            f"back to deterministic random embeddings -- install spaCy + "
            f"en_core_web_lg for reference-parity embeddings")
        return None
