"""Hash tokenizer: deterministic text -> raw token ids (a WordPiece
stand-in; copy of ``repro.data.tokenizer``, numpy only).

Lowercase word and sub-word splitting, ids = stable FNV-1a hashes into a
fixed raw space.  The SEINE vocabulary layer (``core/vocab.py``) then
applies the middle-80% frequency filter on top, as for real tokenizers.
"""
from __future__ import annotations

import re
from typing import Iterable, List

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in s.encode("utf-8"):
        h = (h ^ ch) * 16777619 & 0xFFFFFFFF
    return h


class HashTokenizer:
    def __init__(self, n_raw_tokens: int = 2**17, max_subword: int = 8):
        self.n_raw_tokens = n_raw_tokens
        self.max_subword = max_subword

    def tokenize(self, text: str) -> np.ndarray:
        out: List[int] = []
        for w in _WORD_RE.findall(text.lower()):
            if len(w) <= self.max_subword:
                out.append(_stable_hash(w) % self.n_raw_tokens)
            else:  # WordPiece-style split: head + ##continuations
                out.append(_stable_hash(w[:self.max_subword])
                           % self.n_raw_tokens)
                for i in range(self.max_subword, len(w), self.max_subword):
                    piece = "##" + w[i:i + self.max_subword]
                    out.append(_stable_hash(piece) % self.n_raw_tokens)
        return np.asarray(out, np.int32)

    def tokenize_corpus(self, texts: Iterable[str]) -> List[np.ndarray]:
        return [self.tokenize(t) for t in texts]
