"""TextTiling document segmentation (§2.2), Hearst 1994 [cmp-lg/9406037].

Splits a document into topically coherent segments from the similarity of
neighbouring fixed-size token windows, then standardises every document to
exactly ``n_b`` segments: pad empty segments if fewer, squeeze the remainder
into the final segment if more (paper §2.2). ``n_b=1`` = document-level,
``n_b=len(d)`` = term-level interaction granularity.

Copy of ``repro.core.segment``: host-side numpy, part of the indexing
data pipeline, as in the reference.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _block_vectors(tokens: np.ndarray, w: int) -> np.ndarray:
    """Pseudo-sentence bag-of-words vectors; tokens (n,) >= 0 raw/slot ids."""
    n_blocks = max(1, int(np.ceil(tokens.size / w)))
    vecs = []
    vmax = int(tokens.max()) + 1 if tokens.size else 1
    for b in range(n_blocks):
        blk = tokens[b * w:(b + 1) * w]
        v = np.bincount(blk[blk >= 0], minlength=vmax).astype(np.float32)
        vecs.append(v)
    return np.stack(vecs)


def texttile_boundaries(tokens: np.ndarray, *, window: int = 20,
                        smooth: int = 2) -> np.ndarray:
    """Return block indices after which a topic boundary is placed."""
    tokens = np.asarray(tokens)
    tokens = tokens[tokens >= 0]
    if tokens.size <= window:
        return np.zeros(0, np.int64)
    blocks = _block_vectors(tokens, window)
    nb = blocks.shape[0]
    if nb < 3:
        return np.zeros(0, np.int64)
    # lexical cohesion score between adjacent block pairs
    sims = np.zeros(nb - 1, np.float64)
    for g in range(nb - 1):
        a = blocks[max(0, g - smooth + 1):g + 1].sum(0)
        b = blocks[g + 1:g + 1 + smooth].sum(0)
        na, nbn = np.linalg.norm(a), np.linalg.norm(b)
        sims[g] = float(a @ b) / (na * nbn) if na > 0 and nbn > 0 else 0.0
    # depth score at each gap
    depth = np.zeros_like(sims)
    for g in range(len(sims)):
        l = g
        while l > 0 and sims[l - 1] >= sims[l]:
            l -= 1
        r = g
        while r < len(sims) - 1 and sims[r + 1] >= sims[r]:
            r += 1
        depth[g] = (sims[l] - sims[g]) + (sims[r] - sims[g])
    cut = depth.mean() + depth.std() * 0.5
    return np.flatnonzero(depth > max(cut, 1e-9))


def segment_ids(tokens: np.ndarray, n_b: int, *, window: int = 20,
                smooth: int = 2) -> np.ndarray:
    """Per-token segment id in [0, n_b) with pad/squeeze standardisation."""
    tokens = np.asarray(tokens)
    n = tokens.size
    if n == 0:
        return np.zeros(0, np.int32)
    bounds = texttile_boundaries(tokens, window=window, smooth=smooth)
    # boundary after block g -> token index (g+1)*window
    cuts = ((bounds + 1) * window).clip(0, n)
    cuts = np.unique(cuts[(cuts > 0) & (cuts < n)])
    seg = np.zeros(n, np.int32)
    for c in cuts:
        seg[c:] += 1
    y = int(seg.max()) + 1
    if y > n_b:  # squeeze: all remaining text into the final segment
        seg = np.minimum(seg, n_b - 1)
    # if y < n_b we simply leave segments [y, n_b) empty (padding)
    return seg


def segment_corpus(docs: List[np.ndarray], n_b: int, max_len: int, *,
                   window: int = 20, smooth: int = 2
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate a corpus to (n_docs, max_len) token + segment arrays.

    Returns (tokens, seg_ids); pad positions have token=-1, seg=n_b-1.
    """
    n_docs = len(docs)
    toks = np.full((n_docs, max_len), -1, np.int32)
    segs = np.full((n_docs, max_len), n_b - 1, np.int32)
    for i, d in enumerate(docs):
        d = np.asarray(d)[:max_len]
        s = segment_ids(d, n_b, window=window, smooth=smooth)
        toks[i, :d.size] = d
        segs[i, :d.size] = s
    return toks, segs
