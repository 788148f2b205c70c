"""A packed index over adversarial doc ids, for the PyTorch port's codec
tests on the CPU and on the card (numpy and the port only: the card's
host has no JAX).

Two shard rows of sorted, distinct int32 ids cover every width class:
dense runs (4/8-bit tiles), sparse jumps (16-bit), jumps past 2^16 and
the int32 max cliff (32-bit tiles), and in the second row negative ids
down to int32 min, so that 32-bit tiles store raw words with the top bit
set (16-bit tiles set it too, with upper halves >= 2^15).  Each row is cut
into posting lists of 1-80 ids.
"""
import numpy as np
import torch

INT32_MIN = int(np.iinfo(np.int32).min)
INT32_MAX = int(np.iinfo(np.int32).max)


def adversarial_rows(seed: int = 0):
    """(rows, lengths): two sorted rows of distinct ids, padded with
    their last id to a common width."""
    rng = np.random.RandomState(seed)
    rows = []
    for neg in (False, True):
        parts = [np.arange(100) + rng.randint(0, 50),
                 100 + np.cumsum(rng.randint(1, 3, 150)),
                 1000 + np.cumsum(rng.randint(1, 200, 150)),
                 40_000 + np.cumsum(rng.randint(1, 70_000, 100)),
                 INT32_MAX - np.arange(50)]
        if neg:
            parts += [INT32_MIN + np.arange(20),
                      -(1 << 20) + np.cumsum(rng.randint(1, 5000, 60)),
                      np.arange(-8, 0)]
        rows.append(np.unique(np.concatenate(parts).astype(np.int64)))
    n = max(r.size for r in rows)
    lengths = [r.size for r in rows]
    out = np.stack([np.pad(r, (0, n - r.size), mode="edge") for r in rows])
    return out.astype(np.int32), lengths


def adversarial_arrays(seed: int = 0, n_b: int = 2, n_f: int = 3):
    """Host arrays of a K=2 PartitionedIndex over :func:`adversarial_rows`
    (raw ids, f32 values), with the tables that route its terms."""
    rng = np.random.RandomState(seed + 1)
    rows, lengths = adversarial_rows(seed)
    k, nmax = rows.shape
    offsets = []
    for n in lengths:
        cuts = np.cumsum(rng.randint(1, 81, size=n))
        offsets.append(np.concatenate([[0], cuts[cuts < n], [n]]))
    spans = [o.size - 1 for o in offsets]
    vmax = max(spans)
    term_offsets = np.stack([np.pad(o, (0, vmax + 1 - o.size), mode="edge")
                             for o in offsets]).astype(np.int32)
    range_lo = np.array([0, spans[0]], np.int32)
    return dict(
        term_offsets=term_offsets, doc_ids=rows,
        values=rng.randn(k, nmax, n_b, n_f).astype(np.float32),
        term_to_shard=np.repeat(np.arange(k, dtype=np.int32), spans),
        range_lo=range_lo,
        range_hi=(range_lo + np.array(spans) - 1).astype(np.int32),
        idf=np.ones(sum(spans), np.float32),
        doc_len=np.ones(8, np.float32),
        seg_len=np.ones((8, n_b), np.float32))


def adversarial_index(seed: int = 0, device="cpu"):
    """:func:`adversarial_arrays` as the port's raw PartitionedIndex."""
    from repro_torch.convert import index_from_arrays
    a = adversarial_arrays(seed)
    return index_from_arrays(a, n_docs=8, vocab_size=a["idf"].size,
                             n_b=a["values"].shape[2],
                             functions=("tf", "dot", "cosine"),
                             device=device)


def adversarial_queries(index, seed: int = 0):
    """(query terms, docs) over :func:`adversarial_index`: every term
    plus a pad and a past-vocab id; present ids of both rows (the
    extremes included) and absent ids next to them."""
    rng = np.random.RandomState(seed + 2)
    q = np.concatenate([np.arange(index.vocab_size), [-1, index.vocab_size
                                                      + 3]])
    ids = np.unique(index.doc_ids.cpu().numpy())
    present = np.concatenate([ids[:25], ids[-25:],
                              rng.choice(ids, 150, replace=False)])
    docs = np.concatenate([present, present + 1, present - 1,
                           [INT32_MIN, INT32_MAX, 0, -1]])
    docs = np.clip(docs.astype(np.int64), INT32_MIN, INT32_MAX)
    return (torch.from_numpy(q.astype(np.int32)),
            torch.from_numpy(docs.astype(np.int32)))
