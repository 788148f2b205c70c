"""Shared plumbing of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package exports an index through its own ``save_index`` and the
port loads it with its own ``load_index`` on the CPU, so every parity
test crosses the package boundary the way a real deployment does.
"""
import numpy as np
import torch

from repro.ckpt import save_index
from repro.dist.sharding import partition_index
from repro_torch.ckpt import load_index

K_SWEEP = (1, 2, 4)
TILE_SWEEP = (64, 256, 1024)


def jax_layout(index, k):
    """The JAX index itself at K == 1, else its K-shard partition."""
    return index if k == 1 else partition_index(index, k)


def export(jax_index, path):
    """JAX ``save_index`` -> port ``load_index`` on the CPU."""
    save_index(str(path), jax_index)
    return load_index(str(path), device="cpu")


def t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def adversarial(world, seed, n_tail=3):
    """(query (8,), docs (9,)) mixing every hostile id class, as
    tests/test_kernels.py::TestCsrLookup builds them: present terms, OOV
    padding, absent terms, a past-vocab term, term 0; first/last/random
    docs, one and many past the end, a negative id and a padded tail
    repeating docs[0] (the serve_batches pad pattern)."""
    idx = world["index"]
    rng = np.random.RandomState(seed)
    toks = world["toks"]
    d = rng.randint(0, len(world["ds"].docs))
    present = np.unique(toks[d][toks[d] >= 0])
    absent = np.setdiff1d(np.arange(idx.vocab_size), np.unique(toks))[:2]
    q = np.full(8, -1, np.int32)
    sel = rng.choice(present, size=min(3, present.size), replace=False)
    q[:sel.size] = sel
    q[4:4 + absent.size] = absent
    q[6] = idx.vocab_size + rng.randint(1, 10)
    q[7] = 0
    core = np.array([0, idx.n_docs - 1, rng.randint(0, idx.n_docs),
                     idx.n_docs, idx.n_docs + rng.randint(1, 50), -3],
                    np.int32)
    docs = np.concatenate([core, np.full(n_tail, core[0], np.int32)])
    return q, docs


PARTITION_FIELDS = ("term_offsets", "doc_ids", "values", "fences",
                    "term_to_shard", "range_lo", "range_hi", "split_term",
                    "split_doc", "idf", "doc_len", "seg_len", "packed_words",
                    "tile_bits", "tile_base", "tile_word_off", "values_q",
                    "value_scale")
PARTITION_STATIC = ("n_docs", "vocab_size", "n_b", "n_shards", "functions",
                    "codec", "codec_tile", "max_tile_words", "codec_spans")


def assert_same_partition(port, ref):
    """Every array (dtype included) and static field of a port
    PartitionedIndex equals the JAX one's."""
    for n in PARTITION_FIELDS:
        want = getattr(ref, n)
        got = getattr(port, n)
        if want is None:
            assert got is None, n
            continue
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, n
        np.testing.assert_array_equal(got.numpy(), want, err_msg=n)
    for n in PARTITION_STATIC:
        assert tuple(np.atleast_1d(getattr(port, n))) == tuple(
            np.atleast_1d(getattr(ref, n))), n


def fresh_registry(monkeypatch, *obs_modules):
    """Give each ``obs`` package (the reference's, the port's) an empty
    metric registry and no span aggregates for the rest of the test.
    ``obs.reset()`` zeroes samples but keeps every family a test file
    registered earlier in the same process, and a metrics exposition
    writes each registered family; a CLI run compared family for family
    must start from none."""
    for mod in obs_modules:
        monkeypatch.setattr(mod.REGISTRY, "_metrics", {})
        mod.reset()
