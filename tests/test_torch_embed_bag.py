"""PyTorch port of ``embed_bag``, ``models.embedding_bag`` and the
provider's segment sums, held against the JAX package on the same numpy
inputs.

Tolerances: rtol 1e-5 / atol 1e-6, the bar ``tests/test_kernels.py``
sets between the embed_bag kernel and its oracle (the two packages sum a
bag's rows in different orders); gathers (``MultiTable.lookup``) are
bitwise.  The reference wrapper skips ``-1`` entries while its oracle
gathers them as row V - 1 (``mode="clip"``), so ``-1`` cases are held
against the wrapper (``embed_bag``, the Pallas kernel in interpret mode,
as ``tests/test_kernels.py`` runs it here) and ``-1``-free cases against
both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.providers import HashProvider as JaxHashProvider
from repro.kernels.embed_bag.ops import embed_bag as jax_embed_bag
from repro.kernels.embed_bag.ref import embed_bag_ref as jax_embed_bag_ref
from repro.models.embedding_bag import MultiTable as JaxMultiTable
from repro.models.embedding_bag import embedding_bag as jax_embedding_bag
from repro_torch.core.providers import HashProvider
from repro_torch.kernels.embed_bag import (bag_ptr_from_offsets, embed_bag,
                                           embed_bag_kernel,
                                           embed_bag_plain, embed_bag_ref,
                                           segment_bag_sums)
from repro_torch.models.embedding_bag import MultiTable, embedding_bag
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_kernels.py::TestEmbedBag's sweep
SWEEP = [(100, 32, 8, 10), (50, 16, 4, 6), (200, 128, 16, 20), (30, 8, 5, 3)]


def _bags(V, D, B, maxbag, seed, pads=False):
    """The reference test's draw on numpy, with a numpy table; ``pads``
    turns every third index into -1."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, maxbag, B)
    nnz = max(int(lens.sum()), 1)
    offsets = np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int32)
    idx = rng.randint(0, V, nnz).astype(np.int32)
    if pads:
        idx[::3] = -1
    table = rng.standard_normal((V, D)).astype(np.float32)
    return table, idx, offsets


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("V,D,B,maxbag", SWEEP)
def test_matches_jax_wrapper_and_oracle(V, D, B, maxbag):
    table, idx, offsets = _bags(V, D, B, maxbag, V + B)
    want = np.asarray(jax_embed_bag(jnp.asarray(table), jnp.asarray(idx),
                                    jnp.asarray(offsets), n_bags=B))
    oracle = np.asarray(jax_embed_bag_ref(jnp.asarray(table),
                                          jnp.asarray(idx),
                                          jnp.asarray(offsets), n_bags=B))
    got = embed_bag(_t(table), _t(idx), _t(offsets), n_bags=B)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    ref = embed_bag_ref(_t(table), _t(idx), _t(offsets), n_bags=B)
    np.testing.assert_allclose(ref.numpy(), oracle, **TOL)
    plain = embed_bag_plain(_t(table), _t(idx), bag_ptr_from_offsets(
        _t(offsets), idx.shape[0], B))
    assert torch.equal(plain, got)


@pytest.mark.parametrize("V,D,B,maxbag", SWEEP)
def test_skips_pads_as_the_jax_wrapper(V, D, B, maxbag):
    """-1 entries (and empty bags) against the reference wrapper."""
    table, idx, offsets = _bags(V, D, B, maxbag, 3 * V + B, pads=True)
    assert (idx == -1).any()
    want = np.asarray(jax_embed_bag(jnp.asarray(table), jnp.asarray(idx),
                                    jnp.asarray(offsets), n_bags=B))
    got = embed_bag(_t(table), _t(idx), _t(offsets), n_bags=B)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    keep = np.where(idx >= 0, idx, V)          # -1 -> a zero row
    padded = np.concatenate([table, np.zeros((1, D), np.float32)])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_embed_bag_ref(
            jnp.asarray(padded), jnp.asarray(keep), jnp.asarray(offsets),
            n_bags=B)), **TOL)


def test_empty_bags_zero_and_ids_past_the_table():
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    idx = np.array([1, 2, 14], np.int32)         # 14 reads row 9
    offs = np.array([0, 3, 3], np.int32)          # bags [1, 2, 14], [], []
    got = embed_bag(_t(table), _t(idx), _t(offs), n_bags=4).numpy()
    np.testing.assert_array_equal(got[0], table[1] + table[2] + table[9])
    assert (got[1:] == 0).all()
    want = np.asarray(jax_embed_bag(jnp.asarray(table), jnp.asarray(idx[:2]),
                                    jnp.asarray(offs), n_bags=3))
    np.testing.assert_array_equal(
        embed_bag(_t(table), _t(idx[:2]), _t(offs), n_bags=3).numpy(), want)


@pytest.mark.parametrize("n_bags", [1, 3, 6])
def test_bag_ptr_from_offsets(n_bags):
    """Bags past the offsets are empty; n_bags below them cuts the last
    bag at the next start; bounds clamp to nnz."""
    ptr = bag_ptr_from_offsets(torch.tensor([0, 2, 9]), 5, n_bags)
    want = [0, 2, 5, 5, 5, 5, 5][:n_bags + 1]
    assert ptr.dtype == torch.int32 and ptr.tolist() == want


def test_plain_sums_in_index_order_in_bf16():
    """bf16 rounds after every add, so the order shows: the plain
    version adds a bag's rows in index order."""
    rows = torch.tensor([[256.0], [1.0], [1.0]]).to(torch.bfloat16)
    ptr = torch.tensor([0, 3], dtype=torch.int32)
    fwd = embed_bag_plain(rows, torch.tensor([0, 1, 2], dtype=torch.int32),
                          ptr)
    back = embed_bag_plain(rows, torch.tensor([1, 2, 0], dtype=torch.int32),
                           ptr)
    assert fwd.item() == 256.0 and back.item() == 258.0
    assert embed_bag_kernel(rows, torch.tensor([1, 2, 0], dtype=torch.int32),
                            ptr).item() == 258.0


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    """Pads wrap to row V - 1 (jnp's clip gather), an empty bag is 0 (sum,
    mean) or -inf (max), and n_bags beyond the offsets adds empty bags."""
    rng = np.random.RandomState(7)
    table = rng.standard_normal((20, 6)).astype(np.float32)
    idx = rng.randint(-1, 20, 30).astype(np.int32)
    idx[3] = -1
    offsets = np.array([0, 5, 5, 12, 30], np.int32)
    w = rng.standard_normal(30).astype(np.float32) if weighted else None
    kw = dict(mode=mode, n_bags=7)
    want = np.asarray(jax_embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(offsets),
        weights=None if w is None else jnp.asarray(w), **kw))
    got = embedding_bag(_t(table), _t(idx), _t(offsets),
                        weights=None if w is None else _t(w), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if mode == "max":
        assert np.isneginf(got[[1, 4, 5, 6]]).all()
    else:
        assert (got[[1, 4, 5, 6]] == 0).all()
    with pytest.raises(ValueError):
        embedding_bag(_t(table), _t(idx), _t(offsets), mode="median")


def test_multitable_matches_jax():
    """Row offsets, the 512-row padding and the fused lookup, bitwise."""
    sizes = (10, 20, 700)
    port, ref = MultiTable(sizes, 8), JaxMultiTable(sizes, 8)
    np.testing.assert_array_equal(port.row_offsets, ref.row_offsets)
    assert port.total_rows == ref.total_rows == 1024
    assert MultiTable((3,), 4, pad_rows=16).total_rows == 16
    table = port.init(torch.Generator().manual_seed(0), device="cpu")
    assert table.shape == (1024, 8) and table.dtype == torch.float32
    assert 0.005 < float(table.std()) < 0.015
    bf = port.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                   device="cpu")
    assert bf.dtype == torch.bfloat16
    rng = np.random.RandomState(1)
    ids = np.stack([rng.randint(0, s, 12) for s in sizes], 1)
    ids[0] = [-1, 25, 699]                       # wrap and cross-field
    ids = ids.astype(np.int32)
    want = np.asarray(ref.lookup(jnp.asarray(table.numpy()),
                                 jnp.asarray(ids)))
    got = port.lookup(table, _t(ids))
    assert got.shape == (12, 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def _provider_pair(vocab=50, dim=16):
    ref = JaxHashProvider(vocab, dim, seed=3)
    port = HashProvider(vocab, dim, table=_t(np.array(ref.table())),
                        device="cpu")
    return ref, port


@pytest.mark.parametrize("segs", ["sorted", "unsorted", "out_of_range"])
def test_contextualize_matches_jax(segs):
    """Per doc against the reference's one-doc contextualize; the batch
    of docs in one call gives each doc's rows bitwise (the segment sums
    are per bag, in token order)."""
    ref, port = _provider_pair()
    rng = np.random.RandomState({"sorted": 0, "unsorted": 1,
                                 "out_of_range": 2}[segs])
    n_docs, n = 3, 40
    toks = rng.randint(-1, 55, (n_docs, n)).astype(np.int32)  # pads, OOV
    if segs == "sorted":
        seg = np.sort(rng.randint(0, 8, (n_docs, n)), 1)
    elif segs == "unsorted":
        seg = rng.randint(0, 8, (n_docs, n))
    else:
        seg = rng.randint(-4, 70, (n_docs, n))
    seg = seg.astype(np.int32)
    batched = port.contextualize(_t(toks), _t(seg))
    for d in range(n_docs):
        want = np.asarray(ref.contextualize(jnp.asarray(toks[d]),
                                            jnp.asarray(seg[d])))
        got = port.contextualize(_t(toks[d]), _t(seg[d]))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert torch.equal(batched[d], got)


def test_segment_bag_sums_are_batch_independent():
    """A bag's sum does not depend on the other docs of the call."""
    rng = np.random.RandomState(4)
    table = _t(rng.standard_normal((30, 5)).astype(np.float32))
    rows = _t(rng.randint(-1, 30, (4, 25)))
    bins = _t(rng.randint(0, 6, (4, 25)))
    both = segment_bag_sums(table, rows, bins, 6)
    assert both.shape == (4, 6, 5)
    for d in range(4):
        assert torch.equal(both[d], segment_bag_sums(table, rows[d],
                                                     bins[d], 6))
    onehot = torch.nn.functional.one_hot(bins, 6).float()
    rows_t = table[rows.clamp(min=0)] * (rows >= 0)[..., None]
    torch.testing.assert_close(both, onehot.transpose(1, 2) @ rows_t, **TOL)


def test_segment_bag_sums_clamp_bins():
    """Bins below 0 sum into bin 0 and bins past the end into the last
    one, in token order; a -1 row is skipped whatever its bin."""
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    rows = torch.tensor([[0, 1, -1, 2, 3, 5]])
    bins = torch.tensor([[-3, 0, -1, 9, 2, 2]])
    got = segment_bag_sums(table, rows, bins, 3)
    want = torch.stack([table[0] + table[1], torch.zeros(2),
                        table[2] + table[3] + table[5]])[None]
    assert torch.equal(got, want)
    clamped = segment_bag_sums(table, rows, bins.clamp(0, 2), 3)
    assert torch.equal(got, clamped)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_bag_sums_equal_explicit_csr_bags(dtype):
    """Per (doc, bin) the rows in token order as explicit CSR bags,
    summed by embed_bag_plain, give the segment sums' bits."""
    rng = np.random.RandomState(9)
    n_docs, n, n_bins = 3, 50, 5
    table = _t(rng.standard_normal((40, 8)).astype(np.float32)).to(dtype)
    rows = rng.randint(-1, 43, (n_docs, n))
    bins = rng.randint(-2, n_bins + 2, (n_docs, n))
    idx, ptr = [], [0]
    for d in range(n_docs):
        for b in range(n_bins):
            idx += [int(r) for r, j in zip(rows[d], bins[d])
                    if min(max(j, 0), n_bins - 1) == b]
            ptr.append(len(idx))
    want = embed_bag_plain(table, torch.tensor(idx, dtype=torch.int32),
                           torch.tensor(ptr, dtype=torch.int32))
    got = segment_bag_sums(table, _t(rows), _t(bins), n_bins)
    assert got.shape == (n_docs, n_bins, 8)
    assert torch.equal(got.reshape(-1, 8), want)
