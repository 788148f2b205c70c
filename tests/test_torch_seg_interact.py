"""PyTorch port of ``seg_interact`` and of the nine atomic interaction
functions, held against the JAX package on the same numpy inputs.

Tolerances: rtol 1e-4 / atol 1e-5, the bar ``tests/test_kernels.py``
sets between the seg_interact kernel and its oracle.  The port sums a
segment's dot products token by token while the reference takes one dot
product with the segment's summed embedding, so the float32 rounding
differs; the integer-valued functions (``tf``, ``idf_indicator``) are
held bitwise.  Embeddings are drawn at the scale the build feeds the
kernel, N(0, 1/De) like the provider's table: at unit scale a segment's
dot sum reaches hundreds, and an entry that cancels to ~0.1 then comes
out ~5e-5 apart in the two summation orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.builder import make_batch_interaction_fn as jax_batch_fn
from repro.core.interactions import FUNCTION_NAMES as JAX_FUNCTIONS
from repro.kernels.seg_interact.ops import seg_interact as jax_seg_interact
from repro.kernels.seg_interact.ref import seg_interact_ref as jax_ref
from repro_torch.convert import interaction_params_from_jax, \
    provider_from_numpy
from repro_torch.core.builder import make_batch_interaction_fn
from repro_torch.core.interactions import (FUNCTION_NAMES,
                                           init_interaction_params,
                                           query_doc_interactions)
from repro_torch.kernels.seg_interact import (SEG_CHUNK,
                                              flatten_segments, seg_interact,
                                              seg_interact_kernel,
                                              seg_interact_plain,
                                              seg_interact_ref)
from repro_torch.kernels.seg_interact.kernel import (N_CLASSES, SLICE,
                                                     TOKEN_TILE, WINDOW,
                                                     fold_events,
                                                     live_windows, n_chunks,
                                                     term_tile_for)
import torch_threads  # noqa: F401  (PyTorch threads per test process)

TOL = dict(rtol=1e-4, atol=1e-5)
UNIT_TOL = dict(rtol=1e-3, atol=1e-4)
# tests/test_kernels.py::TestSegInteract's sweep, De = 200 included
SWEEP = [(64, 4, 128, 32), (300, 7, 256, 128), (256, 3, 128, 64),
         (128, 2, 128, 200)]


def _padded(v, s, ls, de, seed, empty=(), unit=False):
    """(e_vocab, seg_tokens, mask) as the reference's test draws them:
    segment lengths uniform in [0, Ls], 0/1 masks, rows at the table's
    N(0, 1/De) scale or, with ``unit``, at the reference test's N(0, 1)."""
    rng = np.random.RandomState(seed)
    scale = 1.0 if unit else 1.0 / np.sqrt(de)
    ev = (rng.randn(v, de) * scale).astype(np.float32)
    st = (rng.randn(s, ls, de) * scale).astype(np.float32)
    lens = rng.randint(0, ls + 1, size=s)
    lens[list(empty)] = 0
    mask = (np.arange(ls)[None] < lens[:, None]).astype(np.float32)
    return ev, st, mask


def _jax_want(ev, st, mask):
    return np.asarray(jax_ref(jnp.asarray(ev),
                              jnp.asarray(st * mask[..., None]),
                              jnp.asarray(mask)))


@pytest.mark.parametrize("v,s,ls,de", SWEEP)
def test_matches_jax_ref_over_the_kernel_sweep(v, s, ls, de):
    ev, st, mask = _padded(v, s, ls, de, seed=v * s + de)
    want = _jax_want(ev, st, mask)
    args = (torch.from_numpy(ev), torch.from_numpy(st),
            torch.from_numpy(mask))
    np.testing.assert_allclose(seg_interact(*args).numpy(), want, **TOL)
    np.testing.assert_allclose(
        seg_interact_ref(args[0], args[1] * args[2][..., None],
                         args[2]).numpy(), want, **TOL)
    plain = seg_interact_plain(*flatten_segments(*args), s)[0]
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


@pytest.mark.parametrize("v,s,ls,de", SWEEP)
def test_matches_jax_ref_at_unit_scale(v, s, ls, de):
    """The reference test's own unit-scale rows, at the reference's
    kernel-vs-index bar (rtol 1e-3 / atol 1e-4, tests/test_kernels.py::
    test_matches_index_builder_values): a segment's dot sum reaches
    hundreds there, and the two summation orders part by more than rtol
    1e-4 (largest |diff| over this sweep on the CPU: 2.1e-4, on values
    up to 582)."""
    ev, st, mask = _padded(v, s, ls, de, seed=v * s + de, unit=True)
    want = _jax_want(ev, st, mask)
    args = (torch.from_numpy(ev), torch.from_numpy(st),
            torch.from_numpy(mask))
    got = seg_interact(*args).numpy()
    np.testing.assert_allclose(got, want, **UNIT_TOL)
    plain = seg_interact_plain(*flatten_segments(*args), s)[0].numpy()
    np.testing.assert_array_equal(plain, got)
    assert (got[:, mask.sum(1) == 0] == 0).all()


def test_matches_the_jax_kernel_in_interpret_mode():
    """The Pallas kernel itself, run by the interpreter as the JAX tests
    run it, on one shape of the sweep."""
    ev, st, mask = _padded(64, 4, 128, 32, seed=3)
    want = np.asarray(jax_seg_interact(jnp.asarray(ev), jnp.asarray(st),
                                       jnp.asarray(mask), interpret=True))
    got = seg_interact(torch.from_numpy(ev), torch.from_numpy(st),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n_seg", [2, SEG_CHUNK])
def test_empty_segments_give_zeros(n_seg):
    ev, st, mask = _padded(64, n_seg, 16, 32, seed=n_seg,
                           empty=(1, n_seg - 1))
    mask[0, :10] = 1.0
    got = seg_interact(torch.from_numpy(ev), torch.from_numpy(st),
                       torch.from_numpy(mask)).numpy()
    assert got.shape == (64, n_seg, 3)
    assert (got[:, 1] == 0).all() and (got[:, n_seg - 1] == 0).all()
    np.testing.assert_allclose(got, _jax_want(ev, st, mask), **TOL)


def test_ragged_layout_pad_terms_and_excluded_tokens():
    """The build's layout: several docs, segment ids out of range and
    pad terms; the wrapper's CPU path is the plain version, and each
    (term, segment) cell equals the JAX ref on that segment alone."""
    rng = np.random.RandomState(7)
    b, u, length, de, n_seg = 3, 11, 40, 24, 5
    e_term = (rng.randn(b, u, de) / np.sqrt(de)).astype(np.float32)
    e_tok = (rng.randn(b, length, de) / np.sqrt(de)).astype(np.float32)
    seg = np.sort(rng.randint(-1, n_seg + 2, size=(b, length)), axis=1)
    seg[:, ::5] = -3
    term_ids = rng.randint(0, 100, size=(b, u)).astype(np.int32)
    term_ids[:, ::4] = -1
    args = [torch.from_numpy(a) for a in (e_term, e_tok,
                                          seg.astype(np.int32), term_ids)]
    got = seg_interact_kernel(*args, n_seg).numpy()
    np.testing.assert_array_equal(got, seg_interact_plain(*args,
                                                          n_seg).numpy())
    assert (got[term_ids < 0] == 0).all()
    for i in range(b):
        for s in range(n_seg):
            toks = e_tok[i][seg[i] == s]
            st = np.zeros((1, max(len(toks), 1), de), np.float32)
            st[0, :len(toks)] = toks
            mask = np.zeros((1, st.shape[1]), np.float32)
            mask[0, :len(toks)] = 1.0
            want = _jax_want(e_term[i], st, mask)[:, 0].copy()
            want[term_ids[i] < 0] = 0.0
            np.testing.assert_allclose(got[i, :, s], want, **TOL,
                                       err_msg=f"doc {i} segment {s}")


def _partition_case(case, seed=0):
    """(seg (B, L), term_ids (B, U), n_seg) for the kernel's partition:
    TextTiling-like runs with excluded positions, segments that come back
    (not contiguous), one segment longer than a token tile, a doc with
    every token excluded, and docs longer than a compaction window."""
    rng = np.random.RandomState(seed)
    b, u, length, n_seg = dict(
        runs=(3, 40, 300, 20), noncontiguous=(2, 9, 200, 7),
        long_segment=(2, 33, 400, 3), all_excluded=(2, 6, 100, 5),
        windows=(2, 17, 2 * WINDOW + 300, 64), one_segment=(2, 1, 150, 1),
        chunks=(2, 20, WINDOW + 200, 2 * SEG_CHUNK + 2),
    )[case]
    seg = np.sort(rng.randint(0, n_seg, size=(b, length)), axis=1)
    if case == "noncontiguous":
        seg = rng.randint(-2, n_seg + 2, size=(b, length))
    if case == "long_segment":
        seg[:, 20:20 + 3 * TOKEN_TILE] = 1
    seg[rng.rand(b, length) < 0.4] = -1            # OOV and pad positions
    seg[:, ::11] = n_seg                           # out of range: excluded
    if case == "all_excluded":
        seg[0] = -1
    ids = rng.randint(0, 500, size=(b, u)).astype(np.int32)
    ids[rng.rand(b, u) < 0.25] = -1
    return seg.astype(np.int32), ids, n_seg


PARTITION_CASES = ["runs", "noncontiguous", "long_segment", "all_excluded",
                   "windows", "one_segment", "chunks"]


def cell_orders(events) -> dict:
    """``{(b, u, s): ((positions of class 0 in order), ..., (class
    N_CLASSES - 1))}`` from ``fold_events``: the order in which the
    kernel adds a cell's tokens."""
    out = {}
    for b, u, p, s, c in events:
        out.setdefault((b, u, s), [[] for _ in range(N_CLASSES)])[c].append(p)
    return {k: tuple(map(tuple, v)) for k, v in out.items()}


@pytest.mark.parametrize("case", PARTITION_CASES)
def test_partition_covers_every_live_pair_once(case):
    """The kernel's partition (compaction, token tiles, fold classes,
    term tiles of 8 or 16 by the case's U) folds every (live term, live
    token) pair of a doc exactly once, into the token's own segment, and
    nothing of a pad term or of a token outside [0, S)."""
    seg, ids, n_seg = _partition_case(case)
    events = fold_events(seg, ids, n_seg)
    pairs = [(b, u, p) for b, u, p, _, _ in events]
    assert len(pairs) == len(set(pairs))
    want = {(b, u, p) for b in range(ids.shape[0])
            for u in np.flatnonzero(ids[b] >= 0)
            for p in np.flatnonzero((seg[b] >= 0) & (seg[b] < n_seg))}
    assert set(pairs) == want
    assert all(s == seg[b, p] for b, _, p, s, _ in events)
    assert all(0 <= c < N_CLASSES for *_, c in events)


@pytest.mark.parametrize("case", PARTITION_CASES)
def test_partition_compacts_in_token_order(case):
    """Live positions come out in token order, chunk by chunk of
    SEG_CHUNK segments and window by window; a token's class is its rank
    in its chunk's window's live list, in tiles of TOKEN_TILE and slices
    of SLICE."""
    seg, ids, n_seg = _partition_case(case)
    for b in range(seg.shape[0]):
        rank = {}
        for ch in range(n_chunks(n_seg)):
            windows = live_windows(seg[b], n_seg, ch)
            flat = np.concatenate(windows) if windows else np.zeros(0, int)
            lo, hi = SEG_CHUNK * ch, min(SEG_CHUNK * (ch + 1), n_seg)
            live = np.flatnonzero((seg[b] >= lo) & (seg[b] < hi))
            assert np.array_equal(flat, live)
            assert all(np.unique(w // WINDOW).size == 1 for w in windows)
            rank.update({int(p): r for w in windows
                         for r, p in enumerate(w)})
        for eb, _, p, _, c in fold_events(seg[b:b + 1], ids[b:b + 1],
                                          n_seg):
            assert c == rank[p] % TOKEN_TILE // SLICE


@pytest.mark.parametrize("case", PARTITION_CASES)
def test_partition_cell_order_depends_only_on_the_doc(case):
    """A cell's summation order is the same whether its term sits among a
    build batch's 512 term slots (tiles of 16) or in a No-Index query of 6
    slots (tiles of 8) or of 12 (tiles of 16), at another doc index of
    another batch: so the two paths give the same bits."""
    seg, ids, n_seg = _partition_case(case)
    n_b = seg.shape[0]
    build_ids = np.full((n_b, 512), -1, np.int32)
    build_ids[:, :ids.shape[1]] = ids
    build = cell_orders(fold_events(seg, build_ids, n_seg))
    assert term_tile_for(512) == 16 and term_tile_for(6) == 8
    for b in range(n_b):
        terms = np.flatnonzero(ids[b] >= 0)
        for q0 in range(0, terms.size, 5):
            q = np.full((1, 6), -1, np.int32)
            q[0, 1:1 + terms[q0:q0 + 5].size] = terms[q0:q0 + 5]
            other = (b + 1) % n_b                  # the doc at index 1
            q_seg = np.stack([seg[other], seg[b]])
            q_ids = np.concatenate([np.full((1, 6), 7, np.int32), q])
            for width in (6, 12):                 # tiles of 8, of 16
                wide = np.full((2, width), -1, np.int32)
                wide[:, :6] = q_ids
                got = cell_orders(fold_events(q_seg, wide, n_seg))
                for slot in range(1, 6):
                    u = q[0, slot]
                    if u < 0:
                        continue
                    for s in range(n_seg):
                        assert got.get((1, slot, s)) == \
                            build.get((b, int(u), s))


def test_partition_sums_match_jax_ref():
    """Summing each cell as the partition orders it (float32 class
    partials added in class order, gauss as their max) gives the JAX
    ref's values for that segment alone."""
    rng = np.random.RandomState(3)
    seg, ids, n_seg = _partition_case("noncontiguous", seed=3)
    n_b, n_u = ids.shape
    de = 16
    e_term = (rng.randn(n_b, n_u, de) / np.sqrt(de)).astype(np.float32)
    e_tok = (rng.randn(n_b, seg.shape[1], de) / np.sqrt(de)).astype(
        np.float32)
    orders = cell_orders(fold_events(seg, ids, n_seg))
    for (b, u, s), classes in orders.items():
        eu = e_term[b, u]
        dot, cos, mx = [], [], []
        for pos in classes:
            et = e_tok[b, list(pos)] if pos else np.zeros((0, de), np.float32)
            sc = et @ eu
            dot.append(np.float32(sc.sum(dtype=np.float32)))
            inv_t = 1.0 / np.maximum(np.linalg.norm(et, axis=1), 1e-9)
            cos.append(np.float32((sc * inv_t).sum(dtype=np.float32)))
            d2 = (eu @ eu + (et * et).sum(1)) - 2.0 * sc
            mx.append((-d2).max() if pos else -np.inf)
        got = np.array([((dot[0] + dot[1]) + dot[2]) + dot[3],
                        (((cos[0] + cos[1]) + cos[2]) + cos[3])
                        / max(np.linalg.norm(eu), 1e-9),
                        np.exp(max(mx))], np.float32)
        toks = e_tok[b][seg[b] == s]
        want = _jax_want(eu[None], toks[None], np.ones((1, len(toks)),
                                                       np.float32))[0, 0]
        np.testing.assert_allclose(got, want, **TOL,
                                   err_msg=f"doc {b} term {u} segment {s}")


@pytest.mark.parametrize("n_u,tile", [(1, 8), (6, 8), (8, 8), (9, 16),
                                      (16, 16), (17, 16), (512, 16)])
def test_term_tile_is_sized_to_the_launch(n_u, tile):
    assert term_tile_for(n_u) == tile


def test_function_names_match_jax():
    assert FUNCTION_NAMES == JAX_FUNCTIONS


def test_init_interaction_params_layout():
    ip = init_interaction_params(torch.Generator().manual_seed(0), 32)
    assert ip["a"].shape == (32,) and ip["b"].shape == ()
    assert [tuple(w.shape) for w in ip["mlp"]["w"]] == [(32, 32), (32, 1)]
    assert [tuple(x.shape) for x in ip["mlp"]["b"]] == [(32,), (1,)]


@pytest.fixture(scope="module")
def batch(seine_world):
    """Eight docs of the smoke world with their unique terms, run through
    both packages' batched interaction pass (the build's stage 2)."""
    w = seine_world
    b = w["builder"]
    toks, segs = w["toks"][:8], w["segs"][:8]
    uniq = np.full((8, 96), -1, np.int32)
    for i in range(8):
        u = np.unique(toks[i][toks[i] >= 0])[:96]
        uniq[i, :u.size] = u
    want = np.asarray(jax_batch_fn(b.provider, jnp.asarray(w["vocab"].idf),
                                   b.ip, w["cfg"].n_segments, b.functions)(
        jnp.asarray(toks), jnp.asarray(segs), jnp.asarray(uniq)))
    provider = provider_from_numpy(np.asarray(b.provider.table()),
                                   device="cpu")
    ip = interaction_params_from_jax(b.ip, device="cpu")
    fn = make_batch_interaction_fn(
        provider, torch.from_numpy(w["vocab"].idf.copy()), ip,
        w["cfg"].n_segments, b.functions, device="cpu")
    got = fn(*(torch.from_numpy(a) for a in (toks, segs, uniq))).numpy()
    return dict(want=want, got=got, provider=provider, ip=ip, toks=toks,
                segs=segs, functions=b.functions)


@pytest.mark.parametrize("fn", FUNCTION_NAMES)
def test_doc_interactions_match_jax_per_function(batch, fn):
    f = batch["functions"].index(fn)
    got, want = batch["got"][..., f], batch["want"][..., f]
    if fn in ("tf", "idf_indicator"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_query_doc_interactions_on_adversarial_terms(seine_world, batch):
    """Query terms past the vocabulary (the last table row, still
    'valid'), OOV padding and absent terms against JAX's per-doc
    ``query_doc_interactions``."""
    from repro.core.interactions import query_doc_interactions as jax_qdi
    w = seine_world
    b = w["builder"]
    v = w["vocab"].size
    q = np.array([int(batch["toks"][0][batch["toks"][0] >= 0][0]), -1,
                  v + 3, v - 1, 0, -7], np.int32)
    table = np.asarray(b.provider.table())
    provider = batch["provider"]
    toks = torch.from_numpy(batch["toks"])
    segs = torch.from_numpy(batch["segs"])
    got = query_doc_interactions(
        torch.from_numpy(q), toks, segs, table=provider.table(),
        idf=torch.from_numpy(w["vocab"].idf.copy()),
        ctx_emb=provider.contextualize(toks, segs), ip=batch["ip"],
        n_b=w["cfg"].n_segments).numpy()
    for i in range(toks.shape[0]):
        ctx = b.provider.contextualize(jnp.asarray(batch["toks"][i]),
                                       jnp.asarray(batch["segs"][i]))
        want = np.asarray(jax_qdi(
            jnp.asarray(q), jnp.asarray(batch["toks"][i]),
            jnp.asarray(batch["segs"][i]), table=jnp.asarray(table),
            idf=jnp.asarray(w["vocab"].idf), ctx_emb=ctx, ip=b.ip,
            n_b=w["cfg"].n_segments))
        np.testing.assert_allclose(got[i], want, **TOL, err_msg=f"doc {i}")
        assert np.isfinite(got[i]).all()
        assert (got[i][[1, 5]] == 0).all()          # pad terms


def test_build_past_one_segment_chunk_matches_jax(seine_world):
    """A build at n_b = SEG_CHUNK + 1 (where each block of the card's
    kernel owns one chunk of segments) on the port's CPU path against the
    JAX build of the same corpus: ids and per-doc stats bitwise, values
    at rtol 1e-4 / atol 1e-5 (tf and idf_indicator bitwise)."""
    import dataclasses

    from repro.configs import seine_smoke as jax_smoke
    from repro.core import IndexBuilder as JaxBuilder
    from repro.core import segment_corpus as jax_segment
    from repro_torch.configs import seine_smoke
    from repro_torch.core.builder import IndexBuilder
    from repro_torch.core.segment import segment_corpus
    from repro_torch.core.vocab import build_vocabulary
    from repro_torch.data.synth_corpus import generate
    w = seine_world
    n_b = SEG_CHUNK + 1
    cfg = dataclasses.replace(seine_smoke(), n_segments=n_b)
    jcfg = dataclasses.replace(jax_smoke(), n_segments=n_b)
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs], n_b,
                                max_len=160)
    jtoks, jsegs = jax_segment([w["vocab"].map_tokens(d)
                                for d in w["ds"].docs], n_b, max_len=160)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(segs, jsegs)
    assert segs.max() >= SEG_CHUNK           # the second chunk is used
    want = JaxBuilder(jcfg, w["vocab"], w["provider"], ip=w["builder"].ip
                      ).build(jtoks, jsegs, batch_size=16)
    got = IndexBuilder(
        cfg, vocab,
        provider_from_numpy(np.asarray(w["provider"].table()), device="cpu"),
        ip=interaction_params_from_jax(w["builder"].ip, device="cpu"),
        device="cpu").build(toks, segs, batch_size=16)
    for f in ("term_offsets", "doc_ids", "idf", "doc_len", "seg_len"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    v, jv = got.values.numpy(), np.asarray(want.values)
    assert v.shape[1] == n_b
    for i, name in enumerate(got.functions):
        if name in ("tf", "idf_indicator"):
            np.testing.assert_array_equal(v[..., i], jv[..., i], name)
        else:
            np.testing.assert_allclose(v[..., i], jv[..., i], **TOL,
                                       err_msg=name)
