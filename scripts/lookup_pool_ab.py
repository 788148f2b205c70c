#!/usr/bin/env python3
"""Time the port's raw pair lookup (``csr_lookup``) and KNRM kernel bank
(``knrm_pool``) on the card for one source tree, at ``chip_smoke.py``'s
shapes.

    python3 scripts/lookup_pool_ab.py SRC_DIR [--seed N]
        [--cache build/scan_ab_rows.npz]

``SRC_DIR`` is the ``src`` directory of the tree to time: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``).  To
compare two trees, run it on both in one call on one card, in turns
(parent, change, change, parent).

The index is phase 1's raw K = 1 index (``scripts/retrieve_scan_ab.py``
draws and caches its rows: 65,323 docs, n_b 20, the nine functions, 9.76M
postings; values drawn on the card from ``--seed``).  It times, as device
us per launch (CUPTI):

- ``csr_lookup`` at the serving shape, 6 slots x 1,000 candidates, over
  16 requests (3-6 real Zipfian terms each) in turn, with a warm and a
  cold L2 (64 MB overwritten before every launch);
- ``csr_lookup`` at the coalesced shape: one front-end batch of 8 of those
  requests, deduplicated by ``plan_coalesced`` (pairs padded to 256) and
  routed per pair, through ``index.lookup_pair_rows``: a (1, P) grid;
- ``knrm_pool`` at the serving shape, 1,000 x 6 x 20, on the cos_norm of
  each request's M (the front end scores each request of a batch on its
  own, so this is its shape there too);

then the device time per re-rank of ``serve_batches`` over the 16
requests with a KNRM ``SeineEngine`` (every kernel, memcpy and memset
CUPTI records, per request, and the device ops per request).  It prints a
SHA-256 digest of every M it computed (serving and coalesced shapes),
which must be equal between trees, and the float64 sum of the pooled
features; the features are also kept in ``build/lookup_pool_ab/`` and
held against every other tree's there (max |diff| and the rtol 1e-5 /
atol 1e-6 bar).  It prints the card's name and power limit first and needs
a CUDA device.
"""
import argparse
import hashlib
import os
import subprocess
import sys

from retrieve_scan_ab import N_B, N_DOCS, VOCAB, host_rows, zipf_p

Q_SLOTS, N_CAND, N_REQUESTS, BATCH, PAIR_PAD = 6, 1000, 16, 8, 256
OUT_DIR = os.path.join("build", "lookup_pool_ab")


def cupti_us(fns, key: str, iters: int, cold: bool = False):
    """(device us per launch, launches recorded) of the kernels whose name
    contains ``key``, over ``iters`` calls cycling through ``fns``, after a
    warm-up; with ``cold``, 64 MB are overwritten before every call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if cold:
        buf = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
        fns = [lambda f=f: (buf.zero_(), f()) for f in fns]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if key in e.key]
    n = sum(e.count for e in ev)
    return sum(e.self_device_time_total for e in ev) / max(n, 1), n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default="build/scan_ab_rows.npz")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.index import build_from_rows
    from repro_torch.data.synth_corpus import ZIPF_FUNCTIONS
    from repro_torch.kernels.csr_lookup import csr_lookup_kernel, route_terms
    from repro_torch.kernels.knrm_pool import knrm_pool_kernel
    from repro_torch.retrievers import get_retriever
    from repro_torch.serving import SeineEngine, serve_batches
    from repro_torch.serving.coalesce import plan_coalesced

    if not torch.cuda.is_available():
        print("lookup_pool_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    doc_ids, term_ids, doc_len = host_rows(args.seed, args.cache)
    df = np.bincount(term_ids, minlength=VOCAB)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    values = torch.rand((doc_ids.size, N_B, len(ZIPF_FUNCTIONS)),
                        generator=gen, device=dev)
    index = build_from_rows(
        doc_ids, term_ids, values,
        idf=np.log(N_DOCS / np.maximum(df, 1)).astype(np.float32),
        doc_len=doc_len, seg_len=np.full((N_DOCS, N_B), 30.0, np.float32),
        n_docs=N_DOCS, vocab_size=VOCAB, functions=ZIPF_FUNCTIONS,
        device=dev)
    del values
    rng = np.random.RandomState(args.seed + 2)
    requests = []
    for _ in range(N_REQUESTS):
        q = np.full(Q_SLOTS, -1, np.int32)
        n = rng.randint(3, Q_SLOTS + 1)
        q[:n] = rng.choice(VOCAB, size=n, replace=False, p=zipf_p(VOCAB))
        requests.append((q, rng.choice(N_DOCS, N_CAND, replace=False)
                         .astype(np.int32)))
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731
    lookups = []
    for q, d in requests:
        k, lo, hi = route_terms(torch.from_numpy(q).to(dev),
                                index.term_offsets[None], None, None)
        lookups.append((i32(k), i32(lo), i32(hi), torch.from_numpy(d).to(dev),
                        index.doc_ids[None], index.fences[None],
                        index.values[None]))
    terms, docs, _, n_distinct = plan_coalesced(requests[:BATCH], PAIR_PAD)
    pair_t = torch.from_numpy(terms).to(dev)
    pair_d = torch.from_numpy(docs).to(dev)
    cos_col = list(ZIPF_FUNCTIONS).index("cosine")
    torch.cuda.synchronize()

    digest = hashlib.sha256()
    feats = []
    for a in lookups:
        m = csr_lookup_kernel(*a, tile=256)
        digest.update(m.cpu().numpy().tobytes())
        cos = torch.clamp(m[..., cos_col] / 30.0, -1.0, 1.0).contiguous()
        mask = torch.ones((N_CAND, N_B), dtype=torch.float32, device=dev)
        feats.append((cos, mask, knrm_pool_kernel(cos, mask)))
    digest.update(index.lookup_pair_rows(pair_t, pair_d).cpu().numpy()
                  .tobytes())

    serve = [lambda a=a: csr_lookup_kernel(*a, tile=256) for a in lookups]
    warm, n_warm = cupti_us(serve, "csr_lookup_kernel", 160)
    cold, _ = cupti_us(serve, "csr_lookup_kernel", 160, cold=True)
    coal, n_coal = cupti_us(
        [lambda: index.lookup_pair_rows(pair_t, pair_d)],
        "csr_lookup_kernel", 40)
    pool, n_pool = cupti_us([lambda f=f: knrm_pool_kernel(f[0], f[1])
                             for f in feats], "knrm_pool_kernel", 160)

    params = get_retriever("knrm").init(
        torch.Generator().manual_seed(args.seed), N_B, ZIPF_FUNCTIONS,
        device=dev)
    engine = SeineEngine(index, "knrm", params)
    serve_batches(engine, requests[:2])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve_batches(engine, requests)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rerank_ms = sum(e.self_device_time_total for e in ev) / 1e3 / N_REQUESTS
    ops = sum(e.count for e in ev) / N_REQUESTS

    out = torch.cat([f[2] for f in feats]).cpu().numpy()
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = os.path.abspath(args.src).strip("/").replace("/", "_")
    np.save(os.path.join(OUT_DIR, f"{tag}.npy"), out)
    others = []
    for name in sorted(os.listdir(OUT_DIR)):
        if name.endswith(".npy") and name != f"{tag}.npy":
            other = np.load(os.path.join(OUT_DIR, name))
            ok = np.allclose(out, other, rtol=1e-5, atol=1e-6)
            others.append(f"{name[:-4]}: max |diff| "
                          f"{np.abs(out - other).max():.3g}"
                          f"{'' if ok else ' PAST rtol 1e-5 / atol 1e-6'}")
    print(f"[{args.src}] csr_lookup {Q_SLOTS} x {N_CAND}: {warm:.4f} us per "
          f"launch warm ({n_warm} recorded), {cold:.4f} cold; coalesced "
          f"(1, {pair_t.shape[0]}) grid of {n_distinct} distinct pairs from "
          f"{BATCH} requests: {coal:.4f} us ({n_coal} recorded); knrm_pool "
          f"{N_CAND} x {Q_SLOTS} x {N_B}: {pool:.4f} us ({n_pool} recorded)"
          f"; serve_batches device time per re-rank {rerank_ms:.5f} ms "
          f"({ops:.1f} device ops); M digest {digest.hexdigest()[:16]}; "
          f"pooled features sum {float(out.astype(np.float64).sum())!r}"
          + "".join(f"; vs {o}" for o in others), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
