#!/usr/bin/env python3
"""Time the port's first-stage posting scan on the card for one source
tree, at ``chip_smoke.py`` phase 4's shapes.

    python3 scripts/retrieve_scan_ab.py SRC_DIR [--seed N] [--queries Q]
        [--cache build/scan_ab_rows.npz]

``SRC_DIR`` is the ``src`` directory of the tree to time: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``).  To
compare two trees, run it on both in one call on one card, in turns
(parent, change, change, parent).

The index is phase 1's: 65,323 docs, n_b 20, the nine functions, a
Zipfian vocabulary of 100k terms with 4 hot terms in every doc (9.76M
postings); the (doc, term) rows are drawn on the host from ``--seed``
and kept in ``--cache`` after the first run, so every run, of either
tree, scans the same index; values are drawn on the card from the same
seed.  Three paths: the raw index (K = 1), and its K = 4 term-range
partition packed under ``packed`` and ``packed-q8`` at tile 256.  Each
scans ``--queries`` retrieval queries (2-6 real slots of 6, Zipfian
terms) whole: 64 blocks of 1,024 docs, through the tree's own wrappers
(a lane-bounds table per query, where the tree has one).  For each path
it prints the device us per block of all the device work (every kernel
and memset CUPTI records, the table's share included), the block
kernel's, the table's us per query and the memset's per block, and a
digest of M (the sum of every block's M in float64), which must agree
between trees.  It prints the card's name and power limit first and
needs a CUDA device.
"""
import argparse
import os
import subprocess
import sys

N_DOCS, N_B, VOCAB, N_HOT, TAIL_DRAWS = 65_323, 20, 100_000, 4, 164
Q_SLOTS, BLOCK, K_SHARDS, PACK_TILE = 6, 1024, 4, 256


def zipf_p(n):
    import numpy as np
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    return p / p.sum()


def host_rows(seed, cache):
    """(doc_ids, term_ids, doc_len) of chip_smoke.py's phase-1 index."""
    import numpy as np
    path = f"{cache[:-4]}_{seed}.npz"
    if not os.path.exists(path):
        rng = np.random.RandomState(seed)
        p_tail = zipf_p(VOCAB)[N_HOT:]
        tail = rng.choice(VOCAB - N_HOT, size=(N_DOCS, TAIL_DRAWS),
                          p=p_tail / p_tail.sum()) + N_HOT
        docs = np.arange(N_DOCS, dtype=np.int64)
        keys = np.unique(np.concatenate([
            (docs[:, None] * VOCAB + np.arange(N_HOT)).ravel(),
            (docs[:, None] * VOCAB + tail).ravel()]))
        doc_len = rng.randint(100, 1100, size=N_DOCS).astype(np.float32)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, doc_ids=(keys // VOCAB).astype(np.int32),
                 term_ids=(keys % VOCAB).astype(np.int32), doc_len=doc_len)
    data = np.load(path)
    return data["doc_ids"], data["term_ids"], data["doc_len"]


def device_profile(fns):
    """{device op: (us, count)} over one call of each of ``fns``, after a
    warm-up call of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--cache", default="build/scan_ab_rows.npz")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.core.index import build_from_rows
    from repro_torch.data.synth_corpus import ZIPF_FUNCTIONS
    from repro_torch.dist.partition import pack_index
    from repro_torch.dist.sharding import partition_index
    from repro_torch.kernels.csr_lookup import kernel as K
    from repro_torch.kernels.csr_lookup import lane_scales, retrieve_lanes

    if not torch.cuda.is_available():
        print("retrieve_scan_ab: no CUDA device", file=sys.stderr)
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
    seg_len = np.full((N_DOCS, N_B), 30.0, np.float32)
    index = build_from_rows(
        doc_ids, term_ids, values,
        idf=np.log(N_DOCS / np.maximum(df, 1)).astype(np.float32),
        doc_len=doc_len, seg_len=seg_len, n_docs=N_DOCS, vocab_size=VOCAB,
        functions=ZIPF_FUNCTIONS, device=dev)
    del values
    pidx = partition_index(index, K_SHARDS)
    paths = {"none K=1": index,
             "packed K=4": pack_index(pidx, "packed", tile=PACK_TILE),
             "packed-q8 K=4": pack_index(pidx, "packed-q8", tile=PACK_TILE)}
    del pidx
    rng = np.random.RandomState(args.seed + 1)
    queries = []
    for _ in range(args.queries):
        q = np.full(Q_SLOTS, -1, np.int32)
        n = rng.randint(2, Q_SLOTS + 1)
        q[:n] = rng.choice(VOCAB, size=n, replace=False, p=zipf_p(VOCAB))
        queries.append(torch.from_numpy(q).to(dev))
    n_blocks = -(-N_DOCS // BLOCK)
    tabled = hasattr(K, "lane_bounds_kernel")
    torch.cuda.synchronize()
    for name, idx in paths.items():
        raw = name.startswith("none")
        if raw:
            to, dids, vals = (idx.term_offsets[None], idx.doc_ids[None],
                              idx.values[None])
            t2s = rlo = rhi = None
        else:
            to, t2s, rlo, rhi = (idx.term_offsets, idx.term_to_shard,
                                 idx.range_lo, idx.range_hi)
            args_p = (idx._packed(), idx.fences, idx._serve_values)
        n_max = dids.shape[1] if raw else idx.nmax
        lanes = []
        for q in queries:
            lo, hi = retrieve_lanes(q, to, t2s, rlo, rhi, n_max)
            scale = (None if raw or idx.value_scale is None else
                     lane_scales(idx.value_scale, idx.range_lo,
                                 q).contiguous())
            lanes.append((lo.to(torch.int32).contiguous(),
                          hi.to(torch.int32).contiguous(), scale))
        digest = [0.0]

        def scan(lo, hi, scale, keep=False):
            bounds = {}
            if tabled:
                bounds["bounds"] = (
                    K.lane_bounds_kernel(dids, lo, hi, 0, BLOCK, n_blocks)
                    if raw else K.lane_bounds_packed_kernel(
                        *args_p, lo, hi, 0, BLOCK, n_blocks, tile=PACK_TILE))
            for b in range(n_blocks):
                if raw:
                    m = K.retrieve_windows_kernel(
                        dids, vals, lo, hi, b * BLOCK, BLOCK, tile=256,
                        **bounds)
                else:
                    m = K.retrieve_windows_packed_kernel(
                        *args_p, scale, lo, hi, b * BLOCK, BLOCK,
                        tile=PACK_TILE, **bounds)
                if keep:
                    digest[0] += float(m.double().sum())
        for c in lanes:
            scan(*c, keep=True)
        prof = device_profile([lambda c=c: scan(*c) for c in lanes])

        def us(piece):
            hits = [v for k, v in prof.items() if piece in k.lower()]
            n = sum(c for _, c in hits)
            return sum(t for t, _ in hits), n
        n_launch = len(lanes) * n_blocks
        block_us, n_block = us("retrieve_block")
        table_us, n_table = us("lane_bounds")
        memset_us, n_memset = us("memset")
        rest = (sum(t for t, _ in prof.values()) - block_us - table_us
                - memset_us)
        # per launch, so that records CUPTI dropped do not count as zeros
        per_block = (block_us / n_block + memset_us / max(n_block, 1)
                     + table_us / max(n_table, 1) / n_blocks
                     + rest / n_launch)
        print(f"[{args.src}] {name}: {per_block:.3f} us per block "
              f"of all device work ({len(lanes)} queries x {n_blocks} "
              f"blocks; block kernel {block_us / max(n_block, 1):.3f} us x "
              f"{n_block}, table {table_us / max(n_table, 1):.3f} us per "
              f"query x {n_table}, memset {memset_us / max(n_memset, 1):.3f}"
              f" us x {n_memset}); M digest {digest[0]!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
