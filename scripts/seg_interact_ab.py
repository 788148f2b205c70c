#!/usr/bin/env python3
"""Time the port's seg_interact kernel on the card for one source tree,
at the build's shape and at the No-Index request's shape.

    python3 scripts/seg_interact_ab.py SRC_DIR [--docs N] [--iters I]
        [--cache build/seg_ab_corpus.npz]

``SRC_DIR`` is the ``src`` directory of the tree to time: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``).  To
compare two trees, run it on both in one call on one card, in turns
(parent, change, change, parent).

The inputs are made as ``chip_smoke.py`` phase 5 makes them, over
SEINE_LETOR's synthetic corpus at ``--docs`` docs (default its full
65,323; n_b 20, De 128, ``max_len`` 512, a ``HashProvider`` table from
seed 0; the host corpus is kept in ``--cache`` after the first run, so
later runs, of either tree, read the same tokens): 16 build batches
of 32 docs with up to 512 unique terms each, and 4 No-Index requests of
6 query slots x 1,000 candidates (the candidates' real docs, as
``NoIndexEngine`` passes them).  For each shape it prints the kernel's
mean device ms per launch (CUPTI through ``torch.profiler``, ``--iters``
launches cycling through the inputs, after a warm-up), the operations
and bytes the live data needs, and a SHA-256 digest of the kernel's
outputs over every input of the shape, which must be equal between trees
that claim the same bits.  It prints the card's name and power limit
first and needs a CUDA device.
"""
import argparse
import dataclasses
import hashlib
import os
import subprocess
import sys


def device_ms(fns, iters):
    """(mean device ms of the seg_interact launches, launches recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "seg_interact" in e.key]
    us = sum(e.self_device_time_total for e in ev)
    n = sum(e.count for e in ev)
    return us / 1e3 / max(n, 1), n


def live_work(inputs, n_b):
    """(flops, bytes) per launch that the live data needs: 2 De flops per
    (live term, live token) pair; the live rows, seg, ids and output."""
    flops = n_bytes = 0.0
    for e_term, e_tok, seg, term_ids in inputs:
        u = (term_ids >= 0).sum(1).double()
        length = ((seg >= 0) & (seg < n_b)).sum(1).double()
        de = e_term.shape[2]
        flops += 2 * float((u * length).sum()) * de
        n_bytes += float(u.sum() + length.sum()) * de * 4
        n_bytes += (seg.numel() + term_ids.numel()) * 4
        n_bytes += e_term.shape[0] * e_term.shape[1] * n_b * 3 * 4
    return flops / len(inputs), n_bytes / len(inputs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src")
    ap.add_argument("--docs", type=int, default=65_323)
    ap.add_argument("--cache", default="build/seg_ab_corpus.npz")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.configs import SEINE_LETOR
    from repro_torch.core.build_pipeline import make_unique_terms_fn
    from repro_torch.core.interactions import seg_interact_inputs
    from repro_torch.core.providers import HashProvider
    from repro_torch.core.segment import segment_corpus
    from repro_torch.core.vocab import build_vocabulary
    from repro_torch.data.batching import candidates_for_query, pad_queries
    from repro_torch.data.synth_corpus import generate
    from repro_torch.kernels.seg_interact import seg_interact_kernel

    if not torch.cuda.is_available():
        print("seg_interact_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    n_b = 20
    cfg = dataclasses.replace(SEINE_LETOR, n_docs=args.docs, n_segments=n_b,
                              embed_dim=128)
    cache = f"{args.cache[:-4]}_{args.docs}.npz"
    if not os.path.exists(cache):
        ds = generate(cfg, seed=0)
        vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                                 keep_frac=cfg.vocab_keep_frac)
        toks, segs = segment_corpus(
            [vocab.map_tokens(d) for d in ds.docs], n_b, max_len=512,
            window=cfg.tile_window, smooth=cfg.tile_smooth)
        queries = pad_queries(ds.queries, vocab.map_tokens, q_len=6)
        os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
        np.savez(cache, toks=toks, segs=segs, queries=queries,
                 qrels=ds.qrels[:4], vocab_size=vocab.size)
    data = np.load(cache)
    toks, segs, queries = data["toks"], data["segs"], data["queries"]
    table = HashProvider(int(data["vocab_size"]), 128, device=dev,
                         generator=torch.Generator().manual_seed(0)).table()
    tok_d = torch.from_numpy(toks).to(dev)
    seg_d = torch.from_numpy(segs).to(dev)
    unique = make_unique_terms_fn(512)
    build = [seg_interact_inputs(tok_d[i:i + 32], seg_d[i:i + 32],
                                 unique(tok_d[i:i + 32]), table, n_b)
             for i in range(0, 16 * 32, 32)]
    rng = np.random.RandomState(0)
    noindex = []
    for i in range(4):
        cand = torch.from_numpy(candidates_for_query(data["qrels"][i], rng,
                                                     1000)).to(dev)
        q = torch.from_numpy(np.asarray(queries[i], np.int32)).to(dev)
        noindex.append(seg_interact_inputs(
            tok_d[cand], seg_d[cand], q[None].expand(cand.numel(), -1),
            table, n_b))
    for shape, inputs in (("build", build), ("noindex", noindex)):
        flops, n_bytes = live_work(inputs, n_b)
        ms, n = device_ms([lambda a=a: seg_interact_kernel(*a, n_b)
                           for a in inputs], args.iters)
        print(f"[{args.src}] {shape} {tuple(inputs[0][0].shape)} x "
              f"{tuple(inputs[0][1].shape[1:])}: {ms:.4f} ms per launch "
              f"({n} launches recorded) = {flops / ms / 1e9:.2f} TFLOP/s on "
              f"the live pairs; live work {flops / 1e9:.4f} GFLOP, "
              f"{n_bytes / 1e6:.2f} MB", flush=True)
        digest = hashlib.sha256()
        for a in inputs:
            digest.update(seg_interact_kernel(*a, n_b).cpu().numpy()
                          .tobytes())
        print(f"[{args.src}] {shape} output sha256 {digest.hexdigest()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
