#!/usr/bin/env python3
"""Time the port's build stages 1-3 on the card for one source tree.

    python3 scripts/build_stage_ab.py SRC_DIR [--docs N] [--reps R]

``SRC_DIR`` is the ``src`` directory of the tree to time: ``src`` for the
checkout, or that of another commit unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``, then ``build/parent/src``).  To
compare two trees, run it on both in one call on one card, in turns
(parent, change, change, parent): the machine and its neighbours change
between calls.

It builds SEINE_LETOR's synthetic corpus at ``--docs`` docs (n_b 20,
De 128, ``max_len`` 512, as ``chip_smoke.py`` phase 5), streams it through
``IndexBuilder.pipeline.stream_runs`` in batches of 32 (the first 128
docs once, untimed), and prints for each of ``--reps`` passes the wall
ms per batch and the host ms per batch of every stage (``BuildStats``),
beside the card's name and power limit.  It needs a CUDA device.
"""
import argparse
import dataclasses
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src")
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.configs import SEINE_LETOR
    from repro_torch.core.builder import IndexBuilder
    from repro_torch.core.interactions import init_interaction_params
    from repro_torch.core.providers import HashProvider
    from repro_torch.core.segment import segment_corpus
    from repro_torch.core.vocab import build_vocabulary
    from repro_torch.data.synth_corpus import generate

    if not torch.cuda.is_available():
        print("build_stage_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(SEINE_LETOR, n_docs=args.docs, n_segments=20,
                              embed_dim=128)
    ds = generate(cfg, seed=0)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens,
                             keep_frac=cfg.vocab_keep_frac)
    toks, segs = segment_corpus([vocab.map_tokens(d) for d in ds.docs], 20,
                                max_len=512, window=cfg.tile_window,
                                smooth=cfg.tile_smooth)
    provider = HashProvider(vocab.size, 128, device=dev,
                            generator=torch.Generator().manual_seed(0))
    ip = init_interaction_params(torch.Generator().manual_seed(1), 128,
                                 device=dev)
    builder = IndexBuilder(cfg, vocab, provider, ip=ip, device=dev)
    kw = dict(batch_size=32, max_uniq=512)
    builder.pipeline.stream_runs(toks[:128], segs[:128], **kw)
    torch.cuda.synchronize()
    n_batches = -(-args.docs // 32)
    for rep in range(args.reps):
        t0 = time.perf_counter()
        _, st = builder.pipeline.stream_runs(toks, segs, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_batches
        stages = ", ".join(f"{k} {v * 1e3 / n_batches:.3f}"
                           for k, v in st.stage_s.items())
        print(f"[{args.src}] pass {rep}: {ms:.3f} ms per batch; host ms "
              f"per batch by stage: {stages}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
