"""Training driver (port of ``repro.launch.train``, on the card).

    PYTHONPATH=src python -m repro_torch.launch.train --workload seine-ranker \
        --retriever knrm --steps 200 --ckpt-dir build/ck

Trains a SEINE ranker on indexed M: the smoke-scale world of the
reference (corpus, vocabulary, TextTiling and index ids from ``--seed``
exactly as there; the HashProvider table and the ranker's initial
weights from ``torch.Generator``s seeded by ``--seed``), the pairwise
hinge over ``PairSampler`` batches of 16 and ``adam(3e-3)``, with
checkpoints and resume in ``--ckpt-dir``.  Every (query, doc) pair's M
comes from the index's ``qd_matrix``: on the card the ``csr_lookup``
kernel, and KNRM's features go through ``knrm_pool``.  Everything runs
on the card (``--device`` defaults to CUDA, and the run fails when
there is none); ``--device cpu`` runs the kernels' plain versions.  The
``lm``, ``recsys`` and ``gnn`` workloads are not ported and exit with an
error.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import obs
from ..kernels.utils import resolve_device

_log = obs.get_logger("repro.launch.train")

# the ROADMAP queue that ports each workload the driver does not run yet
NOT_PORTED = {"lm": "ROADMAP Queue 1 item 4 (the LM's loss and training)",
              "recsys": "ROADMAP Queue 1 item 4 (the recsys models)",
              "gnn": "ROADMAP Queue 1 item 4 (the GNN models)"}


def has_params(params) -> bool:
    return any(True for _ in params.parameters())


def ranker_loss_fn(retriever: str, index):
    """The reference's training loss: for each example of the batch the
    pairwise hinge ``max(0, 1 - s_pos + s_neg)`` of B = 1 scores, then
    the mean over the batch.  M comes from ``index.qd_matrix`` (the
    lookup kernel on the card)."""
    from ..retrievers import get_retriever, hinge_pair_loss
    from ..serving import make_qmeta

    spec = get_retriever(retriever)

    def loss_fn(params, batch):
        losses = []
        for qi, p, n in zip(batch["q"], batch["pos"], batch["neg"]):
            p, n = p[None], n[None]
            losses.append(hinge_pair_loss(
                spec.score, params, index.qd_matrix(qi, p),
                index.qd_matrix(qi, n), make_qmeta(index, qi, p),
                make_qmeta(index, qi, n), index.functions))
        return torch.stack(losses).mean()

    return loss_fn


def pair_batches(sampler, queries: np.ndarray, device):
    """``next_batch(step)`` over ``sampler``: ``{"q" (B, Q), "pos" (B,),
    "neg" (B,)}`` int32 on ``device``.  The sampler's position is set to
    ``step`` first, so the batch of a step depends on the step alone and a
    resumed run sees the batches of an uninterrupted one (the reference
    advances its sampler one batch per call, the same batches when
    ``fit`` starts from step 0)."""
    def next_batch(step):
        sampler.step = int(step)
        b = sampler.next_batch()
        as_ids = lambda a: torch.as_tensor(np.asarray(a, np.int32),
                                           device=device)
        return {"q": as_ids(queries[b["query"]]), "pos": as_ids(b["pos"]),
                "neg": as_ids(b["neg"])}
    return next_batch


def train_ranker(retriever: str, index, queries: np.ndarray,
                 qrels: np.ndarray, params, steps: int, ckpt_dir, *,
                 seed: int = 0, verbose: bool = True, ckpt_every: int = 100):
    """Train ``params`` (a ParamTree, moved to the index's device and
    updated in place) on ``index`` with the hinge of
    :func:`ranker_loss_fn`, ``adam(3e-3)`` and a ``PairSampler`` of
    batch 16 over every query of ``qrels`` (``seed``), as the reference's
    ``train_seine_ranker``; checkpoints in ``ckpt_dir`` every
    ``ckpt_every`` steps, keeping the last 3, and resumes from the latest.
    Returns the ``FitResult``."""
    from ..data.batching import PairSampler
    from ..dist.compression import init_error_feedback
    from ..train import TrainState, adam, fit, make_train_step

    params = params.to(index.device)
    sampler = PairSampler(qrels, np.arange(len(queries)),
                          batch_size=16, seed=seed)
    opt = adam(3e-3)
    step_fn = make_train_step(ranker_loss_fn(retriever, index), opt,
                              donate=False)
    st = TrainState(params=params, opt_state=opt.init(params),
                    residual=init_error_feedback(params))
    return fit(st, step_fn,
               pair_batches(sampler, queries, index.device),
               n_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
               data_state=sampler.state_dict, verbose=verbose)


def train_seine_ranker(retriever: str, steps: int, ckpt_dir, *, seed=0,
                       verbose=True, device=None):
    """The reference's ``train_seine_ranker`` on ``device`` (default
    CUDA): the ``seine_smoke`` world, then :func:`train_ranker`."""
    from ..configs import seine_smoke
    from ..core.builder import IndexBuilder
    from ..core.providers import HashProvider
    from ..core.segment import segment_corpus
    from ..core.vocab import build_vocabulary
    from ..data.batching import pad_queries
    from ..data.synth_corpus import generate
    from ..retrievers import get_retriever

    dev = resolve_device(device)
    cfg = seine_smoke()
    ds = generate(cfg, seed=seed)
    vocab = build_vocabulary(ds.docs, ds.n_raw_tokens)
    slot_docs = [vocab.map_tokens(d) for d in ds.docs]
    toks, segs = segment_corpus(slot_docs, cfg.n_segments, max_len=160)
    provider = HashProvider(vocab.size, cfg.embed_dim,
                            generator=torch.Generator().manual_seed(seed),
                            device=dev)
    builder = IndexBuilder(cfg, vocab, provider, device=dev)
    index = builder.build(toks, segs, batch_size=16)
    if verbose:
        _log.info("index", stats=builder.last_build_stats.summary())
    queries = pad_queries(ds.queries, vocab.map_tokens, q_len=6)
    params = get_retriever(retriever).init(
        torch.Generator().manual_seed(seed), cfg.n_segments,
        index.functions, device=dev)
    if not has_params(params):
        raise SystemExit(f"{retriever} has no trainable params")
    return train_ranker(retriever, index, queries, ds.qrels, params, steps,
                        ckpt_dir, seed=seed, verbose=verbose)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True,
                    choices=["seine-ranker", "lm", "recsys", "gnn"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--retriever", default="knrm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: CUDA; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args()
    if args.workload in NOT_PORTED:
        ap.error(f"--workload {args.workload} is not ported yet: "
                 f"{NOT_PORTED[args.workload]}")

    t0 = time.perf_counter()
    res = train_seine_ranker(args.retriever, args.steps, args.ckpt_dir,
                             device=args.device)
    h = res.history
    _log.info("done", steps=len(h), s=f"{time.perf_counter() - t0:.1f}",
              loss=f"{h[0]['loss']:.4f}->{h[-1]['loss']:.4f}",
              stragglers=len(res.straggler.flagged))


if __name__ == "__main__":
    main()
