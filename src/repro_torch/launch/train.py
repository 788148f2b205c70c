"""Training driver (port of ``repro.launch.train``, on the card).

    PYTHONPATH=src python -m repro_torch.launch.train --workload seine-ranker \
        --retriever knrm --steps 200 --ckpt-dir build/ck
    PYTHONPATH=src python -m repro_torch.launch.train --workload lm \
        [--arch stablelm-1.6b] [--full] --steps 20

Trains a SEINE ranker on indexed M: the smoke-scale world of the
reference (corpus, vocabulary, TextTiling and index ids from ``--seed``
exactly as there; the HashProvider table and the ranker's initial
weights from ``torch.Generator``s seeded by ``--seed``), the pairwise
hinge over ``PairSampler`` batches of 16 and ``adam(3e-3)``, with
checkpoints and resume in ``--ckpt-dir``.  Every (query, doc) pair's M
comes from the index's ``qd_matrix``: on the card the ``csr_lookup``
kernel, and KNRM's features go through ``knrm_pool``.  Everything runs
on the card (``--device`` defaults to CUDA, and the run fails when
there is none); ``--device cpu`` runs the kernels' plain versions.

``--workload lm`` trains a decoder LM (default stablelm-1.6b) on the
reference's random next-token batches, ``adamw(3e-4)``: its smoke config
at (B, S) = (8, 64), or with ``--full`` the published config at (16,
1,024).  The weights come from ``init_params`` with a ``torch.Generator``
seeded by ``--seed``; attention runs the ``flash_attn`` forward and
backward kernels, each layer under remat.  The ``recsys`` and ``gnn``
workloads are not ported and exit with an error.
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
NOT_PORTED = {"recsys": "ROADMAP Queue 1 item 4 (the recsys models, the "
                        "next slice)",
              "gnn": "ROADMAP Queue 1 item 4 (the GNN models, after the "
                     "recsys slice)"}
# (B, S) of an LM batch: the smoke config's, and the published config's
LM_BATCH = {True: (8, 64), False: (16, 1024)}
LM_CE_CHUNKS = 4
LM_LR = 3e-4


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


def lm_batches(vocab_size: int, n_b: int, n_s: int, seed: int, device):
    """``next_batch(step)`` of the reference's ``train_lm``: ``{"tokens",
    "labels"}`` (B, S) int32 on ``device``, the inputs and next tokens of
    ``randint(0, V, (B, S + 1))``, the step-th draw of a
    ``RandomState(seed)``.  The reference draws one batch per call; a
    call out of order (a resumed run) draws again from the seed, so
    every step sees the reference's batch of that step."""
    state = {"rng": None, "next": None}

    def next_batch(step):
        step = int(step)
        if state["next"] != step:
            state["rng"] = np.random.RandomState(seed)
            for _ in range(step):
                state["rng"].randint(0, vocab_size, (n_b, n_s + 1))
        t = state["rng"].randint(0, vocab_size, (n_b, n_s + 1))
        state["next"] = step + 1
        t = torch.from_numpy(t.astype(np.int32)).to(device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    return next_batch


def lm_loss_fn(cfg, attention=None):
    """The reference's ``train_lm`` loss: ``lm_loss`` with 4 cross-entropy
    chunks, through ``attention`` (default the ``flash_attn`` kernels)."""
    from ..kernels.flash_attn import flash_attention
    from ..models import transformer as T

    attention = attention or flash_attention

    def loss_fn(params, batch):
        return T.lm_loss(params, batch, cfg, attention=attention,
                         ce_chunks=LM_CE_CHUNKS)

    return loss_fn


def fit_lm(cfg, params, batch_shape, steps: int, ckpt_dir, *, seed: int = 0,
           verbose: bool = True, ckpt_every: int = 100):
    """Train the LM ``params`` of ``cfg`` (a tree on their device) for
    ``steps`` on :func:`lm_batches` of ``batch_shape`` (B, S) with
    ``adamw(3e-4)``, an error-feedback residual in the state as the
    reference's, and checkpoints in ``ckpt_dir`` every ``ckpt_every``
    steps (resuming from the latest).  Returns the ``FitResult``."""
    from ..dist.compression import init_error_feedback
    from ..train import TrainState, adamw, fit, make_train_step

    dev = next(iter(params["layers"].values())).device
    opt = adamw(LM_LR)
    step_fn = make_train_step(lm_loss_fn(cfg), opt, donate=False)
    st = TrainState(params=params, opt_state=opt.init(params),
                    residual=init_error_feedback(params))
    return fit(st, step_fn, lm_batches(cfg.vocab_size, *batch_shape, seed,
                                       dev),
               n_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
               verbose=verbose)


def train_lm(arch: str, steps: int, ckpt_dir, *, smoke: bool = True,
             device=None, seed: int = 0, verbose: bool = True):
    """The reference's ``train_lm`` on ``device`` (default CUDA):
    ``smoke(arch)`` at (8, 64) or the published config at (16, 1,024),
    weights from ``init_params`` with a generator seeded by ``seed``,
    then :func:`fit_lm`."""
    from ..configs import get_lm_config
    from ..configs import smoke as smoke_cfg
    from ..models import transformer as T

    dev = resolve_device(device)
    cfg = smoke_cfg(arch) if smoke else get_lm_config(arch)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    return fit_lm(cfg, params, LM_BATCH[smoke], steps, ckpt_dir, seed=seed,
                  verbose=verbose)


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
    if args.workload == "lm":
        res = train_lm(args.arch or "stablelm-1.6b", args.steps,
                       args.ckpt_dir, smoke=args.smoke, device=args.device)
    else:
        res = train_seine_ranker(args.retriever, args.steps, args.ckpt_dir,
                                 device=args.device)
    h = res.history
    _log.info("done", steps=len(h), s=f"{time.perf_counter() - t0:.1f}",
              loss=f"{h[0]['loss']:.4f}->{h[-1]['loss']:.4f}",
              stragglers=len(res.straggler.flagged))


if __name__ == "__main__":
    main()
