"""Training driver (port of ``repro.launch.train``, on the card).

    PYTHONPATH=src python -m repro_torch.launch.train --workload seine-ranker \
        --retriever knrm --steps 200 --ckpt-dir build/ck
    PYTHONPATH=src python -m repro_torch.launch.train --workload lm \
        [--arch stablelm-1.6b] [--full] --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --workload recsys \
        --arch bert4rec --steps 20 --ckpt-dir build/ck
    PYTHONPATH=src python -m repro_torch.launch.train --workload gnn

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
backward kernels, each layer under remat.

``--workload recsys`` trains a recommender (``--arch`` autoint, the
default, dlrm-mlperf, sasrec or bert4rec) at its smoke config, as the
reference does with and without ``--full``: the reference's synthetic
batches (CTR batches of 256, sequence batches of 64, batch seed ``seed *
7919 + step``) and ``adam(1e-3)``.  BERT4Rec's attention runs the
``flash_attn`` forward and backward kernels; SASRec's head dim (50) is
not one they take, so it runs the plain attention as the reference does.
``--workload gnn`` trains MACE's smoke config on batches of 8 molecules
of 12 atoms and 32 edges, energy targets ``sin(0..7)`` and zero forces,
with ``adam(1e-3)``; its loss trains through the forces, a gradient of a
gradient.  Weights come from a ``torch.Generator`` seeded by
``--seed``; checkpoints and resume work as for the other workloads.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import obs
from ..kernels.utils import resolve_device

_log = obs.get_logger("repro.launch.train")

# (B, S) of an LM batch: the smoke config's, and the published config's
LM_BATCH = {True: (8, 64), False: (16, 1024)}
LM_CE_CHUNKS = 4
LM_LR = 3e-4
RECSYS_LR = 1e-3
# batch of the reference's train_recsys: CTR rows, or sequences
RECSYS_BATCH = {"ctr": 256, "seq": 64}
GNN_LR = 1e-3
# the reference's train_gnn: graphs, atoms and edges per graph
GNN_BATCH = (8, 12, 32)


def _fit(loss_fn, params, opt, next_batch, steps: int, ckpt_dir, *,
         verbose: bool, ckpt_every: int, data_state=None):
    """The reference trainers' loop: ``opt`` through ``make_train_step``
    (clipping at 1.0), an error-feedback residual in the state as the
    reference's, and checkpoints in ``ckpt_dir`` every ``ckpt_every``
    steps (resuming from the latest).  Returns the ``FitResult``."""
    from ..dist.compression import init_error_feedback
    from ..train import TrainState, fit, make_train_step

    step_fn = make_train_step(loss_fn, opt, donate=False)
    st = TrainState(params=params, opt_state=opt.init(params),
                    residual=init_error_feedback(params))
    return fit(st, step_fn, next_batch, n_steps=steps, ckpt_dir=ckpt_dir,
               ckpt_every=ckpt_every, data_state=data_state,
               verbose=verbose)


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
    from ..train import adam

    params = params.to(index.device)
    sampler = PairSampler(qrels, np.arange(len(queries)),
                          batch_size=16, seed=seed)
    return _fit(ranker_loss_fn(retriever, index), params, adam(3e-3),
                pair_batches(sampler, queries, index.device), steps,
                ckpt_dir, verbose=verbose, ckpt_every=ckpt_every,
                data_state=sampler.state_dict)


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
    from ..train import adamw

    dev = next(iter(params["layers"].values())).device
    return _fit(lm_loss_fn(cfg), params, adamw(LM_LR),
                lm_batches(cfg.vocab_size, *batch_shape, seed, dev), steps,
                ckpt_dir, verbose=verbose, ckpt_every=ckpt_every)


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


def recsys_init(cfg, gen: torch.Generator, device=None):
    """The init of ``cfg``'s family (``models.recsys``)."""
    from ..models import recsys as R
    init = {"attn-ctr": R.autoint_init, "dlrm": R.dlrm_init}.get(
        cfg.family, R.seqrec_init)
    return init(cfg, gen, device)


def recsys_loss_fn(cfg, attention=None):
    """The reference's ``train_recsys`` loss of ``cfg``'s family: BCE of
    AutoInt's or DLRM's logit, SASRec's BPR loss or BERT4Rec's sampled
    softmax; BERT4Rec's attention through ``attention`` (default the
    ``flash_attn`` kernels)."""
    from ..kernels.flash_attn import flash_attention
    from ..models import recsys as R

    attention = attention or flash_attention
    if cfg.family == "attn-ctr":
        return lambda p, b: R.bce_loss(
            R.autoint_forward(p, cfg, b["sparse_ids"]), b["label"])
    if cfg.family == "dlrm":
        return lambda p, b: R.bce_loss(
            R.dlrm_forward(p, cfg, b["dense"], b["sparse_ids"]), b["label"])
    if cfg.causal:
        return lambda p, b: R.sasrec_loss(p, cfg, b, attention=attention)
    return lambda p, b: R.bert4rec_loss(p, cfg, b, attention=attention)


def recsys_batches(cfg, seed: int, device, batch: int = 0):
    """``next_batch(step)``: the reference's ``ctr_batch`` or
    ``seqrec_batch`` of seed ``seed * 7919 + step`` on ``device``, of
    ``batch`` rows (default the reference's: 256 CTR rows, 64
    sequences)."""
    from ..data.recsys_data import ctr_batch, seqrec_batch

    ctr = cfg.family in ("attn-ctr", "dlrm")
    gen = ctr_batch if ctr else seqrec_batch
    n = batch or RECSYS_BATCH["ctr" if ctr else "seq"]

    def next_batch(step):
        b = gen(cfg, n, seed=seed * 7919 + int(step))
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    return next_batch


def fit_recsys(cfg, params, steps: int, ckpt_dir, *, seed: int = 0,
               batch: int = 0, verbose: bool = True, ckpt_every: int = 100):
    """Train the recsys ``params`` of ``cfg`` (a tree on their device) for
    ``steps`` on :func:`recsys_batches` with :func:`recsys_loss_fn` and
    ``adam(1e-3)``.  Returns the ``FitResult``."""
    from .. import tree
    from ..train import adam

    dev = tree.leaves(params)[0].device
    return _fit(recsys_loss_fn(cfg), params, adam(RECSYS_LR),
                recsys_batches(cfg, seed, dev, batch), steps, ckpt_dir,
                verbose=verbose, ckpt_every=ckpt_every)


def train_recsys(arch: str, steps: int, ckpt_dir, *, seed: int = 0,
                 device=None, verbose: bool = True):
    """The reference's ``train_recsys`` on ``device`` (default CUDA):
    ``smoke(arch)``, weights from a generator seeded by ``seed``, then
    :func:`fit_recsys`."""
    from ..configs import smoke as smoke_cfg

    dev = resolve_device(device)
    cfg = smoke_cfg(arch)
    params = recsys_init(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    return fit_recsys(cfg, params, steps, ckpt_dir, seed=seed,
                      verbose=verbose)


def gnn_batches(cfg, seed: int, device, shape=GNN_BATCH):
    """``next_batch(step)`` of the reference's ``train_gnn``:
    ``batched_molecules(*shape, seed=seed * 31 + step)`` on ``device``
    with energy targets ``sin(0..n_graphs-1)`` and zero forces."""
    from ..data.graph import batched_molecules

    n_graphs, nodes_per, edges_per = shape

    def next_batch(step):
        b = batched_molecules(n_graphs, nodes_per, edges_per,
                              seed=seed * 31 + int(step),
                              n_species=cfg.n_species)
        b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        # synthetic targets from a fixed "teacher" configuration
        b["energy"] = torch.sin(torch.arange(n_graphs, dtype=torch.float32,
                                             device=device))
        b["forces"] = torch.zeros_like(b["positions"])
        return b

    return next_batch


def gnn_loss_fn(cfg, n_graphs: int):
    """The reference's ``train_gnn`` loss: ``mace_loss`` (energies and
    forces) over ``n_graphs`` graphs."""
    from ..models import mace as MA
    return lambda p, b: MA.mace_loss(p, cfg, b, n_graphs=n_graphs)


def fit_gnn(cfg, params, steps: int, ckpt_dir, *, seed: int = 0,
            shape=GNN_BATCH, verbose: bool = True, ckpt_every: int = 100):
    """Train the MACE ``params`` of ``cfg`` for ``steps`` on
    :func:`gnn_batches` of ``shape`` with ``adam(1e-3)``.  Returns the
    ``FitResult``."""
    from ..train import adam

    dev = params["species_embed"].device
    return _fit(gnn_loss_fn(cfg, shape[0]), params, adam(GNN_LR),
                gnn_batches(cfg, seed, dev, shape), steps, ckpt_dir,
                verbose=verbose, ckpt_every=ckpt_every)


def train_gnn(steps: int, ckpt_dir, *, seed: int = 0, device=None,
              verbose: bool = True):
    """The reference's ``train_gnn`` on ``device`` (default CUDA): the
    smoke MACE config, weights from a generator seeded by ``seed``, then
    :func:`fit_gnn`."""
    from ..configs import smoke as smoke_cfg
    from ..models import mace as MA

    dev = resolve_device(device)
    cfg = smoke_cfg("mace")
    params = MA.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    return fit_gnn(cfg, params, steps, ckpt_dir, seed=seed, verbose=verbose)


def main():
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

    t0 = time.perf_counter()
    if args.workload == "seine-ranker":
        res = train_seine_ranker(args.retriever, args.steps, args.ckpt_dir,
                                 device=args.device)
    elif args.workload == "lm":
        res = train_lm(args.arch or "stablelm-1.6b", args.steps,
                       args.ckpt_dir, smoke=args.smoke, device=args.device)
    elif args.workload == "recsys":
        res = train_recsys(args.arch or "autoint", args.steps,
                           args.ckpt_dir, device=args.device)
    else:
        res = train_gnn(args.steps, args.ckpt_dir, device=args.device)
    h = res.history
    _log.info("done", steps=len(h), s=f"{time.perf_counter() - t0:.1f}",
              loss=f"{h[0]['loss']:.4f}->{h[-1]['loss']:.4f}",
              stragglers=len(res.straggler.flagged))
    return res


if __name__ == "__main__":
    main()
