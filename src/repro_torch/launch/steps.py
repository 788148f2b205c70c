"""The grid's cells: a step function and its inputs for each of the 40
(architecture x input shape) cells, plus SEINE's two system cells, on one
card (port of ``repro.launch.steps``).

Inputs are tensors on the meta device, the counterpart of the
reference's ``jax.eval_shape`` / ``ShapeDtypeStruct``: parameters come
from each model's shape table (``transformer.param_specs``,
``recsys.param_shapes``, ``mace.param_shapes``), optimizer state from
``opt.init`` of those, batches are shaped tensors; nothing is allocated,
so a 16e9-parameter cell costs nothing to build.  ``Cell.make_args``
materialises the same inputs on a real device from a seed: parameters
through the ``init_*`` functions with an explicit ``torch.Generator``,
batches from numpy.

Every rule of the reference that changes a cell's numbers is kept, with
one device in place of the mesh: the LM training cells' gradient
accumulation (a microbatch of at most 16,384 tokens), ``ce_chunks = max(8,
S // 256)``, ``adam(3e-4)`` with ``clip_by_global_norm(1.0)`` and remat;
MACE's node and edge counts padded to 512; the recsys ``adam(1e-3)``, the
128 BERT4Rec negatives and the CTR candidates set into field 0.  Mesh
placement (the reference's ``in_shardings``) waits for training under a
mesh: ``in_shardings`` is None and ``strategy="fsdp"`` raises, naming
ROADMAP Queue 1 item 4e2 (the serving half of the mesh paths is
``launch/mesh.py`` and ``dist/sharding.py``).

Where the port parts from the reference on purpose:

* SEINE's ``retrieve`` cell calls ``qd_matrix`` with the port's own
  dispatch (the ``csr_lookup`` kernel and KNRM's ``knrm_pool`` for CUDA
  tensors), where the reference forces ``impl="jnp"`` to keep an SPMD
  plan.
* SEINE's ``index_build`` cell sums its 64 segments a doc through the
  ``embed_bag`` kernel's segment entry (``HashProvider.contextualize``,
  the same mix), where the reference writes a ``segment_sum``.
* The LM step functions take their attention as a keyword (the
  ``flash_attn`` kernels by default), as the reference's take
  ``attn_chunk``; ``Cell.count_kwargs`` holds the chunked
  ``gqa_attention`` that ``launch/dryrun.py`` counts them through.
* A LM training step accumulates over as many microbatches as its batch
  holds; ``Cell.count_args`` is its first microbatch, which the counting
  pass runs with the optimizer update, the rest counted as the
  ``microbatch`` component.
* A CTR model's ``retrieval_cand`` step scores its candidates in chunks
  of ``CTR_CAND_CHUNK``: the same scores, in less memory.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree as TR
from ..configs import get_bundle
from ..configs.base import ShapeConfig, TransformerConfig
from ..data import recsys_data as R_DATA
from ..data.graph import batched_molecules, random_graph, subgraph_shape
from ..kernels.flash_attn import flash_attention
from ..models import mace as MA
from ..models import recsys as R
from ..models import transformer as T
from ..models.layers import gqa_attention
from ..train.loop import value_and_grad
from ..train.optimizer import adam, apply_updates, clip_by_global_norm
from .train import recsys_init, recsys_loss_fn

META = torch.device("meta")
# the chunked attention the reference's cells lower (``attn_chunk``)
ATTN_CHUNK = 1024
COUNT_ATTENTION = functools.partial(gqa_attention, chunk=ATTN_CHUNK)
# a microbatch's tokens at most, on one device (the reference's cap)
MICROBATCH_TOKENS = 16384
# candidates of a CTR model's retrieval step scored at once
CTR_CAND_CHUNK = 65536
MESH_ITEM = ("ROADMAP Queue 1 item 4e2 (training and the launch tools "
             "under a mesh)")

Materialize = Callable[[torch.device, int], Tuple[Any, ...]]


@dataclass
class Component:
    """One additively-counted piece of the roofline decomposition."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Any = None
    multiplier: int = 1


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    step_name: str                      # train_step | serve_step | ...
    fn: Callable
    args: Tuple[Any, ...]               # meta tensors
    in_shardings: Any = None            # no placement on one card
    donate: Tuple[int, ...] = ()
    components: List[Component] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    # the counting pass's arguments where they are not ``args`` (a LM
    # training cell's first microbatch), and keywords it gives ``fn``
    # and the components (the attention to count through)
    count_args: Optional[Tuple[Any, ...]] = None
    count_kwargs: Dict[str, Any] = field(default_factory=dict)
    materialize: Optional[Materialize] = None

    def make_args(self, device, seed: int = 0) -> Tuple[Any, ...]:
        """``args`` on ``device``, drawn from ``seed``."""
        return self.materialize(torch.device(device), seed)


# ---------------------------------------------------------------------------
# shapes and draws
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _meta_tree(shapes, dtype=torch.float32):
    """A tree of shape tuples (``param_shapes``) as meta tensors."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v, dtype) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_meta_tree(v, dtype) for v in shapes]
    return _meta(shapes, dtype)


def _lm_params_meta(cfg: TransformerConfig) -> Dict[str, Any]:
    params: Dict[str, Any] = {"layers": {}}
    for name, (shape, _) in T.param_specs(cfg).items():
        t = _meta(shape, T.param_dtype(cfg, name))
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _on(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def _tokens(rng: np.random.RandomState, vocab: int, shape) -> np.ndarray:
    return rng.randint(0, vocab, shape).astype(np.int32)


def _check_strategy(strategy: str) -> None:
    if strategy != "tp2d":
        raise NotImplementedError(
            f"strategy {strategy!r} places parameters across a mesh, "
            f"which the launch tools do not do yet: {MESH_ITEM}")


# ===========================================================================
# LM cells
# ===========================================================================

def lm_accum(shape: ShapeConfig) -> int:
    """The reference's microbatching rule on one device: halve the batch
    while a microbatch holds more than MICROBATCH_TOKENS tokens."""
    B, S = shape.global_batch, shape.seq_len
    accum = 1
    while B // (accum * 2) >= 1 and (B // accum) * S > MICROBATCH_TOKENS:
        accum *= 2
    return accum


def _lm_meta(cfg: TransformerConfig, **kw) -> Dict[str, Any]:
    return {"n_layers": cfg.n_layers, **kw, "n_params": cfg.n_params,
            "n_active_params": cfg.n_active_params}


def _lm_train_cell(cfg: TransformerConfig, shape: ShapeConfig, *,
                   accum: Optional[int] = None,
                   strategy: str = "tp2d") -> Cell:
    _check_strategy(strategy)
    B, S = shape.global_batch, shape.seq_len
    if accum is None:
        accum = lm_accum(shape)
    mb = B // accum
    ce_chunks = max(8, S // 256)
    opt = adam(3e-4)

    params_s = _lm_params_meta(cfg)
    opt_s = opt.init(params_s)
    batch_s = {"tokens": _meta((accum, mb, S), torch.int32),
               "labels": _meta((accum, mb, S), torch.int32)}

    def loss_of(attention):
        return lambda params, batch: T.lm_loss(
            params, batch, cfg, attention=attention, ce_chunks=ce_chunks,
            remat=True)

    def train_step(params, opt_state, batch, *, attention=flash_attention):
        """One optimizer step over every microbatch ``batch`` holds
        (its leading axis): their gradients summed in float32 and scaled
        by 1 / ``accum``, as the reference's scan does."""
        loss_fn = loss_of(attention)
        if accum == 1:
            loss, grads = value_and_grad(
                loss_fn, params, {k: v[0] for k, v in batch.items()})
        else:
            dev = batch["tokens"].device
            loss = torch.zeros((), device=dev)
            grads = TR.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(batch["tokens"].shape[0]):
                loss, grads = microbatch(params, (loss, grads),
                                         {k: v[i] for k, v in batch.items()},
                                         attention=attention)
            inv = 1.0 / accum
            loss = loss * inv
            grads = TR.tree_map(lambda g: g * inv, grads)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    def microbatch(params, carry, mbatch, *, attention=flash_attention):
        """One microbatch's loss and gradients added to ``carry``."""
        tot, g = carry
        loss, gi = value_and_grad(loss_of(attention), params, mbatch)
        with torch.no_grad():
            return tot + loss, TR.tree_map(torch.add, g, gi)

    def make(device, seed):
        params = T.init_params(cfg, _gen(device, seed), device=device)
        rng = np.random.RandomState(seed)
        toks = _tokens(rng, cfg.vocab_size, (accum, mb, S + 1))
        batch = _on({"tokens": toks[..., :-1], "labels": toks[..., 1:]},
                    device)
        return params, opt.init(params), batch

    comps = []
    count_args = None
    if accum > 1:
        mb_s = {k: v[0] for k, v in batch_s.items()}
        acc_s = (_meta((), torch.float32), TR.tree_map(
            lambda p: _meta(p.shape, torch.float32), params_s))
        comps = [Component("microbatch", microbatch, (params_s, acc_s, mb_s),
                           multiplier=accum - 1)]
        count_args = (params_s, opt_s,
                      {k: v[:1] for k, v in batch_s.items()})
    return Cell(arch_id=cfg.name, shape_name=shape.name, kind=shape.kind,
                step_name="train_step", fn=train_step,
                args=(params_s, opt_s, batch_s), donate=(0, 1),
                components=comps,
                meta=_lm_meta(cfg, ce_chunks=ce_chunks, accum=accum,
                              microbatch=mb, strategy=strategy,
                              tokens=B * S),
                count_args=count_args,
                count_kwargs={"attention": COUNT_ATTENTION},
                materialize=make)


def _lm_prefill_cell(cfg: TransformerConfig, shape: ShapeConfig) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    params_s = _lm_params_meta(cfg)
    tok_s = _meta((B, S), torch.int32)

    @torch.no_grad()
    def serve_step(params, tokens, *, attention=flash_attention):
        return T.prefill(params, tokens, cfg, attention=attention)

    def make(device, seed):
        rng = np.random.RandomState(seed)
        return (T.init_params(cfg, _gen(device, seed), device=device),
                torch.from_numpy(_tokens(rng, cfg.vocab_size, (B, S))).to(
                    device))

    # the whole forward is counted: eager torch runs every layer
    return Cell(arch_id=cfg.name, shape_name=shape.name, kind=shape.kind,
                step_name="serve_step", fn=serve_step, args=(params_s, tok_s),
                meta=_lm_meta(cfg, tokens=B * S),
                count_kwargs={"attention": COUNT_ATTENTION},
                materialize=make)


def _lm_decode_cell(cfg: TransformerConfig, shape: ShapeConfig) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    dt = T._dt(cfg)
    params_s = _lm_params_meta(cfg)
    cache_sh = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    cache_s = T.KVCache(_meta(cache_sh, dt), _meta(cache_sh, dt),
                        _meta((B,), torch.int32))
    tok_s = _meta((B,), torch.int32)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg)

    def make(device, seed):
        """A full cache of random keys and values drawn on the device,
        every row at length S - 1, so the step writes the last
        position and attends over all S."""
        params = T.init_params(cfg, _gen(device, seed), device=device)
        gen = _gen(device, seed + 1)
        k, v = (torch.empty(cache_sh, dtype=dt, device=device)
                for _ in range(2))
        for t in (k, v):
            for layer in t:
                layer.copy_(torch.randn(layer.shape, generator=gen,
                                        device=device))
        cache = T.KVCache(k, v, torch.full((B,), S - 1, dtype=torch.int32,
                                           device=device))
        rng = np.random.RandomState(seed)
        return params, cache, torch.from_numpy(
            _tokens(rng, cfg.vocab_size, (B,))).to(device)

    return Cell(arch_id=cfg.name, shape_name=shape.name, kind=shape.kind,
                step_name="serve_step", fn=serve_step,
                args=(params_s, cache_s, tok_s), donate=(1,),
                meta=_lm_meta(cfg, tokens=B, kv_len=S), materialize=make)


# ===========================================================================
# GNN (MACE) cells
# ===========================================================================

def mace_sizes(shape: ShapeConfig) -> Tuple[int, int, int]:
    """(nodes, edges, graphs) of a MACE shape before padding."""
    if shape.name == "minibatch_lg":
        N, E = subgraph_shape(shape.batch_nodes, shape.fanout)
        return N, E, 1
    if shape.name == "molecule":
        return (shape.n_nodes * shape.n_graphs, shape.n_edges * shape.n_graphs,
                shape.n_graphs)
    return shape.n_nodes, shape.n_edges, 1


def _mace_batch(cfg, shape: ShapeConfig, N: int, E: int, seed: int
                ) -> Dict[str, np.ndarray]:
    """A graph of the shape's sizes from ``seed``, padded to (N, E):
    padding edges are self-loops (the model masks them), padding nodes
    sit in the last graph with zero force targets."""
    N0, E0, n_graphs = mace_sizes(shape)
    if shape.name == "molecule":
        g = batched_molecules(shape.n_graphs, shape.n_nodes, shape.n_edges,
                              seed=seed, n_species=cfg.n_species)
    else:
        gr = random_graph(N0, E0, seed=seed, n_species=cfg.n_species)
        g = {"positions": gr.positions, "species": gr.species,
             "senders": gr.senders, "receivers": gr.receivers,
             "graph_idx": np.zeros(N0, np.int32)}
    pad_n, pad_e = N - N0, E - E0
    loops = np.arange(pad_e, dtype=np.int32) % N0
    far = 1e3 + np.arange(pad_n, dtype=np.float32)[:, None] * np.ones(3)
    return {
        "species": np.concatenate([g["species"], np.zeros(pad_n, np.int32)]),
        "positions": np.concatenate([g["positions"],
                                     far.astype(np.float32)]),
        "senders": np.concatenate([g["senders"], loops]),
        "receivers": np.concatenate([g["receivers"], loops]),
        "graph_idx": np.concatenate(
            [g["graph_idx"], np.full(pad_n, n_graphs - 1, np.int32)]),
        "energy": np.sin(np.arange(n_graphs)).astype(np.float32),
        "forces": np.zeros((N, 3), np.float32),
    }


def _mace_cell(cfg, shape: ShapeConfig) -> Cell:
    N0, E0, n_graphs = mace_sizes(shape)
    # the reference pads node and edge counts to its mesh tile; the same
    # sizes are kept here
    N = -(-N0 // 512) * 512
    E = -(-E0 // 512) * 512

    opt = adam(1e-3)
    params_s = _meta_tree(MA.param_shapes(cfg))
    opt_s = opt.init(params_s)
    batch_s = {
        "species": _meta((N,), torch.int32),
        "positions": _meta((N, 3)),
        "senders": _meta((E,), torch.int32),
        "receivers": _meta((E,), torch.int32),
        "graph_idx": _meta((N,), torch.int32),
        "energy": _meta((n_graphs,)),
        "forces": _meta((N, 3)),
    }

    def loss_fn(p, b):
        return MA.mace_loss(p, cfg, b, n_graphs=n_graphs)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad():
            grads, _ = clip_by_global_norm(grads, 1.0)
            updates, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, {"loss": loss}

    def make(device, seed):
        params = MA.init_params(cfg, _gen(device, seed), device)
        return (params, opt.init(params),
                _on(_mace_batch(cfg, shape, N, E, seed), device))

    return Cell(arch_id="mace", shape_name=shape.name, kind=shape.kind,
                step_name="train_step", fn=train_step,
                args=(params_s, opt_s, batch_s), donate=(0, 1),
                meta={"n_nodes": N, "n_edges": E, "n_graphs": n_graphs,
                      "n_nodes_unpadded": N0, "n_edges_unpadded": E0},
                materialize=make)


# ===========================================================================
# recsys cells
# ===========================================================================

def ctr_logit(cfg, params, batch) -> torch.Tensor:
    """A CTR model's logit of ``batch`` (``sparse_ids``, DLRM's
    ``dense``)."""
    if cfg.family == "dlrm":
        return R.dlrm_forward(params, cfg, batch["dense"], batch["sparse_ids"])
    return R.autoint_forward(params, cfg, batch["sparse_ids"])


def recsys_batch(cfg, shape: ShapeConfig, seed: int) -> Dict[str, np.ndarray]:
    """The host inputs of a recsys cell from ``seed`` (numpy): the
    reference's ``ctr_batch`` / ``seqrec_batch`` for training; for
    serving the batch without labels, a sequence model's targets, or one
    context and its candidates."""
    ctr = cfg.family in ("attn-ctr", "dlrm")
    if shape.kind == "training":
        gen = R_DATA.ctr_batch if ctr else R_DATA.seqrec_batch
        return gen(cfg, shape.batch, seed=seed)
    rng = np.random.RandomState(seed)
    if shape.kind in ("online-inference", "offline-scoring"):
        if ctr:
            b = R_DATA.ctr_batch(cfg, shape.batch, seed=seed)
            b.pop("label")
            return b
        items = R_DATA.seqrec_batch(cfg, shape.batch, seed=seed)["items"]
        return {"items": items,
                "target": rng.randint(0, cfg.n_items, shape.batch)}
    n_c = shape.n_candidates
    if not ctr:
        items = R_DATA.seqrec_batch(cfg, 1, seed=seed)["items"]
        return {"items": items, "cand_ids": np.arange(n_c) % cfg.n_items}
    b = R_DATA.ctr_batch(cfg, 1, seed=seed)
    x = {"sparse_ids": b["sparse_ids"],
         "cand_ids": rng.randint(0, cfg.vocab_sizes[0], n_c)}
    if cfg.n_dense:
        x["dense"] = b["dense"]
    return x


def _recsys_specs(cfg, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The meta batch of a recsys cell: the reference's
    ``ShapeDtypeStruct``s (ids int32)."""
    fam, i32 = cfg.family, torch.int32
    ctr = fam in ("attn-ctr", "dlrm")
    if shape.kind in ("training", "online-inference", "offline-scoring"):
        B = shape.batch
        if ctr:
            b = {"sparse_ids": _meta((B, cfg.n_sparse), i32)}
            if shape.kind == "training":
                b["label"] = _meta((B,))
            if fam == "dlrm":
                b["dense"] = _meta((B, cfg.n_dense))
            return b
        S = cfg.seq_len
        if shape.kind != "training":
            return {"items": _meta((B, S), i32), "target": _meta((B,), i32)}
        if cfg.causal:
            return {"items": _meta((B, S), i32), "pos": _meta((B, S), i32),
                    "neg": _meta((B, S), i32), "mask": _meta((B, S))}
        return {"items": _meta((B, S), i32), "labels": _meta((B, S), i32),
                "negatives": _meta((128,), i32)}
    C = shape.n_candidates
    if ctr:
        b = {"sparse_ids": _meta((1, cfg.n_sparse), i32),
             "cand_ids": _meta((C,), i32)}
        if fam == "dlrm":
            b["dense"] = _meta((1, cfg.n_dense))
        return b
    return {"items": _meta((1, cfg.seq_len), i32), "cand_ids": _meta((C,), i32)}


def recsys_inputs(cfg, shape: ShapeConfig, seed: int, device
                  ) -> Dict[str, torch.Tensor]:
    """:func:`recsys_batch` on ``device``, each array in its meta
    spec's dtype."""
    spec = _recsys_specs(cfg, shape)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, spec[k].dtype) for k, v in recsys_batch(cfg, shape,
                                                       seed).items()}


def recsys_serve_fn(cfg, shape: ShapeConfig) -> Callable:
    """``serve_step(params, batch, *, attention)`` of a serving shape, as
    the reference's recsys cells compose it."""
    fam = cfg.family
    ctr = fam in ("attn-ctr", "dlrm")
    if shape.kind in ("online-inference", "offline-scoring"):
        if ctr:
            @torch.no_grad()
            def serve_step(params, batch, *, attention=flash_attention):
                return torch.sigmoid(ctr_logit(cfg, params, batch))
        else:
            @torch.no_grad()
            def serve_step(params, batch, *, attention=flash_attention):
                return R.seqrec_pair_scores(params, cfg, batch["items"],
                                            batch["target"],
                                            attention=attention)
        return serve_step
    if ctr:
        @torch.no_grad()
        def serve_step(params, batch, *, attention=flash_attention):
            out = []
            for c0 in range(0, batch["cand_ids"].shape[0], CTR_CAND_CHUNK):
                cand = batch["cand_ids"][c0:c0 + CTR_CAND_CHUNK]
                ids = batch["sparse_ids"].expand(cand.shape[0], -1).clone()
                ids[:, 0] = cand                    # vary the item field
                b = {"sparse_ids": ids}
                if fam == "dlrm":
                    b["dense"] = batch["dense"].expand(cand.shape[0], -1)
                out.append(torch.sigmoid(ctr_logit(cfg, params, b)))
            return torch.cat(out)
        return serve_step

    @torch.no_grad()
    def serve_step(params, batch, *, attention=flash_attention):
        h = R.seqrec_encode(params, cfg, batch["items"],
                            attention=attention)[:, -1]
        return R.seqrec_score_items(params, h, batch["cand_ids"])[0]
    return serve_step


def _recsys_cell(cfg, shape: ShapeConfig) -> Cell:
    opt = adam(1e-3)
    params_s = _meta_tree(R.param_shapes(cfg))
    batch_s = _recsys_specs(cfg, shape)
    seq = cfg.family == "seq-rec"
    count_kwargs = ({"attention": R.whole_sequence_attention} if seq
                    else {})

    if shape.kind == "training":
        opt_s = opt.init(params_s)

        def train_step(params, opt_state, batch, *,
                       attention=flash_attention):
            loss, grads = value_and_grad(recsys_loss_fn(cfg, attention),
                                         params, batch)
            with torch.no_grad():
                grads, _ = clip_by_global_norm(grads, 1.0)
                updates, opt_state = opt.update(grads, opt_state, params)
                return (apply_updates(params, updates), opt_state,
                        {"loss": loss})

        def make(device, seed):
            params = recsys_init(cfg, _gen(device, seed), device)
            return (params, opt.init(params),
                    recsys_inputs(cfg, shape, seed, device))

        return Cell(arch_id=cfg.name, shape_name=shape.name, kind=shape.kind,
                    step_name="train_step", fn=train_step,
                    args=(params_s, opt_s, batch_s), donate=(0, 1),
                    meta={"batch": shape.batch}, count_kwargs=count_kwargs,
                    materialize=make)

    def make(device, seed):
        return (recsys_init(cfg, _gen(device, seed), device),
                recsys_inputs(cfg, shape, seed, device))

    meta = ({"n_candidates": shape.n_candidates}
            if shape.kind == "retrieval-scoring" else {"batch": shape.batch})
    return Cell(arch_id=cfg.name, shape_name=shape.name, kind=shape.kind,
                step_name="serve_step", fn=recsys_serve_fn(cfg, shape),
                args=(params_s, batch_s), meta=meta,
                count_kwargs=count_kwargs, materialize=make)


# ===========================================================================
# SEINE system cells (the paper's own workload at production scale)
# ===========================================================================

SEINE_V, SEINE_DE, SEINE_NB, SEINE_LP, SEINE_U = 40960, 128, 20, 1024, 512
SEINE_BUILD_DOCS = 1024
SEINE_NNZ, SEINE_DOCS, SEINE_Q, SEINE_CAND = (200_000_000, 2_000_000, 8,
                                              16384)


def _ip_meta(de: int) -> Dict[str, Any]:
    from ..core.interactions import init_interaction_params
    return TR.tree_map(lambda t: torch.empty_like(t, device=META),
                       init_interaction_params(None, de))


def build_docs(n_docs: int, seed: int, *, vocab: int = SEINE_V,
               lp: int = SEINE_LP, n_b: int = SEINE_NB, u: int = SEINE_U
               ) -> Dict[str, np.ndarray]:
    """A build batch from ``seed``: Zipfian tokens (the last tenth of each
    doc's slots padding, -1), segment ids in order over ``n_b`` equal
    segments of the live tokens, and each doc's first ``u`` distinct
    terms (-1 padded)."""
    rng = np.random.RandomState(seed)
    toks = np.minimum(rng.zipf(1.2, (n_docs, lp)) - 1, vocab - 1)
    live = lp - lp // 10
    toks[:, live:] = -1
    segs = np.repeat(np.minimum(np.arange(live) * n_b // live, n_b - 1)[None],
                     n_docs, 0)
    segs = np.concatenate([segs, np.zeros((n_docs, lp - live), np.int64)], 1)
    uniq = np.full((n_docs, u), -1, np.int64)
    for i in range(n_docs):
        terms = np.unique(toks[i, :live])[:u]
        uniq[i, :terms.shape[0]] = terms
    return {"tokens": toks.astype(np.int32), "segs": segs.astype(np.int32),
            "uniq": uniq.astype(np.int32)}


def seine_build_step(table, idf, ip, tokens, segs, uniq):
    """Interaction rows (B, U, n_b, n_f) of a batch of docs: the
    HashProvider's contextual mix (each doc's 64 segment means, through
    the ``embed_bag`` kernel's segment entry) and ``doc_interactions``
    (``seg_interact``)."""
    from ..core.interactions import FUNCTION_NAMES, doc_interactions
    from ..core.providers import HashProvider
    with torch.no_grad():
        prov = HashProvider(table.shape[0], table.shape[1], table=table,
                            device=table.device)
        ctx = prov.contextualize(tokens, segs)
        return doc_interactions(tokens, segs, uniq, table=table, idf=idf,
                                ctx_emb=ctx, ip=ip, n_b=SEINE_NB,
                                functions=FUNCTION_NAMES)


def seine_retrieve_step(index, kparams, query, cands):
    """KNRM's scores of ``cands`` for ``query`` over ``index``: M through
    ``qd_matrix`` (the ``csr_lookup`` kernel for CUDA tensors), the
    pooling through ``knrm_pool``."""
    from ..retrievers import get_retriever
    from ..serving.engine import make_qmeta
    with torch.no_grad():
        m = index.qd_matrix(query, cands)
        meta = make_qmeta(index, query, cands)
        return get_retriever("knrm").score(kparams, m, meta, index.functions)


def _seine_cells() -> List[Cell]:
    from ..core.index import SegmentInvertedIndex
    from ..core.interactions import FUNCTION_NAMES, init_interaction_params
    from ..kernels.knrm_pool import MUS
    V, De, n_b, Lp, U = SEINE_V, SEINE_DE, SEINE_NB, SEINE_LP, SEINE_U
    B_docs = SEINE_BUILD_DOCS

    def make_build(device, seed):
        gen = _gen(device, seed)
        table = torch.randn((V, De), generator=gen, device=device) / De ** 0.5
        idf = torch.rand((V,), generator=gen, device=device) * 10.0
        ip = TR.tree_map(lambda t: t.to(device), init_interaction_params(
            torch.Generator().manual_seed(seed), De))
        docs = _on(build_docs(B_docs, seed, vocab=V, lp=Lp, n_b=n_b, u=U),
                   device)
        return table, idf, ip, docs["tokens"], docs["segs"], docs["uniq"]

    build = Cell(arch_id="seine", shape_name="index_build", kind="indexing",
                 step_name="build_step", fn=seine_build_step,
                 args=(_meta((V, De)), _meta((V,)), _ip_meta(De),
                       _meta((B_docs, Lp), torch.int32),
                       _meta((B_docs, Lp), torch.int32),
                       _meta((B_docs, U), torch.int32)),
                 meta={"docs_per_step": B_docs, "vocab": V, "n_b": n_b},
                 materialize=make_build)

    nnz, n_docs, Q, B_cand = SEINE_NNZ, SEINE_DOCS, SEINE_Q, SEINE_CAND
    n_f = len(FUNCTION_NAMES)
    idx_s = SegmentInvertedIndex(
        term_offsets=_meta((V + 1,), torch.int32),
        doc_ids=_meta((nnz,), torch.int32),
        values=_meta((nnz, n_b, n_f)), idf=_meta((V,)),
        doc_len=_meta((n_docs,)), seg_len=_meta((n_docs, n_b)),
        n_docs=n_docs, vocab_size=V, n_b=n_b, functions=FUNCTION_NAMES)
    kparams_s = {"w": _meta((len(MUS), 1)), "b": _meta((1,))}

    def make_retrieve(device, seed):
        raise MemoryError(f"seine/retrieve's index holds {nnz:,} postings "
                          f"of ({n_b}, {n_f}) float32 values; it is "
                          f"counted on the meta device only")

    retrieve = Cell(
        arch_id="seine", shape_name="retrieve", kind="retrieval-scoring",
        step_name="serve_step", fn=seine_retrieve_step,
        args=(idx_s, kparams_s, _meta((Q,), torch.int32),
              _meta((B_cand,), torch.int32)),
        meta={"nnz": nnz, "candidates": B_cand}, materialize=make_retrieve)
    return [build, retrieve]


# ===========================================================================
# dispatch
# ===========================================================================

def build_cell(arch_id: str, shape_name: str,
               strategy: str = "tp2d") -> Cell:
    _check_strategy(strategy)
    if arch_id == "seine":
        for c in _seine_cells():
            if c.shape_name == shape_name:
                return c
        raise KeyError(shape_name)
    b = get_bundle(arch_id)
    shape = b.shape(shape_name)
    if b.domain == "lm":
        if shape.kind == "training":
            return _lm_train_cell(b.config, shape, strategy=strategy)
        if shape.kind == "inference-prefill":
            return _lm_prefill_cell(b.config, shape)
        return _lm_decode_cell(b.config, shape)
    if b.domain == "gnn":
        return _mace_cell(b.config, shape)
    if b.domain == "recsys":
        return _recsys_cell(b.config, shape)
    raise ValueError(b.domain)


def all_cell_ids(include_seine: bool = True) -> List[Tuple[str, str]]:
    from ..configs import all_cells
    cells = list(all_cells())
    if include_seine:
        cells += [("seine", "index_build"), ("seine", "retrieve")]
    return cells

