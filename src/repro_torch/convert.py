"""Carry weights and indexes from the JAX package (or anywhere numpy
arrays come from) into the port.

``jax.random`` streams cannot be reproduced with a ``torch.Generator``,
so a parity test feeds the reference's own parameters through
:func:`params_from_jax` (a retriever's), :func:`interaction_params_from_jax`
(the atomic functions' ``a``, ``b`` and MLP),
:func:`provider_from_numpy` (an embedding table) and
:func:`lm_params_from_numpy` / :func:`lm_provider_from_numpy` (an LM's
parameter tree, dense or MoE, and ``LMProvider``'s projection),
:func:`snrm_params_from_numpy` (the SNRM baseline's encoder),
:func:`recsys_params_from_numpy` (AutoInt, DLRM, SASRec, BERT4Rec) and
:func:`mace_params_from_numpy` (MACE);
:func:`index_to_device` turns any object with
the index's array fields (a ``repro`` index, a port index on another
device) into the port's index on ``device``.  Nothing here imports jax:
``np.asarray`` reads a jax array through the array protocol.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.codec import fences_from_packed, validate_codec
from .core.index import SegmentInvertedIndex, build_fences
from .core.interactions import params_to
from .core.providers import HashProvider, LearnedProvider, LMProvider
from .dist.partition import PartitionedIndex
from .kernels.utils import resolve_device
from .models import mace as MA
from .models import recsys as R
from .models import transformer as T
from .models.layers import ParamTree
from .retrievers import get_retriever

INDEX_ARRAYS = ("term_offsets", "doc_ids", "values", "idf", "doc_len",
                "seg_len")
PARTITION_ARRAYS = ("term_to_shard", "range_lo")
OPTIONAL_ARRAYS = ("range_hi", "split_term", "split_doc")
CODEC_ARRAYS = ("packed_words", "tile_bits", "tile_base", "tile_word_off",
                "values_q", "value_scale")


def _host(a) -> np.ndarray:
    """A writable host copy (jax hands out read-only views)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.array(a)


def index_from_arrays(arrays: Dict[str, np.ndarray], *, n_docs: int,
                      vocab_size: int, n_b: int, functions, device=None,
                      codec: str = "none", codec_tile: int = 0,
                      max_tile_words: int = 0, codec_spans=(0, 0)):
    """The port's index from host arrays: a :class:`PartitionedIndex`
    when ``arrays`` holds the routing table, else a
    :class:`SegmentInvertedIndex`.  Fences are rebuilt as the reference's
    loader does: from the doc ids, or under a packed codec from the
    packed tile metadata at ``codec_tile``."""
    dev = resolve_device(device)
    codec = validate_codec(codec)
    t = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for n, a in arrays.items() if a is not None}
    static = dict(n_docs=int(n_docs), vocab_size=int(vocab_size),
                  n_b=int(n_b), functions=tuple(functions))
    if "term_to_shard" not in t:
        if codec != "none":
            raise ValueError(f"codec {codec!r} needs a partitioned index")
        return SegmentInvertedIndex(fences=build_fences(t["doc_ids"]),
                                    **static,
                                    **{n: t[n] for n in INDEX_ARRAYS})
    if codec == "none":
        fences = build_fences(t["doc_ids"])
        codec_kw = {}
    else:
        nmax = t["values" if codec == "packed" else "values_q"].shape[1]
        fences = torch.from_numpy(fences_from_packed(
            *(np.asarray(arrays[n]) for n in ("tile_bits", "tile_base",
                                              "tile_word_off",
                                              "packed_words")),
            tile=int(codec_tile), n=int(nmax))).to(dev)
        codec_kw = dict(codec=codec, codec_tile=int(codec_tile),
                        max_tile_words=int(max_tile_words),
                        codec_spans=tuple(int(s) for s in codec_spans),
                        **{n: t.get(n) for n in CODEC_ARRAYS})
    return PartitionedIndex(
        fences=fences, n_shards=int(t["term_offsets"].shape[0]), **static,
        **{n: t.get(n) for n in INDEX_ARRAYS + PARTITION_ARRAYS
           + OPTIONAL_ARRAYS}, **codec_kw)


def index_to_device(index: Any, device=None):
    """Move a single-CSR or partitioned index, raw or packed — the JAX
    package's or the port's — onto ``device`` as the port's index."""
    if getattr(index, "is_live", False):
        raise TypeError(
            "a live index does not cross between the packages: move its "
            "base with index_to_device(live.base) and wrap that in the "
            "port's repro_torch.dist.live.LiveIndex")
    names = INDEX_ARRAYS + (PARTITION_ARRAYS + OPTIONAL_ARRAYS + CODEC_ARRAYS
                            if hasattr(index, "term_to_shard") else ())
    arrays = {n: _host(getattr(index, n)) for n in names
              if getattr(index, n, None) is not None}
    return index_from_arrays(
        arrays, n_docs=index.n_docs, vocab_size=index.vocab_size,
        n_b=index.n_b, functions=index.functions, device=device,
        codec=getattr(index, "codec", "none"),
        codec_tile=getattr(index, "codec_tile", 0),
        max_tile_words=getattr(index, "max_tile_words", 0),
        codec_spans=getattr(index, "codec_spans", (0, 0)))


def params_from_jax(retriever: str, tree: Any, device=None) -> ParamTree:
    """Map a retriever's JAX parameter tree (nested dicts and lists of
    arrays) onto the port's parameters, checking every name and shape
    against the port's own ``init``."""
    spec = get_retriever(retriever)

    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [to_torch(v) for v in x]
        return torch.from_numpy(np.array(_host(x), np.float32))

    params = ParamTree(to_torch(tree))
    want = {n: tuple(p.shape) for n, p in spec.init(
        torch.Generator().manual_seed(0), 1, (), device="cpu"
    ).state_dict().items()}
    got = {n: tuple(p.shape) for n, p in params.state_dict().items()}
    if want != got:
        raise ValueError(f"{retriever} parameters do not match the port's "
                         f"layout: expected {want}, got {got}")
    return params.to(resolve_device(device))


def interaction_params_from_jax(ip: Any, device=None) -> Dict[str, Any]:
    """The interaction parameters of ``repro.core.interactions.
    init_interaction_params`` (``a`` (De,), ``b`` (), ``mlp.{w, b}``
    lists), read as numpy, as the port's float32 tensors on ``device``."""
    host = {"a": _host(ip["a"]), "b": _host(ip["b"]),
            "mlp": {"w": [_host(w) for w in ip["mlp"]["w"]],
                    "b": [_host(b) for b in ip["mlp"]["b"]]}}
    return params_to(host, resolve_device(device))


def provider_from_numpy(table, *, kind: str = "hash", alpha: float = 0.25,
                        device=None):
    """A provider over a given (|v|, De) embedding table (e.g. the JAX
    provider's ``table()``): ``kind`` "hash" (fixed) or "learned"."""
    t = torch.from_numpy(np.array(_host(table), np.float32))
    dev = resolve_device(device)
    if kind == "hash":
        return HashProvider(t.shape[0], t.shape[1], alpha=alpha, table=t,
                            device=dev)
    if kind == "learned":
        return LearnedProvider(t.to(dev), alpha=alpha)
    raise ValueError(f"unknown provider kind {kind!r}")


def _f32(a) -> np.ndarray:
    """A float32 host copy.  ``np.asarray`` of a JAX bf16 array is an
    ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses;
    bf16 -> float32 -> bf16 is exact, so the value survives the trip."""
    return np.array(_host(a), np.float32)


def lm_params_from_numpy(tree: Any, cfg, device=None) -> Dict[str, Any]:
    """An LM parameter tree (the reference's ``T.init_params`` pytree:
    ``embed``, ``layers.{ln1, ln2, wq, wk, wv, wo}`` and the dense
    ``w_gate, w_up, w_down`` or the MoE ``router, we_*`` and shared
    ``ws_*`` stacked over L, ``final_norm``, ``unembed``; JAX or numpy
    arrays) as the port's tree on ``device``, each leaf in its dtype
    (``T.param_dtype``: the config's, the router float32).  Every name
    and shape is checked against the port's own ``T.param_specs``."""
    flat = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            flat.update({f"{name}.{k}": v for k, v in value.items()})
        else:
            flat[name] = value
    want = {n: tuple(shape) for n, (shape, _) in T.param_specs(cfg).items()}
    got = {n: tuple(np.shape(v)) for n, v in flat.items()}
    if want != got:
        raise ValueError(f"{cfg.name} parameters do not match the port's "
                         f"layout: expected {want}, got {got}")
    dev = resolve_device(device)
    params: Dict[str, Any] = {"layers": {}}
    for name, value in flat.items():
        t = torch.from_numpy(_f32(value)).to(dev, T.param_dtype(cfg, name))
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


def lm_provider_from_numpy(cfg, params: Any, proj=None,
                           device=None) -> LMProvider:
    """An ``LMProvider`` over a reference LM tree and the reference
    provider's projection ``_proj`` (``(d_model, embed_dim)``, or None
    when the hidden states are used unprojected)."""
    dev = resolve_device(device)
    tp = lm_params_from_numpy(params, cfg, dev)
    if proj is None:
        return LMProvider(cfg, tp, cfg.d_model, device=dev)
    p = torch.from_numpy(_f32(proj))
    return LMProvider(cfg, tp, p.shape[1], proj=p, device=dev)


SNRM_NAMES = ("emb", "w1", "w2")


def snrm_params_from_numpy(tree: Any, device=None) -> Dict[str, Any]:
    """The reference's ``init_snrm`` pytree (``emb`` (|v|, d_emb), ``w1``
    (d_emb, d_hidden), ``w2`` (d_hidden, d_latent); JAX or numpy arrays)
    as the port's float32 tree on ``device``."""
    if set(tree) != set(SNRM_NAMES):
        raise ValueError(f"SNRM parameters are {SNRM_NAMES}, got "
                         f"{sorted(tree)}")
    dims = [np.shape(tree[n]) for n in SNRM_NAMES]
    if any(len(s) != 2 for s in dims) or dims[0][1] != dims[1][0] \
            or dims[1][1] != dims[2][0]:
        raise ValueError(f"SNRM shapes do not chain: {dims}")
    dev = resolve_device(device)
    return {n: torch.from_numpy(_f32(tree[n])).to(dev) for n in SNRM_NAMES}



def _walk(tree: Any, path=()):
    """``(name, leaf)`` of nested dicts (keys sorted) and lists; anything
    else, a shape tuple included, is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _walk(x, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, fn) for v in tree]
    return fn(tree)


def _tree_from_numpy(tree: Any, shapes: Any, device, what: str) -> Any:
    """``tree`` (nested dicts and lists of JAX or numpy arrays) as float32
    tensors on ``device``, checked leaf by leaf against ``shapes`` (the
    port's nesting with a shape tuple per leaf)."""
    got = {n: tuple(np.shape(v)) for n, v in _walk(tree)}
    want = dict(_walk(shapes))
    if got != want:
        raise ValueError(f"{what} parameters do not match the port's "
                         f"layout: expected {want}, got {got}")
    dev = resolve_device(device)
    return _rebuild(tree, lambda v: torch.from_numpy(_f32(v)).to(dev))


def recsys_params_from_numpy(tree: Any, cfg, device=None) -> Dict[str, Any]:
    """A recsys parameter tree (the reference's ``autoint_init``,
    ``dlrm_init`` or ``seqrec_init`` pytree; JAX or numpy arrays) as the
    port's float32 tree on ``device``, every name and shape checked
    against ``models.recsys.param_shapes(cfg)``."""
    return _tree_from_numpy(tree, R.param_shapes(cfg), device, cfg.name)


def mace_params_from_numpy(tree: Any, cfg, device=None) -> Dict[str, Any]:
    """The reference's MACE ``init_params`` pytree as the port's float32
    tree on ``device``, checked against ``models.mace.param_shapes``."""
    return _tree_from_numpy(tree, MA.param_shapes(cfg), device, cfg.name)
