"""Recsys architectures: AutoInt, DLRM (MLPerf), SASRec, BERT4Rec (port of
``repro.models.recsys``).

Parameters are plain trees (dicts and lists of tensors) named as the
reference's pytrees, so ``repro_torch.tree`` walks them in its order and
``convert.recsys_params_from_numpy`` carries its parameters across.
Embedding tables use the packed ``MultiTable`` layout; every
``.at[...].get(mode="clip")`` of the reference is ``gather_clip``.

The sequential recommenders share a small pre-norm transformer encoder.
Its attention goes through the ``flash_attn`` kernels (forward and, under
autograd, backward) when the head dim is one the kernels take
(BERT4Rec: 2 heads of 32), else through the plain ``gqa_attention`` with
one chunk of the whole sequence, as the reference computes it (SASRec:
one head of 50).  The route depends on the config alone.  AutoInt's
field attention is an einsum and a softmax inside the model, in plain
torch, its softmax rounded as ``jax.nn.softmax``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from .. import tree as T
from ..configs.base import RecsysConfig
from ..core.index import gather_clip
from ..kernels.flash_attn import HEAD_DIMS, flash_attention
from ..kernels.utils import resolve_device
from .embedding_bag import MultiTable
from .layers import (dense_init, embed_init, gqa_attention, layer_norm,
                     mlp_apply, mlp_init, softmax)

Params = Dict[str, Any]
Attention = Callable[..., torch.Tensor]
ATTN_NAMES = ("wq", "wk", "wv", "w_res")


def _on(tree: Params, device) -> Params:
    return T.tree_map(lambda t: t.to(device), tree)


def _mlp_shapes(dims) -> Params:
    return {"w": [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)],
            "b": [(dims[i + 1],) for i in range(len(dims) - 1)]}


def _dlrm_top_in(cfg: RecsysConfig) -> int:
    n_vec = cfg.n_sparse + 1
    return n_vec * (n_vec - 1) // 2 + cfg.bot_mlp[-1]


def _item_rows(cfg: RecsysConfig) -> int:
    """Item table rows: the items, the padding id (= n_items) and the mask
    token (= n_items + 1, BERT4Rec), padded to a multiple of 512."""
    return -(-(cfg.n_items + 2) // 512) * 512


def param_shapes(cfg: RecsysConfig) -> Params:
    """The parameter tree of ``cfg``'s family with each leaf's shape in
    place of the leaf: the layout the inits draw and ``convert`` checks."""
    if cfg.family == "attn-ctr":
        d, attn = cfg.embed_dim, []
        for _ in range(cfg.n_attn_layers):
            attn.append({n: (d, cfg.n_heads * cfg.d_attn)
                         for n in ATTN_NAMES})
            d = cfg.n_heads * cfg.d_attn
        mt = MultiTable(cfg.vocab_sizes, cfg.embed_dim)
        return {"table": (mt.total_rows, cfg.embed_dim), "attn": attn,
                "w_out": (cfg.n_sparse * d, 1), "b_out": (1,)}
    if cfg.family == "dlrm":
        mt = MultiTable(cfg.vocab_sizes, cfg.embed_dim)
        return {"table": (mt.total_rows, cfg.embed_dim),
                "bot": _mlp_shapes(tuple(cfg.bot_mlp)),
                "top": _mlp_shapes((_dlrm_top_in(cfg),)
                                   + tuple(cfg.top_mlp))}
    d = cfg.embed_dim
    dense = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
             "w1": (d, 4 * d), "w2": (4 * d, d)}
    norms = {n: (d,) for n in ("ln1_s", "ln1_b", "ln2_s", "ln2_b")}
    return {"item_emb": (_item_rows(cfg), d), "pos_emb": (cfg.seq_len, d),
            "blocks": [{**norms, **dense} for _ in range(cfg.n_blocks)],
            "ln_f_s": (d,), "ln_f_b": (d,)}


# ---------------------------------------------------------------------------
# AutoInt  [arXiv:1810.11921]
# ---------------------------------------------------------------------------

def autoint_init(cfg: RecsysConfig, gen: torch.Generator,
                 device=None) -> Params:
    """Weights drawn from ``gen`` on its device, returned on ``device``
    (default CUDA)."""
    mt = MultiTable(cfg.vocab_sizes, cfg.embed_dim)
    d, width = cfg.embed_dim, cfg.n_heads * cfg.d_attn
    layers = []
    for _ in range(cfg.n_attn_layers):
        layers.append({n: dense_init(gen, d, width) for n in ATTN_NAMES})
        d = width
    return _on({
        "table": mt.init(gen, device=gen.device),
        "attn": layers,
        "w_out": dense_init(gen, cfg.n_sparse * d, 1),
        "b_out": torch.zeros(1),
    }, resolve_device(device))


def autoint_forward(p: Params, cfg: RecsysConfig, ids: torch.Tensor
                    ) -> torch.Tensor:
    """ids: (B, n_sparse) -> CTR logit (B,)."""
    mt = MultiTable(cfg.vocab_sizes, cfg.embed_dim)
    x = mt.lookup(p["table"], ids)                                # (B,F,De)
    n_b, n_f, _ = x.shape
    n_h, da = cfg.n_heads, cfg.d_attn
    for lp in p["attn"]:
        q = (x @ lp["wq"]).reshape(n_b, n_f, n_h, da)
        k = (x @ lp["wk"]).reshape(n_b, n_f, n_h, da)
        v = (x @ lp["wv"]).reshape(n_b, n_f, n_h, da)
        s = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
        a = softmax(s, -1)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(n_b, n_f, n_h * da)
        x = torch.relu(o + x @ lp["w_res"])
    return (x.reshape(n_b, -1) @ p["w_out"] + p["b_out"])[:, 0]


# ---------------------------------------------------------------------------
# DLRM  [arXiv:1906.00091] (MLPerf config)
# ---------------------------------------------------------------------------

def dlrm_init(cfg: RecsysConfig, gen: torch.Generator,
              device=None) -> Params:
    mt = MultiTable(cfg.vocab_sizes, cfg.embed_dim)
    return _on({
        "table": mt.init(gen, scale=1.0 / math.sqrt(cfg.embed_dim),
                         device=gen.device),
        "bot": mlp_init(gen, tuple(cfg.bot_mlp)),
        "top": mlp_init(gen, (_dlrm_top_in(cfg),) + tuple(cfg.top_mlp)),
    }, resolve_device(device))


def dlrm_forward(p: Params, cfg: RecsysConfig, dense: torch.Tensor,
                 sparse_ids: torch.Tensor) -> torch.Tensor:
    """dense: (B, 13); sparse_ids: (B, 26) -> CTR logit (B,)."""
    mt = MultiTable(cfg.vocab_sizes, cfg.embed_dim)
    z = mlp_apply(p["bot"], dense, act=torch.relu,
                  final_act=torch.relu)                           # (B,De)
    emb = mt.lookup(p["table"], sparse_ids)                       # (B,26,De)
    allv = torch.cat([z[:, None, :], emb], dim=1)                 # (B,27,De)
    inter = torch.einsum("bfd,bgd->bfg", allv, allv)              # (B,27,27)
    n = allv.shape[1]
    # jnp.triu_indices(n, k=1): the same row-major order
    iu, ju = torch.triu_indices(n, n, 1, device=allv.device)
    from ..dist.dtensor import rows_local
    flat = rows_local(lambda t: t[:, iu, ju], inter)              # (B, 351)
    x = torch.cat([z, flat], dim=1)
    return mlp_apply(p["top"], x, act=torch.relu)[:, 0]


# ---------------------------------------------------------------------------
# Sequential recommenders (SASRec causal / BERT4Rec bidirectional)
# ---------------------------------------------------------------------------

def seqrec_init(cfg: RecsysConfig, gen: torch.Generator,
                device=None) -> Params:
    d = cfg.embed_dim
    on = dict(device=gen.device)
    blocks = []
    for _ in range(cfg.n_blocks):
        b = {"ln1_s": torch.ones(d, **on), "ln1_b": torch.zeros(d, **on),
             "ln2_s": torch.ones(d, **on), "ln2_b": torch.zeros(d, **on)}
        b.update({n: dense_init(gen, *shape) for n, shape in (
            ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)),
            ("w1", (d, 4 * d)), ("w2", (4 * d, d)))})
        blocks.append(b)
    return _on({
        "item_emb": embed_init(gen, _item_rows(cfg), d),
        "pos_emb": embed_init(gen, cfg.seq_len, d),
        "blocks": blocks,
        "ln_f_s": torch.ones(d, **on), "ln_f_b": torch.zeros(d, **on),
    }, resolve_device(device))


def uses_flash_attn(cfg: RecsysConfig) -> bool:
    """Whether a sequence model's attention runs the ``flash_attn``
    kernels: its head dim is one they take."""
    return cfg.family == "seq-rec" \
        and cfg.embed_dim // max(cfg.n_heads, 1) in HEAD_DIMS


def whole_sequence_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """``gqa_attention`` over one chunk of the whole sequence, as the
    reference computes a sequence model's attention."""
    return gqa_attention(q, k, v, causal=causal, chunk=max(k.shape[1], 1))


def seqrec_encode(p: Params, cfg: RecsysConfig, items: torch.Tensor, *,
                  attention: Attention = flash_attention) -> torch.Tensor:
    """items: (B, S) item ids -> hidden (B, S, d).  ``attention`` (the
    ``flash_attn`` kernels by default; ``flash_attention_plain`` for the
    plain yardstick) serves a config whose head dim the kernels take;
    any other runs ``gqa_attention`` over one chunk."""
    n_b, n_s = items.shape
    d, n_h = cfg.embed_dim, max(cfg.n_heads, 1)
    hd = d // n_h
    attend = attention if uses_flash_attn(cfg) else whole_sequence_attention
    x = gather_clip(p["item_emb"], items) + p["pos_emb"][None, :n_s]
    for bp in p["blocks"]:
        h = layer_norm(x, bp["ln1_s"], bp["ln1_b"])
        q = (h @ bp["wq"]).reshape(n_b, n_s, n_h, hd)
        k = (h @ bp["wk"]).reshape(n_b, n_s, n_h, hd)
        v = (h @ bp["wv"]).reshape(n_b, n_s, n_h, hd)
        o = attend(q, k, v, causal=cfg.causal)
        x = x + o.reshape(n_b, n_s, d) @ bp["wo"]
        h = layer_norm(x, bp["ln2_s"], bp["ln2_b"])
        x = x + torch.relu(h @ bp["w1"]) @ bp["w2"]
    return layer_norm(x, p["ln_f_s"], p["ln_f_b"])


def seqrec_score_items(p: Params, hidden_last: torch.Tensor,
                       candidate_ids: torch.Tensor) -> torch.Tensor:
    """hidden_last: (B, d); candidate_ids: (C,) -> scores (B, C)."""
    cand = gather_clip(p["item_emb"], candidate_ids)              # (C,d)
    return hidden_last @ cand.T


def seqrec_pair_scores(p: Params, cfg: RecsysConfig, items: torch.Tensor,
                       target: torch.Tensor, *,
                       attention: Attention = flash_attention
                       ) -> torch.Tensor:
    """Pointwise (sequence, target item) scores: items (B,S), target (B,)."""
    h = seqrec_encode(p, cfg, items, attention=attention)[:, -1]  # (B,d)
    t = gather_clip(p["item_emb"], target)
    return torch.sum(h * t, dim=-1)


# ---------------------------------------------------------------------------
# losses (shared)
# ---------------------------------------------------------------------------

def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(logits, -30, 30)
    return torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * labels
                      + torch.log1p(torch.exp(-torch.abs(z))))


def sasrec_loss(p: Params, cfg: RecsysConfig, batch: Dict[str, torch.Tensor],
                *, attention: Attention = flash_attention) -> torch.Tensor:
    """BPR-style: next-item positives vs sampled negatives.

    batch: items (B,S), pos (B,S), neg (B,S), mask (B,S).
    """
    h = seqrec_encode(p, cfg, batch["items"], attention=attention)
    pe = gather_clip(p["item_emb"], batch["pos"])
    ne = gather_clip(p["item_emb"], batch["neg"])
    sp = torch.sum(h * pe, -1)
    sn = torch.sum(h * ne, -1)
    m = batch["mask"].float()
    loss = -torch.log(torch.sigmoid(sp - sn) + 1e-9) * m
    return loss.sum() / torch.clamp(m.sum(), min=1.0)


def bert4rec_loss(p: Params, cfg: RecsysConfig,
                  batch: Dict[str, torch.Tensor], n_negatives: int = 128, *,
                  attention: Attention = flash_attention) -> torch.Tensor:
    """Masked-item prediction with sampled softmax.

    batch: items (B,S) with mask-token at masked slots, labels (B,S) w/ -1
    ignore, negatives (n_negatives,) sampled ids.
    """
    h = seqrec_encode(p, cfg, batch["items"], attention=attention)
    labels = batch["labels"]
    valid = labels >= 0
    pos_e = gather_clip(p["item_emb"], labels.clamp(min=0))
    pos_s = torch.sum(h * pos_e, -1)                              # (B,S)
    neg_e = gather_clip(p["item_emb"], batch["negatives"])        # (n,d)
    neg_s = torch.einsum("bsd,nd->bsn", h, neg_e)
    logits = torch.cat([pos_s[..., None], neg_s], dim=-1)
    ce = torch.logsumexp(logits, -1) - pos_s
    m = valid.float()
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)
