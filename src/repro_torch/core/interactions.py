"""The nine atomic interaction functions (§2.3) as one batched device pass
(port of ``repro.core.interactions``).

``doc_interactions`` computes, for a batch of documents (each doc's
terms U x its n_b segments), every enabled atomic function value.  The
same code serves the index builder (offline, U = a doc's unique terms)
and the No-Index on-the-fly scorer (query time, U = the query's terms),
which is what makes `indexed == on-the-fly` hold for stored pairs.

``dot``, ``cosine`` and ``gauss_max`` come from one ``seg_interact`` call
per batch: the CUDA kernel for CUDA tensors, its plain version on the
CPU.  ``log_cond_prob``'s segment sums of the contextual embeddings go
through the ``embed_bag`` kernel the same way.  The other segment
reductions are GEMMs against a one-hot segment matrix, as in the
reference.  Pad token = -1; pad segment = n_b (a trash bin, sliced
off).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..kernels.embed_bag import segment_bag_sums
from ..kernels.seg_interact import seg_interact_kernel
from ..models.layers import mlp_init

FUNCTION_NAMES: Tuple[str, ...] = (
    "tf", "idf_indicator", "dot", "cosine", "gauss_max",
    "linear_agg", "max_op", "mlp_emb", "log_cond_prob",
)
_KERNEL_FUNCTIONS = ("dot", "cosine", "gauss_max")


def init_interaction_params(generator: Optional[torch.Generator],
                            embed_dim: int, device=None) -> Dict[str, Any]:
    """Learned pieces of atomic functions 6 and 8 (DeepCT-style ``a``,
    ``b`` and the MLP), drawn on the CPU from ``generator``.  Same layout
    as the reference's: ``{"a": (De,), "b": (), "mlp": {"w": [...],
    "b": [...]}}``."""
    gen = generator or torch.Generator().manual_seed(17)
    ip = {
        "a": torch.randn(embed_dim, generator=gen) / math.sqrt(embed_dim),
        "b": torch.zeros(()),
        "mlp": mlp_init(gen, (embed_dim, 32, 1)),
    }
    return params_to(ip, device if device is not None else "cpu")


def params_to(ip: Dict[str, Any], device) -> Dict[str, Any]:
    """The interaction parameters as float32 tensors on ``device``."""
    to = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)
    return {"a": to(ip["a"]), "b": to(ip["b"]),
            "mlp": {"w": [to(w) for w in ip["mlp"]["w"]],
                    "b": [to(b) for b in ip["mlp"]["b"]]}}


def _gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ids clamped to [0, |v| - 1]: the reference's
    ``table.at[ids.clip(0)].get(mode="clip")``, under which a term past
    the vocabulary reads the last row."""
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def _segment_max(x: torch.Tensor, seg: torch.Tensor, nseg: int
                 ) -> torch.Tensor:
    """x (B, U, L), seg (B, L) in [0, nseg) -> max over each segment's
    tokens (B, U, nseg); -inf where a segment has none."""
    idx = seg[:, None, :].expand(x.shape)
    return x.new_full(x.shape[:2] + (nseg,), float("-inf")).scatter_reduce_(
        2, idx, x, "amax", include_self=False)


def seg_interact_inputs(doc_tokens: torch.Tensor, seg_ids: torch.Tensor,
                        uniq_terms: torch.Tensor, table: torch.Tensor,
                        n_b: int) -> Tuple[torch.Tensor, ...]:
    """The ``seg_interact`` kernel's inputs for a batch of docs:
    ``(e_term (B, U, De), e_tok (B, Lp, De), seg (B, Lp) int32,
    term_ids (B, U) int32)``, contiguous.  Pad terms and pad tokens get
    zero rows; a token outside ``[0, n_b)`` (pad, or a segment id out of
    range, which the reference's segment reductions drop) gets segment
    -1, which the kernel excludes."""
    tok_valid = doc_tokens >= 0
    term_valid = uniq_terms >= 0
    seg_ids = seg_ids.long()
    keep = tok_valid & (seg_ids >= 0) & (seg_ids < n_b)
    e_tok = _gather_rows(table, doc_tokens) * tok_valid[..., None]
    e_term = _gather_rows(table, uniq_terms) * term_valid[..., None]
    return (e_term.contiguous(), e_tok.contiguous(),
            torch.where(keep, seg_ids, -1).to(torch.int32).contiguous(),
            uniq_terms.to(torch.int32).contiguous())


def doc_interactions(doc_tokens: torch.Tensor, seg_ids: torch.Tensor,
                     uniq_terms: torch.Tensor, *, table: torch.Tensor,
                     idf: torch.Tensor, ctx_emb: torch.Tensor,
                     ip: Dict[str, Any], n_b: int,
                     functions: Sequence[str] = FUNCTION_NAMES
                     ) -> torch.Tensor:
    """Atomic interaction values for a batch of documents.

    doc_tokens: (B, Lp) vocab slots, -1 pad.  seg_ids: (B, Lp) in
    [0, n_b).  uniq_terms: (B, U) vocab slots to evaluate (-1 pad).
    table: (|v|, De) static embeddings.  ctx_emb: (B, Lp, De) contextual
    embeddings (``provider.contextualize``).  Returns (B, U, n_b, n_f).
    One document's 1-D inputs give (U, n_b, n_f), as in the reference.
    """
    if doc_tokens.ndim == 1:
        return doc_interactions(
            doc_tokens[None], seg_ids[None], uniq_terms[None], table=table,
            idf=idf, ctx_emb=ctx_emb[None], ip=ip, n_b=n_b,
            functions=functions)[0]
    n_docs, n_l = doc_tokens.shape
    tok_valid = doc_tokens >= 0
    term_valid = uniq_terms >= 0
    e_term, e_tok, kernel_seg, kernel_terms = seg_interact_inputs(
        doc_tokens, seg_ids, uniq_terms, table, n_b)
    seg = torch.where(kernel_seg >= 0, kernel_seg.long(), n_b)  # trash = n_b
    nseg = n_b + 1
    # exact-match matrix (B, U, Lp)
    matchf = ((uniq_terms[:, :, None] == doc_tokens[:, None, :])
              & tok_valid[:, None, :] & term_valid[:, :, None]).float()
    # one_hot(seg, nseg), without one_hot's range check (a host read)
    onehot = (seg[..., None] == torch.arange(nseg, device=seg.device)
              ).float()                                  # (B, Lp, nseg)
    # integer-valued sums of 0/1: exact in any order
    counts = matchf @ onehot                             # (B, U, nseg)
    tf = counts[..., :n_b]

    kernel_vals = None
    if any(f in functions for f in _KERNEL_FUNCTIONS):
        kernel_vals = seg_interact_kernel(
            e_term, e_tok, kernel_seg, kernel_terms, n_b)  # (B, U, n_b, 3)

    out = []
    for fn in functions:
        if fn == "tf":
            out.append(tf)
        elif fn == "idf_indicator":
            v = _gather_rows(idf, uniq_terms) * term_valid
            out.append(v[..., None] * (tf > 0))
        elif fn in _KERNEL_FUNCTIONS:
            out.append(kernel_vals[..., _KERNEL_FUNCTIONS.index(fn)])
        elif fn == "linear_agg":
            # a . mean_ctx + b, factored: a . ctx per token first, so no
            # (U, Lp, De) tensor exists
            w = ctx_emb @ ip["a"]                                # (B, Lp)
            num = matchf @ (onehot * w[..., None])               # (B, U, nseg)
            out.append((num / torch.clamp(counts, min=1.0)
                        + ip["b"])[..., :n_b])
        elif fn == "max_op":
            # max_t in S of <log(softplus(ctx(t))), e_w>; softplus as
            # logaddexp(x, 0), the reference's (torch's softplus switches
            # to x above 20)
            f_ctx = torch.log(torch.logaddexp(
                ctx_emb, torch.zeros((), dtype=ctx_emb.dtype,
                                     device=ctx_emb.device)) + 1e-9)
            s = e_term @ f_ctx.transpose(1, 2)                   # (B, U, Lp)
            s = torch.where(tok_valid[:, None, :], s,
                            torch.full((), float("-inf"), device=s.device))
            v = _segment_max(s, seg, nseg)[..., :n_b]
            out.append(torch.where(torch.isfinite(v), v,
                                   torch.zeros((), device=v.device)))
        elif fn == "mlp_emb":
            # MLP(mean_ctx): the first layer is linear in ctx, so tokens
            # are projected first (Lp, K), segment-reduced in one GEMM,
            # then the nonlinear tail
            w1, b1 = ip["mlp"]["w"][0], ip["mlp"]["b"][0]
            ctx_proj = ctx_emb @ w1                              # (B, Lp, K)
            k = ctx_proj.shape[-1]
            # (B, Lp, nseg, K)
            basis = onehot[..., None] * ctx_proj[:, :, None, :]
            num = (matchf @ basis.reshape(n_docs, n_l, nseg * k)).reshape(
                n_docs, -1, nseg, k)[:, :, :n_b]
            den = counts[..., :n_b, None]
            h1 = torch.relu(num / torch.clamp(den, min=1.0) + b1)
            out.append((h1 @ ip["mlp"]["w"][1] + ip["mlp"]["b"][1])[..., 0])
        elif fn == "log_cond_prob":
            # segment LM head: log P(w | S) = log softmax(ctx_mean(S) @
            # table.T)[w]
            # each segment's contextual rows summed by the embed_bag
            # kernel (its plain version on the CPU): the table is the
            # batch's ctx rows, an index a flat token position
            ones = tok_valid.float()
            pos = torch.arange(n_docs * n_l, device=ctx_emb.device)
            live = tok_valid & (seg < n_b)
            seg_sum = segment_bag_sums(
                ctx_emb.reshape(n_docs * n_l, -1),
                torch.where(live, pos.reshape(n_docs, n_l), -1),
                seg.clamp(max=n_b - 1), n_b)               # (B, n_b, De)
            cnt = (onehot * ones[..., None]).sum(1)[:, :n_b]     # (B, n_b)
            ctx_mean = seg_sum / torch.clamp(cnt, min=1.0)[..., None]
            logits = ctx_mean @ table.T                     # (B, n_b, |v|)
            logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
            at = uniq_terms.long().clamp(0, table.shape[0] - 1)
            gathered = torch.gather(
                logp, 2, at[:, None, :].expand(n_docs, n_b, at.shape[1]))
            out.append(gathered.transpose(1, 2) * term_valid[..., None])
        else:
            raise ValueError(f"unknown atomic function {fn!r}")

    vals = torch.stack(out, dim=-1)                      # (B, U, n_b, n_f)
    return vals * term_valid[..., None, None]


def query_doc_interactions(query_terms: torch.Tensor,
                           doc_tokens: torch.Tensor, seg_ids: torch.Tensor,
                           *, table: torch.Tensor, idf: torch.Tensor,
                           ctx_emb: torch.Tensor, ip: Dict[str, Any],
                           n_b: int,
                           functions: Sequence[str] = FUNCTION_NAMES
                           ) -> torch.Tensor:
    """No-Index on-the-fly path: the q-d interaction matrix (B, Q, n_b,
    n_f) of query_terms (Q,) or (B, Q) against each doc of the batch.
    The build path with the query's terms in place of a doc's unique
    terms."""
    if doc_tokens.ndim == 2 and query_terms.ndim == 1:
        query_terms = query_terms[None].expand(doc_tokens.shape[0], -1)
    return doc_interactions(doc_tokens, seg_ids, query_terms, table=table,
                            idf=idf, ctx_emb=ctx_emb, ip=ip, n_b=n_b,
                            functions=functions)
