"""HiNT [Fan et al., SIGIR'18] — hierarchical neural matching.
Port of ``repro.retrievers.hint``: a local matching layer builds
segment-level relevance signals, a global decision layer accumulates
evidence across segments (gated attention + top-k selection)."""
from __future__ import annotations

import torch

from ..models.layers import dense_init, mlp_apply, mlp_init, softmax
from .base import QMeta, RetrieverSpec, fidx, make_init, register

D_LOCAL = 32
TOP_K = 8
N_CH = 4  # tf, idf_indicator, cosine, dot

init = make_init(lambda gen, n_b: {
    "local": mlp_init(gen, (3 * N_CH, 64, D_LOCAL)),
    "gate": dense_init(gen, D_LOCAL, 1),
    "decision": mlp_init(gen, (2 * D_LOCAL, 64, 1)),
})


def score(params, M, meta: QMeta, functions) -> torch.Tensor:
    chans = [M[..., fidx(functions, c)]
             for c in ("tf", "idf_indicator", "cosine", "dot")]
    x = torch.stack(chans, dim=-1)                      # (B, Q, n_b, C)
    x = x * meta.q_mask[None, :, None, None]
    denom = torch.clamp(meta.seg_len, min=1.0)[:, None, :, None]
    xn = x / denom
    # local matching: per-segment statistics over query terms
    qsum = torch.clamp(meta.q_mask.sum(), min=1.0)
    feats = torch.cat([x.sum(1) / qsum, xn.sum(1) / qsum, x.amax(1)],
                      dim=-1)                           # (B, n_b, 3C)
    local = torch.tanh(mlp_apply(params["local"], feats, act=torch.relu))
    # global decision: gated importance + top-k evidence accumulation
    sig = (local @ params["gate"])[..., 0]              # (B, n_b)
    gate = softmax(sig + torch.where(meta.seg_len > 0, 0.0, -1e9))
    attended = torch.einsum("bn,bnd->bd", gate, local)
    # lax.top_k order: descending, ties toward the lower index
    k = min(TOP_K, sig.shape[-1])
    topi = torch.sort(sig, dim=-1, descending=True, stable=True).indices
    top_repr = torch.take_along_dim(local, topi[..., :k, None],
                                    dim=1).mean(1)
    h = torch.cat([attended, top_repr], dim=-1)
    return mlp_apply(params["decision"], h, act=torch.relu)[:, 0]


SPEC = register(RetrieverSpec(name="hint", init=init, score=score,
                              needs=("tf", "idf_indicator", "cosine", "dot")))
