"""SNRM baseline indexer [Zamani et al., CIKM'18] (port of
``repro.core.snrm``; the paper's Table 1 middle block).

Learns a sparse latent representation; the latent nodes act as vocabulary
entries of an inverted index (they satisfy SEINE's independence
condition, which is how the paper applies SNRM to KNRM / HiNT /
DeepTileBars: documents are re-expressed as sequences of latent words).

The encoder is a per-token MLP with ReLU sparsity, mean-pooled over the
tokens, trained with hinge + L1 (the paper's objective).  Parameters are
a plain dict of float32 tensors drawn from an explicit
``torch.Generator``: ``jax.random`` streams cannot be reproduced, so a
parity test carries the reference's arrays across
(``convert.snrm_params_from_numpy``).  Training uses
``train.optimizer.adam`` and ``apply_updates`` over the dict.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.utils import resolve_device
from ..models.layers import dense_init
from .index import gather_clip

Params = Dict[str, Any]
ENCODE_CHUNK = 4096      # docs per chunk of encode_docs


def init_snrm(vocab_size: int, d_latent: int = 256, d_emb: int = 64,
              d_hidden: int = 128, *,
              generator: Optional[torch.Generator] = None,
              device=None) -> Params:
    """Token embedding (|v|, d_emb) and the 2-layer MLP encoder into the
    sparse ``d_latent`` space, each N(0, 1/d_in), drawn in float32 from
    ``generator`` (default: seeded with 0, on ``device``, default CUDA)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    return {"emb": dense_init(gen, vocab_size, d_emb).to(dev),
            "w1": dense_init(gen, d_emb, d_hidden).to(dev),
            "w2": dense_init(gen, d_hidden, d_latent).to(dev)}


def encode(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (..., L) vocab slots (-1 pad) -> sparse latent
    (..., d_latent): the mean over the valid tokens of the per-token
    ReLU encoding.  A slot past the vocabulary reads the last row (the
    reference's clipping gather)."""
    valid = (tokens >= 0).float()
    e = gather_clip(p["emb"], tokens.clamp(min=0)) * valid[..., None]
    h = torch.relu(e @ p["w1"])
    z = torch.relu(h @ p["w2"])                     # per-token latent
    return z.sum(-2) / torch.clamp(valid.sum(-1, keepdim=True), min=1.0)


def encode_docs(p: Params, tokens, chunk: int = ENCODE_CHUNK
                ) -> torch.Tensor:
    """``encode`` of (n_docs, L) tokens (numpy or a tensor) in chunks of
    ``chunk`` docs on the parameters' device, without autograd:
    (n_docs, d_latent) float32.  One pass over a whole corpus would hold
    an (n_docs, L, d_latent) float32 intermediate."""
    dev = p["emb"].device
    out = []
    with torch.inference_mode():
        for i in range(0, len(tokens), chunk):
            t = torch.as_tensor(tokens[i:i + chunk]).to(dev)
            out.append(encode(p, t))
    return torch.cat(out)


def score(p: Params, q_tokens: torch.Tensor,
          d_tokens: torch.Tensor) -> torch.Tensor:
    """Dot product of the query's and the doc's latent encodings."""
    return torch.sum(encode(p, q_tokens) * encode(p, d_tokens), dim=-1)


def snrm_loss(p: Params, batch: Dict[str, torch.Tensor],
              l1: float = 1e-5) -> torch.Tensor:
    """Pairwise hinge + L1 sparsity (Zamani et al. Eq. 4).  The hinge is
    ``torch.maximum``, whose gradient splits at a tie as
    ``jnp.maximum``'s does."""
    sp = score(p, batch["query"], batch["pos"])
    sn = score(p, batch["query"], batch["neg"])
    margin = 1.0 - sp + sn
    hinge = torch.maximum(torch.zeros_like(margin), margin).mean()
    zq = encode(p, batch["query"])
    zp = encode(p, batch["pos"])
    return hinge + l1 * (torch.abs(zq).sum(-1)
                         + torch.abs(zp).sum(-1)).mean()


def latent_doc_sequences(p: Params, tokens, top_k: int = 32
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Docs re-expressed as their top-k active latent 'words' and
    strengths: (latent_ids (n_docs, top_k) int32 with -1 where the
    strength is 0, strengths float32).  The order is the reference's
    ``np.argsort(-z)`` on the host."""
    z = encode_docs(p, tokens).cpu().numpy()
    order = np.argsort(-z, axis=-1)[:, :top_k]
    strength = np.take_along_axis(z, order, axis=-1)
    latent_ids = np.where(strength > 0, order, -1).astype(np.int32)
    return latent_ids, strength.astype(np.float32)


def latent_embeddings(p: Params) -> torch.Tensor:
    """Embeddings of the latent words: the decoder rows (``w2``'s
    columns), each scaled to unit norm."""
    w = p["w2"].T                                   # (d_latent, d_hidden)
    return w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True),
                           min=1e-9)
