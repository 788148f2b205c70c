"""KNRM [Xiong et al., SIGIR'17] — kernel pooling over match signals.

Port of ``repro.retrievers.knrm``.  The stored cosine is a segment-
aggregated sum; it is length-normalised per segment to a mean match
signal in [-1, 1], run through the RBF kernel bank (11 kernels, the
original mu grid), log-pooled over segments and combined by a linear
layer.  The kernel bank is ``kernels.knrm_pool``: the hand-written CUDA
kernel for CUDA tensors, its plain torch version on the CPU — the same
function the reference computes with jnp.
"""
from __future__ import annotations

import torch

from ..kernels.knrm_pool import MUS, SIGMAS, kernel_features, knrm_pool
from ..models.layers import dense_init
from .base import QMeta, RetrieverSpec, fidx, make_init, register

__all__ = ["MUS", "SIGMAS", "init", "kernel_features", "score"]


init = make_init(lambda gen, n_b: {"w": dense_init(gen, len(MUS), 1),
                                   "b": torch.zeros(1)})


def score(params, M, meta: QMeta, functions) -> torch.Tensor:
    cos = M[..., fidx(functions, "cosine")]             # (B, Q, n_b)
    seg_mask = (meta.seg_len > 0).to(torch.float32)     # (B, n_b)
    denom = torch.clamp(meta.seg_len, min=1.0)[:, None, :]
    cos_norm = torch.clamp(cos / denom, -1.0, 1.0)
    phi = knrm_pool(cos_norm, seg_mask)                 # (B, Q, K)
    phi = phi * meta.q_mask[None, :, None]
    pooled = phi.sum(dim=1)                             # (B, K)
    return (pooled @ params["w"] + params["b"])[:, 0]


SPEC = register(RetrieverSpec(name="knrm", init=init, score=score,
                              needs=("cosine",)))
