"""Plain PyTorch KNRM kernel bank: the RBF kernels + log pooling.

in:  cos_norm (B, Q, n_b) match signals in [-1, 1], seg_mask (B, n_b)
out: (B, Q, K) log-pooled soft-TF features (K = 11, the original mu grid).
Port of ``repro.kernels.knrm_pool.ref`` and
``repro.retrievers.knrm.kernel_features``; the constants live here so
that the retriever and the kernel share them.
"""
from __future__ import annotations

from functools import lru_cache

import torch

MUS = (1.0, 0.9, 0.7, 0.5, 0.3, 0.1, -0.1, -0.3, -0.5, -0.7, -0.9)
SIGMAS = (0.001,) + (0.1,) * 10


@lru_cache(maxsize=None)
def _bank(device: torch.device):
    """(mus, sigmas) as float32 tensors on ``device``, made once, outside
    inference mode: a first call from an engine's scoring (under
    ``torch.inference_mode``) would otherwise cache inference tensors,
    which autograd refuses to save when a training step uses them."""
    with torch.inference_mode(False):
        return (torch.tensor(MUS, dtype=torch.float32, device=device),
                torch.tensor(SIGMAS, dtype=torch.float32, device=device))


def kernel_features(cos_norm: torch.Tensor, seg_mask: torch.Tensor
                    ) -> torch.Tensor:
    """cos_norm (..., n_b) in [-1, 1]; seg_mask broadcastable (..., n_b)
    -> (..., K) log-pooled soft-TF features."""
    mus, sigmas = _bank(cos_norm.device)
    k = torch.exp(-0.5 * ((cos_norm[..., None] - mus) / sigmas) ** 2)
    k = k * seg_mask[..., None]
    return torch.log1p(k.sum(dim=-2))                  # pool over segments


def knrm_pool_ref(cos_norm: torch.Tensor, seg_mask: torch.Tensor
                  ) -> torch.Tensor:
    """cos_norm (B, Q, n_b), seg_mask (B, n_b) -> (B, Q, K)."""
    return kernel_features(cos_norm, seg_mask[:, None, :])
