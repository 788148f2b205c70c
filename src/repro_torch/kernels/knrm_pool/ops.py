"""Public entry point of the KNRM kernel bank: the CUDA kernel for CUDA
tensors, the plain torch version for CPU tensors."""
from __future__ import annotations

import torch

from .kernel import knrm_pool_kernel
from .ref import knrm_pool_ref


def knrm_pool(cos_norm: torch.Tensor, seg_mask: torch.Tensor
              ) -> torch.Tensor:
    """cos_norm (B, Q, n_b), seg_mask (B, n_b) -> (B, Q, 11)."""
    return knrm_pool_kernel(cos_norm.to(torch.float32).contiguous(),
                            seg_mask.to(torch.float32).contiguous())


__all__ = ["knrm_pool", "knrm_pool_ref"]
