"""Public entry point of ``flash_attn`` with the JAX package's layout:
``flash_attention(q (B, Sq, Hq, hd), k, v (B, Skv, Hkv, hd)) -> (B, Sq,
Hq, hd)``.  The kernel takes the model layout itself, so the reference's
transposes and its halving of the tile to divide the sequence go away
(the kernel masks the tail).  A CUDA tensor goes to the CUDA kernel, a
CPU tensor to its plain version.
"""
from __future__ import annotations

import torch

from .kernel import flash_attn_kernel
from .ref import flash_attn_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, Sq, Hq, hd) x (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    return flash_attn_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=causal)


__all__ = ["flash_attention", "flash_attn_ref"]
