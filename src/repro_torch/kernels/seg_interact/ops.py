"""Public entry point of ``seg_interact`` with the JAX package's
signature: ``seg_interact(e_vocab (V, De), seg_tokens (S, Ls, De), mask
(S, Ls)) -> (V, S, 3)`` [dot, cos, gauss].

The padded segments are flattened into one ragged doc (``B = 1``, ``L =
S * Ls``, token (s, l) in segment s where ``mask > 0``, excluded
elsewhere), so the same kernel as the build's serves it: the CUDA kernel
for CUDA tensors, its plain version for CPU tensors.  The masks are 0/1,
as in every caller of the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .kernel import seg_interact_kernel
from .ref import seg_interact_ref


def flatten_segments(e_vocab: torch.Tensor, seg_tokens: torch.Tensor,
                     mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernel's ragged inputs ``(e_term (1, V, De), e_tok (1, S*Ls,
    De), seg (1, S*Ls), term_ids (1, V))`` for the padded layout."""
    n_seg, n_l, de = seg_tokens.shape
    dev = e_vocab.device
    tok = seg_tokens.to(torch.float32) * mask.to(torch.float32)[..., None]
    seg = torch.where(mask > 0, torch.arange(n_seg, device=dev)[:, None],
                      torch.full((), -1, device=dev))
    return (e_vocab.to(torch.float32).contiguous()[None],
            tok.reshape(1, n_seg * n_l, de).contiguous(),
            seg.reshape(1, -1).to(torch.int32).contiguous(),
            torch.zeros((1, e_vocab.shape[0]), dtype=torch.int32,
                        device=dev))


def seg_interact(e_vocab: torch.Tensor, seg_tokens: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """(V, De) x (S, Ls, De) [+ mask (S, Ls)] -> (V, S, 3)."""
    return seg_interact_kernel(*flatten_segments(e_vocab, seg_tokens, mask),
                               seg_tokens.shape[0])[0]


__all__ = ["flatten_segments", "seg_interact", "seg_interact_ref"]
