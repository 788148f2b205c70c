"""Plain PyTorch oracle of ``seg_interact`` over the TPU kernel's padded
layout (port of ``repro.kernels.seg_interact.ref``).

For every (vocab term, segment) pair, segments pre-padded to one length
Ls as ``seg_tokens (S, Ls, De)`` with ``mask (S, Ls)``:

  dot   = sum_{t in S} E(w) . E(t)
  cos   = sum_{t in S} cos(E(w), E(t))
  gauss = max_{t in S} exp(-||E(w) - E(t)||^2)

Output (V, S, 3); an empty segment gives 0 for all three.
"""
from __future__ import annotations

import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-9)


def seg_interact_ref(e_vocab: torch.Tensor, seg_tokens: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    ev = e_vocab.to(torch.float32)                      # (V, De)
    st = seg_tokens.to(torch.float32)                   # (S, Ls, De)
    m = mask.to(torch.float32)                          # (S, Ls)
    scores = torch.einsum("vd,sld->vsl", ev, st)        # (V, S, Ls)
    dot = (scores * m[None]).sum(-1)
    cos = (torch.einsum("vd,sld->vsl", _normalize(ev), _normalize(st))
           * m[None]).sum(-1)
    d2 = ((ev ** 2).sum(-1)[:, None, None] + (st ** 2).sum(-1)[None]
          - 2.0 * scores)
    d2 = torch.where(m[None] > 0, d2, torch.full((), float("inf")))
    neg = (-d2).amax(-1)                                # (V, S)
    gauss = torch.where(torch.isfinite(neg), torch.exp(neg),
                        torch.zeros(()))
    return torch.stack([dot, cos, gauss], dim=-1)
