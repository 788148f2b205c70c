"""Gradient compression with error feedback (port of
``repro.dist.compression``): the training-cost side of the paper's
effectiveness-vs-efficiency trade-off, where rankers train data-parallel
and a compressed all-reduce keeps the gradient exchange off the critical
path.

Two schemes over the port's parameter trees (``repro_torch.tree``):

* ``int8`` — symmetric per-leaf quantisation (4x smaller payload);
* ``topk`` — magnitude sparsification (send the largest ``topk_frac``).

Both are wrapped in error feedback [Seide et al. '14; Karimireddy et al.
'19]: the residual (what compression dropped) is carried in the train
state and added back before the next round, so the *sum* of transmitted
gradients tracks the sum of true gradients.  The arithmetic is the
reference's: the int8 scale is a true float32 division by 127, rounding
is half to even, and top-k breaks ties toward the lower index, as
``jax.lax.top_k`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .. import tree as T


# ---------------------------------------------------------------------------
# int8 quantisation
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale f32 scalar) with
    dequant error bounded by scale/2."""
    peak = torch.clamp(torch.abs(x).max(), min=1e-12)
    scale = peak / torch.full_like(peak, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Invert :func:`quantize_int8`: int8 codes * scale -> f32."""
    return q.to(torch.float32) * scale


# ---------------------------------------------------------------------------
# top-k sparsification
# ---------------------------------------------------------------------------

def topk_sparsify(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the k largest-magnitude entries: returns (flat indices int32,
    values); equal magnitudes keep the lower index first."""
    flat = x.reshape(-1)
    idx = torch.sort(torch.abs(flat), descending=True,
                     stable=True).indices[:k]
    return idx.to(torch.int32), flat[idx]


def topk_densify(idx: torch.Tensor, vals: torch.Tensor,
                 shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of topk_sparsify: scatter values back into a zero tensor."""
    n = 1
    for d in shape:
        n *= d
    out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    out[idx.long()] = vals
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

def init_error_feedback(params: Any) -> Any:
    """Zero residual buffers, one per param leaf (carried in TrainState)."""
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def _compress_leaf(x: torch.Tensor, scheme: str, topk_frac: float
                   ) -> torch.Tensor:
    """Compress-then-decompress one leaf (the value that would be sent)."""
    if scheme == "int8":
        return dequantize_int8(*quantize_int8(x))
    if scheme == "topk":
        k = max(1, int(x.numel() * topk_frac))
        if k >= x.numel():
            return x
        idx, vals = topk_sparsify(x, k)
        return topk_densify(idx, vals, tuple(x.shape))
    raise ValueError(f"unknown compression scheme {scheme!r}")


@torch.no_grad()
def compress_with_feedback(grads: Any, residual: Any, *, scheme: str = "int8",
                           topk_frac: float = 0.01) -> Tuple[Any, Any]:
    """(grads, residual) -> (transmitted, new_residual), per leaf:

        c = g + residual          # add back what was dropped last round
        t = decompress(compress(c))
        new_residual = c - t
    """
    def leaf(g, r):
        c = g.to(torch.float32) + r
        t = _compress_leaf(c, scheme, topk_frac)
        return t, c - t

    out = T.tree_map(leaf, grads, residual)
    return (T.tree_map(lambda _, o: o[0], grads, out),
            T.tree_map(lambda _, o: o[1], grads, out))
