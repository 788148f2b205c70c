"""Public entry point of ``flash_attn`` with the JAX package's layout:
``flash_attention(q (B, Sq, Hq, hd), k, v (B, Skv, Hkv, hd)) -> (B, Sq,
Hq, hd)``.  The kernel takes the model layout itself, so the reference's
transposes and its halving of the tile to divide the sequence go away
(the kernel masks the tail).  A CUDA tensor goes to the CUDA kernel, a
CPU tensor to its plain version.

When an input needs a gradient, the call goes through an autograd
Function: the forward also keeps each row's log-sum-exp, and the
backward is the hand-written backward kernel (on CPU tensors its plain
version, so the CPU runs the backward's algorithm, not autograd of the
forward).  Without gradients (serving, the build, a prefill) the forward
runs as it always has, with no lse.  ``flash_attention_plain`` is the
same with both plain versions on any device: the yardstick a training
step on the card is held against.

Under a mesh q, k and v arrive as DTensors.  The kernels run on each
rank's local tensors (``dist.dtensor.on_local``) and the result is a
DTensor with the operands' placements, the counterpart of a
``shard_map`` around the Pallas call: legal where the sharded dimension
is one the kernels treat independently, the batch (dimension 0), or
the query and KV heads together (dimension 2, when both head counts
divide).  Any other placement (a split sequence or head dimension, a
partial sum) is redistributed to ``Replicate()`` on that mesh dimension
first.  The backward takes the local tensors the same way.
"""
from __future__ import annotations

import torch

from .kernel import (flash_attn_bwd_kernel, flash_attn_bwd_plain,
                     flash_attn_kernel, flash_attn_plain)
from .ref import flash_attn_ref


class _FlashAttention(torch.autograd.Function):
    """o = flash_attn(q, k, v); its backward from q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, plain: bool):
        fwd = flash_attn_plain if plain else flash_attn_kernel
        o, lse = fwd(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.plain = causal, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attn_bwd_plain if ctx.plain else flash_attn_bwd_kernel
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse,
                         causal=ctx.causal)
        return dq, dk, dv, None, None


def _local_placements(q, k, v) -> tuple:
    """Per mesh dimension: the operands' ``Shard(0)`` (batch) or
    ``Shard(2)`` (heads, when q's, k's and v's agree and both head counts
    divide), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    out = []
    for i in range(mesh.ndim):
        p, n = q.placements[i], mesh.size(i)
        same = p == k.placements[i] == v.placements[i]
        if same and p == Shard(0):
            out.append(p)
        elif (same and p == Shard(2) and q.shape[2] % n == 0
              and k.shape[2] % n == 0):
            out.append(p)
        else:
            out.append(Replicate())
    return tuple(out)


def per_rank(attention):
    """``attention(q, k, v, **kw)`` that, given DTensors, runs on each
    rank's local q, k and v, split over the batch or the heads
    (:func:`_local_placements`), and returns a DTensor placed as they
    are."""
    def run(q, k, v, **kw):
        from ...dist.dtensor import any_dtensor, on_local
        if any_dtensor(q, k, v):
            return on_local(lambda a, b, c: attention(a, b, c, **kw),
                            (q, k, v), _local_placements(q, k, v))
        return attention(q, k, v, **kw)
    return run


def _attend(q, k, v, causal: bool, plain: bool) -> torch.Tensor:
    from ...dist.dtensor import any_dtensor, on_local
    if any_dtensor(q, k, v):
        return on_local(_attend, (q, k, v), _local_placements(q, k, v),
                        causal, plain)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, plain)
    fwd = flash_attn_plain if plain else flash_attn_kernel
    return fwd(q, k, v, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, Sq, Hq, hd) x (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd), through the
    kernels (their plain versions on CPU tensors)."""
    return _attend(q, k, v, causal, plain=False)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention` through the plain forward and backward on
    any device."""
    return _attend(q, k, v, causal, plain=True)


__all__ = ["flash_attention", "flash_attention_plain", "flash_attn_ref",
           "per_rank"]
