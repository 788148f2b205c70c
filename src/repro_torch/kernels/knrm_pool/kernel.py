"""Wrapper of the CUDA kernel in ``csrc/knrm_pool.cu``, which replaces
``repro/kernels/knrm_pool/kernel.py::knrm_pool_pallas`` (the source file
says what bounds it on the H100 and what the design does about it).

Given CUDA tensors it validates them, allocates the output with
``torch.empty``, launches on PyTorch's current stream, raises on a
nonzero ``cudaGetLastError`` and adds one to ``knrm_pool_kernel.launches``;
given CPU tensors it runs its plain version, ``ref.knrm_pool_ref``.
The kernel has no backward: on CUDA tensors that need a gradient (under
``torch.is_grad_enabled()``) it raises rather than drop the gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import (check_cuda_tensor, check_launch, load_library, ptr,
                     stream_handle)
from .ref import MUS, knrm_pool_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"knrm_pool_launch": [_P, _P, _P, _I, _I, _I, _P]}
# segments a CTA stages at a time: 16 rows and up to 16 mask rows of
# this many floats, 128 KB of shared memory (csrc/knrm_pool.cu kChunk)
SEG_CHUNK = 1024


def knrm_pool_kernel(cos_norm: torch.Tensor, seg_mask: torch.Tensor
                     ) -> torch.Tensor:
    """cos_norm (B, Q, n_b) f32, seg_mask (B, n_b) f32 -> (B, Q, 11) f32,
    at any n_b: a CTA stages its rows and mask rows ``SEG_CHUNK`` (1,024)
    segments at a time and carries each sum across the chunks, in
    segment order."""
    if cos_norm.device.type != "cuda":
        return knrm_pool_ref(cos_norm, seg_mask)
    if torch.is_grad_enabled() and (cos_norm.requires_grad
                                    or seg_mask.requires_grad):
        raise NotImplementedError(
            "knrm_pool_kernel has no backward: call it under "
            "torch.no_grad() or with inputs that need no gradient")
    dev = cos_norm.device
    check_cuda_tensor("cos_norm", cos_norm, torch.float32, dev, 3)
    check_cuda_tensor("seg_mask", seg_mask, torch.float32, dev, 2)
    n_cand, n_q, n_b = cos_norm.shape
    if seg_mask.shape != (n_cand, n_b):
        raise ValueError(f"seg_mask must be (B, n_b) = {(n_cand, n_b)}, got "
                         f"{tuple(seg_mask.shape)}")
    out = torch.empty((n_cand, n_q, len(MUS)), dtype=torch.float32,
                      device=dev)
    lib = load_library("knrm_pool", _SIGNATURES)
    rc = lib.knrm_pool_launch(ptr(cos_norm), ptr(seg_mask), ptr(out),
                              n_cand, n_q, n_b, stream_handle())
    check_launch(lib, rc, "knrm_pool_kernel")
    knrm_pool_kernel.launches += 1
    return out


knrm_pool_kernel.launches = 0
