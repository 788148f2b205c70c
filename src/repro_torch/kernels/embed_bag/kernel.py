"""Wrapper of the CUDA kernel in ``csrc/embed_bag.cu``, which replaces
``repro/kernels/embed_bag/kernel.py::embed_bag_pallas`` (the source file
says what bounds it on the H100 and what the design does about it), and
its plain PyTorch version.

Both take ``table (V, D)`` (float32 or bf16), ``indices (nnz,)`` int32
(negative: skipped; >= V: row V - 1) and ``bag_ptr (n_bags + 1,)`` int32,
the non-decreasing CSR bounds of the bags over ``indices``, and return
``(n_bags, D)`` in the table's dtype: each bag's rows summed in index
order, zeros for an empty bag.

Given CUDA tensors :func:`embed_bag_kernel` validates them, allocates its
output with ``torch.empty``, launches on PyTorch's current stream,
raises on a nonzero ``cudaGetLastError`` and adds one to its
``launches`` count.  Given CPU tensors it runs :func:`embed_bag_plain`.
The kernel has no backward: a table that needs a gradient is refused.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import (check_cuda_tensor, check_launch, load_library, ptr,
                     stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"embed_bag_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def embed_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                    bag_ptr: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, summing in the kernel's
    order: the r-th live row of every bag is added in pass r, one add
    per bag per pass, so each bag accumulates in index order (in bf16,
    rounded after every add, as the kernel does)."""
    n_rows, d = table.shape
    n_bags = bag_ptr.shape[0] - 1
    out = torch.zeros((n_bags, d), dtype=table.dtype, device=table.device)
    if n_bags == 0 or indices.shape[0] == 0:
        return out
    ptr_ = bag_ptr.long()
    pos = torch.arange(indices.shape[0], device=table.device)
    bag = torch.searchsorted(ptr_[1:], pos, right=True)
    keep = (indices >= 0) & (pos >= ptr_[0]) & (bag < n_bags)
    bag, pos = bag[keep], pos[keep]
    rows = indices[keep].long().clamp(max=n_rows - 1)
    rank = pos - ptr_[bag]
    order = torch.argsort(rank, stable=True)
    bag, rows = bag[order], rows[order]
    start = 0
    for count in torch.bincount(rank).tolist():
        b = bag[start:start + count]          # distinct bags: one add each
        out[b] = out[b] + table[rows[start:start + count]]
        start += count
    return out


def embed_bag_kernel(table: torch.Tensor, indices: torch.Tensor,
                     bag_ptr: torch.Tensor) -> torch.Tensor:
    """table (V, D) float32 or bf16, indices (nnz,) int32, bag_ptr
    (n_bags + 1,) int32 -> (n_bags, D) in the table's dtype."""
    if table.device.type != "cuda":
        return embed_bag_plain(table, indices, bag_ptr)
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "embed_bag_kernel has no backward yet: call it under "
            "torch.no_grad() or with a table that needs no gradient")
    dev = table.device
    if table.dtype not in _DTYPES:
        raise TypeError(f"table has dtype {table.dtype}; the kernel takes "
                        "float32 or bfloat16")
    check_cuda_tensor("table", table, table.dtype, dev, 2)
    check_cuda_tensor("indices", indices, torch.int32, dev, 1)
    check_cuda_tensor("bag_ptr", bag_ptr, torch.int32, dev, 1)
    if bag_ptr.shape[0] < 1:
        raise ValueError("bag_ptr needs n_bags + 1 >= 1 entries")
    n_rows, d = table.shape
    if n_rows == 0:
        raise ValueError("table has no rows")
    n_bags = bag_ptr.shape[0] - 1
    out = torch.empty((n_bags, d), dtype=table.dtype, device=dev)
    lib = load_library("embed_bag", _SIGNATURES)
    rc = lib.embed_bag_launch(ptr(table), ptr(indices), ptr(bag_ptr),
                              ptr(out), n_rows, d, n_bags, indices.shape[0],
                              _DTYPES[table.dtype], stream_handle())
    check_launch(lib, rc, "embed_bag_kernel")
    embed_bag_kernel.launches += 1
    return out


embed_bag_kernel.launches = 0
