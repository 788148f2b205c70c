"""Wrapper of the CUDA kernel in ``csrc/embed_bag.cu``, which replaces
``repro/kernels/embed_bag/kernel.py::embed_bag_pallas`` (the source file
says what bounds it on the H100 and what the design does about it), and
its plain PyTorch version.

Both take ``table (V, D)`` (float32 or bf16), ``indices (nnz,)`` int32
(negative: skipped; >= V: row V - 1) and ``bag_ptr (n_bags + 1,)`` int32,
the non-decreasing CSR bounds of the bags over ``indices``, and return
``(n_bags, D)`` in the table's dtype: each bag's rows summed in index
order, zeros for an empty bag.

The segment entry :func:`embed_bag_segment_kernel` takes ``table``,
``rows (..., n)`` int64 table row ids (negative: skipped) and ``bins
(..., n)`` int64, clamped into ``[0, n_bins)``, and returns ``(...,
n_bins, D)``: per doc (the leading dims) each bin's rows summed in token
order.  It bags on the card in the same launch; its plain version,
:func:`segment_bag_sums_plain`, bags with a stable sort into CSR
(:func:`segment_bags`) and sums with :func:`embed_bag_plain`, giving the
same bits.

Given CUDA tensors either wrapper validates them, allocates its output
with ``torch.empty``, launches on PyTorch's current stream, raises on a
nonzero ``cudaGetLastError`` and adds one to ``embed_bag_kernel``'s
``launches`` count (one count for both entries).  Given CPU tensors they
run their plain versions.  The kernels have no backward: a table that
needs a gradient is refused.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..utils import (check_cuda_tensor, check_launch, load_library, ptr,
                     stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"embed_bag_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P],
               "embed_bag_segment_launch": [_P, _P, _P, _P, _I, _I, _I, _I,
                                            _I, _I, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SEGMENT_TOKENS = 6144   # the segment kernel stages 8 bytes per token


def embed_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                    bag_ptr: torch.Tensor, max_bag: Optional[int] = None
                    ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, summing in the kernel's
    order: the r-th row of every bag is added in pass r, one add per bag
    per pass (a negative index adds nothing), so each bag accumulates in
    index order (in bf16, rounded after every add, as the kernel does).
    The passes run to ``max_bag``, a bound on the rows of a bag, which
    keeps every shape static (no host read: the function runs on meta
    tensors); by default the longest bag, read from the device."""
    n_rows, d = table.shape
    n_bags = bag_ptr.shape[0] - 1
    out = torch.zeros((n_bags, d), dtype=table.dtype, device=table.device)
    nnz = indices.shape[0]
    if n_bags == 0 or nnz == 0:
        return out
    ptr_ = bag_ptr.long().clamp(0, nnz)
    start = ptr_[:-1]
    size = (ptr_[1:] - start).clamp(min=0)
    if max_bag is None:
        max_bag = int(size.max())
    for r in range(max_bag):
        at = (start + r).clamp(max=nnz - 1)
        row = indices[at].long()
        live = (size > r) & (row >= 0)
        add = table[row.clamp(0, n_rows - 1)]
        out = torch.where(live[:, None], out + add, out)
    return out


def _check_table(table: torch.Tensor) -> None:
    if table.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "embed_bag_kernel has no backward yet: call it under "
            "torch.no_grad() or with a table that needs no gradient")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table has dtype {table.dtype}; the kernel takes "
                        "float32 or bfloat16")
    check_cuda_tensor("table", table, table.dtype, table.device, 2)
    if table.shape[0] == 0:
        raise ValueError("table has no rows")


def embed_bag_kernel(table: torch.Tensor, indices: torch.Tensor,
                     bag_ptr: torch.Tensor) -> torch.Tensor:
    """table (V, D) float32 or bf16, indices (nnz,) int32, bag_ptr
    (n_bags + 1,) int32 -> (n_bags, D) in the table's dtype."""
    if table.device.type != "cuda":
        return embed_bag_plain(table, indices, bag_ptr)
    _check_table(table)
    dev = table.device
    check_cuda_tensor("indices", indices, torch.int32, dev, 1)
    check_cuda_tensor("bag_ptr", bag_ptr, torch.int32, dev, 1)
    if bag_ptr.shape[0] < 1:
        raise ValueError("bag_ptr needs n_bags + 1 >= 1 entries")
    n_rows, d = table.shape
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


def segment_bags(rows: torch.Tensor, bins: torch.Tensor, n_bins: int):
    """The segment sums as CSR bags: ``(indices (n_docs * n,) int32,
    bag_ptr (n_docs * n_bins + 1,) int32)``, bag ``doc * n_bins + bin``.
    The key ``doc * n_bins + bin`` (bins clamped into [0, n_bins)) is
    sorted stably, so each bag keeps its rows in token order; nothing is
    read back to the host."""
    n = rows.shape[-1]
    n_docs = math.prod(rows.shape[:-1])
    doc = torch.arange(n_docs, device=rows.device)[:, None]
    key = (doc * n_bins + bins.reshape(n_docs, n).long().clamp(
        0, n_bins - 1)).reshape(-1)
    key, order = torch.sort(key, stable=True)
    idx = rows.reshape(-1)[order].to(torch.int32).contiguous()
    bounds = torch.arange(n_docs * n_bins + 1, device=rows.device)
    ptr = torch.searchsorted(key, bounds).to(torch.int32).contiguous()
    return idx, ptr


def segment_bag_sums_plain(table: torch.Tensor, rows: torch.Tensor,
                           bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The segment entry's function in plain PyTorch: the sort-based
    bags of :func:`segment_bags` summed by :func:`embed_bag_plain`."""
    # a bag holds at most one doc's n tokens: n passes, static
    out = embed_bag_plain(table, *segment_bags(rows, bins, n_bins),
                          max_bag=rows.shape[-1])
    return out.reshape(*rows.shape[:-1], n_bins, table.shape[1])


def embed_bag_segment_kernel(table: torch.Tensor, rows: torch.Tensor,
                             bins: torch.Tensor, n_bins: int
                             ) -> torch.Tensor:
    """table (V, D) float32 or bf16, rows and bins (..., n) int64 ->
    (..., n_bins, D) in the table's dtype, in one launch."""
    if table.device.type != "cuda":
        return segment_bag_sums_plain(table, rows, bins, n_bins)
    _check_table(table)
    dev = table.device
    if rows.ndim < 1 or bins.shape != rows.shape:
        raise ValueError(f"rows {tuple(rows.shape)} and bins "
                         f"{tuple(bins.shape)} must have one shape (..., n)")
    check_cuda_tensor("rows", rows, torch.int64, dev, rows.ndim)
    check_cuda_tensor("bins", bins, torch.int64, dev, rows.ndim)
    n_bins = int(n_bins)
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    n = rows.shape[-1]
    if n > MAX_SEGMENT_TOKENS:
        raise ValueError(f"{n} tokens per doc; the segment kernel takes up "
                         f"to {MAX_SEGMENT_TOKENS}")
    n_rows, d = table.shape
    out = torch.empty((*rows.shape[:-1], n_bins, d), dtype=table.dtype,
                      device=dev)
    lib = load_library("embed_bag", _SIGNATURES)
    rc = lib.embed_bag_segment_launch(
        ptr(table), ptr(rows), ptr(bins), ptr(out), n_rows, d,
        math.prod(rows.shape[:-1]), n, n_bins, _DTYPES[table.dtype],
        stream_handle())
    check_launch(lib, rc, "embed_bag_segment_kernel")
    embed_bag_kernel.launches += 1
    return out
