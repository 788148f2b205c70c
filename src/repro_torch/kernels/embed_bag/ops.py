"""Public entry point of ``embed_bag`` with the JAX package's signature
(port of ``repro.kernels.embed_bag.ops``): the CUDA kernel for CUDA
tensors, its plain version for CPU tensors."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import resolve_device
from .kernel import embed_bag_kernel
from .ref import embed_bag_ref


def bag_ptr_from_offsets(offsets: torch.Tensor, nnz: int, n_bags: int
                         ) -> torch.Tensor:
    """CSR bounds ``(n_bags + 1,)`` int32 of bags given by their starts
    ``offsets (B,)``: bag b ends where bag b + 1 starts, the last at
    ``nnz``; bags past ``B`` are empty, and bounds clamp to [0, nnz]."""
    tail = torch.full((max(n_bags + 1 - offsets.shape[0], 1),), nnz,
                      dtype=torch.int64, device=offsets.device)
    full = torch.cat([offsets.long(), tail])[:n_bags + 1]
    return full.clamp(0, nnz).to(torch.int32).contiguous()


def embed_bag(table, indices, offsets, *, n_bags: int,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """EmbeddingBag(sum): table (V, D), indices (nnz,), offsets (B,) bag
    starts -> (n_bags, D) in the table's dtype.  Negative indices are
    skipped, empty bags are zero (the reference wrapper's convention).
    Tensors stay on their device; numpy inputs go to ``device`` (default
    CUDA)."""
    dev = (table.device if isinstance(table, torch.Tensor)
           else resolve_device(device))

    def as_tensor(a, dtype=None):
        if isinstance(a, np.ndarray):
            a = np.ascontiguousarray(a)
        return torch.as_tensor(a, dtype=dtype, device=dev)

    table = as_tensor(table)
    indices = as_tensor(indices, torch.int32)
    ptr = bag_ptr_from_offsets(as_tensor(offsets), indices.shape[0],
                               int(n_bags))
    return embed_bag_kernel(table.contiguous(), indices.contiguous(), ptr)


def segment_bag_sums(table: torch.Tensor, rows: torch.Tensor,
                     bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-doc segment sums of table rows through the kernel: ``rows
    (..., n)`` table row ids (negative: skipped) fall in bin ``bins
    (..., n)`` in [0, n_bins) of their doc (the leading dims) ->
    ``(..., n_bins, D)``.  The bag key is ``doc * n_bins + bin``; a
    stable sort puts the keys in bag order and keeps each bag's rows in
    position order, so a bag sums in token order whatever the batch.
    Nothing is read back to the host."""
    lead, n = rows.shape[:-1], rows.shape[-1]
    n_docs = rows.numel() // max(n, 1)
    doc = torch.arange(n_docs, device=rows.device)[:, None]
    key = (doc * n_bins + bins.reshape(n_docs, n).long()).reshape(-1)
    key, order = torch.sort(key, stable=True)
    idx = rows.reshape(-1)[order].to(torch.int32).contiguous()
    bounds = torch.arange(n_docs * n_bins + 1, device=rows.device)
    ptr = torch.searchsorted(key, bounds).to(torch.int32).contiguous()
    out = embed_bag_kernel(table.contiguous(), idx, ptr)
    return out.reshape(*lead, n_bins, table.shape[1])


__all__ = ["bag_ptr_from_offsets", "embed_bag", "embed_bag_ref",
           "segment_bag_sums"]
