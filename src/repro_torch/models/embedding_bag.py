"""EmbeddingBag and the packed multi-table layout (port of
``repro.models.embedding_bag``).

``embedding_bag`` is the plain ragged gather + segment reduce (sum, mean
or max, with per-sample weights), and the oracle of the ``embed_bag``
kernel; ``MultiTable`` packs F embedding tables in one row-shardable
``(sum(V_f), D)`` array (the MLPerf-DLRM trick).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.index import gather_clip
from ..kernels.utils import resolve_device


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor, *, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None,
                  n_bags: Optional[int] = None) -> torch.Tensor:
    """torch.nn.EmbeddingBag semantics with the reference's gather.

    table: (V, D); indices: (nnz,) flat ids; offsets: (B,) bag starts
    (CSR row pointers without the trailing nnz).  Returns (n_bags or B,
    D).  Ids gather as jnp's ``mode="clip"`` does: -1 wraps to row V - 1
    (it is not skipped, unlike the kernel).  Positions whose bag falls
    outside [0, n_bags) are dropped; an empty bag is 0 under sum and
    mean and -inf under max.
    """
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    nnz = indices.shape[0]
    n_out = n_bags or offsets.shape[0]
    pos = torch.arange(nnz, device=table.device, dtype=offsets.dtype)
    seg = torch.searchsorted(offsets.contiguous(), pos, right=True) - 1
    rows = gather_clip(table, indices)                       # (nnz, D)
    if weights is not None:
        rows = rows * weights[:, None]
    keep = (seg >= 0) & (seg < n_out)
    seg, rows = seg[keep].long(), rows[keep]
    shape = (n_out, table.shape[1])
    if mode == "max":
        out = torch.full(shape, float("-inf"), dtype=rows.dtype,
                         device=table.device)
        return out.scatter_reduce_(0, seg[:, None].expand(rows.shape), rows,
                                   "amax", include_self=False)
    s = torch.zeros(shape, dtype=rows.dtype,
                    device=table.device).index_add_(0, seg, rows)
    if mode == "sum":
        return s
    cnt = torch.zeros(n_out, dtype=rows.dtype, device=table.device)
    cnt.index_add_(0, seg, torch.ones_like(seg, dtype=rows.dtype))
    return s / torch.clamp(cnt, min=1.0)[:, None]


class MultiTable:
    """F embedding tables packed in one (sum(V_f), D) array.

    Total rows are padded to a multiple of ``pad_rows`` so the packed
    table row-shards on any production mesh axis (512 covers 2x16x16);
    padding rows are unreachable by construction (offsets never point at
    them).
    """

    def __init__(self, vocab_sizes: Tuple[int, ...], d: int,
                 pad_rows: int = 512):
        self.vocab_sizes = tuple(vocab_sizes)
        self.d = d
        self.row_offsets = np.concatenate(
            [[0], np.cumsum(vocab_sizes)]).astype(np.int64)
        self.total_rows = -(-int(self.row_offsets[-1]) // pad_rows) * pad_rows

    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32, scale: float = 0.01,
             device=None) -> torch.Tensor:
        """A (total_rows, d) N(0, scale^2) table drawn from ``generator``
        (on its device, default the CPU's) and moved to ``device``
        (default CUDA)."""
        gen = generator or torch.Generator()
        t = torch.randn(self.total_rows, self.d, generator=gen,
                        dtype=torch.float32, device=gen.device) * scale
        return t.to(resolve_device(device), dtype)

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """ids: (B, F) per-field ids -> (B, F, D): one gather over the
        packed table, after the per-field offset turns field-local ids
        into global rows."""
        offs = torch.as_tensor(self.row_offsets[:-1], dtype=ids.dtype,
                               device=ids.device)
        flat = (ids + offs[None, :]).reshape(-1)
        out = gather_clip(table, flat)
        return out.reshape(ids.shape[0], ids.shape[1], self.d)
