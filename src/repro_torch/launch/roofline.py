"""Roofline terms of a step on one card or one device of a mesh (port of
``repro.launch.roofline``).

The constants are an NVIDIA H100 80GB HBM3's (SXM): 989 TFLOP/s dense
bf16 on the tensor cores (the one peak ``PEAK_FLOPS`` stands for, as the
reference's single bf16 peak does), 3.35 TB/s of HBM3, and 450 GB/s a
direction of NVLink for ``ICI_BW``.  The reference reads XLA's
``cost_analysis()`` of a compiled module, which eager PyTorch has no
counterpart of: here :func:`terms_from_counts` takes the flops and
bytes that ``launch/dryrun.py``'s counting pass adds up op by op on the
meta device.  On one card nothing crosses a link, so the collective
term is 0 and ``coll_by_op`` is ``{"total": 0.0}``.  On a mesh the
counting pass records the collectives each device issues, the
``_c10d_functional`` ops DTensor's redistributions run (and ``c10d``'s
in-place ones, which the placed index's merge calls), and
:func:`collective_bytes` sums their result bytes by op under the
reference's HLO names, as the reference's parser of the compiled HLO
does; ``t_collective`` is those bytes over ``ICI_BW``.  A step's total is
still composed as in the reference:

    total = cost(step) + sum_c multiplier_c * cost(component_c)

where a component is a piece of the step counted once and scaled (the
LM training cells' microbatch, see ``launch/steps.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional, Tuple

PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
ICI_BW = 450e9               # bytes/s a direction, NVLink

# the collectives of torch.distributed, by the reference's HLO op names
COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "broadcast",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}


def collective_op(func) -> Optional[str]:
    """The reference's name of a collective op (an ``OpOverload``), or
    None for any other op."""
    return COLLECTIVE_OPS.get(str(func._overloadpacket))


def collective_bytes(calls: Iterable[Tuple[Any, Any]]) -> Dict[str, float]:
    """Per-device result bytes of collective ops, by op kind, from the
    ``(op, result)`` pairs a counting pass recorded; ``"total"`` sums
    them.  The result of an all-gather is the gathered tensor, of a
    reduce-scatter this device's part, of an all-reduce the whole
    tensor, as the HLO result shapes the reference sums."""
    import torch
    from torch.utils._pytree import tree_leaves
    out: Dict[str, float] = {}
    for func, result in calls:
        op = collective_op(func)
        if op is None:
            continue
        n = sum(t.numel() * t.element_size() for t in tree_leaves(result)
                if isinstance(t, torch.Tensor))
        out[op] = out.get(op, 0.0) + float(n)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclass
class RooflineTerms:
    flops: float = 0.0            # per device
    hbm_bytes: float = 0.0        # per device
    coll_bytes: float = 0.0       # per device
    coll_by_op: Dict[str, float] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time (perfect overlap of the three engines)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def add(self, other: "RooflineTerms", k: float = 1.0) -> "RooflineTerms":
        merged = dict(self.coll_by_op)
        for op, v in other.coll_by_op.items():
            merged[op] = merged.get(op, 0.0) + k * v
        return RooflineTerms(
            flops=self.flops + k * other.flops,
            hbm_bytes=self.hbm_bytes + k * other.hbm_bytes,
            coll_bytes=self.coll_bytes + k * other.coll_bytes,
            coll_by_op=merged)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "coll_by_op": self.coll_by_op,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
        }


def terms_from_counts(flops: float, hbm_bytes: float,
                      coll_by_op: Optional[Dict[str, float]] = None
                      ) -> RooflineTerms:
    """The terms of one counted function: its flops, the bytes its ops
    read and write, and its collective bytes by op (none on one card;
    :func:`collective_bytes` on a mesh)."""
    coll = dict(coll_by_op) if coll_by_op else {}
    coll["total"] = sum(v for k, v in coll.items() if k != "total")
    return RooflineTerms(flops=float(flops), hbm_bytes=float(hbm_bytes),
                         coll_bytes=coll["total"], coll_by_op=coll)


def model_flops(meta: Dict[str, Any], kind: str) -> Optional[float]:
    """MODEL_FLOPS: 6*N*D for dense training, 2*N*D inference (global)."""
    n = meta.get("n_active_params")
    tokens = meta.get("tokens")
    if not n or not tokens:
        return None
    mult = 6.0 if kind == "training" else 2.0
    return mult * n * tokens
