"""Roofline terms of a step on one card (port of
``repro.launch.roofline``).

The constants are an NVIDIA H100 80GB HBM3's (SXM): 989 TFLOP/s dense
bf16 on the tensor cores (the one peak ``PEAK_FLOPS`` stands for, as the
reference's single bf16 peak does), 3.35 TB/s of HBM3, and 450 GB/s a
direction of NVLink for ``ICI_BW``.  The reference reads XLA's
``cost_analysis()`` of a compiled module, which eager PyTorch has no
counterpart of: here :func:`terms_from_counts` takes the flops and
bytes that ``launch/dryrun.py``'s counting pass adds up op by op on the
meta device.  On one card nothing crosses a link, so the collective
term is 0 and ``coll_by_op`` is ``{"total": 0.0}``; the reference's HLO
parser ``collective_bytes`` waits for training under a mesh (ROADMAP
Queue 1 item 4e2).  A step's total is still composed as in the reference:

    total = cost(step) + sum_c multiplier_c * cost(component_c)

where a component is a piece of the step counted once and scaled (the
LM training cells' microbatch, see ``launch/steps.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
ICI_BW = 450e9               # bytes/s a direction, NVLink


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
    read and write, and its collective bytes by op (none on one card)."""
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
