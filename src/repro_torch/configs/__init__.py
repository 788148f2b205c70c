"""Config registry of the port (copy of ``repro.configs``):
``get_bundle("yi-9b")`` -> ArchBundle with the exact published config and
its input-shape set; ``smoke(arch_id)`` -> a reduced config of the same
family for CPU tests, for any domain.  ``get_lm_config(name)`` is the LM
bundle's config, and SEINE's own config sits beside them.
"""
from __future__ import annotations

from typing import Dict

from . import gnn_archs, lm_archs, recsys_archs
from .base import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ArchBundle,
                   MACEConfig, MoEConfig, RecsysConfig, SeineConfig,
                   ShapeConfig, TransformerConfig)
from .seine_letor import SEINE_LETOR, seine_smoke

_BUNDLES: Dict[str, ArchBundle] = {}
_BUNDLES.update(lm_archs.LM_BUNDLES)
_BUNDLES.update(gnn_archs.GNN_BUNDLES)
_BUNDLES.update(recsys_archs.RECSYS_BUNDLES)

ALL_ARCH_IDS = tuple(sorted(_BUNDLES))
LM_ARCH_IDS = tuple(sorted(lm_archs.LM_CONFIGS))


def get_bundle(arch_id: str) -> ArchBundle:
    if arch_id not in _BUNDLES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCH_IDS}")
    return _BUNDLES[arch_id]


def get_lm_config(name: str) -> TransformerConfig:
    if name not in lm_archs.LM_CONFIGS:
        raise KeyError(f"unknown LM arch {name!r}; known: {LM_ARCH_IDS}")
    return lm_archs.LM_CONFIGS[name]


def smoke(arch_id: str):
    b = get_bundle(arch_id)
    if b.domain == "lm":
        return lm_archs.smoke_config(get_lm_config(arch_id))
    if b.domain == "gnn":
        return gnn_archs.smoke_config(b.config)
    if b.domain == "recsys":
        return recsys_archs.smoke_config(b.config)
    raise ValueError(b.domain)


def all_cells():
    """Yield every (arch_id, shape_name) cell of the grid."""
    for aid in ALL_ARCH_IDS:
        for s in get_bundle(aid).shapes:
            yield aid, s.name


__all__ = [
    "ALL_ARCH_IDS", "ArchBundle", "GNN_SHAPES", "LM_ARCH_IDS", "LM_SHAPES",
    "MACEConfig", "MoEConfig", "RECSYS_SHAPES", "RecsysConfig",
    "SEINE_LETOR", "SeineConfig", "ShapeConfig", "TransformerConfig",
    "all_cells", "get_bundle", "get_lm_config", "seine_smoke", "smoke",
]
