"""The GNN architecture, MACE [arXiv:2206.07697], at its published dims
(copy of ``repro.configs.gnn_archs``)."""
from __future__ import annotations

import dataclasses

from .base import GNN_SHAPES, ArchBundle, MACEConfig

MACE = MACEConfig(
    name="mace", n_layers=2, d_hidden=128, l_max=2, correlation_order=3,
    n_rbf=8, n_species=16, r_cut=5.0, d_readout=64,
    source="arXiv:2206.07697",
)

GNN_BUNDLES = {
    "mace": ArchBundle(arch_id="mace", config=MACE, shapes=GNN_SHAPES,
                       domain="gnn"),
}


def smoke_config(cfg: MACEConfig) -> MACEConfig:
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=2, d_hidden=16, l_max=2,
        correlation_order=2, n_rbf=4, n_species=4, d_readout=8,
    )
