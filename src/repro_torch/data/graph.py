"""Graph data: synthetic generators and a CSR neighbour sampler (port of
``repro.data.graph``).  Host numpy, drawn from ``RandomState`` in the
reference's order, so one seed gives the reference's arrays bit for bit.

``NeighborSampler`` implements GraphSAGE-style fanout sampling (15-10 for
the ``minibatch_lg`` shape) over a CSR adjacency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class Graph:
    n_nodes: int
    senders: np.ndarray     # (E,)
    receivers: np.ndarray   # (E,)
    positions: Optional[np.ndarray] = None   # (N,3) for MACE
    species: Optional[np.ndarray] = None     # (N,)

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])


def random_graph(n_nodes: int, n_edges: int, *, seed: int = 0,
                 n_species: int = 16, pos_scale: float = 3.0) -> Graph:
    """Synthetic point-cloud graph with the given node / edge counts.

    Positions are a jittered cubic lattice (so edge lengths are bounded and
    physical); species hash from node index.
    """
    rng = np.random.RandomState(seed)
    side = int(np.ceil(n_nodes ** (1 / 3)))
    idx = np.arange(n_nodes)
    lattice = np.stack([idx % side, (idx // side) % side, idx // side**2], 1)
    positions = lattice * 1.5 + rng.uniform(-0.3, 0.3, (n_nodes, 3))
    senders = rng.randint(0, n_nodes, n_edges).astype(np.int32)
    # receivers near senders (local edges): neighbour in lattice
    offs = rng.randint(1, 4, n_edges)
    receivers = ((senders + offs) % n_nodes).astype(np.int32)
    species = (idx * 2654435761 % n_species).astype(np.int32)
    return Graph(n_nodes=n_nodes, senders=senders, receivers=receivers,
                 positions=positions.astype(np.float32), species=species)


def batched_molecules(n_graphs: int, nodes_per: int, edges_per: int, *,
                      seed: int = 0, n_species: int = 16
                      ) -> Dict[str, np.ndarray]:
    """Batch of small molecules flattened into one padded graph."""
    rng = np.random.RandomState(seed)
    N, E = n_graphs * nodes_per, n_graphs * edges_per
    positions = rng.normal(0, 1.5, (N, 3)).astype(np.float32)
    species = rng.randint(0, n_species, N).astype(np.int32)
    senders = np.empty(E, np.int32)
    receivers = np.empty(E, np.int32)
    for g in range(n_graphs):
        s = rng.randint(0, nodes_per, edges_per) + g * nodes_per
        r = rng.randint(0, nodes_per, edges_per) + g * nodes_per
        senders[g * edges_per:(g + 1) * edges_per] = s
        receivers[g * edges_per:(g + 1) * edges_per] = r
    graph_idx = np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32)
    return {"positions": positions, "species": species, "senders": senders,
            "receivers": receivers, "graph_idx": graph_idx}


class NeighborSampler:
    """Fanout neighbour sampling over CSR adjacency (GraphSAGE protocol)."""

    def __init__(self, graph: Graph):
        order = np.argsort(graph.senders, kind="stable")
        self.dst = graph.receivers[order]
        counts = np.bincount(graph.senders, minlength=graph.n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        self.n_nodes = graph.n_nodes

    def sample(self, seeds: np.ndarray, fanout: Tuple[int, ...], *,
               seed: int = 0) -> Dict[str, np.ndarray]:
        """Multi-hop sample.  Returns flat arrays with static shapes:
        ``nodes`` (n_sub,), ``senders`` / ``receivers`` (n_sub_edges,)
        local ids, ``edge_mask`` and ``seed_local``.  A node with no
        neighbour takes itself f times (masked by ``edge_mask``)."""
        rng = np.random.RandomState(seed)
        layers = [np.asarray(seeds, np.int64)]
        edges_s, edges_r, edge_mask = [], [], []
        frontier = layers[0]
        for f in fanout:
            nf = frontier.shape[0]
            lo = self.indptr[frontier]
            hi = self.indptr[frontier + 1]
            deg = (hi - lo)
            # sample f neighbours per frontier node (with replacement)
            r = rng.randint(0, np.maximum(deg, 1)[:, None], size=(nf, f))
            nbr = self.dst[(lo[:, None] + r).clip(0, self.dst.size - 1)]
            valid = (deg > 0)[:, None] & np.ones((nf, f), bool)
            nbr = np.where(valid, nbr, frontier[:, None])
            edges_s.append(nbr.reshape(-1))
            edges_r.append(np.repeat(frontier, f))
            edge_mask.append(valid.reshape(-1))
            layers.append(nbr.reshape(-1))
            frontier = layers[-1]
        uniq = np.unique(np.concatenate(layers))
        senders = np.concatenate(edges_s)
        receivers = np.concatenate(edges_r)
        # map global -> local via searchsorted on uniq
        return {
            "nodes": uniq.astype(np.int64),
            "senders": np.searchsorted(uniq, senders).astype(np.int32),
            "receivers": np.searchsorted(uniq, receivers).astype(np.int32),
            "edge_mask": np.concatenate(edge_mask),
            "seed_local": np.searchsorted(uniq, np.asarray(seeds)).astype(
                np.int32),
        }


def subgraph_shape(batch_nodes: int, fanout: Tuple[int, ...]
                   ) -> Tuple[int, int]:
    """Static (n_nodes, n_edges) upper bound of a fanout sample."""
    n, e = batch_nodes, 0
    frontier = batch_nodes
    for f in fanout:
        e += frontier * f
        frontier *= f
        n += frontier
    return n, e
