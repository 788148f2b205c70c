"""MACE — higher-order equivariant message passing [arXiv:2206.07697]
(port of ``repro.models.mace``).

The tensor products are in the Cartesian basis (scalar / vector /
symmetric-traceless rank-2, l = 0, 1, 2), so every Clebsch-Gordan
contraction is an einsum; the ACE product basis is built by successive
contractions up to the correlation order (3).  Message passing is an
edge-index gather and a segment sum.

The segment sum is ``index_put`` with ``accumulate=True``: on the card
it sorts the ids and sums each segment in order, so a step gives the
same bits every time (``index_add_`` adds with atomics, in whatever
order the threads arrive), which a resumed run needs; on the CPU it
adds with atomics across threads unless torch's deterministic mode is
on.  The forces are ``-dE/dpositions`` by ``torch.autograd.grad`` with
``create_graph`` when gradients are on, so ``mace_loss`` trains through
them: a gradient of a gradient.

Under a mesh (DTensor parameters or inputs) each rank runs its own
nodes and edges, as the reference pins its edge and node tensors over
every mesh axis (``maybe_constrain`` over ``"__all__"``): the batch's
rows split over every axis in blocks (``dist.collective.row_block``),
the parameters replicated.  A step gathers the positions once; a layer
mixes its local nodes' features and gathers them, computes its local
edges' messages (the ids are global), sums them into a zero buffer of
every node and reduce-scatters it to each rank's nodes (``A_s / A_v /
A_t`` split as the reference's pins); the product basis and the readout
run on the local nodes, and the per-graph energies are all-reduced once.
The collectives are ``dist.collective``'s autograd Functions, so the
forces (a gradient) and the loss's gradient of them cross nothing but
explicit local ops and those: no DTensor redistribution, through which
torch 2.11 drops the second derivative.  A parameter's gradient there is
this rank's partial sum (``to_local(grad_placements=Partial())``), which
``train.loop.value_and_grad`` sums once.  On one rank every collective
copies, so a 1 x 1 mesh gives the mesh-less bits.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .. import tree as T
from ..configs.base import MACEConfig
from ..dist.collective import (all_gather_rows, all_reduce_sum,
                               reduce_scatter_rows)
from ..kernels.utils import resolve_device
from .layers import dense_init, mlp_apply, mlp_init

Params = Dict[str, Any]
RADIAL = ("rad_ss", "rad_sv", "rad_st", "rad_vs", "rad_vv")
INPUTS = ("species", "positions", "senders", "receivers", "graph_idx")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op by op: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int
                ) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, num_segments=n)`` for ids in
    [0, n): rows of ``data`` summed by id, in a deterministic order."""
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_put((ids,), data, accumulate=True)


def sym_traceless(m: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the symmetric-traceless (l=2) subspace."""
    s = 0.5 * (m + m.transpose(-1, -2))
    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return s - tr * torch.eye(3, dtype=m.dtype, device=m.device) / 3.0


def bessel_rbf(r: torch.Tensor, n: int, r_cut: float) -> torch.Tensor:
    """Radial Bessel basis with polynomial cutoff (MACE/NequIP standard)."""
    r = torch.clamp(r, min=1e-9)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=r.device)
    basis = math.sqrt(2.0 / r_cut) * torch.sin(
        k * math.pi * r[..., None] / r_cut) / r[..., None]
    u = torch.clamp(r / r_cut, 0.0, 1.0)
    # p=6 polynomial envelope
    fc = 1 - 28 * u**6 + 48 * u**7 - 21 * u**8
    return basis * fc[..., None]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _n_basis(nu: int) -> Dict[str, int]:
    """Number of product-basis features per parity type for correlation nu."""
    # order-1: s,v,t each 1; order-2: s:3 v:2 t:3; order-3: s:3 v:3 t:2
    ns, nv, nt = 1, 1, 1
    if nu >= 2:
        ns, nv, nt = ns + 3, nv + 2, nt + 3
    if nu >= 3:
        ns, nv, nt = ns + 3, nv + 3, nt + 2
    return {"s": ns, "v": nv, "t": nt}


def param_shapes(cfg: MACEConfig) -> Params:
    """The parameter tree with each leaf's shape in place of the leaf."""
    C, R = cfg.d_hidden, cfg.n_rbf
    n_b = _n_basis(cfg.correlation_order)
    mlp = lambda dims: {"w": [(dims[i], dims[i + 1])
                              for i in range(len(dims) - 1)],
                        "b": [(dims[i + 1],) for i in range(len(dims) - 1)]}
    layer = {**{k: mlp((R, 32, C)) for k in RADIAL},
             "w_h": (C, C), "w_hv": (C, C), "mix_s": (n_b["s"] * C, C),
             "mix_v": (n_b["v"] * C, C), "mix_t": (n_b["t"] * C, C),
             "skip_s": (C, C), "readout": mlp((C, cfg.d_readout, 1))}
    return {"species_embed": (cfg.n_species, C),
            "layers": [layer for _ in range(cfg.n_layers)]}


def init_params(cfg: MACEConfig, gen: torch.Generator, device=None
                ) -> Params:
    """Weights drawn from ``gen`` on its device, returned on ``device``
    (default CUDA)."""
    C, R = cfg.d_hidden, cfg.n_rbf
    n_b = _n_basis(cfg.correlation_order)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            # radial MLPs: rbf -> per-channel weights for each message path
            **{k: mlp_init(gen, (R, 32, C)) for k in RADIAL},
            "w_h": dense_init(gen, C, C),          # sender scalar mix
            "w_hv": dense_init(gen, C, C),         # sender vector mix
            # product-basis channel mixers (one per parity type)
            "mix_s": dense_init(gen, n_b["s"] * C, C),
            "mix_v": dense_init(gen, n_b["v"] * C, C),
            "mix_t": dense_init(gen, n_b["t"] * C, C),
            "skip_s": dense_init(gen, C, C),
            "readout": mlp_init(gen, (C, cfg.d_readout, 1)),
        })
    tree = {"species_embed": dense_init(gen, cfg.n_species, C, scale=1.0),
            "layers": layers}
    dev = resolve_device(device)
    return T.tree_map(lambda t: t.to(dev), tree)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(p: Params, cfg: MACEConfig, **inputs) -> torch.Tensor:
    """Total energy per graph.

    species (N,), positions (N,3), senders/receivers (E,),
    graph_idx (N,), n_graphs -> energies (n_graphs,).  Under a mesh,
    each rank's nodes and edges, the energies whole on every rank
    (module doc).
    """
    part = _Placed.of(p, inputs)
    if part is None:
        return _forward(p, cfg, **inputs)
    return part.whole(_forward(part.params, cfg, **part.inputs,
                               **part.kw))


def _forward(p: Params, cfg: MACEConfig, *, species: torch.Tensor,
             positions: torch.Tensor, senders: torch.Tensor,
             receivers: torch.Tensor, graph_idx: torch.Tensor,
             n_graphs: int, group=None, n_nodes: int = 0) -> torch.Tensor:
    """The energies of the whole graph (``group`` None), or, over the
    ranks of ``group``, of the graph of ``n_nodes`` nodes whose block of
    node rows (``species``, ``positions``, ``graph_idx``) and of edges
    (``senders`` / ``receivers``, global ids) this rank holds."""
    n_here = species.shape[0]
    N = n_here if group is None else n_nodes
    C = cfg.d_hidden
    snd, rcv = senders.long(), receivers.long()
    # every node's rows from each rank's, and each rank's node sums from
    # every edge's; with no group the tensor itself
    gather = ((lambda t: t) if group is None
              else (lambda t: all_gather_rows(t, group, N)))
    scatter = ((lambda t: t) if group is None
               else (lambda t: reduce_scatter_rows(t, group)))

    # one_hot(species) @ species_embed: the row of each species
    h_s = p["species_embed"][species.long()]                      # (N,C)
    h_v = torch.zeros((n_here, C, 3), dtype=positions.dtype,
                      device=positions.device)

    pos = gather(positions)
    rel = pos[rcv] - pos[snd]                                     # (E,3)
    d2 = torch.sum(rel * rel, -1)
    # mask degenerate/self edges (grad of sqrt at 0 explodes in f32)
    valid = d2 > 1e-10
    d2 = torch.where(valid, d2, torch.ones_like(d2))
    dist = torch.sqrt(d2)
    rhat = rel / dist[:, None]
    y1 = rhat                                                     # (E,3)
    y2 = sym_traceless(rhat[:, :, None] * rhat[:, None, :])       # (E,3,3)
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.r_cut)                  # (E,R)
    rbf = rbf * valid[:, None]

    energies = torch.zeros((n_graphs,), dtype=positions.dtype,
                           device=positions.device)
    for lp in p["layers"]:
        rad = {k: mlp_apply(lp[k], rbf, act=silu) for k in RADIAL}
        hs_e = gather(h_s @ lp["w_h"])[snd]                       # (E,C)
        hv_e = gather(torch.einsum("ncj,cd->ndj", h_v,
                                   lp["w_hv"]))[snd]              # (E,C,3)

        # --- A-basis: radial x angular x sender features, summed over edges
        m_s = rad["rad_ss"] * hs_e \
            + rad["rad_vs"] * torch.einsum("ecj,ej->ec", hv_e, y1)
        m_v = rad["rad_sv"][..., None] * hs_e[..., None] * y1[:, None, :] \
            + rad["rad_vv"][..., None] * hv_e
        m_t = rad["rad_st"][..., None, None] * hs_e[..., None, None] \
            * y2[:, None]

        A_s = scatter(segment_sum(m_s, rcv, N))
        A_v = scatter(segment_sum(m_v, rcv, N))
        A_t = scatter(segment_sum(m_t, rcv, N))

        # --- ACE product basis by successive Cartesian contractions.  The
        # reference also concatenates the rank-2 features into B_t and
        # never reads it (h_t stays implicit, so mix_t's gradient is 0);
        # the port forms only sym(A_t A_t), which a vector feature reads.
        feats_s = [A_s]
        feats_v = [A_v]
        if cfg.correlation_order >= 2:
            vv = torch.einsum("ncj,ncj->nc", A_v, A_v)
            tt = torch.einsum("ncij,ncij->nc", A_t, A_t)
            tv = torch.einsum("ncij,ncj->nci", A_t, A_v)
            feats_s += [A_s * A_s, vv, tt]
            feats_v += [A_s[..., None] * A_v, tv]
        if cfg.correlation_order >= 3:
            t_tt = sym_traceless(torch.einsum("ncik,nckj->ncij", A_t, A_t))
            feats_s += [A_s * A_s * A_s,
                        vv * A_s,
                        torch.einsum("nci,nci->nc", tv, A_v)]     # v.T t v
            feats_v += [vv[..., None] * A_v,
                        A_s[..., None] * tv,
                        torch.einsum("ncij,ncj->nci", t_tt, A_v)]

        B_s = torch.cat(feats_s, dim=-1)                          # (N, nb_s*C)
        B_v = torch.cat(feats_v, dim=-2)                    # (N, nb_v*C, 3)

        h_s = B_s @ lp["mix_s"] + h_s @ lp["skip_s"]
        h_v = torch.einsum("nbj,bc->ncj", B_v, lp["mix_v"])
        node_e = mlp_apply(lp["readout"], h_s, act=silu)[:, 0]
        energies = energies + segment_sum(node_e, graph_idx.long(),
                                          n_graphs)
    return energies if group is None else all_reduce_sum(energies, group)


def energy_and_forces(p: Params, cfg: MACEConfig, **inputs):
    """(energies (n_graphs,), forces (N, 3) = -dE/dpositions).  With
    gradients on, the forces keep their graph, so a loss of them trains
    the parameters; under ``torch.no_grad`` they come back detached.
    Under a mesh the energies are whole on every rank and the forces
    split as the positions are."""
    keep = torch.is_grad_enabled()
    part = _Placed.of(p, inputs)
    if part is None:
        return _energy_and_forces(p, cfg, keep, **inputs)
    e, f = _energy_and_forces(part.params, cfg, keep, **part.inputs,
                              **part.kw)
    return part.whole(e), part.rows(f)


def _energy_and_forces(p, cfg, keep, **inputs):
    pos = inputs.pop("positions")
    with torch.enable_grad():
        if not pos.requires_grad:
            pos = pos.detach().requires_grad_(True)
        e = _forward(p, cfg, positions=pos, **inputs)
        (de,) = torch.autograd.grad(e.sum(), pos, create_graph=keep)
    return (e if keep else e.detach()), -de


def mace_loss(p: Params, cfg: MACEConfig, batch: Dict[str, torch.Tensor],
              n_graphs: int, force_weight: float = 10.0) -> torch.Tensor:
    """Energy + force matching loss (the standard MACE objective).
    Under a mesh, each rank's nodes and edges, the loss whole on every
    rank (module doc)."""
    part = _Placed.of(p, batch)
    if part is None:
        return _mace_loss(p, cfg, batch, n_graphs, force_weight)
    return part.whole(_mace_loss(part.params, cfg, part.inputs, n_graphs,
                                 force_weight, **part.kw))


def _mace_loss(p, cfg, batch, n_graphs, force_weight, **part):
    """The loss of the whole graph, or with ``part`` (``group``,
    ``n_nodes``: :func:`_forward`'s) of this rank's nodes and edges."""
    inputs = {k: batch[k] for k in INPUTS}
    e, f = _energy_and_forces(p, cfg, torch.is_grad_enabled(),
                              n_graphs=n_graphs, **inputs, **part)
    le = torch.mean(torch.square(e - batch["energy"]))
    sq = torch.sum(torch.square(f - batch["forces"]), -1)
    if not part:
        lf = torch.mean(sq)
    else:
        # this rank's share of the mean over every node: on one rank
        # torch.mean's bits (times 1.0)
        n = sq.shape[0]
        lf = all_reduce_sum(torch.mean(sq) * (n / part["n_nodes"]) if n
                            else sq.sum(), part["group"])
    return le + force_weight * lf


# inputs whole on every rank; every other input is split by rows
WHOLE = ("energy",)


class _Placed:
    """A call on DTensors as each rank's local parts: the parameters
    whole (``Replicate()``), their gradient this rank's partial sum; the
    inputs' rows split over every mesh axis (``Shard(0)`` on each), as
    ``launch.steps._mace_cell`` places them, ``energy`` whole.  A plain
    tensor among them is taken as the whole tensor, the same on every
    rank."""

    def __init__(self, mesh, params, inputs):
        from torch.distributed import get_rank
        from torch.distributed.tensor import Replicate, Shard

        from ..launch.mesh import axes_group, axes_rank
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        self.group = axes_group(mesh, names)
        if get_rank(self.group) != axes_rank(mesh, names):
            raise ValueError(f"{mesh}: the group over every axis does not "
                             f"rank its members in the mesh's order")
        self.rep = (Replicate(),) * mesh.ndim
        self.split = (Shard(0),) * mesh.ndim
        self.n_nodes = int(inputs["positions"].shape[0])
        self.params = T.tree_map(self._param, params)
        self.inputs = {k: self._input(k, v) if isinstance(v, torch.Tensor)
                       else v for k, v in inputs.items()}
        self.kw = dict(group=self.group, n_nodes=self.n_nodes)

    @staticmethod
    def of(params, inputs):
        """The local parts of a call whose parameters or inputs hold a
        DTensor, else None."""
        from ..dist.dtensor import is_dtensor
        for x in T.leaves(params) + list(inputs.values()):
            if is_dtensor(x):
                return _Placed(x.device_mesh, params, inputs)
        return None

    def _param(self, t):
        from torch.distributed.tensor import Partial
        return self._local(t, self.rep,
                           (Partial(),) * self.mesh.ndim)

    def _input(self, name, t):
        return self._local(t, self.rep if name in WHOLE else self.split)

    def _local(self, t, placements, grad_placements=None):
        """This rank's part of ``t`` placed as ``placements`` (a plain
        ``t`` taken as whole: its rows split with no collective)."""
        from torch.distributed.tensor import DTensor
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, self.mesh, self.rep, run_check=False)
        if tuple(t.placements) != placements:
            t = t.redistribute(self.mesh, placements)
        return t.to_local(grad_placements=grad_placements)

    def whole(self, t):
        """A value whole on every rank as a replicated DTensor."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, self.rep, run_check=False)

    def rows(self, t):
        """This rank's node rows as a DTensor split as the positions."""
        from torch.distributed.tensor import DTensor
        shape = (self.n_nodes,) + tuple(t.shape[1:])
        return DTensor.from_local(t, self.mesh, self.split, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
