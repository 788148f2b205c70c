"""Decoder-only transformer LM, dense GQA and MoE (port of
``repro.models.transformer``: ``init_params``, the capacity-dispatch
``moe_ffn``, ``forward``, ``prefill``, the losses ``chunked_ce_loss``
and ``lm_loss``, and the KV-cache decode ``init_cache`` /
``decode_step``).

The reference scans stacked layers under remat for pod-scale SPMD; the
port keeps the stacked parameter layout (so a JAX pytree carries across
name for name, see ``convert.lm_params_from_numpy``) and runs a plain
loop over layers, each under ``torch.utils.checkpoint`` when it is
differentiated (``remat``, the reference's ``jax.checkpoint`` of the
scanned body).  Attention goes through ``kernels.flash_attn``: the
hand-written CUDA kernels for CUDA tensors (forward, and backward when a
gradient is taken), their plain versions on the CPU (where the
reference uses its chunked jnp stand-in and differentiates it).  The bf16 forward
rounds where the reference does: ``rms_norm``, RoPE and attention
compute in float32 and cast back; the residual adds and
``silu(gate) * up`` run in the working dtype.  The MoE router is
float32 in every model, as the reference's.

A decode step attends over the cache through ``layers.gqa_attention``
(the reference's jnp path: the flash kernel takes no valid lengths).
``prefill_cache`` fills a cache from a prompt in one forward; the
reference has no such entry and decodes a prompt token by token.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..configs.base import TransformerConfig
from ..core.index import gather_clip
from ..kernels.flash_attn import flash_attention
from ..kernels.utils import resolve_device
from .layers import apply_rope, dense_init, gqa_attention, rms_norm, softmax

Params = Dict[str, Any]
Attention = Callable[..., torch.Tensor]
# parameters kept in float32 whatever the model's dtype
F32_PARAMS = ("layers.router",)


def _dt(cfg: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param_dtype(cfg: TransformerConfig, name: str) -> torch.dtype:
    """The dtype of parameter ``name`` (a key of :func:`param_specs`)."""
    return torch.float32 if name in F32_PARAMS else _dt(cfg)


def param_specs(cfg: TransformerConfig) -> Dict[str, Tuple[tuple,
                                                           Optional[float]]]:
    """``{"embed": (shape, scale), "layers.wq": ...}`` for every
    parameter: the init's N(0, scale^2) draw, or ``None`` for the RMSNorm
    scales (ones).  Layer weights are stacked over L, expert weights
    over (L, E), as in the reference's pytree."""
    n_l, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    specs = {
        "embed": ((cfg.vocab_size, d), 0.02),
        "layers.ln1": ((n_l, d), None),
        "layers.ln2": ((n_l, d), None),
        "layers.wq": ((n_l, d, hq), 1.0 / math.sqrt(d)),
        "layers.wk": ((n_l, d, hkv), 1.0 / math.sqrt(d)),
        "layers.wv": ((n_l, d, hkv), 1.0 / math.sqrt(d)),
        "layers.wo": ((n_l, hq, d), 1.0 / math.sqrt(hq * n_l)),
    }
    if cfg.moe is None:
        f = cfg.d_ff
        specs.update({
            "layers.w_gate": ((n_l, d, f), 1.0 / math.sqrt(d)),
            "layers.w_up": ((n_l, d, f), 1.0 / math.sqrt(d)),
            "layers.w_down": ((n_l, f, d), 1.0 / math.sqrt(f * n_l)),
        })
    else:
        e, fe = cfg.moe.n_experts, cfg.moe.d_expert
        specs.update({
            "layers.router": ((n_l, d, e), 1.0 / math.sqrt(d)),
            "layers.we_gate": ((n_l, e, d, fe), 1.0 / math.sqrt(d)),
            "layers.we_up": ((n_l, e, d, fe), 1.0 / math.sqrt(d)),
            "layers.we_down": ((n_l, e, fe, d), 1.0 / math.sqrt(fe * n_l)),
        })
        if cfg.moe.n_shared_experts:
            fs = cfg.moe.n_shared_experts * fe
            specs.update({
                "layers.ws_gate": ((n_l, d, fs), 1.0 / math.sqrt(d)),
                "layers.ws_up": ((n_l, d, fs), 1.0 / math.sqrt(d)),
                "layers.ws_down": ((n_l, fs, d), 1.0 / math.sqrt(fs * n_l)),
            })
    specs["final_norm"] = ((d,), None)
    if not cfg.tie_embeddings:
        specs["unembed"] = ((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    return specs


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """The reference's pytree ``{"embed", "layers": {name: (L, ...)},
    "final_norm", "unembed"}`` on ``device`` (default CUDA), with its
    shapes, scales and dtypes (:func:`param_dtype`), drawn in float32
    from ``generator`` (default: seeded with 0, on ``device``) one layer
    at a time and cast.  A generator on the device draws a full-width
    model in about a second; one on the host takes minutes."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    params: Params = {"layers": {}}
    for name, (shape, scale) in param_specs(cfg).items():
        dt = param_dtype(cfg, name)
        if scale is None:
            t = torch.ones(shape, dtype=dt, device=dev)
        elif len(shape) >= 3:                 # stacked over the layers
            t = torch.stack([dense_init(gen, *shape[-2:], scale, dtype=dt,
                                        lead=shape[1:-2]).to(dev)
                             for _ in range(shape[0])])
        else:
            t = dense_init(gen, *shape, scale, dtype=dt).to(dev)
        if name.startswith("layers."):
            params["layers"][name[len("layers."):]] = t
        else:
            params[name] = t
    return params


def unembed_matrix(cfg: TransformerConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * (1 / (1 + exp(-x)))`` op by op in x's dtype: the reference's
    ``jax.nn.silu``, which in bf16 rounds after every op (one fused
    ``F.silu`` rounds once and parts from it by up to 2 bf16 ulps)."""
    return x * (1 / (1 + torch.exp(-x)))


def dense_ffn(x: torch.Tensor, lp: Params) -> torch.Tensor:
    from ..dist.dtensor import matmul
    h = silu(matmul(x, lp["w_gate"])) * matmul(x, lp["w_up"])
    return matmul(h, lp["w_down"])


# -- MoE dispatch (capacity-based; Switch/GShard token-drop semantics) ------

def moe_capacity(m_tokens: int, k: int, n_experts: int,
                 cf: float = 1.25) -> int:
    return max(1, int(math.ceil(m_tokens * k / n_experts * cf)))


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_slots(eid: torch.Tensor) -> torch.Tensor:
    """(G, N) expert ids -> (G, N) rank of each entry among the entries
    of its group with the same expert, in entry order: the reference's
    stable argsort by expert id, then the position inside each run."""
    n_g, n = eid.shape
    sorted_e, order = torch.sort(eid, dim=1, stable=True)
    idx = torch.arange(n, device=eid.device).expand(n_g, n)
    new_run = torch.ones_like(sorted_e, dtype=torch.bool)
    new_run[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=1).values
    return torch.empty_like(eid).scatter_(1, order, (idx - run_start)
                                          .to(eid.dtype))


class Routing(NamedTuple):
    """Where a group's (token, slot) pairs go: the renormalised top-k
    weights (G, M, K) float32, their experts ``eid`` and ranks ``pos``
    among the group's pairs of that expert (both (G, M * K), token-major),
    the capacity C (a pair keeps a row iff ``pos < C``) and the aux
    loss."""
    topv: torch.Tensor
    eid: torch.Tensor
    pos: torch.Tensor
    cap: int
    aux: torch.Tensor


def moe_route(x: torch.Tensor, router: torch.Tensor, cfg: TransformerConfig,
              capacity_factor: Optional[float] = None) -> Routing:
    """The float32 router, top-k with its renormalisation by
    ``max(sum, 1e-9)``, the Switch aux loss on each token's first
    choice, and the slot ranks, for x: (G, M, D) token groups.  Under a
    mesh each rank routes its own groups (``dist.dtensor.group_split``:
    the top-k and the slot ranks' ``sort`` / ``cummax`` / ``scatter``
    are per group); the aux loss's two means over the groups are the
    ranks' partial sums, reduced."""
    from ..dist.dtensor import group_split, is_dtensor, matmul, on_local
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    probs = softmax(matmul(x.float(), router), -1)                 # (G,M,E)
    if not is_dtensor(probs):
        topv, eid, pos, me, ce_frac = _route(probs, cfg, capacity_factor)
    else:
        from torch.distributed.tensor import Partial, Replicate
        groups = group_split(probs)
        part = tuple(Partial() if p.is_shard() else p for p in groups)
        topv, eid, pos, me, ce_frac = on_local(
            _route, (probs,), groups, cfg, capacity_factor, probs.shape[0],
            out_placements=[groups] * 3 + [part] * 2)
        whole = (Replicate(),) * probs.device_mesh.ndim
        me, ce_frac = (t.redistribute(probs.device_mesh, whole)
                       for t in (me, ce_frac))
    aux = cfg.moe.router_aux_coef * cfg.moe.n_experts * torch.sum(
        me * ce_frac)
    return Routing(topv, eid, pos, moe_capacity(
        probs.shape[1], cfg.moe.top_k, cfg.moe.n_experts, capacity_factor),
        aux)


def _route(probs: torch.Tensor, cfg: TransformerConfig,
           capacity_factor: float, n_groups: Optional[int] = None) -> Tuple:
    """(topv, eid, pos, mean probability, first-choice fraction) of
    ``probs`` (G, M, E); the two means scaled by G / ``n_groups`` (the
    groups of all ranks), so that their sum over the ranks is the mean
    over all groups."""
    n_g, n_m, _ = probs.shape
    n_e, k = cfg.moe.n_experts, cfg.moe.top_k
    topv, topi = top_k(probs, k)                                   # (G,M,K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    # one_hot(topi[..., 0]), without one_hot's range check (a host sync)
    first = topi[..., :1] == torch.arange(n_e, device=probs.device)
    ce_frac = first.float().mean(dim=(0, 1))
    if n_groups is not None and n_groups != n_g:
        me, ce_frac = me * (n_g / n_groups), ce_frac * (n_g / n_groups)
    eid = topi.reshape(n_g, n_m * k)
    return topv, eid, moe_slots(eid), me, ce_frac


def _dispatch(x: torch.Tensor, eid: torch.Tensor, pos: torch.Tensor,
              cap: int, n_e: int, k: int, window: Optional[Tuple] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The expert-major dispatch buffer (E, G * C, D) of x (G, M, D),
    each kept (token, slot) pair's buffer row and its keep mask.  With
    ``window`` (e0, e1, r0, r1) the buffer holds experts [e0, e1) and
    rows [r0, r1) of each expert's G * C alone; the pairs' rows keep the
    whole buffer's numbering."""
    n_g, n_m, d = x.shape
    dev = x.device
    kept = pos < cap
    g_idx = torch.arange(n_g, device=dev)[:, None]
    # buffer row of each kept (token, slot): (e * G + g) * C + pos
    row = (eid * n_g + g_idx) * cap + pos.clamp(max=cap - 1)
    if window is None:
        e0, e1, r0, r1 = 0, n_e, 0, n_g * cap
        inside, at = kept, row
    else:
        e0, e1, r0, r1 = window
        gc = g_idx * cap + pos.clamp(max=cap - 1)
        inside = kept & (eid >= e0) & (eid < e1) & (gc >= r0) & (gc < r1)
        at = (eid - e0) * (r1 - r0) + gc - r0
    n_rows = (e1 - e0) * (r1 - r0)
    # the token each buffer row holds; n_g * n_m (a zero row) if none
    tok = (g_idx * n_m + torch.arange(n_m * k, device=dev) // k)
    holder = torch.full((n_rows + 1,), n_g * n_m, dtype=torch.long,
                        device=dev)
    holder.index_put_((torch.where(inside, at, n_rows).flatten(),),
                      tok.flatten())
    xz = torch.cat([x.reshape(n_g * n_m, d), x.new_zeros(1, d)])
    return xz[holder[:-1]].reshape(e1 - e0, r1 - r0, d), row, kept


def _dispatch_window(x, rows: tuple, shape: Tuple[int, ...],
                     layout: Tuple) -> Tuple[tuple, Optional[Tuple]]:
    """(the placements this rank's dispatch buffer is built in, its
    ``_dispatch`` window) for the whole buffer ``shape`` (E, G * C, D):
    the layout's placements (``layers.constrain_placements``) where they
    keep every split of the groups' rows (``rows``) and split further
    only inside a rank's groups, so each rank builds just its part of
    the pinned buffer (the window: its experts and rows, None when that
    is all of its groups' buffer); ``rows`` otherwise."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_part
    from .layers import constrain_placements
    mesh = x.device_mesh
    want = constrain_placements(shape, mesh, *layout)
    if want is None:
        return rows, None
    want = tuple(want)
    last_rows = max((i for i, p in enumerate(rows) if p.is_shard()),
                    default=-1)
    for i, (r, w) in enumerate(zip(rows, want)):
        if r.is_shard() and w != r:
            return rows, None
        if not r.is_shard() and w.is_shard() and (
                w.dim == 2 or (w.dim == 1 and i < last_rows)):
            return rows, None
    if want == rows:
        return rows, None
    size, at = local_part(shape, mesh, want)
    _, base = local_part(shape, mesh, rows)
    r0 = at[1] - base[1]
    return want, (at[0], at[0] + size[0], r0, r0 + size[1])


def _combine(y: torch.Tensor, row: torch.Tensor, kept: torch.Tensor,
             topv: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's kept expert outputs (rows of y (E, G * C, D)),
    weighted by its top-k weights and summed: (G, M, D)."""
    n_g = row.shape[0]
    y = y.reshape(-1, y.shape[-1])
    back = torch.where(kept[..., None], y[row], 0).reshape(
        n_g, row.shape[1] // k, k, y.shape[-1])
    return (back * topv[..., None].to(y.dtype)).sum(dim=2)


def _dispatch_layout(n_e: int, batch_axes: str) -> Tuple:
    """The reference's three (G, E, C, D) dispatch-buffer layouts on the
    port's expert-major (E, G * C, D) buffer: experts over ``model`` and
    groups over the batch axes (expert-parallel, when E divides
    ``model``); groups over the batch axes and capacity rows over
    ``model`` (tensor-parallel within an expert); groups over every axis
    (FSDP, ``batch_axes="__all__"``)."""
    from ..launch.mesh import current_mesh
    mesh = current_mesh()
    n_model = (dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
               if mesh is not None else 1)
    if batch_axes != "__data__":
        return (None, "__all__", None)
    if n_e % n_model == 0:
        return ("model", "__data__", None)
    names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
    return (None, tuple(a for a in ("pod", "data", "model")
                        if a in names) or None, None)


def moe_ffn(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
            capacity_factor: Optional[float] = None,
            batch_axes: str = "__data__"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (G, M, D) token groups -> (out (G, M, D), aux loss).

    Each group routes its M tokens to their top-k experts
    (:func:`moe_route`); a (token, slot) pair takes the next of the
    expert's C rows in the group and is dropped when none is left (its
    output is zero).  The dispatch buffer is gathered expert-major,
    (E, G * C, D), so the expert SwiGLU is three batched products over
    E; the reference scatters a (G, E, C, D) buffer with the same
    rows.  The routing, the dispatch into the buffer and the combine
    back run under ``torch.profiler`` ranges (``moe.route``,
    ``moe.dispatch``, ``moe.combine``), so a profile attributes their
    device time.

    Under a mesh (DTensor x) each rank routes and dispatches its own
    groups (``dist.dtensor.group_split``; any other split of x is
    gathered first): the whole buffer's dimension 1 is split as x's
    groups are.  The buffer's layout is the one :func:`_dispatch_layout`
    picks for ``batch_axes`` ("__data__" under tensor parallelism,
    "__all__" under FSDP), and each rank builds only its part of it
    (:func:`_dispatch_window`: its experts under expert parallelism, its
    rows within an expert), so no rank holds the whole batch's buffer;
    the expert products' outputs are pinned to the same layout, go back
    to the groups' split, each rank combines its own groups, and the
    result takes x's split."""
    from ..dist.dtensor import (group_split, is_dtensor, like, matmul,
                                on_local)
    from .layers import maybe_constrain
    n_e, k = cfg.moe.n_experts, cfg.moe.top_k
    layout = _dispatch_layout(n_e, batch_axes)
    pin = lambda t: maybe_constrain(t, *layout)
    with record_function("moe.route"):
        r = moe_route(x, lp["router"], cfg, capacity_factor)
    groups = group_split(x) if is_dtensor(x) else None
    if groups is not None:
        from torch.distributed.tensor import Shard
        rows = tuple(Shard(1) if p.is_shard() else p for p in groups)
        built, window = _dispatch_window(
            x, rows, (n_e, x.shape[0] * r.cap, x.shape[-1]), layout)
    with record_function("moe.dispatch"):
        if groups is None:
            buf, row, kept = _dispatch(x, r.eid, r.pos, r.cap, n_e, k)
        else:
            buf, row, kept = on_local(
                _dispatch, (x, r.eid, r.pos), groups, r.cap, n_e, k,
                window, out_placements=[built, groups, groups])
        buf = pin(buf)                                             # (E,GC,D)
    h = pin(silu(torch.bmm(buf, lp["we_gate"]))
            * torch.bmm(buf, lp["we_up"]))
    y = pin(torch.bmm(h, lp["we_down"]))
    with record_function("moe.combine"):
        if groups is None:
            out = _combine(y, row, kept, r.topv, k)
        else:
            out = like(on_local(_combine, (y, row, kept, r.topv),
                                [rows, groups, groups, groups], k,
                                out_placements=groups), x)

    if cfg.moe.n_shared_experts:
        hs = silu(matmul(x, lp["ws_gate"])) * matmul(x, lp["ws_up"])
        out = out + matmul(hs, lp["ws_down"])
    return out, r.aux


def _ffn(h: torch.Tensor, lp: Params, cfg: TransformerConfig,
         moe_batch_axes: str = "__data__"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe is None:
        return dense_ffn(h, lp), torch.zeros((), device=h.device)
    return moe_ffn(h, lp, cfg, batch_axes=moe_batch_axes)


# -- transformer block -------------------------------------------------------

def split_heads(t: torch.Tensor, n_h: int) -> torch.Tensor:
    """(..., n_h * hd) -> (..., n_h, hd).  A DTensor keeps a split of the
    last dimension as a split of the heads where it divides them
    (``dist.dtensor``: gathered otherwise) and reshapes each rank's
    part."""
    from ..dist.dtensor import divisible, reshape_local
    hd = t.shape[-1] // n_h
    t = divisible(t, -1, n_h)
    last = t.ndim - 1
    return reshape_local(lambda u: u.reshape(*u.shape[:-1], -1, hd), t,
                         {d: d for d in range(last + 1)})


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n_h, hd) -> (..., n_h * hd), a split of the heads kept."""
    from ..dist.dtensor import reshape_local
    return reshape_local(lambda u: u.reshape(*u.shape[:-2], -1), t,
                         {d: d for d in range(t.ndim - 1)})


def block(x: torch.Tensor, lp: Params, cfg: TransformerConfig, *,
          positions: torch.Tensor, attention: Attention = flash_attention,
          kv_out: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
          moe_batch_axes: str = "__data__"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block.  x: (B, S, D) -> (x, MoE aux loss).  When
    ``kv_out`` is a list, the block's roped k and v are appended to it.
    ``moe_batch_axes`` as in :func:`moe_ffn`."""
    from ..dist.dtensor import matmul
    n_b, n_s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = split_heads(matmul(h, lp["wq"]), hq)
    k = split_heads(matmul(h, lp["wk"]), hkv)
    v = split_heads(matmul(h, lp["wv"]), hkv)
    del h
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_out is not None:
        kv_out.append((k, v))
    o = attention(q, k, v, causal=True)
    # drop the frame's references before the FFN's wide temporaries (a
    # 32k-token prefill holds 16 GB in them); autograd keeps what it saved
    del q, k, v
    x = x + matmul(merge_heads(o), lp["wo"])
    del o
    y, aux = _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg,
                  moe_batch_axes)
    return x + y, aux


def gathered_block(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
                   **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`block` under FSDP: the layer's weights gathered whole
    (``maybe_replicate``) inside the body, so a remat'd layer gathers
    them again when it is recomputed; the expert weights ``we_*`` keep
    their expert split (gathering them moves E x the bytes of the tokens
    they process), and the MoE dispatch runs batch-parallel over every
    axis."""
    from .layers import maybe_replicate
    lp = {name: t if name.startswith("we_") else maybe_replicate(t)
          for name, t in lp.items()}
    return block(x, lp, cfg, moe_batch_axes="__all__", **kw)


def _layers(params: Params) -> List[Params]:
    """Each layer's weights as views of the stacked (L, ...) leaves, from
    one ``torch.unbind`` per leaf: its backward stacks the L layers'
    gradients once, where indexing ``t[i]`` per layer would build a
    full-size zero gradient for every layer and sum L of them."""
    per = {name: torch.unbind(t) for name, t in params["layers"].items()}
    n_l = len(next(iter(per.values())))
    return [{name: u[i] for name, u in per.items()} for i in range(n_l)]


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            *, attention: Attention = flash_attention,
            kv_out: Optional[list] = None, remat: bool = True,
            gather_layer_weights: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (final hidden (B, S, D), summed MoE aux loss).
    The embedding gather is the reference's ``mode="clip"`` one: an id
    past the vocabulary reads the last row, a negative id wraps first
    (``LMProvider`` clamps its pads to 0 before, as the reference's
    does).  A MoE model routes each row of the batch as its own group
    of S tokens, as the reference does.

    ``remat``: when autograd records the forward (a layer weight needs a
    gradient), each layer runs under ``torch.utils.checkpoint`` (not
    re-entrant), which keeps only its input and recomputes the layer in
    the backward, as the reference's ``jax.checkpoint`` of the scanned
    body; the values are the same.  Without gradients, and with
    ``kv_out`` (which the recompute would append to again), layers run
    as they are.

    ``gather_layer_weights``: FSDP, each layer through
    :func:`gathered_block` (a no-op without a current mesh)."""
    n_b, n_s = tokens.shape
    x = gather_clip(params["embed"], tokens)                     # (B, S, D)
    positions = torch.arange(n_s, device=x.device)[None].expand(n_b, n_s)
    aux = torch.zeros((), device=x.device)
    layers = _layers(params)
    remat = remat and kv_out is None and torch.is_grad_enabled() and any(
        t.requires_grad for t in params["layers"].values())
    body = gathered_block if gather_layer_weights else block
    for lp in layers:
        if remat:
            x, a = checkpoint(body, x, lp, cfg, positions=positions,
                              attention=attention, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = body(x, lp, cfg, positions=positions,
                        attention=attention, kv_out=kv_out)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def logits_of(params: Params, hidden: torch.Tensor,
              cfg: TransformerConfig) -> torch.Tensor:
    """Float32 logits of hidden states (..., D) -> (..., V)."""
    return hidden.float() @ unembed_matrix(cfg, params).float()


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            *, attention: Attention = flash_attention) -> torch.Tensor:
    """Full-prompt forward; returns next-token logits (B, V) in float32."""
    hidden, _ = forward(params, tokens, cfg, attention=attention)
    return logits_of(params, hidden[:, -1], cfg)


# -- losses -------------------------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) summed and returned in float32.  On CUDA, bf16
    operands stay bf16 on the tensor cores (``out_dtype``); otherwise
    both are widened to float32, which for bf16 values is the same
    product (the reference's ``preferred_element_type=float32``).

    DTensor operands (under a mesh, where ``out_dtype`` has no sharding
    rule) multiply on each rank's local parts: a's rows and b's columns
    keep their splits, the contracted dimension is gathered, and the
    product is split as they were."""
    from ..dist.dtensor import any_dtensor, matmul
    if any_dtensor(a, b):
        return matmul(a, b, _mm_f32)
    if a.is_cuda and torch.bfloat16 in (a.dtype, b.dtype):
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16),
                        out_dtype=torch.float32)
    return a.float() @ b.float()


class _LogitsF32(torch.autograd.Function):
    """Float32 logits ``h @ w`` of a chunk's hidden states h (N, D)
    against the unembedding w (D, V), with its gradients; a float32 dL /
    dlogits meets bf16 operands on the card as bf16 (the tensor cores'
    type), and in float32 everywhere else."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_f32(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        return (_mm_f32(g, w.T).to(h.dtype), _mm_f32(h.T, g).to(w.dtype))


def _gold(logits: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """``logits[..., lab]``.  Under a mesh the logits may be split over
    the vocabulary (tensor parallelism), where a gather has no sharding
    rule that holds: the gold logit is then the sum over the vocabulary
    of the logits where the label is, which each rank sums over its own
    part of the vocabulary (exact: one term is not zero)."""
    from ..dist.dtensor import is_dtensor
    if is_dtensor(logits):
        hit = lab[..., None] == torch.arange(logits.shape[-1],
                                             device=logits.device)
        return torch.where(hit, logits, 0.0).sum(-1)
    return torch.gather(logits, -1, lab[..., None])[..., 0]


def chunked_ce_loss(hidden: torch.Tensor, labels: torch.Tensor,
                    unembed: torch.Tensor, n_chunks: int = 8
                    ) -> torch.Tensor:
    """Mean cross-entropy without the (B, S, V) logits: hidden (B, S, D),
    labels (B, S) with -1 ignored, unembed (D, V).  The reference's
    chunking: ``n_chunks`` cut to S, then down to a divisor of S; per
    chunk of c positions the (B, c, V) float32 logits (bf16 operands,
    float32 sums), ``logsumexp`` minus the gold logit, summed over the
    valid positions with their count; the total over max(count, 1)."""
    from ..dist.dtensor import reshape_local, whole_dims
    # chunks are cut along, and flattened with, the sequence: a split of
    # it (FSDP's pod axis) is gathered first
    hidden, labels = whole_dims(hidden, (1,)), whole_dims(labels, (1,))
    n_b, n_s, d = hidden.shape
    n_chunks = min(n_chunks, n_s)
    while n_s % n_chunks:
        n_chunks -= 1
    c = n_s // n_chunks
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(n_chunks):
        h = reshape_local(lambda u: u.reshape(-1, d),
                          hidden[:, i * c:(i + 1) * c], {0: 0, 2: 1})
        lab = labels[:, i * c:(i + 1) * c].long()
        logits = reshape_local(lambda u: u.reshape(-1, c, u.shape[-1]),
                               _LogitsF32.apply(h, unembed), {0: 0, 1: 2})
        lse = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, lab.clamp(min=0))
        valid = (lab >= 0).float()
        tot = tot + torch.sum((lse - gold) * valid)
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, *, attention: Attention = flash_attention,
            ce_chunks: int = 8, remat: bool = True,
            gather_layer_weights: bool = False) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S), -1 ignored) plus the MoE aux loss, as the reference's.  Its
    ``attn_chunk`` sizes the jnp attention's KV chunks; the kernels tile
    by themselves.  ``gather_layer_weights`` as in :func:`forward`."""
    hidden, aux = forward(params, batch["tokens"], cfg, attention=attention,
                          remat=remat,
                          gather_layer_weights=gather_layer_weights)
    ce = chunked_ce_loss(hidden, batch["labels"],
                         unembed_matrix(cfg, params), n_chunks=ce_chunks)
    return ce + aux


# -- KV-cache decode ----------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (L, B, S, Hkv, hd)
    v: torch.Tensor       # (L, B, S, Hkv, hd)
    length: torch.Tensor  # (B,) int32 valid lengths


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None, device=None) -> KVCache:
    """An empty cache of ``max_len`` positions on ``device`` (default
    CUDA), in ``dtype`` (default the model's)."""
    dev = resolve_device(device)
    dt = dtype or _dt(cfg)
    sh = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(sh, dtype=dt, device=dev),
                   torch.zeros(sh, dtype=dt, device=dev),
                   torch.zeros((batch,), dtype=torch.int32, device=dev))


def _write_at(cache: torch.Tensor, rows: torch.Tensor, at: torch.Tensor,
              new: torch.Tensor) -> None:
    """cache[b, at[b]] = new[b] in place, a row with ``at`` past the
    cache left as it is (the reference's scatter drops it).  A placed
    cache (a DTensor) writes on each rank's slice
    (``dist.sp_decode.placed_write_at``)."""
    from ..dist.dtensor import is_dtensor
    if is_dtensor(cache):
        from ..dist.sp_decode import placed_write_at
        return placed_write_at(cache, at, new)
    n_s = cache.shape[1]
    pos = at.long().clamp(max=n_s - 1)
    fits = (at < n_s)[:, None, None]
    cache[rows, pos] = torch.where(fits, new.to(cache.dtype),
                                   cache[rows, pos])


def decode_step(params: Params, cache: KVCache, tokens: torch.Tensor,
                cfg: TransformerConfig) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step.  tokens: (B,) -> (logits (B, V) float32,
    the cache one longer).  Each row's k and v are written at its own
    ``length`` into ``cache``'s tensors, which the returned cache shares
    (the step updates the cache in place, as a donated buffer).

    A placed cache (DTensors, the sequence split over ``model`` as the
    reference's decode cell lays it out) writes each row on the rank
    that holds its position and attends by the log-sum-exp merge of the
    ranks' slices (``dist.sp_decode.placed_decode_attention``)."""
    from ..dist.dtensor import is_dtensor, matmul
    n_b = tokens.shape[0]
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    length = cache.length
    x = gather_clip(params["embed"], tokens)[:, None]              # (B,1,D)
    pos = length[:, None]                                          # (B,1)
    rows = torch.arange(n_b, device=x.device)
    chunk = min(cache.k.shape[2], 4096)
    for i, lp in enumerate(_layers(params)):
        kc, vc = cache.k[i], cache.v[i]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q = split_heads(matmul(h, lp["wq"]), hq)
        k = split_heads(matmul(h, lp["wk"]), hkv)
        v = split_heads(matmul(h, lp["wv"]), hkv)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        _write_at(kc, rows, length, k[:, 0])
        _write_at(vc, rows, length, v[:, 0])
        if is_dtensor(kc):
            from ..dist.sp_decode import placed_decode_attention
            o = placed_decode_attention(q[:, 0], kc, vc, length + 1)
            o = o.to(q.dtype)[:, None]
        else:
            o = gqa_attention(q, kc, vc, causal=False, chunk=chunk,
                              kv_valid_len=length + 1)
        x = x + matmul(merge_heads(o), lp["wo"])
        y, _ = _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(n_b, 1, d),
                    lp, cfg)
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_of(params, x[:, 0], cfg), KVCache(cache.k, cache.v,
                                                    length + 1)


def prefill_cache(params: Params, tokens: torch.Tensor,
                  cfg: TransformerConfig, max_len: int
                  ) -> Tuple[torch.Tensor, KVCache]:
    """A prompt of S tokens per row through one ``forward`` -> (its
    next-token logits (B, V) float32, a cache of ``max_len`` positions
    holding the prompt's k and v, every length S).  ``decode_step`` then
    continues from position S."""
    n_b, n_s = tokens.shape
    if max_len < n_s:
        raise ValueError(f"max_len {max_len} < prompt length {n_s}")
    kv: list = []
    hidden, _ = forward(params, tokens, cfg, kv_out=kv)
    cache = init_cache(cfg, n_b, max_len, device=tokens.device)
    for i, (k, v) in enumerate(kv):
        cache.k[i, :, :n_s] = k
        cache.v[i, :, :n_s] = v
    cache.length.fill_(n_s)
    return logits_of(params, hidden[:, -1], cfg), cache
