"""The layer helpers of the retrievers, the LM, the recsys models and MACE
(port of ``repro.models.layers``: the init helpers, ``mlp_apply``,
``rms_norm``, ``layer_norm``, RoPE, the attention functions and the mesh
hints ``maybe_constrain`` / ``maybe_replicate``), and ``softmax``,
rounded as ``jax.nn.softmax``.

A scorer's parameters live in :class:`ParamTree`, an ``nn.Module``
holding the same nested dict/list structure as the reference's parameter
pytrees and indexed like it (``params["mlp"]["w"][0]``), so each scorer
reads like its JAX original and ``convert.params_from_jax`` maps a JAX
tree onto it name for name; the LM keeps a plain dict of tensors
(``models.transformer``).  Inits draw from an explicit
``torch.Generator`` on its own device: ``jax.random`` streams cannot be
reproduced in torch, so parity tests carry the JAX parameters across.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def _resolve_axis(a, names: Tuple[str, ...]):
    if a is None:
        return None
    if a == "__data__":
        return tuple(n for n in ("pod", "data") if n in names) or None
    if a == "__all__":
        return names or None
    if isinstance(a, tuple):
        return tuple(n for n in a if n in names) or None
    return a if a in names else None


def maybe_constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` redistributed to the layout ``axes`` name (one entry a
    dimension: a mesh axis, a tuple of them, None, or the pseudo-axes
    ``"__data__"``, every batch axis present, and ``"__all__"``, every
    axis) when a mesh is current (``launch.mesh.set_mesh``) and ``x`` is
    a DTensor; otherwise ``x`` itself.  An axis tuple that does not
    divide its dimension is shrunk from the left ('pod' before
    'data'/'model'), and dropped only when nothing divides; when every
    entry is dropped ``x`` comes back as it is.  Mesh axes no entry
    names are replicated, as under ``with_sharding_constraint``."""
    from ..dist.dtensor import is_dtensor
    from ..launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    placements = constrain_placements(tuple(x.shape), mesh, *axes)
    if placements is None:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_placements(shape: Tuple[int, ...], mesh, *axes):
    """The placements :func:`maybe_constrain` gives a tensor of ``shape``
    on ``mesh`` for the layout ``axes``, or None when every entry is
    dropped."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    spec = [_resolve_axis(a, names) for a in axes]
    for i, s in enumerate(spec):
        if s is None:
            continue
        keep = list(s if isinstance(s, tuple) else (s,))
        while keep and shape[i] % math.prod(sizes[a] for a in keep):
            keep.pop(0)
        spec[i] = tuple(keep) or None
    if all(s is None for s in spec):
        return None
    placements = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        for a in s or ():
            placements[names.index(a)] = Shard(d)
    return placements


def maybe_replicate(x: torch.Tensor) -> torch.Tensor:
    """``x`` gathered to ``Replicate()`` on every mesh dimension when a
    mesh is current and ``x`` is a DTensor; otherwise ``x`` itself.
    Under FSDP a layer's weights go through it inside the (remat'd)
    layer body, so each layer gathers its weights in the forward and
    again in the recomputation, and the backward of the gather is the
    gradient's reduce-scatter."""
    from ..dist.dtensor import is_dtensor, replicate_all
    from ..launch.mesh import current_mesh
    if current_mesh() is None or not is_dtensor(x):
        return x
    return replicate_all(x)


class ParamTree(nn.Module):
    """A nested dict of tensors, lists of tensors and lists of dicts as
    an ``nn.Module``, read with ``tree[name]`` like the JAX pytree."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            elif isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif all(isinstance(x, torch.Tensor) for x in v):
                self.add_module(name, nn.ParameterList(v))
            else:
                self.add_module(name, nn.ModuleList(ParamTree(x) for x in v))

    def __getitem__(self, name: str):
        return getattr(self, name)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, *,
               dtype: torch.dtype = torch.float32,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, scale^2) of shape (*lead, d_in, d_out), scale 1/sqrt(d_in) by
    default, drawn in float32 on the generator's device, then cast to
    ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn(*lead, d_in, d_out, generator=gen, device=gen.device)
            * scale).to(dtype)


def embed_init(gen: torch.Generator, n: int, d: int, *,
               dtype: torch.dtype = torch.float32,
               scale: float = 0.02) -> torch.Tensor:
    """An (n, d) N(0, scale^2) table, drawn in float32 on the generator's
    device, then cast to ``dtype``."""
    return (torch.randn(n, d, generator=gen, device=gen.device)
            * scale).to(dtype)


def mlp_init(gen: torch.Generator, dims: Tuple[int, ...]) -> dict:
    """Plain MLP parameter stack: dims = (d0, d1, ..., dn)."""
    return {
        "w": [dense_init(gen, dims[i], dims[i + 1])
              for i in range(len(dims) - 1)],
        "b": [torch.zeros(dims[i + 1]) for i in range(len(dims) - 1)],
    }


def mlp_apply(p, x: torch.Tensor, act=torch.relu, final_act=None
              ) -> torch.Tensor:
    n = len(p["w"])
    for i in range(n):
        x = x @ p["w"][i] + p["b"][i]
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x



class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` rounded as the reference rounds it: ``exp(x -
    max)`` divided by its sum (``torch.softmax`` multiplies by the sum's
    reciprocal), and as gradient the transpose of its custom JVP,
    ``y * g - y * sum(y * g)`` (``torch.softmax``'s backward forms ``y *
    (g - sum(y * g))``).  Where a gradient is zero in exact arithmetic,
    the two forms leave different rounding noise, which Adam turns into
    steps of different size."""

    @staticmethod
    def forward(ctx, x, dim):
        e = torch.exp(x - x.amax(dim, keepdim=True))
        y = e / e.sum(dim, keepdim=True)
        ctx.save_for_backward(y)
        ctx.dim = dim
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * g - y * (y * g).sum(ctx.dim, keepdim=True), None


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return _Softmax.apply(x, dim)

# -- norms -----------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """In float32, cast back to x's dtype (a bf16 rounding point)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """In float32 (the mean, then the variance of x - mean), cast back to
    x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# -- RoPE ------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates
    the two halves of head_dim against each other (``jnp.split``), not
    interleaved pairs; in float32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    ang = positions[..., :, None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- attention -------------------------------------------------------------

def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: int = 0, chunk: int = 1024,
                  kv_valid_len: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Grouped-query attention as a chunked online softmax over KV (the
    reference's jnp stand-in for the flash_attn kernel).

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), Hq % Hkv == 0.
    q_offset: absolute position of q[0] (causal masking of a prefill
    chunk or a decode step).  kv_valid_len: (B,) optional valid kv
    length.  Returns (B, Sq, Hq, D) in q's dtype.
    """
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    g = n_hq // n_hkv
    qg = q.reshape(n_b, n_q, n_hkv, g, d).float()
    scale = 1.0 / math.sqrt(d)
    n_chunks = max(1, -(-n_kv // chunk))
    pad = n_chunks * chunk - n_kv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(n_q, device=q.device)
    m = torch.full((n_b, n_q, n_hkv, g), float("-inf"), device=q.device)
    l = torch.zeros((n_b, n_q, n_hkv, g), device=q.device)
    acc = torch.zeros((n_b, n_q, n_hkv, g, d), device=q.device)
    for c in range(n_chunks):
        kb = kf[:, c * chunk:(c + 1) * chunk]
        vb = vf[:, c * chunk:(c + 1) * chunk]
        kv_pos = c * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb) * scale
        mask = (kv_pos < n_kv)[None, :].expand(n_q, chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= kv_pos[None, :])
        mask = mask[None, :, None, None, :]
        if kv_valid_len is not None:
            mask = mask & (kv_pos[None, :] < kv_valid_len[:, None]
                           )[:, None, None, None, :]
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                     float("-inf")))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p,
                                                   vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(n_b, n_q, n_hq, d).to(q.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0) -> torch.Tensor:
    """O(S^2)-memory reference attention (the oracle of the tests)."""
    n_b, n_q, n_hq, d = q.shape
    n_kv, n_hkv = k.shape[1], k.shape[2]
    qg = q.reshape(n_b, n_q, n_hkv, n_hq // n_hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) / math.sqrt(d)
    if causal:
        qp = q_offset + torch.arange(n_q, device=q.device)
        kp = torch.arange(n_kv, device=q.device)
        s = torch.where((qp[:, None] >= kp[None, :])[None, :, None, None, :],
                        s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(n_b, n_q, n_hq, d).to(q.dtype)
