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
    h = silu(x @ lp["w_gate"]) * (x @ lp["w_up"])
    return h @ lp["w_down"]


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
    choice, and the slot ranks, for x: (G, M, D) token groups."""
    n_g, n_m, _ = x.shape
    n_e, k = cfg.moe.n_experts, cfg.moe.top_k
    if capacity_factor is None:
        capacity_factor = cfg.moe.capacity_factor
    probs = softmax(x.float() @ router, -1)                        # (G,M,E)
    topv, topi = top_k(probs, k)                                   # (G,M,K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    # one_hot(topi[..., 0]), without one_hot's range check (a host sync)
    first = topi[..., :1] == torch.arange(n_e, device=x.device)
    ce_frac = first.float().mean(dim=(0, 1))
    aux = cfg.moe.router_aux_coef * n_e * torch.sum(me * ce_frac)
    eid = topi.reshape(n_g, n_m * k)
    return Routing(topv, eid, moe_slots(eid),
                   moe_capacity(n_m, k, n_e, capacity_factor), aux)


def moe_ffn(x: torch.Tensor, lp: Params, cfg: TransformerConfig,
            capacity_factor: Optional[float] = None
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
    device time."""
    n_g, n_m, d = x.shape
    n_e, k = cfg.moe.n_experts, cfg.moe.top_k
    dt, dev = x.dtype, x.device
    with record_function("moe.route"):
        r = moe_route(x, lp["router"], cfg, capacity_factor)
    with record_function("moe.dispatch"):
        cap, kept = r.cap, r.pos < r.cap
        g_idx = torch.arange(n_g, device=dev)[:, None]
        # buffer row of each kept (token, slot): (e * G + g) * C + pos
        row = (r.eid * n_g + g_idx) * cap + r.pos.clamp(max=cap - 1)
        # the token each buffer row holds; n_g * n_m (a zero row) if none
        tok = (g_idx * n_m + torch.arange(n_m * k, device=dev) // k)
        holder = torch.full((n_e * n_g * cap + 1,), n_g * n_m,
                            dtype=torch.long, device=dev)
        holder.index_put_((torch.where(kept, row, n_e * n_g * cap)
                           .flatten(),), tok.flatten())
        xz = torch.cat([x.reshape(n_g * n_m, d), x.new_zeros(1, d)])
        buf = xz[holder[:-1]].reshape(n_e, n_g * cap, d)           # (E,GC,D)
    h = silu(torch.bmm(buf, lp["we_gate"])) * torch.bmm(buf, lp["we_up"])
    y = torch.bmm(h, lp["we_down"]).reshape(n_e * n_g * cap, d)
    with record_function("moe.combine"):
        back = torch.where(kept[..., None], y[row], 0).reshape(n_g, n_m, k,
                                                               d)
        out = (back * r.topv[..., None].to(dt)).sum(dim=2)

    if cfg.moe.n_shared_experts:
        hs = silu(x @ lp["ws_gate"]) * (x @ lp["ws_up"])
        out = out + hs @ lp["ws_down"]
    return out, r.aux


def _ffn(h: torch.Tensor, lp: Params, cfg: TransformerConfig
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.moe is None:
        return dense_ffn(h, lp), torch.zeros((), device=h.device)
    return moe_ffn(h, lp, cfg)


# -- transformer block -------------------------------------------------------

def block(x: torch.Tensor, lp: Params, cfg: TransformerConfig, *,
          positions: torch.Tensor, attention: Attention = flash_attention,
          kv_out: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block.  x: (B, S, D) -> (x, MoE aux loss).  When
    ``kv_out`` is a list, the block's roped k and v are appended to it."""
    n_b, n_s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(n_b, n_s, hq, hd)
    k = (h @ lp["wk"]).reshape(n_b, n_s, hkv, hd)
    v = (h @ lp["wv"]).reshape(n_b, n_s, hkv, hd)
    del h
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_out is not None:
        kv_out.append((k, v))
    o = attention(q, k, v, causal=True)
    # drop the frame's references before the FFN's wide temporaries (a
    # 32k-token prefill holds 16 GB in them); autograd keeps what it saved
    del q, k, v
    x = x + o.reshape(n_b, n_s, hq * hd) @ lp["wo"]
    del o
    y, aux = _ffn(rms_norm(x, lp["ln2"], cfg.norm_eps), lp, cfg)
    return x + y, aux


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
            kv_out: Optional[list] = None, remat: bool = True
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
    as they are."""
    n_b, n_s = tokens.shape
    x = gather_clip(params["embed"], tokens)                     # (B, S, D)
    positions = torch.arange(n_s, device=x.device)[None].expand(n_b, n_s)
    aux = torch.zeros((), device=x.device)
    layers = _layers(params)
    remat = remat and kv_out is None and torch.is_grad_enabled() and any(
        t.requires_grad for t in params["layers"].values())
    for lp in layers:
        if remat:
            x, a = checkpoint(block, x, lp, cfg, positions=positions,
                              attention=attention, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = block(x, lp, cfg, positions=positions,
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
    product (the reference's ``preferred_element_type=float32``)."""
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


def chunked_ce_loss(hidden: torch.Tensor, labels: torch.Tensor,
                    unembed: torch.Tensor, n_chunks: int = 8
                    ) -> torch.Tensor:
    """Mean cross-entropy without the (B, S, V) logits: hidden (B, S, D),
    labels (B, S) with -1 ignored, unembed (D, V).  The reference's
    chunking: ``n_chunks`` cut to S, then down to a divisor of S; per
    chunk of c positions the (B, c, V) float32 logits (bf16 operands,
    float32 sums), ``logsumexp`` minus the gold logit, summed over the
    valid positions with their count; the total over max(count, 1)."""
    n_b, n_s, d = hidden.shape
    n_chunks = min(n_chunks, n_s)
    while n_s % n_chunks:
        n_chunks -= 1
    c = n_s // n_chunks
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(n_chunks):
        h = hidden[:, i * c:(i + 1) * c].reshape(n_b * c, d)
        lab = labels[:, i * c:(i + 1) * c].long()
        logits = _LogitsF32.apply(h, unembed).reshape(n_b, c, -1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.clamp(min=0)[..., None])[..., 0]
        valid = (lab >= 0).float()
        tot = tot + torch.sum((lse - gold) * valid)
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params: Params, batch: Dict[str, torch.Tensor],
            cfg: TransformerConfig, *, attention: Attention = flash_attention,
            ce_chunks: int = 8, remat: bool = True) -> torch.Tensor:
    """Next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    (B, S), -1 ignored) plus the MoE aux loss, as the reference's.  Its
    ``attn_chunk`` sizes the jnp attention's KV chunks; the kernels tile
    by themselves."""
    hidden, aux = forward(params, batch["tokens"], cfg, attention=attention,
                          remat=remat)
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
    cache left as it is (the reference's scatter drops it)."""
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
    (the step updates the cache in place, as a donated buffer)."""
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
        q = (h @ lp["wq"]).reshape(n_b, 1, hq, hd)
        k = (h @ lp["wk"]).reshape(n_b, 1, hkv, hd)
        v = (h @ lp["wv"]).reshape(n_b, 1, hkv, hd)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        _write_at(kc, rows, length, k[:, 0])
        _write_at(vc, rows, length, v[:, 0])
        o = gqa_attention(q, kc, vc, causal=False, chunk=chunk,
                          kv_valid_len=length + 1)
        x = x + o.reshape(n_b, 1, hq * hd) @ lp["wo"]
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
