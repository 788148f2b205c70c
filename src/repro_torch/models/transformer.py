"""Decoder-only transformer LM, dense GQA (port of the dense path of
``repro.models.transformer``: ``init_params``, ``forward``, ``prefill``).

The reference scans stacked layers under remat for pod-scale SPMD; the
port keeps the stacked parameter layout (so a JAX pytree carries across
name for name, see ``convert.lm_params_from_numpy``) and runs a plain
loop over layers.  Attention goes through ``kernels.flash_attn``: the
hand-written CUDA kernel for CUDA tensors, its plain version on the CPU
(where the reference uses its chunked jnp stand-in).  The bf16 forward
rounds where the reference does: ``rms_norm``, RoPE and attention
compute in float32 and cast back; the residual adds and
``silu(gate) * up`` run in the working dtype.

MoE configs (the capacity dispatch), decoding with a KV cache, the
losses and training are not ported yet (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import TransformerConfig
from ..core.index import gather_clip
from ..kernels.flash_attn import flash_attention
from ..kernels.utils import resolve_device
from .layers import apply_rope, dense_init, embed_init, rms_norm

Params = Dict[str, Any]
Attention = Callable[..., torch.Tensor]
LAYER_NAMES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
               "w_down")


def _dt(cfg: TransformerConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _require_dense(cfg: TransformerConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name} is a MoE config; the MoE FFN (capacity dispatch) "
            "is not ported yet (ROADMAP Queue 1 item 15)")


def param_specs(cfg: TransformerConfig) -> Dict[str, Tuple[tuple,
                                                           Optional[float]]]:
    """``{"embed": (shape, scale), "layers.wq": ...}`` for every
    parameter of the dense model: the init's N(0, scale^2) draw, or
    ``None`` for the RMSNorm scales (ones).  Layer weights are stacked
    over L, as in the reference's pytree."""
    _require_dense(cfg)
    n_l, d, hd, f = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    specs = {
        "embed": ((cfg.vocab_size, d), 0.02),
        "layers.ln1": ((n_l, d), None),
        "layers.ln2": ((n_l, d), None),
        "layers.wq": ((n_l, d, hq), 1.0 / math.sqrt(d)),
        "layers.wk": ((n_l, d, hkv), 1.0 / math.sqrt(d)),
        "layers.wv": ((n_l, d, hkv), 1.0 / math.sqrt(d)),
        "layers.wo": ((n_l, hq, d), 1.0 / math.sqrt(hq * n_l)),
        "layers.w_gate": ((n_l, d, f), 1.0 / math.sqrt(d)),
        "layers.w_up": ((n_l, d, f), 1.0 / math.sqrt(d)),
        "layers.w_down": ((n_l, f, d), 1.0 / math.sqrt(f * n_l)),
        "final_norm": ((d,), None),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ((d, cfg.vocab_size), 1.0 / math.sqrt(d))
    return specs


def init_params(cfg: TransformerConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Params:
    """The reference's pytree ``{"embed", "layers": {name: (L, ...)},
    "final_norm", "unembed"}`` in the config's dtype on ``device``
    (default CUDA), with its shapes and scales, drawn in float32 from
    ``generator`` (default: seeded with 0, on ``device``) one layer at a
    time and cast.  A generator on the device draws a full-width model
    in well under a second; one on the host takes minutes."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    dt = _dt(cfg)
    params: Params = {"layers": {}}
    for name, (shape, scale) in param_specs(cfg).items():
        if scale is None:
            t = torch.ones(shape, dtype=dt, device=dev)
        elif name == "embed":
            t = embed_init(gen, *shape, dtype=dt, scale=scale).to(dev)
        elif len(shape) == 3:                 # stacked over the layers
            t = torch.stack([dense_init(gen, *shape[1:], scale,
                                        dtype=dt).to(dev)
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


def block(x: torch.Tensor, lp: Params, cfg: TransformerConfig, *,
          positions: torch.Tensor, attention: Attention = flash_attention
          ) -> torch.Tensor:
    """One pre-norm block.  x: (B, S, D) -> (B, S, D)."""
    n_b, n_s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(n_b, n_s, hq, hd)
    k = (h @ lp["wk"]).reshape(n_b, n_s, hkv, hd)
    v = (h @ lp["wv"]).reshape(n_b, n_s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True)
    x = x + o.reshape(n_b, n_s, hq * hd) @ lp["wo"]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + dense_ffn(h, lp)


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            *, attention: Attention = flash_attention
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (final hidden (B, S, D), MoE aux loss = 0).
    The embedding gather is the reference's ``mode="clip"`` one: an id
    past the vocabulary reads the last row, a negative id wraps first
    (``LMProvider`` clamps its pads to 0 before, as the reference's
    does)."""
    _require_dense(cfg)
    n_b, n_s = tokens.shape
    x = gather_clip(params["embed"], tokens)                     # (B, S, D)
    positions = torch.arange(n_s, device=x.device)[None].expand(n_b, n_s)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: layers[name][i] for name in LAYER_NAMES}
        x = block(x, lp, cfg, positions=positions, attention=attention)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def prefill(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            *, attention: Attention = flash_attention) -> torch.Tensor:
    """Full-prompt forward; returns next-token logits (B, V) in float32."""
    hidden, _ = forward(params, tokens, cfg, attention=attention)
    return hidden[:, -1].float() @ unembed_matrix(cfg, params).float()
