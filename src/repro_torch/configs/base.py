"""Config dataclasses of the port: SEINE itself and the decoder-only LM
(copies of ``repro.configs.base.SeineConfig``, ``MoEConfig`` and
``TransformerConfig``; ``repro.configs`` loads jax through its package,
so the port keeps its own copies)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class SeineConfig:
    """Config for the paper's own system (indexing + retrieval)."""

    name: str = "seine"
    vocab_keep_frac: Tuple[float, float] = (0.10, 0.90)  # middle 80%
    n_segments: int = 20          # n_b; Fig.2 best value
    embed_dim: int = 128          # embedding provider dim
    sigma_index: float = 0.0      # tf filter threshold (Algorithm 1, line 8)
    functions: Tuple[str, ...] = (
        "tf", "idf_indicator", "dot", "cosine", "gauss_max",
        "linear_agg", "max_op", "mlp_emb", "log_cond_prob",
    )
    # TextTiling
    tile_window: int = 20         # tokens per pseudo-sentence window
    tile_smooth: int = 2
    # synthetic-LETOR scale knobs (MQ2007-like defaults; reduced in smoke tests)
    n_docs: int = 4000
    n_queries: int = 200
    avg_doc_len: int = 600
    n_topics: int = 32
    provider: str = "hash"        # "hash" | "learned"
    dtype: str = "float32"


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert ffn hidden dim
    n_shared_experts: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25  # Switch-style token-drop capacity


@dataclass(frozen=True)
class TransformerConfig:
    """Decoder-only transformer LM (dense or MoE) with GQA."""

    name: str
    family: str  # "dense" | "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d

    def _embed_params(self) -> int:
        return self.vocab_size * self.d_model * (
            1 if self.tie_embeddings else 2)

    @property
    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d = self.d_model
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_expert \
                + d * self.moe.n_experts
            if self.moe.n_shared_experts:
                ffn += self.moe.n_shared_experts * 3 * d * self.moe.d_expert
        else:
            ffn = 3 * d * self.d_ff  # SwiGLU: w_gate, w_up, w_down
        per_layer = self._attn_params() + ffn + 2 * d  # two RMSNorm scales
        return self.n_layers * per_layer + self._embed_params() + d

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE uses top_k experts)."""
        if self.moe is None:
            return self.n_params
        d = self.d_model
        active_ffn = (self.moe.top_k + self.moe.n_shared_experts) * 3 * d \
            * self.moe.d_expert + d * self.moe.n_experts
        per_layer = self._attn_params() + active_ffn + 2 * d
        return self.n_layers * per_layer + self._embed_params() + d
