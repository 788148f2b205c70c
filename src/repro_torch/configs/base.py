"""Config dataclasses of the port: SEINE itself, the decoder-only LM,
MACE, the recsys models, the input-shape cells and the (arch, shapes)
bundles (copies of ``repro.configs.base``; ``repro.configs`` loads jax
through its package, so the port keeps its own copies)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the (arch x shape) grid."""

    name: str
    kind: str  # "training" | "inference-prefill" | "inference-decode" |
    #            "long-context-decode" | "full-batch" | "sampled-training" |
    #            "full-batch-large" | "batched-small-graphs" | "online-inference" |
    #            "offline-scoring" | "retrieval-scoring"
    # LM shapes
    seq_len: int = 0
    global_batch: int = 0
    # GNN shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0
    # recsys shapes
    batch: int = 0
    n_candidates: int = 0

    @property
    def is_decode(self) -> bool:
        return self.kind in ("inference-decode", "long-context-decode")

    @property
    def is_train(self) -> bool:
        return self.kind in ("training", "full-batch", "sampled-training",
                             "full-batch-large", "batched-small-graphs")


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


@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    family: str = "gnn"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    n_species: int = 16
    r_cut: float = 5.0
    d_readout: int = 64
    dtype: str = "float32"
    source: str = "arXiv:2206.07697"


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    family: str  # "attn-ctr" | "dlrm" | "seq-rec"
    n_dense: int = 0
    n_sparse: int = 0
    embed_dim: int = 16
    vocab_sizes: Tuple[int, ...] = ()
    # AutoInt
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    # DLRM
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    interaction: str = "dot"
    # sequential recommenders
    n_blocks: int = 0
    seq_len: int = 0
    n_items: int = 0
    causal: bool = True
    dtype: str = "float32"
    source: str = ""


@dataclass(frozen=True)
class ArchBundle:
    """An architecture + its assigned input shapes, as one dry-run unit."""

    arch_id: str
    config: Any
    shapes: Tuple[ShapeConfig, ...]
    domain: str  # "lm" | "gnn" | "recsys" | "ir"

    def shape(self, name: str) -> ShapeConfig:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}; "
                       f"have {[s.name for s in self.shapes]}")


# ---------------------------------------------------------------------------
# Shared shape sets (from the assignment)
# ---------------------------------------------------------------------------

LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig(name="train_4k", kind="training", seq_len=4096,
                global_batch=256),
    ShapeConfig(name="prefill_32k", kind="inference-prefill", seq_len=32768,
                global_batch=32),
    ShapeConfig(name="decode_32k", kind="inference-decode", seq_len=32768,
                global_batch=128),
    ShapeConfig(name="long_500k", kind="long-context-decode",
                seq_len=524288, global_batch=1),
)

GNN_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig(name="full_graph_sm", kind="full-batch",
                n_nodes=2708, n_edges=10556, d_feat=1433),
    ShapeConfig(name="minibatch_lg", kind="sampled-training",
                n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                fanout=(15, 10)),
    ShapeConfig(name="ogb_products", kind="full-batch-large",
                n_nodes=2449029, n_edges=61859140, d_feat=100),
    ShapeConfig(name="molecule", kind="batched-small-graphs",
                n_nodes=30, n_edges=64, n_graphs=128),
)

RECSYS_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig(name="train_batch", kind="training", batch=65536),
    ShapeConfig(name="serve_p99", kind="online-inference", batch=512),
    ShapeConfig(name="serve_bulk", kind="offline-scoring", batch=262144),
    ShapeConfig(name="retrieval_cand", kind="retrieval-scoring", batch=1,
                n_candidates=1_000_000),
)
