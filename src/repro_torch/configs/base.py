"""The config of SEINE itself (copy of ``repro.configs.base.SeineConfig``;
``repro.configs`` loads jax through its package, so the port keeps its
own copy)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
