"""The recsys architectures at their exact published dims (copy of
``repro.configs.recsys_archs``)."""
from __future__ import annotations

import dataclasses

from .base import RECSYS_SHAPES, ArchBundle, RecsysConfig

# Criteo 1TB per-field cardinalities (MLPerf DLRM reference preprocessing,
# day 0-23, frequency threshold 0; published in the MLPerf logging repo).
CRITEO_1TB_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

# -- autoint [arXiv:1810.11921] ----------------------------------------------
# 39 fields (13 numerical discretized + 26 categorical, Criteo protocol).
AUTOINT = RecsysConfig(
    name="autoint", family="attn-ctr",
    n_sparse=39, embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32,
    interaction="self-attn",
    vocab_sizes=tuple([10000] * 39),
    source="arXiv:1810.11921",
)

# -- dlrm-mlperf [arXiv:1906.00091] -------------------------------------------
DLRM = RecsysConfig(
    name="dlrm-mlperf", family="dlrm",
    n_dense=13, n_sparse=26, embed_dim=128,
    bot_mlp=(13, 512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
    interaction="dot", vocab_sizes=CRITEO_1TB_VOCABS,
    source="arXiv:1906.00091",
)

# -- sasrec [arXiv:1808.09781] -------------------------------------------------
SASREC = RecsysConfig(
    name="sasrec", family="seq-rec",
    embed_dim=50, n_blocks=2, n_heads=1, seq_len=50, causal=True,
    interaction="self-attn-seq", n_items=1_000_000,
    source="arXiv:1808.09781",
)

# -- bert4rec [arXiv:1904.06690] -----------------------------------------------
BERT4REC = RecsysConfig(
    name="bert4rec", family="seq-rec",
    embed_dim=64, n_blocks=2, n_heads=2, seq_len=200, causal=False,
    interaction="bidir-seq", n_items=1_000_000,
    source="arXiv:1904.06690",
)

RECSYS_BUNDLES = {
    cfg.name: ArchBundle(arch_id=cfg.name, config=cfg, shapes=RECSYS_SHAPES,
                         domain="recsys")
    for cfg in (AUTOINT, DLRM, SASREC, BERT4REC)
}


def smoke_config(cfg: RecsysConfig) -> RecsysConfig:
    repl = dict(name=cfg.name + "-smoke")
    if cfg.vocab_sizes:
        repl["vocab_sizes"] = tuple(min(v, 100) for v in cfg.vocab_sizes)
    if cfg.n_items:
        repl["n_items"] = 500
    if cfg.seq_len:
        repl["seq_len"] = min(cfg.seq_len, 16)
    return dataclasses.replace(cfg, **repl)
