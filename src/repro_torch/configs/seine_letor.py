"""The paper's experiment config: SEINE on (synthetic) LETOR 4.0 (copy of
``repro.configs.seine_letor``).

MQ2007: ~1700 queries / 65,323 annotated docs; MQ2008: 800 / 15,211.
The data layer generates a Zipfian topical corpus with the same
structural statistics (configurable scale).  Fig. 2's best segment count
(20) is the default n_b.
"""
from __future__ import annotations

import dataclasses

from .base import SeineConfig

SEINE_LETOR = SeineConfig(
    name="seine-letor",
    n_segments=20,
    embed_dim=128,
    sigma_index=0.0,
    n_docs=4000,          # scaled-down MQ2007 (full scale = 65323)
    n_queries=200,
    avg_doc_len=600,
    n_topics=32,
    provider="hash",
)


def seine_smoke() -> SeineConfig:
    return dataclasses.replace(
        SEINE_LETOR, name="seine-smoke", n_docs=60, n_queries=8,
        avg_doc_len=120, n_segments=5, embed_dim=32, n_topics=8,
    )
