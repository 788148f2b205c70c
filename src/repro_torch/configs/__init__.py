"""Config registry of the port: SEINE's own config and, for the LM
domain, ``get_lm_config("minitron-4b")`` (the exact published config)
and ``smoke(name)`` (a reduced config of the same family for CPU tests).
"""
from __future__ import annotations

from . import lm_archs
from .base import MoEConfig, SeineConfig, TransformerConfig
from .seine_letor import SEINE_LETOR, seine_smoke

LM_ARCH_IDS = tuple(sorted(lm_archs.LM_CONFIGS))


def get_lm_config(name: str) -> TransformerConfig:
    if name not in lm_archs.LM_CONFIGS:
        raise KeyError(f"unknown LM arch {name!r}; known: {LM_ARCH_IDS}")
    return lm_archs.LM_CONFIGS[name]


def smoke(name: str) -> TransformerConfig:
    return lm_archs.smoke_config(get_lm_config(name))


__all__ = ["LM_ARCH_IDS", "MoEConfig", "SEINE_LETOR", "SeineConfig",
           "TransformerConfig", "get_lm_config", "seine_smoke", "smoke"]
