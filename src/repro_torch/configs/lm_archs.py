"""The LM-family transformer architectures at their exact published
dims with their shape cells (copy of ``repro.configs.lm_archs``)."""
from __future__ import annotations

import dataclasses

from .base import LM_SHAPES, ArchBundle, MoEConfig, TransformerConfig

# -- granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base] --------
GRANITE_MOE = TransformerConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

# -- moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B] -------------------
MOONSHOT = TransformerConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared_experts=2),
    source="hf:moonshotai/Moonlight-16B-A3B",
)

# -- yi-9b [arXiv:2403.04652] ------------------------------------------------
YI_9B = TransformerConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    source="arXiv:2403.04652",
)

# -- minitron-4b [arXiv:2407.14679] -------------------------------------------
MINITRON_4B = TransformerConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    source="arXiv:2407.14679",
)

# -- stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b] ---------------------------
STABLELM_16 = TransformerConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    source="hf:stabilityai/stablelm-2-1_6b",
)

LM_CONFIGS = {cfg.name: cfg for cfg in (GRANITE_MOE, MOONSHOT, YI_9B,
                                        MINITRON_4B, STABLELM_16)}
LM_BUNDLES = {
    name: ArchBundle(arch_id=name, config=cfg, shapes=LM_SHAPES, domain="lm")
    for name, cfg in LM_CONFIGS.items()
}


def smoke_config(cfg: TransformerConfig) -> TransformerConfig:
    """Reduced same-family config for CPU smoke tests."""
    moe = None
    if cfg.moe is not None:
        # capacity_factor 8 -> dropless at smoke scale, so decode == prefill
        # is exactly testable (production configs keep the 1.25 drop regime)
        moe = MoEConfig(n_experts=4, top_k=2, d_expert=32,
                        n_shared_experts=min(cfg.moe.n_shared_experts, 1),
                        capacity_factor=8.0)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, cfg.n_kv_heads * 4 // cfg.n_heads),
        d_ff=128, vocab_size=512, head_dim=16, moe=moe, dtype="float32",
    )
