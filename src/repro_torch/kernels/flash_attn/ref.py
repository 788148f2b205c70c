"""Oracle for flash_attn: O(S^2)-memory GQA attention (models.layers)."""
from __future__ import annotations

from ...models.layers import naive_attention


def flash_attn_ref(q, k, v, *, causal: bool = True):
    return naive_attention(q, k, v, causal=causal)
