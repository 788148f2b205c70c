from .kernel import (BLOCK_K, BLOCK_Q, HEAD_DIMS, flash_attn_bwd_kernel,
                     flash_attn_bwd_plain, flash_attn_kernel,
                     flash_attn_plain)
from .ops import flash_attention, flash_attention_plain
from .ref import flash_attn_ref

__all__ = ["BLOCK_K", "BLOCK_Q", "HEAD_DIMS", "flash_attention",
           "flash_attention_plain", "flash_attn_bwd_kernel",
           "flash_attn_bwd_plain", "flash_attn_kernel", "flash_attn_plain",
           "flash_attn_ref"]
