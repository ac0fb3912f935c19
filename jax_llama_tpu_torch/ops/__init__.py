"""Tensor ops of the port: plain PyTorch, and the hand-written CUDA
kernels' wrappers: the flash-attention forward (``flash_attention``) and
the paged-attention decode (``paged_pool_attention``)."""

from .attention import attention_bias, repeat_kv, sdpa, sdpa_cached
from .flash_attention import flash_attention, flash_attention_reference
from .norm import rms_norm
from .paged_attention import (
    paged_decode_attention,
    paged_pool_attention,
    paged_pool_attention_reference,
)
from .rope import apply_rope, llama3_scale_inv_freq, rope_table
from .sampling import (
    greedy,
    sample,
    stop_token_hits,
    top_k_filter,
    top_p_filter,
    warped_probs,
)

__all__ = [
    "attention_bias", "repeat_kv", "sdpa", "sdpa_cached",
    "flash_attention", "flash_attention_reference", "rms_norm",
    "paged_decode_attention", "paged_pool_attention",
    "paged_pool_attention_reference",
    "apply_rope", "llama3_scale_inv_freq", "rope_table", "greedy", "sample",
    "stop_token_hits", "top_k_filter", "top_p_filter", "warped_probs",
]
