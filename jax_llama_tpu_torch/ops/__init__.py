"""Tensor ops of the port: plain PyTorch, and the hand-written CUDA
flash-attention forward (``flash_attention``)."""

from .attention import attention_bias, repeat_kv, sdpa, sdpa_cached
from .flash_attention import flash_attention, flash_attention_reference
from .norm import rms_norm
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
    "apply_rope", "llama3_scale_inv_freq", "rope_table", "greedy", "sample",
    "stop_token_hits", "top_k_filter", "top_p_filter", "warped_probs",
]
