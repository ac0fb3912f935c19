"""Model definitions of the port."""

from .llama import (
    FLASH_MIN_SEQ,
    KVCache,
    forward,
    from_jax_params,
    init_cache,
    init_params,
    lm_head_logits,
    param_count,
)

__all__ = [
    "FLASH_MIN_SEQ", "KVCache", "forward", "from_jax_params", "init_cache",
    "init_params", "lm_head_logits", "param_count",
]
