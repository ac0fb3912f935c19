"""Model definitions of the port."""

from .llama import (
    FLASH_MIN_SEQ,
    AuxOutput,
    KVCache,
    PagedKVCache,
    forward,
    from_jax_params,
    init_cache,
    init_params,
    lm_head_logits,
    paged_forward,
    paged_pool_write,
    paged_write_indices,
    param_count,
)

__all__ = [
    "FLASH_MIN_SEQ", "AuxOutput", "KVCache", "PagedKVCache", "forward",
    "from_jax_params", "init_cache", "init_params", "lm_head_logits",
    "paged_forward", "paged_pool_write", "paged_write_indices",
    "param_count",
]
