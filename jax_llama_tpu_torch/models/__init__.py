"""Model definitions of the port."""

from .llama import (
    FLASH_MIN_SEQ,
    AuxOutput,
    KVCache,
    PagedKVCache,
    forward,
    from_jax_params,
    fuse_params,
    fuse_qkv,
    init_cache,
    init_params,
    lm_head_logits,
    paged_forward,
    paged_pool_write,
    paged_write_indices,
    param_count,
    permute_d_axis,
    rope_permute,
    split_qkv,
)

__all__ = [
    "FLASH_MIN_SEQ", "AuxOutput", "KVCache", "PagedKVCache", "forward",
    "from_jax_params", "init_cache", "init_params", "lm_head_logits",
    "paged_forward", "paged_pool_write", "paged_write_indices",
    "param_count", "rope_permute", "fuse_qkv", "split_qkv",
    "permute_d_axis", "fuse_params",
]
