"""Tensor ops of the port: plain PyTorch, and the hand-written CUDA
kernels' wrappers: flash attention (``flash_attention``, forward and
backward kernels; ``flash_attention_quantized`` over int8 K/V) and the
paged-attention decode (``paged_pool_attention``); the kernel-selection
layer (``kernels``: the registry, ``splash_prefill`` and
``stock_paged_decode``); int8 quantization (``quant``)."""

from .attention import attention_bias, dropout, repeat_kv, sdpa, sdpa_cached
from .flash_attention import (
    dropout_keep,
    flash_attention,
    flash_attention_quantized,
    flash_attention_quantized_reference,
    flash_attention_reference,
    flash_backward,
    flash_backward_reference,
)
from .kernels import (
    DECODE_KERNELS,
    PREFILL_KERNELS,
    KernelSpec,
    resolve_decode_kernel,
    resolve_prefill_kernel,
    splash_eligible,
    splash_prefill,
    splash_prefill_attention,
    splash_prefill_reference,
    stock_paged_decode,
    stock_paged_decode_attention,
    stock_paged_decode_reference,
)
from .loss import chunked_softmax_xent
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
    "attention_bias", "dropout", "repeat_kv", "sdpa", "sdpa_cached",
    "dropout_keep", "flash_attention", "flash_attention_reference",
    "flash_attention_quantized", "flash_attention_quantized_reference",
    "flash_backward", "flash_backward_reference", "DECODE_KERNELS",
    "PREFILL_KERNELS", "KernelSpec", "resolve_decode_kernel",
    "resolve_prefill_kernel", "splash_eligible", "splash_prefill",
    "splash_prefill_attention", "splash_prefill_reference",
    "stock_paged_decode", "stock_paged_decode_attention",
    "stock_paged_decode_reference", "chunked_softmax_xent",
    "rms_norm",
    "paged_decode_attention", "paged_pool_attention",
    "paged_pool_attention_reference",
    "apply_rope", "llama3_scale_inv_freq", "rope_table", "greedy", "sample",
    "stop_token_hits", "top_k_filter", "top_p_filter", "warped_probs",
]
