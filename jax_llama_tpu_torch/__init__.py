"""jax_llama_tpu_torch — the PyTorch/CUDA port of jax_llama_tpu for one
NVIDIA H100.

It imports torch and numpy only: never jax, and nothing of the JAX
package.  Entry points run on the card (``device="cuda"``) and raise when
no GPU is present unless the caller passes ``device="cpu"``.

  Model:      LLaMAConfig, get_config, init_params, from_jax_params,
              forward (AuxOutput: hidden states, attention
              probabilities), KVCache, init_cache, PagedKVCache
  Decode:     GenerationConfig, generate, score, LLaMA
  Serving:    ContinuousBatcher (speculative with draft_params),
              init_pool (paged KV pool); LLMServer (the HTTP front-end:
              /generate, /chat, /metrics, /healthz, /debug/*) over the
              host layers faults, degrade, overload and obs
  Speculative: generate_speculative (spec_decode)
  int8:       QuantizedTensor, quantize_params, is_quantized (int8
              weights); quantize_kv and config kv_cache_dtype="int8" (int8
              KV caches and pools, through the engine, the batcher and
              speculation)
  Training:   train_step (AdamW step over lm_loss; flash forward and
              backward kernels under attn_impl="flash"), make_optimizer,
              init_train_state, TrainState, lm_loss; data.batches /
              data.to_device for packed batches
  Tokenizers: ByteTokenizer (the Llama-2 and Llama-3 tokenizers and
              ChatFormat in jax_llama_tpu_torch.tokenizers)
  Weights:    convert_meta_checkpoint, save_checkpoint, load_checkpoint,
              save_train_state, load_train_state
              (jax_llama_tpu_torch.convert; CLI: python -m
              jax_llama_tpu_torch.convert); the layout helpers
              rope_permute, fuse_qkv, split_qkv, fuse_params
              (jax_llama_tpu_torch.models)
  CLI:        python -m jax_llama_tpu_torch.run (one-shot completion,
              --serve over stdin, --http PORT); jax_llama_tpu_torch.download
  Kernels:    ops.flash_attention (hand-written CUDA, csrc/flash_fwd.cu and
              csrc/flash_bwd.cu; flash_attention_quantized for int8 K/V),
              ops.paged_attention (hand-written CUDA, csrc/paged_decode.cu,
              T >= 1 query tokens per row, bf16/float32/int8 pools)
  Parallel:   make_mesh, auto_mesh, use_mesh, constrain
              (jax_llama_tpu_torch.parallel: one process per rank over
              torch.distributed, weights sharded by slicing with
              shard_params, explicit collectives; forward, generate,
              score, LLaMA, generate_speculative and ContinuousBatcher
              take mesh=; the serving mesh in parallel.serve_mesh)
  Selection:  KernelSpec, PREFILL_KERNELS, DECODE_KERNELS,
              resolve_prefill_kernel, resolve_decode_kernel,
              splash_eligible; the splash prefill slot
              (ops.kernels.splash_prefill, csrc/splash_prefill.cu) and the
              stock-paged decode slot (ops.kernels.stock_paged_decode,
              csrc/stock_paged.cu), chosen with
              ContinuousBatcher(prefill_kernel=..., decode_kernel=...)
"""

from .config import LLaMAConfig, get_config, swiglu_hidden_size
from .engine import GenerationConfig, generate, score
from .generation import LLaMA
from .models import (
    AuxOutput,
    KVCache,
    PagedKVCache,
    forward,
    from_jax_params,
    init_cache,
    init_params,
    param_count,
)
from .ops.kernels import (
    DECODE_KERNELS,
    PREFILL_KERNELS,
    KernelSpec,
    resolve_decode_kernel,
    resolve_prefill_kernel,
    splash_eligible,
)
from .ops.quant import (
    QuantizedTensor,
    is_quantized,
    quantize_kv,
    quantize_params,
)
from .parallel import auto_mesh, constrain, make_mesh, use_mesh
from .server import LLMServer
from .serving import ContinuousBatcher, init_pool
from .spec_decode import generate_speculative
from .tokenizers import ByteTokenizer
from .train import (
    TrainState,
    init_train_state,
    lm_loss,
    make_optimizer,
    train_step,
)

__version__ = "0.1.0"

__all__ = [
    "LLaMAConfig", "get_config", "swiglu_hidden_size", "GenerationConfig",
    "generate", "score", "LLaMA", "AuxOutput", "ByteTokenizer", "KVCache",
    "forward",
    "from_jax_params", "init_cache", "init_params", "param_count",
    "PagedKVCache", "ContinuousBatcher", "init_pool", "LLMServer",
    "QuantizedTensor", "quantize_params", "is_quantized", "quantize_kv",
    "generate_speculative", "KernelSpec", "PREFILL_KERNELS",
    "DECODE_KERNELS", "resolve_prefill_kernel", "resolve_decode_kernel",
    "splash_eligible", "make_mesh", "auto_mesh", "use_mesh", "constrain",
    "TrainState",
    "init_train_state", "lm_loss", "make_optimizer", "train_step",
    "__version__",
]
