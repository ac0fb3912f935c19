"""Model configuration for the PyTorch/CUDA port.

A copy of ``jax_llama_tpu.config`` (the architecture fields, the SwiGLU
sizing rule and the published presets) with dtype strings mapped to torch
dtypes.  The port keeps its own copy because importing the JAX package
pulls in jax.  Fields the port does not run yet (ring attention,
pipeline microbatches, kernel selection) are kept so a config
round-trips between the two packages; ``validate`` rejects the values the
port cannot honour instead of silently ignoring them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """Map a dtype string of the config ("bfloat16", ...) to a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


def swiglu_hidden_size(
    dim: int,
    multiple_of: int = 256,
    ffn_dim_multiplier: Optional[float] = None,
) -> int:
    """Meta's SwiGLU FFN sizing rule: 2/3 of 4*dim, optionally scaled
    (Llama-3 uses 1.3), rounded up to ``multiple_of``."""
    hidden = int(2 * (4 * dim) / 3)
    if ffn_dim_multiplier is not None:
        hidden = int(ffn_dim_multiplier * hidden)
    return multiple_of * math.ceil(hidden / multiple_of)


@dataclasses.dataclass(frozen=True)
class LLaMAConfig:
    """Architecture + numerics configuration for a LLaMA-family model."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None      # None -> n_heads (no GQA)
    intermediate_size: Optional[int] = None
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    max_seq_len: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    use_scaled_rope: bool = False         # Llama-3.1 context-extension RoPE
    tie_word_embeddings: bool = False

    resid_pdrop: float = 0.0
    embd_pdrop: float = 0.0
    attn_pdrop: float = 0.0

    dtype: str = "bfloat16"               # activation/compute dtype
    param_dtype: str = "float32"          # parameter storage dtype
    scan_layers: bool = True              # no effect: layers run in a loop
    scan_unroll: int = 1
    remat: bool = False
    remat_policy: str = "dots"
    attn_impl: str = "xla"                # "xla" | "flash" | "ring" | "auto"
    pp_microbatches: Optional[int] = None
    attn_softmax_dtype: str = "float32"
    logits_dtype: str = "float32"
    kv_cache_dtype: str = "auto"
    prefill_kernel: str = "flash"
    decode_kernel: str = "paged"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        assert self.dim % self.n_heads == 0
        return self.dim // self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        return swiglu_hidden_size(
            self.dim, self.multiple_of, self.ffn_dim_multiplier
        )

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def weight_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "LLaMAConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        assert self.dim % self.n_heads == 0, "n_heads must divide dim"
        assert self.n_heads % self.kv_heads == 0, (
            "n_heads must be a multiple of n_kv_heads (GQA group size)"
        )
        if self.attn_impl not in ("xla", "flash", "ring", "auto"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.remat_policy not in ("dots", "full"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected "
                "'dots' or 'full'")
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"unknown kv_cache_dtype {self.kv_cache_dtype!r}; "
                "expected 'auto' or 'int8'"
            )
        for name in ("resid_pdrop", "embd_pdrop", "attn_pdrop"):
            p = getattr(self, name)
            if not 0.0 <= p < 1.0:
                raise ValueError(f"{name}={p} must be in [0, 1)")
        for name in ("dtype", "param_dtype", "attn_softmax_dtype",
                     "logits_dtype"):
            torch_dtype(getattr(self, name))
        # A typo'd kernel name would never match the dispatch predicates
        # and would quietly run the default kernel: fail instead.
        if self.prefill_kernel not in ("flash", "splash", "auto"):
            raise ValueError(
                f"unknown prefill_kernel {self.prefill_kernel!r}; "
                "expected 'flash', 'splash', or 'auto'"
            )
        if self.decode_kernel not in ("paged", "stock-paged", "auto"):
            raise ValueError(
                f"unknown decode_kernel {self.decode_kernel!r}; "
                "expected 'paged', 'stock-paged', or 'auto'"
            )


# ---------------------------------------------------------------------------
# Presets: the published Meta architectures.
# ---------------------------------------------------------------------------

def tiny(**kw) -> LLaMAConfig:
    """Tiny config for unit tests."""
    base = dict(
        vocab_size=256, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
        multiple_of=32, max_seq_len=64, rope_theta=10000.0,
        rms_norm_eps=1e-5, dtype="float32", param_dtype="float32",
    )
    base.update(kw)
    return LLaMAConfig(**base)


def llama2_7b(**kw) -> LLaMAConfig:
    base = dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=None,
        multiple_of=256, max_seq_len=4096, rope_theta=10000.0,
        rms_norm_eps=1e-5,
    )
    base.update(kw)
    return LLaMAConfig(**base)


def llama2_13b(**kw) -> LLaMAConfig:
    base = dict(
        vocab_size=32000, dim=5120, n_layers=40, n_heads=40, n_kv_heads=None,
        multiple_of=256, max_seq_len=4096, rope_theta=10000.0,
        rms_norm_eps=1e-5,
    )
    base.update(kw)
    return LLaMAConfig(**base)


def llama2_70b(**kw) -> LLaMAConfig:
    base = dict(
        vocab_size=32000, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        multiple_of=4096, ffn_dim_multiplier=1.3, max_seq_len=4096,
        rope_theta=10000.0, rms_norm_eps=1e-5,
    )
    base.update(kw)
    return LLaMAConfig(**base)


def llama3_8b(**kw) -> LLaMAConfig:
    base = dict(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        multiple_of=1024, ffn_dim_multiplier=1.3, max_seq_len=8192,
        rope_theta=500000.0, rms_norm_eps=1e-5,
    )
    base.update(kw)
    return LLaMAConfig(**base)


def llama3_70b(**kw) -> LLaMAConfig:
    base = dict(
        vocab_size=128256, dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        multiple_of=4096, ffn_dim_multiplier=1.3, max_seq_len=8192,
        rope_theta=500000.0, rms_norm_eps=1e-5,
    )
    base.update(kw)
    return LLaMAConfig(**base)


def llama3_1_8b(**kw) -> LLaMAConfig:
    base = dict(use_scaled_rope=True, max_seq_len=131072)
    base.update(kw)
    return llama3_8b(**base)


def llama3_1_70b(**kw) -> LLaMAConfig:
    base = dict(use_scaled_rope=True, max_seq_len=131072)
    base.update(kw)
    return llama3_70b(**base)


PRESETS = {
    "tiny": tiny,
    "llama2-7b": llama2_7b,
    "llama2-13b": llama2_13b,
    "llama2-70b": llama2_70b,
    "llama3-8b": llama3_8b,
    "llama3-70b": llama3_70b,
    "llama3.1-8b": llama3_1_8b,
    "llama3.1-70b": llama3_1_70b,
}


def get_config(name: str, **kw) -> LLaMAConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown config preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**kw)
