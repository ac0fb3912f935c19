"""LLaMA model in PyTorch (port of ``jax_llama_tpu/models/llama.py``).

Parameters are a plain dictionary of tensors in the JAX package's fused,
layer-stacked layout, so one set of weights serves both packages:

    {"embed":  {"embedding": [V, D]},
     "layers": {"attn_norm": [L, D],
                "qkv": [L, KVH, G+2, D, hd],   # slots [q_0..q_{G-1}, k, v]
                "o": [L, H, hd, D],
                "mlp_norm": [L, D],
                "gate_up": [L, 2, D, F], "down": [L, F, D]},
     "final_norm": [D],
     "lm_head": [D, V]}            # absent when tie_word_embeddings

The q/k features are stored in the half-split RoPE order (``ops.rope``).
The JAX ``lax.scan`` over the stacked layers is a Python loop here.

Attention per block, after ``attn_impl`` is resolved ("auto" picks
"flash" for blocks longer than ``FLASH_MIN_SEQ`` tokens, else "xla"):

* cached "xla": append-free ``sdpa_cached`` over the cache plus the
  step's own K/V; the new K/V are written into the cache after the
  layer's attention;
* "flash": the new K/V are written into the cache first, then the
  hand-written flash kernel attends the whole cache (or, without a
  cache, the block's own K/V);
* uncached "xla": plain ``sdpa`` with a positional bias.

The KV cache is updated IN PLACE (its k, v, pos and index): a forward
with a cache returns the same ``KVCache`` object it was given, so every
handle to it sees the advanced state.  The JAX package returns a fresh
buffer; copying a multi-gigabyte cache per decode step is what in-place
writes save.  Only the scalar cache index (lockstep decode) is ported;
paged caches, ring attention, int8, dropout, auxiliary outputs, pipeline
stages and quantized weights raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import LLaMAConfig, torch_dtype
from ..ops.attention import attention_bias, sdpa, sdpa_cached
from ..ops.flash_attention import flash_attention
from ..ops.norm import rms_norm
from ..ops.rope import apply_rope, rope_table

Params = Dict[str, Any]

# attn_impl="auto" runs the flash kernel only for blocks longer than this
# many tokens (models/llama.py:271 of the JAX package).
FLASH_MIN_SEQ = 8


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless told otherwise: a
    CUDA device with no GPU present raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def _params_device(params: Params) -> torch.device:
    return params["embed"]["embedding"].device


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Fixed-capacity per-layer KV cache with per-slot absolute positions.

    k, v:  [L, B, S_max, KVH, head_dim] in the activation dtype.
    pos:   [B, S_max] int32 absolute position of each slot; -1 = invalid.
    index: next write offset, one for all rows (lockstep decode).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    index: int = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(
    config: LLaMAConfig,
    batch: int,
    max_len: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> KVCache:
    """Allocate an empty cache on ``device``."""
    config.validate()
    device = resolve_device(device)
    max_len = max_len or config.max_seq_len
    dtype = dtype or config.activation_dtype
    shape = (config.n_layers, batch, max_len, config.kv_heads, config.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
        index=0,
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(
    config: LLaMAConfig,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
    device="cuda",
) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (or a fresh
    one seeded with ``seed``): normal with std 0.02 for the embedding and
    fan-in scaling for the projections, norms at 1 — the JAX package's
    scheme, though not its numbers (threefry and torch's generator
    differ).  Stacked weights are drawn one layer at a time, so the
    float32 scratch stays one layer's size."""
    config.validate()
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, H, KVH, hd, F_, V, L = (
        config.dim, config.n_heads, config.kv_heads, config.head_dim,
        config.ffn_dim, config.vocab_size, config.n_layers,
    )
    G = H // KVH
    wd = config.weight_dtype

    def dense(shape, std):
        out = torch.empty(shape, dtype=wd, device=device)
        flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
        for i in range(flat.shape[0]):
            flat[i].copy_(torch.randn(
                flat.shape[1:], generator=generator, device=device,
                dtype=torch.float32,
            ) * std)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=wd, device=device)

    params: Params = {
        "embed": {"embedding": dense((V, D), 0.02)},
        "layers": {
            "attn_norm": ones((L, D)),
            "qkv": dense((L, KVH, G + 2, D, hd), D ** -0.5),
            "o": dense((L, H, hd, D), D ** -0.5),
            "mlp_norm": ones((L, D)),
            "gate_up": dense((L, 2, D, F_), D ** -0.5),
            "down": dense((L, F_, D), F_ ** -0.5),
        },
        "final_norm": ones((D,)),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = dense((D, V), D ** -0.5)
    return params


def _tensor_from_numpy(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def from_jax_params(tree, device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Convert the JAX package's parameter tree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into the port's, same layout,
    same dtype unless ``dtype`` is given."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor_from_numpy(node, device, dtype)

    params = conv(tree)
    expected = {"attn_norm", "qkv", "o", "mlp_norm", "gate_up", "down"}
    if set(params["layers"]) != expected:
        raise NotImplementedError(
            f"layer tree {sorted(params['layers'])} is not the fused layout "
            f"{sorted(expected)} (quantized or legacy trees are not ported)"
        )
    return params


def param_count(params: Params) -> int:
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return node.numel()

    return count(params)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _rope_tables(head_dim, max_positions, theta, scaled, device):
    cos, sin = rope_table(head_dim, max_positions, theta, use_scaled_rope=scaled)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, D] @ w [D, V] with float32 output and float32 accumulation,
    without widening w (the JAX einsum's preferred_element_type=float32)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    if x.device.type == "cuda":
        return torch.mm(x, w.to(x.dtype), out_dtype=torch.float32)
    return x.float() @ w.float()


def lm_head_logits(params: Params, x: torch.Tensor, config: LLaMAConfig) -> torch.Tensor:
    """Final RMSNorm + (tied or untied) LM head: [B, T, D] -> [B, T, V]
    in config.logits_dtype."""
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    if config.tie_word_embeddings:
        kernel = params["embed"]["embedding"].T
    else:
        kernel = params["lm_head"]
    B, T, D = x.shape
    logits = _matmul_f32_out(x.reshape(B * T, D), kernel)
    return logits.reshape(B, T, -1).to(torch_dtype(config.logits_dtype))


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h [N, D] against a stack of C [D, k] weights ([..., D, k]) ->
    [N, ..., k].  One of the two operands has to be laid out again for a
    single GEMM; this copies the smaller: h, broadcast over the C weights
    (N <= k, decode), or the weight, as one [D, C*k] matrix (prefill)."""
    lead, (D, k) = w.shape[:-2], w.shape[-2:]
    w = w.reshape(-1, D, k).to(h.dtype)
    N = h.shape[0]
    if N <= k:
        out = torch.matmul(h[None], w).permute(1, 0, 2)
    else:
        out = h @ w.permute(1, 0, 2).reshape(D, -1)
    return out.reshape(N, *lead, k)


def _block(
    x: torch.Tensor,
    lp: Dict[str, torch.Tensor],
    cache_k: Optional[torch.Tensor],
    cache_v: Optional[torch.Tensor],
    *,
    config: LLaMAConfig,
    positions: torch.Tensor,
    bias: Optional[torch.Tensor],
    slot_pos: torch.Tensor,
    cache_index: Optional[int],
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias_new: Optional[torch.Tensor],
    impl: str,
) -> torch.Tensor:
    """One pre-norm transformer block, x: [B, T, D]; ``impl`` is the
    resolved attention path.  Writes this block's new K/V into
    ``cache_k``/``cache_v`` (views of one layer of the cache) in place."""
    B, T, D = x.shape
    adt = x.dtype
    H, KVH, hd = config.n_heads, config.kv_heads, config.head_dim
    G = H // KVH
    softmax_dtype = torch_dtype(config.attn_softmax_dtype)

    h = rms_norm(x, lp["attn_norm"], config.rms_norm_eps).reshape(B * T, D)
    qkv = _proj(h, lp["qkv"]).reshape(B, T, KVH, G + 2, hd)
    q = qkv[:, :, :, :G].reshape(B, T, H, hd)
    k = qkv[:, :, :, G]
    v = qkv[:, :, :, G + 1].contiguous()
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)

    if cache_k is not None and impl == "xla":
        attn = sdpa_cached(
            q, cache_k.to(adt), cache_v.to(adt), k, v, bias, bias_new,
            softmax_dtype=softmax_dtype,
        )
        # Append-free: the step's K/V land after the attention read the
        # cache (the slots they fill were masked from it).
        cache_k[:, cache_index:cache_index + T] = k.to(cache_k.dtype)
        cache_v[:, cache_index:cache_index + T] = v.to(cache_v.dtype)
    else:
        if cache_k is not None:
            cache_k[:, cache_index:cache_index + T] = k.to(cache_k.dtype)
            cache_v[:, cache_index:cache_index + T] = v.to(cache_v.dtype)
            kk, vv = cache_k.to(adt), cache_v.to(adt)
        else:
            kk, vv = k, v
        if impl == "flash":
            attn = flash_attention(q, kk, vv, positions, slot_pos)
        else:
            attn = sdpa(q, kk, vv, bias, softmax_dtype=softmax_dtype)

    attn_out = attn.reshape(B * T, H * hd) @ lp["o"].reshape(H * hd, D).to(adt)
    x = x + attn_out.reshape(B, T, D)

    h = rms_norm(x, lp["mlp_norm"], config.rms_norm_eps).reshape(B * T, D)
    gate_up = _proj(h, lp["gate_up"])  # [N, 2, F]
    hidden = F.silu(gate_up[:, 0]) * gate_up[:, 1]
    down = hidden @ lp["down"].to(adt)
    return x + down.reshape(B, T, D)


def forward(
    params: Params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    config: LLaMAConfig,
    cache: Optional[KVCache] = None,
    attn_mask: Optional[torch.Tensor] = None,
    compute_logits: bool = True,
    dropout_rng=None,
    output_hidden_states: bool = False,
    output_attentions: bool = False,
    output_last_hidden: bool = False,
    chunk_offset: Optional[int] = None,
) -> Tuple[Optional[torch.Tensor], Optional[KVCache]]:
    """Run the transformer.

    Args:
      params: from ``init_params`` or ``from_jax_params``.
      tokens: [B, T] integer token ids.
      positions: [B, T] integer absolute positions; padding carries -1
        (clamped to 0 for RoPE and queries, recorded as -1 in the cache).
      config: model config; ``attn_impl`` in {"xla", "flash", "auto"}.
      cache: optional KVCache, updated in place and returned (see module
        docstring): the T tokens are written at ``cache.index``, attention
        runs over the whole cache, and ``cache.index`` advances by T.
        ``cache.index + T`` must not pass ``cache.max_len``.
      attn_mask: optional [B, T] bool, False for padding; defaults to
        positions >= 0.
      compute_logits: False skips the final norm and LM head and returns
        (None, cache), for non-final prefill chunks.
      dropout_rng, output_hidden_states, output_attentions,
        output_last_hidden, chunk_offset: the JAX signature's training,
        auxiliary-output and splash-kernel options; not ported, and any
        value but the default raises NotImplementedError.
    Returns:
      (logits [B, T, V] in config.logits_dtype or None, cache or None).
    """
    unported = dict(
        dropout_rng=dropout_rng, output_hidden_states=output_hidden_states,
        output_attentions=output_attentions,
        output_last_hidden=output_last_hidden, chunk_offset=chunk_offset,
    )
    for name, value in unported.items():
        if value is not None and value is not False:
            raise NotImplementedError(f"forward({name}=...) is not ported")
    if cache is not None and not isinstance(cache, KVCache):
        raise NotImplementedError(
            f"{type(cache).__name__} is not ported (scalar-index KVCache only)"
        )
    config.validate()
    device = _params_device(params)
    tokens = tokens.to(device)
    positions = positions.to(device=device, dtype=torch.int32)
    B, T = tokens.shape
    adt = config.activation_dtype
    if attn_mask is None:
        attn_mask = positions >= 0
    attn_mask = attn_mask.to(device=device, dtype=torch.bool)
    q_positions = positions.clamp(min=0).contiguous()
    if cache is not None and cache.index + T > cache.max_len:
        raise ValueError(
            f"cache overflow: index {cache.index} + {T} tokens > "
            f"{cache.max_len} slots"
        )

    max_positions = max(
        2 * config.max_seq_len, cache.max_len if cache is not None else 0
    )
    cos, sin = _rope_tables(
        config.head_dim, max_positions, config.rope_theta,
        config.use_scaled_rope, device,
    )
    x = params["embed"]["embedding"][tokens.long()].to(adt)

    impl = config.attn_impl
    if impl == "auto":
        impl = "flash" if T > FLASH_MIN_SEQ else "xla"
    xla_cached = cache is not None and impl == "xla"

    new_slot_pos = torch.where(
        attn_mask, q_positions, torch.full_like(q_positions, -1)
    )
    if cache is not None:
        slot_pos = cache.pos.clone()
        slot_pos[:, cache.index:cache.index + T] = new_slot_pos
    else:
        slot_pos = new_slot_pos.contiguous()
    bias = bias_new = None
    if xla_cached:
        bias = attention_bias(q_positions, cache.pos, cache.pos >= 0)
        bias_new = attention_bias(q_positions, new_slot_pos, attn_mask)
    elif impl != "flash":
        bias = attention_bias(q_positions, slot_pos, slot_pos >= 0)

    lp = params["layers"]
    for i in range(config.n_layers):
        x = _block(
            x, {name: w[i] for name, w in lp.items()},
            cache.k[i] if cache is not None else None,
            cache.v[i] if cache is not None else None,
            config=config, positions=q_positions, bias=bias,
            slot_pos=slot_pos,
            cache_index=cache.index if cache is not None else None,
            cos=cos, sin=sin, bias_new=bias_new, impl=impl,
        )

    logits = lm_head_logits(params, x, config) if compute_logits else None
    if cache is None:
        return logits, None
    cache.pos.copy_(slot_pos)
    cache.index += T
    return logits, cache
