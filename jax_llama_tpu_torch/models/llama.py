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
  cache, the block's own K/V).  A cached chunk that
  ``ops.kernels.splash_eligible`` accepts (``config.prefill_kernel ==
  "splash"``, a static ``chunk_offset``, 128-multiple shapes, a
  full-precision cache) runs the splash kernel instead;
* uncached "xla": plain ``sdpa`` with a positional bias.

The KV cache is updated IN PLACE (its k, v, pos and index): a forward
with a cache returns the same ``KVCache`` object it was given, so every
handle to it sees the advanced state.  The JAX package returns a fresh
buffer; copying a multi-gigabyte cache per decode step is what in-place
writes save.  The cache index is a scalar (lockstep decode) or a [B]
tensor (one write offset per row, the serving batcher's gathered view,
xla path only).

A ``PagedKVCache`` (the serving block pool) routes to ``paged_forward``:
T >= 1 consecutive tokens per row (a decode token, or the speculative
verify block), attention through the hand-written paged kernel, and the
same in-place contract (pool k, v and pos written, the same cache object
returned).  Under ``config.decode_kernel == "stock-paged"`` a T = 1 step
over a full-precision pool runs the stock-paged kernel
(``ops.kernels``) instead; T > 1 and int8 pools keep the paged kernel.

Training (``train.py``): ``forward(dropout_rng=...)`` applies the config's
embedding, residual and attention dropout, drawn from a ``torch.Generator``
(or an int seed).  Attention dropout runs inside the flash kernel on the
flash path (two seed words per layer drawn from the generator, the mask
hashed in the kernel and rebuilt by the backward kernels) and through
``sdpa`` on the xla path.  The masks differ from the JAX package's, which
draws its kernel seed words from threefry keys; parity with JAX holds at
the op level (the same seed words give the same mask bits) and at the
model level with dropout off.  ``config.remat`` runs each block under
``torch.utils.checkpoint``: policy "full" recomputes everything, "dots"
saves the matmul outputs (JAX's ``dots_with_no_batch_dims_saveable``).

int8 (``ops.quant``): a projection held as a ``QuantizedTensor`` (from
``quantize_params``, or a quantized JAX tree through ``from_jax_params``)
is multiplied as its int8 payload and rescaled after the product.  With
``config.kv_cache_dtype == "int8"`` the caches and pools hold int8 K/V
with float32 per-slot-per-head scales: the xla path folds them in
``sdpa_cached``, the flash path writes the quantized chunk first and runs
``flash_attention_quantized``, the paged path folds them in the paged
kernel; the step's own K/V join at full precision and are quantized only
for the write.

Ring attention, the hidden-state and attention-weight outputs and
pipeline stages raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..config import LLaMAConfig, torch_dtype
from ..ops.attention import attention_bias, dropout, sdpa, sdpa_cached
from ..ops.flash_attention import flash_attention, flash_attention_quantized
from ..ops.kernels import (
    splash_eligible,
    splash_prefill_attention,
    stock_paged_decode_attention,
)
from ..ops.loss import matmul_f32_out
from ..ops.norm import rms_norm
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant import QuantizedTensor, matmul, quantize_kv
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

    k, v:  [L, B, S_max, KVH, head_dim] in the activation dtype, or int8
           when the cache is quantized (config.kv_cache_dtype == "int8").
    pos:   [B, S_max] int32 absolute position of each slot; -1 = invalid.
    index: next write offset: an int, one for all rows (lockstep decode),
           or a [B] int32 tensor, one per row (continuous batching).
    k_scale, v_scale: [L, B, S_max, KVH] float32 per-slot-per-head dequant
           scales (int8 cache only; None otherwise).
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    index: Union[int, torch.Tensor] = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def per_row_index(self) -> bool:
        return isinstance(self.index, torch.Tensor)


@dataclasses.dataclass
class PagedKVCache:
    """Paged (block-table) KV cache: the serving pool as ``paged_forward``
    reads it, through the paged kernel, with no gathered view.

    k, v:  [L, KVH, NB, BLK, head_dim], KV-head-major, so one (head, block)
           tile is a contiguous [BLK, head_dim] page; int8 when quantized.
    pos:   [NB, BLK] int32 absolute position per slot; -1 invalid.
    table: [B, MB] int32 physical block ids in sequence order; NB marks an
           unused entry.
    fill:  [B] int32 per-row next write offset in tokens (advanced by the
           caller after each step, as in the JAX package).
    k_scale, v_scale: [L, KVH, NB, BLK] float32 per-slot-per-head scales
           (int8 pool only; None otherwise), folded in the paged kernel.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    table: torch.Tensor
    fill: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def n_blocks(self) -> int:
        return self.k.shape[2]

    @property
    def block_size(self) -> int:
        return self.k.shape[3]


def paged_write_indices(
    table: torch.Tensor,
    fill: torch.Tensor,
    active: torch.Tensor,
    T: int,
    n_blocks: int,
    block_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Physical (block, offset) pairs for landing T new per-row entries.

    Row b's token j goes to block ``table[b, (fill[b]+j) // BLK]`` at
    offset ``(fill[b]+j) % BLK``; inactive rows and columns past the row's
    reserved capacity resolve to the sentinel block id ``n_blocks``, which
    ``paged_pool_write`` drops.  Returns (blk, off, cols), each [B, T]
    int64: ``cols`` is the clamped view column of each pair.
    """
    MB = table.shape[1]
    cols = fill.long()[:, None] + torch.arange(T, device=fill.device)[None, :]
    safe = cols.clamp(max=MB * block_size - 1)
    blk = torch.gather(table.long(), 1, safe // block_size)
    live = active[:, None] & (cols < MB * block_size)
    blk = torch.where(live, blk, n_blocks)
    return blk, safe % block_size, safe


def paged_pool_write(
    plane: torch.Tensor,
    upd: torch.Tensor,
    blk: torch.Tensor,
    off: torch.Tensor,
) -> torch.Tensor:
    """Write per-(row, token) updates into a pool plane in place; pairs
    whose block id is outside [0, NB) (the sentinel) are dropped.

    plane: [L, KVH, NB, BLK, d] payload with upd [L, KVH, B, T, d], an
      [L, KVH, NB, BLK] scale plane with upd [L, KVH, B, T], or the
      [NB, BLK] position plane with upd [B, T].
    blk, off: [B, T] physical coordinates from ``paged_write_indices``.

    The JAX package writes through a chain of dynamic-update-slices only
    to keep XLA's pool layout; eager PyTorch has no layout to keep, so
    this is one ``index_put_``.  index_put_ cannot skip a pair and leaves
    the winner of duplicate targets unspecified, so each dead pair repeats
    the first live pair (same slot, same value); with no live pair, every
    pair rewrites its clamped slot's own value.  Returns ``plane``.
    """
    nl = 0 if plane.dim() == 2 else 2  # the leading (L, KVH) axes
    NB = plane.shape[nl]
    flat = blk.reshape(-1)
    live = (flat >= 0) & (flat < NB)
    any_live = live.any()
    src = torch.where(live | ~any_live,
                      torch.arange(live.numel(), device=live.device),
                      live.int().argmax())
    b = flat[src].clamp(0, NB - 1)
    o = off.reshape(-1)[src]
    lead = (slice(None),) * nl
    u = upd.reshape(*upd.shape[:nl], -1, *upd.shape[nl + 2:]).to(plane.dtype)
    plane[lead + (b, o)] = torch.where(any_live, u[lead + (src,)],
                                       plane[lead + (b, o)])
    return plane


@dataclasses.dataclass
class AuxOutput:
    """``forward(..., output_last_hidden=True)``'s third output: the
    post-final-norm hidden states [B, T, D] (feed them to
    ``lm_head_logits(..., normed=True)``)."""

    last_hidden_state: torch.Tensor


def init_cache(
    config: LLaMAConfig,
    batch: int,
    max_len: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> KVCache:
    """Allocate an empty cache on ``device``: int8 payload with zero
    scales when ``config.kv_cache_dtype == "int8"`` and no ``dtype`` is
    given (JAX :434-452)."""
    config.validate()
    device = resolve_device(device)
    max_len = max_len or config.max_seq_len
    int8_kv = config.kv_cache_dtype == "int8" and dtype is None
    dtype = torch.int8 if int8_kv else (dtype or config.activation_dtype)
    shape = (config.n_layers, batch, max_len, config.kv_heads, config.head_dim)

    def scales():
        return (torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                if int8_kv else None)

    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
        index=0, k_scale=scales(), v_scale=scales(),
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
    same dtype unless ``dtype`` is given.  A quantized tree's weights (any
    node with ``.q`` and ``.scale``, the JAX ``QuantizedTensor``) become
    ``QuantizedTensor``s: int8 payload and float32 scales, never cast."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QuantizedTensor(
                q=_tensor_from_numpy(node.q, device, torch.int8),
                scale=_tensor_from_numpy(node.scale, device, torch.float32))
        return _tensor_from_numpy(node, device, dtype)

    params = conv(tree)
    expected = {"attn_norm", "qkv", "o", "mlp_norm", "gate_up", "down"}
    if set(params["layers"]) != expected:
        raise NotImplementedError(
            f"layer tree {sorted(params['layers'])} is not the fused layout "
            f"{sorted(expected)} (legacy trees are not ported)"
        )
    return params


def param_count(params: Params) -> int:
    """Elements of every leaf (a quantized weight counts its payload and
    its scales, as the JAX package's leaf count does)."""
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, QuantizedTensor):
            return node.q.numel() + node.scale.numel()
        return node.numel()

    return count(params)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _rope_tables(head_dim, max_positions, theta, scaled, device):
    cos, sin = rope_table(head_dim, max_positions, theta, use_scaled_rope=scaled)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def lm_head_logits(
    params: Params, x: torch.Tensor, config: LLaMAConfig, normed: bool = False
) -> torch.Tensor:
    """Final RMSNorm + (tied or untied) LM head: [B, T, D] -> [B, T, V]
    in config.logits_dtype.  ``normed=True``: x is already the
    post-final-norm hidden state."""
    if not normed:
        x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    if config.tie_word_embeddings:
        kernel = params["embed"]["embedding"].T
    else:
        kernel = params["lm_head"]
    B, T, D = x.shape
    if isinstance(kernel, QuantizedTensor):
        logits = (matmul_f32_out(x.reshape(B * T, D), kernel.q)
                  * kernel.scale.reshape(-1))
    else:
        logits = matmul_f32_out(x.reshape(B * T, D), kernel)
    return logits.reshape(B, T, -1).to(torch_dtype(config.logits_dtype))


def _proj(h: torch.Tensor, w) -> torch.Tensor:
    """h [N, D] against a stack of C [D, k] weights ([..., D, k]) ->
    [N, ..., k].  One of the two operands has to be laid out again for a
    single GEMM; this copies the smaller: h, broadcast over the C weights
    (N <= k, decode), or the weight, as one [D, C*k] matrix (prefill).  A
    ``QuantizedTensor`` multiplies its payload and rescales the product
    per output channel in float32 (JAX ``qeinsum``)."""
    if isinstance(w, QuantizedTensor):
        out = _proj(h, w.q).float() * w.scale.reshape(w.shape[:-2] + (-1,))
        return out.to(h.dtype)
    lead, (D, k) = w.shape[:-2], w.shape[-2:]
    w = w.reshape(-1, D, k).to(h.dtype)
    N = h.shape[0]
    if N <= k:
        out = torch.matmul(h[None], w).permute(1, 0, 2)
    else:
        out = h @ w.permute(1, 0, 2).reshape(D, -1)
    return out.reshape(N, *lead, k)


def _cache_write(
    cache_layer: torch.Tensor,
    new: torch.Tensor,
    index: Union[int, torch.Tensor],
) -> None:
    """Write new [B, T, KVH, hd] into one layer's cache [B, S, KVH, hd] at
    ``index``: a shared int offset, or a [B] tensor of per-row offsets
    (row b's token t lands at index[b] + t; a token past the cache is
    dropped, as JAX's ``.at[...].set(mode="drop")``).  The same for a
    layer's [B, S, KVH] scale plane with new [B, T, KVH]."""
    if not isinstance(index, torch.Tensor):
        cache_layer[:, index:index + new.shape[1]] = new.to(cache_layer.dtype)
        return
    B, T = new.shape[:2]
    S = cache_layer.shape[1]
    rows = torch.arange(B, device=new.device)[:, None]
    cols = index.long()[:, None] + torch.arange(T, device=new.device)[None]
    safe = cols.clamp(max=S - 1)
    # index_put_ leaves the winner of duplicate targets unspecified, so a
    # dropped token (clamped onto slot S-1) repeats what that slot gets:
    # the row's token that lands at S-1, or the slot's own value when the
    # whole row is past the cache.
    src = (safe - index.long()[:, None]).clamp(min=0)
    fits = (index < S).reshape((B,) + (1,) * (new.dim() - 1))
    cache_layer[rows, safe] = torch.where(
        fits, new[rows, src].to(cache_layer.dtype), cache_layer[rows, safe])


@dataclasses.dataclass(frozen=True)
class _LayerDropout:
    """One layer's dropout draw: the flash kernel's two seed words and the
    seed of the layer's own generator (residual dropout, and attention
    dropout on the xla path).  Seeds rather than generator state, so a
    rematerialized block redraws the same masks."""

    attn_seed: Tuple[int, int]
    seed: int
    attn_rate: float
    resid_rate: float


def _block(
    x: torch.Tensor,
    lp: Dict[str, torch.Tensor],
    cache_k: Optional[torch.Tensor],
    cache_v: Optional[torch.Tensor],
    *,
    config: LLaMAConfig,
    positions: torch.Tensor,
    bias: Optional[torch.Tensor],
    slot_pos: Optional[torch.Tensor],
    cache_index: Optional[Union[int, torch.Tensor]],
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias_new: Optional[torch.Tensor],
    impl: str,
    paged: Optional[Tuple["PagedKVCache", torch.Tensor, int]] = None,
    drop: Optional[_LayerDropout] = None,
    cache_ks: Optional[torch.Tensor] = None,
    cache_vs: Optional[torch.Tensor] = None,
    chunk_offset: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pre-norm transformer block, x: [B, T, D]; ``impl`` is the
    resolved attention path.  Writes this block's new K/V into
    ``cache_k``/``cache_v`` (views of one layer of the cache) in place; an
    int8 cache passes its scale planes as ``cache_ks``/``cache_vs`` and
    gets the quantized K/V and their scales.  ``impl="paged"`` attends
    ``paged`` = (pool cache, per-row query position, layer) through the
    paged kernel (the stock-paged kernel under ``decode_kernel ==
    "stock-paged"`` at T == 1 over a full-precision pool, JAX :750-768)
    and leaves the pool to the caller's write-back.  ``chunk_offset`` (a
    static int, the chunk's first position) lets a cached flash chunk run
    the splash kernel where ``splash_eligible`` holds (JAX :833-855).
    ``drop`` (training, cache-free) applies the layer's attention and
    residual dropout.  Returns (x, the block's new K, its new V) at full
    precision."""
    B, T, D = x.shape
    adt = x.dtype
    H, KVH, hd = config.n_heads, config.kv_heads, config.head_dim
    G = H // KVH
    softmax_dtype = torch_dtype(config.attn_softmax_dtype)
    gen = None
    if drop is not None:
        gen = torch.Generator(device=x.device).manual_seed(drop.seed)

    h = rms_norm(x, lp["attn_norm"], config.rms_norm_eps).reshape(B * T, D)
    qkv = _proj(h, lp["qkv"]).reshape(B, T, KVH, G + 2, hd)
    q = qkv[:, :, :, :G].reshape(B, T, H, hd)
    k = qkv[:, :, :, G]
    v = qkv[:, :, :, G + 1].contiguous()
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)

    int8 = cache_ks is not None
    if impl == "paged":
        pool, q_pos_row, layer = paged
        if (config.decode_kernel == "stock-paged" and T == 1
                and not pool.quantized):
            attn = stock_paged_decode_attention(
                q, k, v, pool.k, pool.v, pool.table, q_pos_row, layer=layer)
        else:
            attn = paged_decode_attention(
                q, k, v, pool.k, pool.v, pool.pos, pool.table, q_pos_row,
                layer=layer, k_scale=pool.k_scale, v_scale=pool.v_scale,
            )
    elif cache_k is not None and impl == "xla":
        if int8:
            attn = sdpa_cached(
                q, cache_k, cache_v, k, v, bias, bias_new,
                softmax_dtype=softmax_dtype, k_scale=cache_ks,
                v_scale=cache_vs,
            )
        else:
            attn = sdpa_cached(
                q, cache_k.to(adt), cache_v.to(adt), k, v, bias, bias_new,
                softmax_dtype=softmax_dtype,
            )
        # Append-free: the step's K/V land after the attention read the
        # cache (the slots they fill were masked from it).
        _cache_write_kv(cache_k, cache_v, cache_ks, cache_vs, k, v,
                        cache_index)
    elif cache_k is not None and int8:
        # int8 flash: the chunk's quantized K/V land first, then the
        # kernel attends the whole cache folding the scales (JAX
        # :781-803).
        _cache_write_kv(cache_k, cache_v, cache_ks, cache_vs, k, v,
                        cache_index)
        attn = flash_attention_quantized(q, cache_k, cache_v, cache_ks,
                                         cache_vs, positions, slot_pos)
    else:
        if cache_k is not None:
            _cache_write(cache_k, k, cache_index)
            _cache_write(cache_v, v, cache_index)
            kk, vv = cache_k.to(adt), cache_v.to(adt)
        else:
            kk, vv = k, v
        attn_rate = drop.attn_rate if drop is not None else 0.0
        if impl == "flash" and cache_k is not None and splash_eligible(
                config, batch=B, q_len=T, kv_len=kk.shape[1],
                chunk_offset=chunk_offset):
            # The insert's chunk offset is a static int: the chunk's
            # causal window is a static offset mask (no dropout with a
            # cache).
            attn = splash_prefill_attention(q, kk, vv,
                                            chunk_offset=chunk_offset)
        elif impl == "flash":
            attn = flash_attention(
                q, kk, vv, positions, slot_pos, dropout_rate=attn_rate,
                dropout_seed=drop.attn_seed if attn_rate > 0.0 else None)
        else:
            attn = sdpa(q, kk, vv, bias, softmax_dtype=softmax_dtype,
                        dropout_rate=attn_rate, generator=gen)

    attn_out = matmul(attn.reshape(B * T, H * hd), lp["o"])
    if drop is not None and drop.resid_rate > 0.0:
        attn_out = dropout(attn_out, drop.resid_rate, gen)
    x = x + attn_out.reshape(B, T, D)

    h = rms_norm(x, lp["mlp_norm"], config.rms_norm_eps).reshape(B * T, D)
    gate_up = _proj(h, lp["gate_up"])  # [N, 2, F]
    hidden = F.silu(gate_up[:, 0]) * gate_up[:, 1]
    down = matmul(hidden, lp["down"])
    if drop is not None and drop.resid_rate > 0.0:
        down = dropout(down, drop.resid_rate, gen)
    return x + down.reshape(B, T, D), k, v


def _cache_write_kv(cache_k, cache_v, cache_ks, cache_vs, k, v, index):
    """Write the step's K/V into one layer of the cache at ``index``;
    quantized first, with their scales, when the cache is int8."""
    if cache_ks is not None:
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        _cache_write(cache_ks, ks, index)
        _cache_write(cache_vs, vs, index)
    _cache_write(cache_k, k, index)
    _cache_write(cache_v, v, index)


# The "dots" remat policy: keep the outputs of plain (batch-free) matrix
# products, recompute everything else in the backward pass.
_SAVED_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    if op in _SAVED_MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, config: LLaMAConfig):
    """``fn`` under per-block rematerialization (JAX ``_remat``): "full"
    recomputes the whole block in the backward pass, "dots" saves the
    matmul outputs (the QKV, attention-out and MLP projections) and
    recomputes the elementwise work and the attention kernel."""
    kw = {}
    if config.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return run


def _layer_dropouts(generator: torch.Generator, config: LLaMAConfig):
    """Per-layer dropout draws: three uint32 words per layer from the
    generator (the flash kernel's two seed words and the layer's own
    seed), fetched in one host copy."""
    words = torch.randint(0, 2**32, (config.n_layers, 3), generator=generator,
                          device=generator.device, dtype=torch.int64).tolist()
    return [_LayerDropout((w[0], w[1]), w[2], config.attn_pdrop,
                          config.resid_pdrop) for w in words]


def _dropout_generator(dropout_rng, device) -> torch.Generator:
    if isinstance(dropout_rng, torch.Generator):
        return dropout_rng
    return torch.Generator(device=device).manual_seed(int(dropout_rng))


def forward(
    params: Params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    config: LLaMAConfig,
    cache: Optional[Union[KVCache, PagedKVCache]] = None,
    attn_mask: Optional[torch.Tensor] = None,
    compute_logits: bool = True,
    dropout_rng=None,
    output_hidden_states: bool = False,
    output_attentions: bool = False,
    output_last_hidden: bool = False,
    chunk_offset: Optional[int] = None,
):
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
        ``cache.index + T`` must not pass ``cache.max_len`` (a per-row
        index past it drops that row's writes).  A per-row index runs the
        xla path ("auto" resolves there).  A PagedKVCache runs
        ``paged_forward``.
      attn_mask: optional [B, T] bool, False for padding; defaults to
        positions >= 0.
      compute_logits: False skips the LM head and returns (None, cache),
        for non-final prefill chunks.
      output_last_hidden: also return an ``AuxOutput`` with the
        post-final-norm hidden states: (logits, cache, aux).
      dropout_rng: a ``torch.Generator`` (on the params' device) or an int
        seed enabling dropout at the config's embd/resid/attn_pdrop rates
        (training only: refused with a cache).  All rates zero: ignored.
      chunk_offset: the static (Python int) position of this call's first
        token where the caller knows it (the serving insert's chunk loop).
        Only the splash prefill kernel reads it: a cached flash chunk
        runs splash where ``ops.kernels.splash_eligible`` holds.  None
        (the default) keeps the flash kernel.
      output_hidden_states, output_attentions: the JAX signature's
        auxiliary outputs; not ported, and any value but the default
        raises NotImplementedError.
    Returns:
      (logits [B, T, V] in config.logits_dtype or None, cache or None),
      plus the AuxOutput when ``output_last_hidden``.
    """
    unported = dict(
        output_hidden_states=output_hidden_states,
        output_attentions=output_attentions,
    )
    for name, value in unported.items():
        if value is not None and value is not False:
            raise NotImplementedError(f"forward({name}=...) is not ported")
    if dropout_rng is not None and not (
        config.embd_pdrop > 0.0 or config.resid_pdrop > 0.0
        or config.attn_pdrop > 0.0
    ):
        dropout_rng = None  # all rates zero: the deterministic path
    if dropout_rng is not None and cache is not None:
        raise ValueError(
            "dropout_rng is training-only; cached decode is deterministic "
            "(pass dropout_rng=None)")
    if isinstance(cache, PagedKVCache):
        if output_last_hidden:
            raise NotImplementedError(
                "output_last_hidden is not supported on the paged path")
        return paged_forward(params, tokens, positions, config, cache,
                             attn_mask=attn_mask,
                             compute_logits=compute_logits)
    if cache is not None and not isinstance(cache, KVCache):
        raise NotImplementedError(f"{type(cache).__name__} is not ported")
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
    per_row = cache is not None and cache.per_row_index
    if cache is not None and not per_row and cache.index + T > cache.max_len:
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
    drops = [None] * config.n_layers
    if dropout_rng is not None:
        gen = _dropout_generator(dropout_rng, device)
        if config.embd_pdrop > 0.0:
            x = dropout(x, config.embd_pdrop, gen)
        if config.resid_pdrop > 0.0 or config.attn_pdrop > 0.0:
            drops = _layer_dropouts(gen, config)

    impl = config.attn_impl
    if impl == "auto":
        impl = "flash" if T > FLASH_MIN_SEQ and not per_row else "xla"
    if per_row and impl != "xla":
        raise NotImplementedError(
            "per-row cache indices (continuous batching) run on the xla "
            "attention path only")
    xla_cached = cache is not None and impl == "xla"

    new_slot_pos = torch.where(
        attn_mask, q_positions, torch.full_like(q_positions, -1)
    )
    if cache is not None:
        slot_pos = cache.pos.clone()
        # the positions plane as a [B, S, 1, 1] "layer"
        _cache_write(slot_pos[..., None, None], new_slot_pos[..., None, None],
                     cache.index)
    else:
        slot_pos = new_slot_pos.contiguous()
    bias = bias_new = None
    if xla_cached:
        bias = attention_bias(q_positions, cache.pos, cache.pos >= 0)
        bias_new = attention_bias(q_positions, new_slot_pos, attn_mask)
    elif impl != "flash":
        bias = attention_bias(q_positions, slot_pos, slot_pos >= 0)

    # unbind, not w[i]: its backward stacks the per-layer gradients once
    # instead of adding a zero-filled full-stack gradient per layer.
    lp = params["layers"]
    layers = [dict(zip(lp, ws))
              for ws in zip(*(w.unbind(0) for w in lp.values()))]

    def block(x, lp_i, drop):
        return _block(
            x, lp_i, None, None, config=config, positions=q_positions,
            bias=bias, slot_pos=slot_pos, cache_index=None, cos=cos, sin=sin,
            bias_new=bias_new, impl=impl, drop=drop,
        )[0]

    if config.remat and cache is None and torch.is_grad_enabled():
        block = _remat(block, config)
    for i, lp_i in enumerate(layers[:config.n_layers]):
        if cache is None:
            x = block(x, lp_i, drops[i])
            continue
        x, _, _ = _block(
            x, lp_i, cache.k[i], cache.v[i],
            config=config, positions=q_positions, bias=bias,
            slot_pos=slot_pos, cache_index=cache.index,
            cos=cos, sin=sin, bias_new=bias_new, impl=impl,
            cache_ks=cache.k_scale[i] if cache.quantized else None,
            cache_vs=cache.v_scale[i] if cache.quantized else None,
            chunk_offset=chunk_offset,
        )

    if output_last_hidden:
        h = rms_norm(x, params["final_norm"], config.rms_norm_eps)
        logits = (lm_head_logits(params, h, config, normed=True)
                  if compute_logits else None)
    else:
        logits = lm_head_logits(params, x, config) if compute_logits else None
    if cache is not None:
        cache.pos.copy_(slot_pos)
        cache.index = cache.index + T
    if output_last_hidden:
        return logits, cache, AuxOutput(last_hidden_state=h)
    return logits, cache


def paged_forward(
    params: Params,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    config: LLaMAConfig,
    cache: PagedKVCache,
    attn_mask: Optional[torch.Tensor] = None,
    compute_logits: bool = True,
    write_back: bool = True,
) -> Tuple[Optional[torch.Tensor], PagedKVCache]:
    """One decode step of T tokens per row over a paged block pool (T = 1
    is plain decode, T = n_draft + 1 the speculative verify).

    Every layer's attention runs the paged kernel
    (``ops.paged_attention``), which walks ``cache.table`` itself and
    reads the layer's plane of the pool once for all T tokens of a row;
    the step's own K/V merge at the softmax level.  After the last layer
    the step's K/V and positions land in the pool through
    ``paged_write_indices``/``paged_pool_write`` (the write-back contract
    the serving gathered view shares).

    Contract for T > 1 (the kernel derives token t's position as
    ``positions[:, 0] + t``): each active row's positions are consecutive
    and its mask is the same along T.  A row that breaks either is folded
    to inactive (JAX :1486-1500), never trusted.

    The pool is updated IN PLACE (cache.k, cache.v, cache.pos) and the
    same ``cache`` object is returned; ``cache.fill`` is the caller's to
    advance.  ``write_back=False`` leaves the pool untouched (the
    speculative draft chain, whose JAX twin discards the returned pool).
    Rows with ``attn_mask`` False (or position -1) are inactive: they
    attend nothing, their logits are garbage the caller ignores, and
    their write-back is dropped.  An int8 pool (``cache.k_scale``) is read
    through the kernel's scale fold; the step's K/V are quantized for the
    write-back, their scales landing in the scale planes under the same
    rule of dropping dead pairs.
    """
    B, T = tokens.shape
    config.validate()
    device = _params_device(params)
    tokens = tokens.to(device)
    positions = positions.to(device=device, dtype=torch.int32)
    adt = config.activation_dtype
    if attn_mask is None:
        attn_mask = positions >= 0
    attn_mask = attn_mask.to(device=device, dtype=torch.bool)
    q_positions = positions.clamp(min=0).contiguous()
    NB, BLK = cache.pos.shape
    MB = cache.table.shape[1]
    cos, sin = _rope_tables(
        config.head_dim, max(2 * config.max_seq_len, MB * BLK),
        config.rope_theta, config.use_scaled_rope, device,
    )
    x = params["embed"]["embedding"][tokens.long()].to(adt)
    active = attn_mask[:, 0]
    if T > 1:
        steps = torch.arange(T, device=device, dtype=torch.int32)
        active = (active & (attn_mask == attn_mask[:, :1]).all(dim=1)
                  & (positions == positions[:, :1] + steps).all(dim=1))
    q_pos_row = torch.where(active, positions[:, 0], -1).to(torch.int32)

    lp = params["layers"]
    new_k, new_v = [], []
    for i in range(config.n_layers):
        x, k, v = _block(
            x, {name: w[i] for name, w in lp.items()}, None, None,
            config=config, positions=q_positions, bias=None, slot_pos=None,
            cache_index=None, cos=cos, sin=sin, bias_new=None, impl="paged",
            paged=(cache, q_pos_row, i),
        )
        if write_back:
            new_k.append(k)
            new_v.append(v)
    logits = lm_head_logits(params, x, config) if compute_logits else None
    if not write_back:
        return logits, cache

    blk, off, _ = paged_write_indices(
        cache.table, cache.fill, active, T, NB, BLK)
    new_k, new_v = torch.stack(new_k), torch.stack(new_v)
    if cache.quantized:
        new_k, k_s = quantize_kv(new_k)
        new_v, v_s = quantize_kv(new_v)
        # [L, B, T, KVH] -> [L, KVH, B, T]
        paged_pool_write(cache.k_scale, k_s.movedim(3, 1), blk, off)
        paged_pool_write(cache.v_scale, v_s.movedim(3, 1), blk, off)
    # [L, B, T, KVH, hd] -> [L, KVH, B, T, hd]
    paged_pool_write(cache.k, new_k.movedim(3, 1), blk, off)
    paged_pool_write(cache.v, new_v.movedim(3, 1), blk, off)
    paged_pool_write(cache.pos, torch.where(active[:, None], positions, -1),
                     blk, off)
    return logits, cache
