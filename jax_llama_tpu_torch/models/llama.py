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

``forward(output_hidden_states=True)`` returns every block's input and
the final hidden state on whichever attention path the config resolves;
``output_attentions=True`` forces the xla path, the only one that
materializes the probabilities.

Tensor and data parallelism (``parallel``; one process per rank): under
``parallel.use_mesh(mesh)`` every rank calls ``forward`` with the GLOBAL
tokens and positions and its own shard of the weights
(``parallel.shard_params``), and gets the GLOBAL outputs back.  Over
``tensor`` the qkv projection is column-parallel over KV heads (each rank
attends its H/tp query heads and KVH/tp KV heads through the same
kernels), ``o`` and ``down`` are row-parallel and followed by an
``all_reduce``, the embedding is vocab-sharded (a masked gather and an
``all_reduce``) and the LM head column-parallel (an ``all_gather`` of the
logits).  Over the row axes (``data`` x ``fsdp``) a rank runs its own
rows when the row count divides them, and runs every row otherwise (a
single fused-chunk row, B = 1); the outputs are all-gathered over the
rows.  KV caches and the paged pool hold this rank's KV-head slice and
every row, as the JAX package's pool replicates over ``data``: the new
K/V of a row-split step are all-gathered over the rows before they land,
so every data rank holds every row's KV.  A sharded tree without a mesh,
or a mesh whose tensor axis does not match the tree, raises.

Sequence, pipeline and ZeRO-3 axes (``parallel.ring``,
``parallel.pipeline``):

* ``attn_impl="ring"`` without a cache on a ``seq > 1`` mesh: each seq
  rank runs its contiguous T / seq slice of every row and attends through
  ``ring_sdpa``; the outputs are gathered over ``seq``.  With a cache on
  a ``seq > 1`` mesh the cache holds this rank's S / seq slots
  (``init_cache``) and every seq rank runs the step's tokens through
  ``ring_decode`` over the PRE-step cache, landing the part of the
  step's K/V that falls in its own slots afterwards (a lockstep index
  only).  ``ring`` on ``seq == 1`` is dense ``sdpa`` without a cache and
  the flash branch with one (JAX :817-833).
* ``stage > 1``: the tree holds this stage's L / stage layers and the
  block stack runs ``pipeline_blocks`` (``config.pp_microbatches``
  microbatches, ``stage`` by default); no cache, no per-layer outputs,
  no ``seq > 1`` (JAX :1165-1230).
* A tree sharded with ``fsdp=True`` is all-gathered a layer at a time
  before use (inside the block, so remat gathers again in the backward
  pass); the gather's backward reduce-scatters the gradient.

Under autograd the collectives go through ``Mesh``'s differentiable
forms: *f* (``copy_f``) in front of the column-parallel qkv, gate_up and
LM head products, *g* (``reduce_g``) after the row-parallel o and down
products and the vocab-sharded embedding, ``gather_slice`` for the
logits.  ``forward(local_rows=True)`` (the training loss under a mesh)
takes this rank's rows, as ``data.shard_batch`` gives them, and returns
this rank's rows and sequence slice.  Dropout on a mesh draws every
generator mask (embedding, residual, the xla path's attention) whole
from the layer's generator and keeps this rank's slice, so the masks are
the unsharded run's; the ring path's mask is the position hash keyed on
global rows and heads, and the flash kernel's hash is keyed on global
rows and KV heads too (each rank passes its first row and KV head as
``dropout_offsets``), so its masks are the unsharded run's, as the JAX
package's are (GSPMD never partitions its ``pallas_call``).

Layout helpers (JAX :499-:580): ``rope_permute`` moves q/k features
between Meta's interleaved RoPE order and the half-split order,
``fuse_qkv``/``split_qkv`` pack and unpack the fused qkv slots,
``permute_d_axis`` and ``fuse_params`` bring older layer trees (separate
q/k/v and gate/up, or D-first) to this layout.
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
from ..parallel.mesh import (
    ROWS,
    constrain,
    current_mesh,
    local_size,
    use_mesh,
)
from ..parallel.partition import (
    local_shape,
    mesh_specs,
    param_partition_specs,
    shard_index,
    validate_tp,
)
from ..parallel.pipeline import pipeline_blocks
from ..parallel.ring import ring_decode, ring_sdpa
from ..parallel.serve_mesh import constrain_pool, constrain_view, fits

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


def _seq_cached(config: LLaMAConfig, mesh) -> bool:
    """Whether a cache on ``mesh`` is sharded along its slots: ring
    attention on a ``seq > 1`` mesh."""
    return (config.attn_impl == "ring" and mesh is not None
            and mesh.shape["seq"] > 1)


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
    """``forward``'s third output when any of ``output_last_hidden``,
    ``output_hidden_states`` or ``output_attentions`` is set (JAX
    :912-940, the reference model's own outputs).

    hidden_states: [L+1, B, T, D] or None: entries 0..L-1 are each
      block's input (entry 0 the embedding output), entry L the
      post-final-norm hidden state.
    last_hidden_state: [B, T, D] post-final-norm hidden state (feed it
      to ``lm_head_logits(..., normed=True)``); always present.
    attentions: [L, B, H, T, S] post-softmax attention probabilities or
      None; on the cached path S spans the cache slots, then the step's
      new tokens.
    """

    last_hidden_state: torch.Tensor
    hidden_states: Optional[torch.Tensor] = None
    attentions: Optional[torch.Tensor] = None


def init_cache(
    config: LLaMAConfig,
    batch: int,
    max_len: Optional[int] = None,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> KVCache:
    """Allocate an empty cache on ``device``: int8 payload with zero
    scales when ``config.kv_cache_dtype == "int8"`` and no ``dtype`` is
    given (JAX :434-452).  Under an active mesh the cache holds this
    rank's KV-head slice (KVH/tp heads) and every row; under
    ``attn_impl="ring"`` on a ``seq > 1`` mesh, this rank's contiguous
    ``max_len / seq`` slots (``ring_decode``'s shard)."""
    config.validate()
    device = resolve_device(device)
    max_len = max_len or config.max_seq_len
    int8_kv = config.kv_cache_dtype == "int8" and dtype is None
    dtype = torch.int8 if int8_kv else (dtype or config.activation_dtype)
    mesh = current_mesh()
    kvh = local_size(mesh, config.kv_heads, "tensor")
    if _seq_cached(config, mesh):
        n = mesh.shape["seq"]
        if max_len % n:
            raise ValueError(
                f"a seq-sharded cache needs seq={n} to divide its "
                f"{max_len} slots")
        max_len //= n
    shape = (config.n_layers, batch, max_len, kvh, config.head_dim)

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
    mesh=None,
) -> Params:
    """Random weights drawn on ``device`` from ``generator`` (or a fresh
    one seeded with ``seed``): normal with std 0.02 for the embedding and
    fan-in scaling for the projections, norms at 1 — the JAX package's
    scheme, though not its numbers (threefry and torch's generator
    differ).  Stacked weights are drawn one layer at a time, so the
    float32 scratch stays one layer's size.

    With ``mesh`` the result is this rank's shard (``shard_params``) of
    the very tree drawn without one: every rank draws every slice in the
    same order and keeps the part its shard holds, so no rank ever holds
    the full tree.

    On ``device="meta"`` the tree holds shapes and dtypes only: nothing
    is drawn or allocated (the full-size shape checks of
    ``rehearsal.rehearse_8b_shapes``)."""
    config.validate()
    device = resolve_device(device)
    if mesh is not None:
        validate_tp(config, mesh)
    specs = (mesh_specs(config, mesh) if mesh is not None
             else param_partition_specs(config))
    meta = device.type == "meta"
    if generator is None and not meta:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, H, KVH, hd, F_, V, L = (
        config.dim, config.n_heads, config.kv_heads, config.head_dim,
        config.ffn_dim, config.vocab_size, config.n_layers,
    )
    G = H // KVH
    wd = config.weight_dtype

    def dense(shape, std, spec):
        if meta:
            return torch.empty(shape if mesh is None
                               else local_shape(mesh, spec, shape),
                               dtype=wd, device=device)
        if mesh is None:
            out = torch.empty(shape, dtype=wd, device=device)
            flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
            for i in range(flat.shape[0]):
                flat[i].copy_(torch.randn(
                    flat.shape[1:], generator=generator, device=device,
                    dtype=torch.float32,
                ) * std)
            return out
        # The same draws in the same order; each lands only where this
        # rank's shard holds it.
        idx = shard_index(mesh, spec, shape)
        out = torch.empty(local_shape(mesh, spec, shape), dtype=wd,
                          device=device)
        lead, tail = shape[:-2], shape[-2:]
        for mi in np.ndindex(*lead):
            draw = torch.randn(tail, generator=generator, device=device,
                               dtype=torch.float32)
            if all(s.start is None or s.start <= i < s.stop
                   for i, s in zip(mi, idx)):
                at = tuple(i - (s.start or 0) for i, s in zip(mi, idx))
                out[at].copy_(draw[idx[len(lead):]] * std)
        return out

    def ones(shape, spec):
        if mesh is not None:
            shape = local_shape(mesh, spec, shape)
        return torch.ones(shape, dtype=wd, device=device)

    ls = specs["layers"]
    params: Params = {
        "embed": {"embedding": dense((V, D), 0.02,
                                     specs["embed"]["embedding"])},
        "layers": {
            "attn_norm": ones((L, D), ls["attn_norm"]),
            "qkv": dense((L, KVH, G + 2, D, hd), D ** -0.5, ls["qkv"]),
            "o": dense((L, H, hd, D), D ** -0.5, ls["o"]),
            "mlp_norm": ones((L, D), ls["mlp_norm"]),
            "gate_up": dense((L, 2, D, F_), D ** -0.5, ls["gate_up"]),
            "down": dense((L, F_, D), F_ ** -0.5, ls["down"]),
        },
        "final_norm": ones((D,), specs["final_norm"]),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = dense((D, V), D ** -0.5, specs["lm_head"])
    return params


def _tensor_from_numpy(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def rope_permute(w: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Permute a projection weight's trailing head_dim axis between Meta's
    interleaved RoPE feature order and the runtime half-split order
    (``ops.rope``): forward maps Meta feature 2i -> i and 2i+1 -> i + hd/2,
    ``inverse`` undoes it (JAX ``models/llama.py:499``).  Exact: it only
    moves elements."""
    *lead, hd = w.shape
    if inverse:
        return w.reshape(*lead, 2, hd // 2).transpose(-1, -2).reshape(w.shape)
    return w.reshape(*lead, hd // 2, 2).transpose(-1, -2).reshape(w.shape)


def fuse_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Pack separate projection weights q [..., D, H, hd] and k, v
    [..., D, KVH, hd] (Meta interleaved-RoPE feature order) into the fused
    [..., KVH, G+2, D, hd] layout: slots [q_0..q_{G-1}, k, v] per KV head
    (query head h = kvh*G + g), q/k features in the half-split order, v
    as it was (JAX :513)."""
    *lead, D, H, hd = q.shape
    KVH = k.shape[-2]
    G = H // KVH
    qg = torch.movedim(
        rope_permute(q).reshape(*lead, D, KVH, G, hd), -4, -2)
    kk = rope_permute(k).transpose(-3, -2).unsqueeze(-3)
    vv = v.transpose(-3, -2).unsqueeze(-3)
    return torch.cat([qg, kk, vv], dim=-3)


def split_qkv(qkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Inverse of ``fuse_qkv``: (q [..., D, H, hd], k, v [..., D, KVH, hd])
    in Meta interleaved-RoPE feature order (JAX :536)."""
    *lead, KVH, g2, D, hd = qkv.shape
    G = g2 - 2
    q = torch.movedim(qkv[..., :G, :, :], -2, -4).reshape(
        *lead, D, KVH * G, hd)
    return (
        rope_permute(q, inverse=True),
        rope_permute(qkv[..., G, :, :].transpose(-3, -2), inverse=True),
        qkv[..., G + 1, :, :].transpose(-3, -2).contiguous(),
    )


def permute_d_axis(lp: Dict[str, Any], to_d_first: bool) -> Dict[str, Any]:
    """Move the contracted D axis of the layer tree's qkv (between -2 and
    -4) and gate_up (between -2 and -3): the current layout <-> the older
    D-first fused layout (JAX :553).  A ``QuantizedTensor`` moves its
    payload and its scale together (the scale keeps size-1 contracted
    dims in the same positions), so int8 trees move exactly."""
    def mv(x, src, dst):
        if isinstance(x, QuantizedTensor):
            return QuantizedTensor(q=torch.movedim(x.q, src, dst).contiguous(),
                                   scale=torch.movedim(x.scale, src,
                                                       dst).contiguous())
        return torch.movedim(x, src, dst).contiguous()

    lp = dict(lp)
    if to_d_first:
        lp["qkv"] = mv(lp["qkv"], -2, -4)
        lp["gate_up"] = mv(lp["gate_up"], -2, -3)
    else:
        lp["qkv"] = mv(lp["qkv"], -4, -2)
        lp["gate_up"] = mv(lp["gate_up"], -3, -2)
    return lp


def fuse_params(params: Params) -> Params:
    """An older layer tree in the current fused layout (JAX :580):
    separate q/k/v + gate/up are fused (``fuse_qkv``), the D-first fused
    layout (qkv [L, D, KVH, G+2, hd], gate_up [L, D, 2, F]) has its D
    axis moved; a current tree is returned as it is.  A quantized tree in
    the separate layout is refused: its scales do not concatenate."""
    lp = dict(params["layers"])
    if "qkv" in lp:
        d_model = lp["attn_norm"].shape[-1]
        if (lp["qkv"].shape[-4] == d_model
                and lp["gate_up"].shape[-3] == d_model):
            # D == KVH cannot alias: KVH is a head count, D the model dim.
            return dict(params, layers=permute_d_axis(lp, to_d_first=False))
        return params
    if any(isinstance(lp.get(k), QuantizedTensor)
           for k in ("q", "k", "v", "gate", "up")):
        raise NotImplementedError(
            "an int8-quantized layer tree in the separate q/k/v layout "
            "cannot be fused (its scales do not concatenate); quantize the "
            "full-precision tree with quantize_params instead")
    lp["qkv"] = fuse_qkv(lp.pop("q"), lp.pop("k"), lp.pop("v"))
    lp["gate_up"] = torch.stack([lp.pop("gate"), lp.pop("up")], dim=-3)
    return dict(params, layers=lp)


def from_jax_params(tree, device="cuda", dtype: Optional[torch.dtype] = None) -> Params:
    """Convert the JAX package's parameter tree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into the port's, same dtype
    unless ``dtype`` is given.  A quantized tree's weights (any node with
    ``.q`` and ``.scale``, the JAX ``QuantizedTensor``) become
    ``QuantizedTensor``s: int8 payload and float32 scales, never cast.
    An older layer tree (separate q/k/v and gate/up, or D-first) is
    brought to the fused layout by ``fuse_params``."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QuantizedTensor(
                q=_tensor_from_numpy(node.q, device, torch.int8),
                scale=_tensor_from_numpy(node.scale, device, torch.float32))
        return _tensor_from_numpy(node, device, dtype)

    params = fuse_params(conv(tree))
    expected = {"attn_norm", "qkv", "o", "mlp_norm", "gate_up", "down"}
    if set(params["layers"]) != expected:
        raise ValueError(
            f"layer tree {sorted(params['layers'])} is neither the fused "
            f"layout {sorted(expected)} nor an older one fuse_params knows")
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


def _gather_fsdp(w, dim: int):
    """A leaf sharded over ``fsdp`` along ``dim``, all-gathered (its
    backward reduce-scatters the gradient)."""
    mesh = current_mesh()
    if mesh is None or mesh.axis_size("fsdp") == 1:
        return w
    if isinstance(w, QuantizedTensor):
        raise NotImplementedError(
            "an fsdp-sharded tree is full precision (training); quantize "
            "a tree sharded without fsdp")
    return mesh.gather_scatter(w, "fsdp", dim)


def _head_kernel(params: Params, config: LLaMAConfig, fsdp: bool):
    """The LM head [D, V_local] (the tied embedding transposed), with an
    fsdp-sharded tree's D (untied) or V (tied) gathered."""
    if config.tie_word_embeddings:
        table = params["embed"]["embedding"]
        return (_gather_fsdp(table, 0) if fsdp else table).T
    head = params["lm_head"]
    return _gather_fsdp(head, 0) if fsdp else head


def lm_head_logits(
    params: Params, x: torch.Tensor, config: LLaMAConfig, normed: bool = False
) -> torch.Tensor:
    """Final RMSNorm + (tied or untied) LM head: [B, T, D] -> [B, T, V]
    in config.logits_dtype.  ``normed=True``: x is already the
    post-final-norm hidden state."""
    if not normed:
        x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    mesh = current_mesh()
    kernel = _head_kernel(params, config, _fsdp_sharded(params, config))
    B, T, D = x.shape
    if mesh is not None:
        x = mesh.copy_f(x, "tensor")   # column-parallel head
    if isinstance(kernel, QuantizedTensor):
        logits = (matmul_f32_out(x.reshape(B * T, D), kernel.q)
                  * kernel.scale.reshape(-1))
    else:
        logits = matmul_f32_out(x.reshape(B * T, D), kernel)
    logits = logits.reshape(B, T, -1).to(torch_dtype(config.logits_dtype))
    if mesh is not None:
        # Column-parallel head: each tensor rank holds V/tp logits.
        constrain(logits, None, None, "tensor",
                  full=(None, None, config.vocab_size))
        logits = mesh.gather_slice(logits, "tensor", dim=-1)
    return logits


def _embed(params: Params, tokens: torch.Tensor, config: LLaMAConfig,
           dtype: torch.dtype, fsdp: bool = False) -> torch.Tensor:
    """The token embedding; over a vocab-sharded table (tensor > 1) a
    masked gather of this rank's rows and an ``all_reduce``, which is
    exact (one rank contributes each row, the others zeros).  An
    fsdp-sharded table is gathered over ``fsdp`` first."""
    table = params["embed"]["embedding"]
    if fsdp:
        table = _gather_fsdp(table, 0)
    mesh = current_mesh()
    if mesh is None or mesh.axis_size("tensor") == 1:
        return table[tokens.long()].to(dtype)
    constrain(table, "tensor", None, full=(config.vocab_size, None))
    n = table.shape[0]
    local = tokens.long() - mesh.axis_index("tensor") * n
    hit = (local >= 0) & (local < n)
    x = torch.where(hit[..., None], table[local.clamp(0, n - 1)].to(dtype),
                    torch.zeros((), dtype=dtype, device=table.device))
    return mesh.reduce_g(x, "tensor")


def _fsdp_sharded(params: Params, config: LLaMAConfig) -> bool:
    """Whether ``params`` is a tree sharded with ``fsdp=True``: its
    layers hold D / fsdp of the model dimension."""
    qkv = params["layers"]["qkv"]
    d = (qkv.q if isinstance(qkv, QuantizedTensor) else qkv).shape[-2]
    if d == config.dim:
        return False
    mesh = current_mesh()
    fs = mesh.axis_size("fsdp") if mesh is not None else 1
    if d * fs != config.dim:
        raise ValueError(
            f"the weights hold {d} of dim={config.dim} (an fsdp shard); run "
            "under the mesh they were sharded for (parallel.use_mesh, or "
            "mesh=)")
    return True


@dataclasses.dataclass(frozen=True)
class _Shard:
    """How one forward call splits over the active mesh.

    rows: this rank's slice of the rows when they split over the row
      axes (global inputs; None: every row runs here).
    local: the inputs are already this rank's rows (``local_rows``); the
      outputs stay this rank's.
    row0, n_rows: the global index of this rank's first row and the
      global row count.
    seq: this rank's slice of T (ring attention on ``seq > 1``).
    fsdp: the weights are fsdp-sharded (gathered per use).
    """

    mesh: Any
    rows: Optional[slice]
    local: bool = False
    row0: int = 0
    n_rows: int = 0
    seq: Optional[slice] = None
    fsdp: bool = False

    def take(self, t):
        """This rank's rows of a per-row input (identity off-split).  A
        slice that does not start on a 16-byte boundary is copied: the
        kernels read their position and table arrays with aligned vector
        loads and refuse a misaligned pointer."""
        if self.rows is None or not isinstance(t, torch.Tensor):
            return t
        part = t[self.rows]
        return part if part.data_ptr() % 16 == 0 else part.clone()

    def take_seq(self, t):
        """This rank's slice of T of a [B, T, ...] input (identity
        off-split)."""
        if self.seq is None or t is None:
            return t
        return t[:, self.seq].contiguous()

    def view(self, t):
        """This rank's rows of a cache plane, as a view written in place
        (identity off-split)."""
        if self.rows is None or t is None:
            return t
        return t[self.rows]

    def gather(self, t: Optional[torch.Tensor], dim: int = 0):
        """Every row's value of a per-row output (identity off-split, and
        when the outputs stay local)."""
        if self.rows is None or t is None or self.local:
            return t
        return self.mesh.gather_slice(t, ROWS, dim=dim)

    def gather_seq(self, t: Optional[torch.Tensor], dim: int = 1):
        """Every position's value of an output split over ``seq``."""
        if self.seq is None or t is None or self.local:
            return t
        return self.mesh.gather_slice(t, "seq", dim=dim)

    def place(self, n_local: int, t_full: int, row0: int = None):
        """Where ``n_local`` rows starting at global row ``row0`` (this
        rank's first by default) sit: (global rows, global T, row slice,
        T slice), for dropout masks drawn whole."""
        r0 = self.row0 if row0 is None else row0
        return (self.n_rows, t_full, slice(r0, r0 + n_local),
                self.seq if self.seq is not None else slice(None))


def _shard_ctx(params: Params, config: LLaMAConfig, n_rows: int,
               local: bool = False, split_rows: bool = True,
               seq_len: Optional[int] = None) -> _Shard:
    """Check the weights against the active mesh (a shard without one,
    or a shard of another tensor width, raises) and split the rows (not
    with ``split_rows=False``) and, given ``seq_len`` (ring attention),
    the sequence."""
    mesh = current_mesh()
    kvh = params["layers"]["qkv"].shape[-4]
    if mesh is None:
        if kvh != config.kv_heads:
            raise ValueError(
                f"the weights hold {kvh} of {config.kv_heads} KV heads (a "
                "tensor-parallel shard); run under the mesh they were "
                "sharded for (parallel.use_mesh, or mesh=)")
        _fsdp_sharded(params, config)
        return _Shard(None, None, n_rows=n_rows)
    constrain(params["layers"]["qkv"], None, "tensor",
              full=(None, config.kv_heads))
    fsdp = _fsdp_sharded(params, config)
    seq = None
    if seq_len is not None and mesh.shape["seq"] > 1:
        n = mesh.shape["seq"]
        if seq_len % n:
            raise ValueError(
                f"ring attention over seq={n} needs it to divide the "
                f"{seq_len} tokens of the call")
        i = mesh.axis_index("seq")
        seq = slice(i * (seq_len // n), (i + 1) * (seq_len // n))
    rows = mesh.axis_size(ROWS)
    if local:
        return _Shard(mesh, None, local=True,
                      row0=mesh.axis_index(ROWS) * n_rows,
                      n_rows=n_rows * rows, seq=seq, fsdp=fsdp)
    if split_rows and rows > 1 and fits(mesh, config.kv_heads, n_rows):
        b = n_rows // rows
        i = mesh.axis_index(ROWS)
        return _Shard(mesh, slice(i * b, (i + 1) * b), row0=i * b,
                      n_rows=n_rows, seq=seq, fsdp=fsdp)
    return _Shard(mesh, None, n_rows=n_rows, seq=seq, fsdp=fsdp)


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
    weights_out: Optional[list] = None,
    splash: bool = False,
    place: Optional[Tuple] = None,
    fsdp: bool = False,
    ring_new_pos: Optional[torch.Tensor] = None,
    ring_lo: int = 0,
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
    static int, the chunk's first position) is the splash kernel's causal
    offset: a cached flash chunk runs splash when the caller found it
    ``splash_eligible`` (``splash``; JAX :833-855).  Head counts are read
    from the weights, so a tensor-parallel shard attends its own H/tp
    query and KVH/tp KV heads; its ``o`` and ``down`` partial products
    are summed over ``tensor`` (``all_reduce``).
    ``drop`` (training, cache-free) applies the layer's attention and
    residual dropout.  ``weights_out`` (a list; the xla path only)
    receives the block's attention probabilities.  ``place`` (a mesh
    call; ``_Shard.place``) says where x's rows and tokens sit in the
    global batch, for the dropout masks and the kernels' offsets;
    ``fsdp`` gathers the layer's fsdp-sharded weights first.
    ``impl="ring"`` attends through ``ring_sdpa`` (cache-free);
    ``impl="ring_decode"`` through ``ring_decode`` over the pre-step
    cache shard (``slot_pos``), the step's own positions in
    ``ring_new_pos``, then lands the step's K/V where they fall in this
    rank's slots, which start at global slot ``ring_lo``.  Returns (x,
    the block's new K, its new V) at full precision."""
    if fsdp:
        lp = _gather_layer(lp)
    B, T, D = x.shape
    adt = x.dtype
    hd = config.head_dim
    G = config.n_heads // config.kv_heads
    KVH = lp["qkv"].shape[-4]       # this rank's KV heads
    H = KVH * G
    mesh = current_mesh()
    softmax_dtype = torch_dtype(config.attn_softmax_dtype)
    gen = None
    if drop is not None:
        gen = torch.Generator(device=x.device).manual_seed(drop.seed)
    kvh_off = mesh.axis_index("tensor") * KVH if mesh is not None else 0
    if place is None:
        place = (B, T, slice(None), slice(None))
    n_rows, t_full, rows, tsl = place

    def resid_drop(y):
        return dropout(y, drop.resid_rate, gen,
                       ((n_rows, t_full, D), (rows, tsl)))

    h = rms_norm(x, lp["attn_norm"], config.rms_norm_eps).reshape(B * T, D)
    if mesh is not None:
        h = mesh.copy_f(h, "tensor")          # column-parallel qkv
    qkv = _proj(h, lp["qkv"]).reshape(B, T, KVH, G + 2, hd)
    q = qkv[:, :, :, :G].reshape(B, T, H, hd)
    k = qkv[:, :, :, G]
    v = qkv[:, :, :, G + 1].contiguous()
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)

    int8 = cache_ks is not None
    want_w = weights_out is not None
    if impl == "ring_decode":
        # Seq-sharded cached decode: this rank's slots of the pre-step
        # cache, combined over ``seq``; the step's K/V merge at the
        # softmax level, then land where they fall in this rank's slots
        # (JAX :685-705).
        if int8:
            attn = ring_decode(q, cache_k, cache_v, slot_pos, k, v,
                               positions, ring_new_pos,
                               softmax_dtype=softmax_dtype,
                               k_scale=cache_ks, v_scale=cache_vs)
        else:
            attn = ring_decode(q, cache_k.to(adt), cache_v.to(adt),
                               slot_pos, k, v, positions, ring_new_pos,
                               softmax_dtype=softmax_dtype)
        _seq_write_kv(cache_k, cache_v, cache_ks, cache_vs, k, v,
                      cache_index - ring_lo)
    elif impl == "paged":
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
                v_scale=cache_vs, return_weights=want_w,
            )
        else:
            attn = sdpa_cached(
                q, cache_k.to(adt), cache_v.to(adt), k, v, bias, bias_new,
                softmax_dtype=softmax_dtype, return_weights=want_w,
            )
        if want_w:
            attn, w = attn
            weights_out.append(w)
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
        if impl == "ring" and mesh is not None and mesh.shape["seq"] > 1:
            attn = ring_sdpa(
                q, kk, vv, positions, slot_pos,
                dropout_rng=drop.attn_seed if attn_rate > 0.0 else None,
                dropout_rate=attn_rate,
                b_off=rows.start or 0, h_off=kvh_off * G)
        elif impl == "flash" and cache_k is not None and splash:
            # The insert's chunk offset is a static int: the chunk's
            # causal window is a static offset mask (no dropout with a
            # cache).
            attn = splash_prefill_attention(q, kk, vv,
                                            chunk_offset=chunk_offset)
        elif impl == "flash":
            attn = flash_attention(
                q, kk, vv, positions, slot_pos, dropout_rate=attn_rate,
                dropout_seed=drop.attn_seed if attn_rate > 0.0 else None,
                dropout_offsets=(rows.start or 0, kvh_off))
        else:
            S = kk.shape[1]
            attn = sdpa(q, kk, vv, bias, softmax_dtype=softmax_dtype,
                        dropout_rate=attn_rate, generator=gen,
                        return_weights=want_w, dropout_shard=(
                            (n_rows, config.kv_heads, G, T, S),
                            (rows, slice(kvh_off, kvh_off + KVH))))
            if want_w:
                attn, w = attn
                weights_out.append(w)

    attn_out = matmul(attn.reshape(B * T, H * hd), lp["o"])
    if mesh is not None:
        attn_out = mesh.reduce_g(attn_out, "tensor")   # row-parallel o
    if drop is not None and drop.resid_rate > 0.0:
        attn_out = resid_drop(attn_out)
    x = x + attn_out.reshape(B, T, D)

    h = rms_norm(x, lp["mlp_norm"], config.rms_norm_eps).reshape(B * T, D)
    if mesh is not None:
        h = mesh.copy_f(h, "tensor")          # column-parallel gate_up
    gate_up = _proj(h, lp["gate_up"])  # [N, 2, F]
    hidden = F.silu(gate_up[:, 0]) * gate_up[:, 1]
    down = matmul(hidden, lp["down"])
    if mesh is not None:
        down = mesh.reduce_g(down, "tensor")  # row-parallel down
    if drop is not None and drop.resid_rate > 0.0:
        down = resid_drop(down)
    return x + down.reshape(B, T, D), k, v


# The fsdp-sharded dimension of each per-layer weight (JAX partition :56).
_FSDP_DIMS = {"qkv": -2, "o": -1, "gate_up": -2, "down": -1}


def _gather_layer(lp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One layer's fsdp-sharded weights, all-gathered (ZeRO-3)."""
    return {name: (_gather_fsdp(w, _FSDP_DIMS[name]) if name in _FSDP_DIMS
                   else w) for name, w in lp.items()}


def _seq_part(S: int, T: int, local_index: int):
    """Of T tokens landing at ``local_index`` of a slot shard of S slots
    (the global index less the shard's first slot): (the tokens that
    fall in ``[0, S)``, their first slot), or None."""
    lo, hi = max(local_index, 0), min(local_index + T, S)
    if lo >= hi:
        return None
    return slice(lo - local_index, hi - local_index), lo


def _seq_write_kv(cache_k, cache_v, cache_ks, cache_vs, k, v,
                  local_index: int) -> None:
    """Land the part of the step's [B, T] K/V that falls in a slot shard
    (``_seq_part``); quantized first when the cache is int8."""
    part = _seq_part(cache_k.shape[1], k.shape[1], local_index)
    if part is not None:
        _cache_write_kv(cache_k, cache_v, cache_ks, cache_vs, k[:, part[0]],
                        v[:, part[0]], part[1])


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
    recomputes the elementwise work and the attention kernel.  The
    recompute runs where autograd runs it (on its own thread for CUDA
    tensors), so the block re-enters the mesh that was active when it
    first ran: its collectives are issued again, on the same groups."""
    kw = {}
    if config.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)

    def run(*args):
        mesh = current_mesh()

        def under_mesh(*a):
            with use_mesh(mesh):
                return fn(*a)

        return checkpoint(under_mesh, *args, use_reentrant=False, **kw)

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
    local_rows: bool = False,
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
      output_hidden_states: the ``AuxOutput`` also carries every block's
        input and the final hidden state, [L+1, B, T, D]; the attention
        path stays the resolved one (the flash kernel at T > 8 under
        "auto").
      output_attentions: the ``AuxOutput`` also carries each block's
        post-softmax probabilities [L, B, H, T, S]; the xla path is
        forced, the only one that materializes them (no kernel runs).
        Neither flag is taken on the paged path.
      dropout_rng: a ``torch.Generator`` (on the params' device) or an int
        seed enabling dropout at the config's embd/resid/attn_pdrop rates
        (training only: refused with a cache).  All rates zero: ignored.
      chunk_offset: the static (Python int) position of this call's first
        token where the caller knows it (the serving insert's chunk loop).
        Only the splash prefill kernel reads it: a cached flash chunk
        runs splash where ``ops.kernels.splash_eligible`` holds.  None
        (the default) keeps the flash kernel.
      local_rows: under a mesh, ``tokens`` and ``positions`` are this
        rank's rows of the global batch (``data.shard_batch``), and the
        outputs stay this rank's rows and, under ring attention on a
        ``seq > 1`` mesh, its slice of T (the training loss); cache-free
        only.
    Returns:
      (logits [B, T, V] in config.logits_dtype or None, cache or None),
      plus the AuxOutput when any output flag is set (JAX :1013-1025,
      :1080-1088, :1323-1330, :1400-1405).
    """
    collect = bool(output_hidden_states or output_attentions)
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
        if collect or output_last_hidden:
            raise NotImplementedError(
                "output_hidden_states/output_attentions/output_last_hidden "
                "are not supported on the paged (serving) path; use a "
                "plain KVCache or a cache-free forward")
        return paged_forward(params, tokens, positions, config, cache,
                             attn_mask=attn_mask,
                             compute_logits=compute_logits)
    if cache is not None and not isinstance(cache, KVCache):
        raise NotImplementedError(f"{type(cache).__name__} is not ported")
    if local_rows and cache is not None:
        raise ValueError("local_rows is cache-free (the training loss)")
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
    mesh = current_mesh()
    n_seq = mesh.shape["seq"] if mesh is not None else 1
    n_stage = mesh.shape["stage"] if mesh is not None else 1

    impl = config.attn_impl
    if impl == "auto":
        impl = "flash" if T > FLASH_MIN_SEQ and not per_row else "xla"
    if output_attentions:
        if impl == "ring":
            raise NotImplementedError(
                "output_attentions does not compose with ring "
                "(seq-sharded) attention -- the chunked accumulation "
                "never materializes the weights; use "
                "attn_impl='xla'/'auto'/'flash'")
        impl = "xla"  # the only path that materializes [B, H, T, S]
    ring_cached = False
    if cache is not None and impl == "ring":
        if n_seq > 1:
            if per_row:
                raise NotImplementedError(
                    "seq-sharded decode needs a lockstep (scalar) cache "
                    "index; continuous batching uses seq == 1 meshes")
            ring_cached = True
            impl = "ring_decode"
        else:
            impl = "flash"  # ring with a cache on seq == 1 (JAX :833)
    if per_row and impl != "xla":
        raise NotImplementedError(
            "per-row cache indices (continuous batching) run on the xla "
            "attention path only")
    if n_stage > 1 and cache is not None:
        raise NotImplementedError(
            "decode with a KV cache is not supported on a stage > 1 mesh; "
            "generation meshes keep stage == 1 (use data/tensor axes)")
    if n_stage > 1 and collect:
        raise NotImplementedError(
            "output_hidden_states/output_attentions are not supported on "
            "stage > 1 (pipeline) meshes -- per-layer outputs live on "
            "their stage group; run the eval forward on a stage == 1 mesh")
    if n_stage > 1 and n_seq > 1:
        raise NotImplementedError(
            "stage > 1 does not compose with seq > 1 (ring attention "
            "nests a second shard_map); use stage*tensor*data/fsdp "
            "meshes for pipeline training")
    xla_cached = cache is not None and impl == "xla"
    seq_split = impl == "ring" and cache is None and n_seq > 1
    sh = _shard_ctx(params, config, B, local=local_rows,
                    split_rows=not ring_cached,
                    seq_len=T if seq_split else None)
    if cache is not None:
        constrain_view(cache, config.kv_heads)
    capacity = cache.max_len * n_seq if ring_cached else (
        cache.max_len if cache is not None else 0)
    if cache is not None and not per_row and cache.index + T > capacity:
        raise ValueError(
            f"cache overflow: index {cache.index} + {T} tokens > "
            f"{capacity} slots"
        )

    max_positions = max(2 * config.max_seq_len, capacity)
    cos, sin = _rope_tables(
        config.head_dim, max_positions, config.rope_theta,
        config.use_scaled_rope, device,
    )
    x = _embed(params, sh.take_seq(sh.take(tokens)), config, adt,
               fsdp=sh.fsdp)
    l_B, l_T = x.shape[:2]
    drops = [None] * config.n_layers
    if dropout_rng is not None:
        gen = _dropout_generator(dropout_rng, device)
        if config.embd_pdrop > 0.0:
            n_rows, t_full, rows, tsl = sh.place(l_B, T)
            x = dropout(x, config.embd_pdrop, gen,
                        ((n_rows, t_full, x.shape[-1]), (rows, tsl)))
        if config.resid_pdrop > 0.0 or config.attn_pdrop > 0.0:
            drops = _layer_dropouts(gen, config)

    new_slot_pos = torch.where(
        attn_mask, q_positions, torch.full_like(q_positions, -1)
    )
    ring_lo = 0
    if ring_cached:
        # This rank's slots [ring_lo, ring_lo + S_local) of the global
        # cache; ring_decode reads the pre-step positions.
        ring_lo = mesh.axis_index("seq") * cache.max_len
        slot_pos = cache.pos.clone()
        part = _seq_part(cache.max_len, T, cache.index - ring_lo)
        if part is not None:
            slot_pos[:, part[1]:part[1] + part[0].stop - part[0].start] = (
                new_slot_pos[:, part[0]])
    elif cache is not None:
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
    elif impl == "xla" or (impl == "ring" and n_seq == 1):
        # ring on seq == 1 is dense sdpa (JAX ring_sdpa :277).
        bias = attention_bias(q_positions, slot_pos, slot_pos >= 0)
    splash = (impl == "flash" and cache is not None and splash_eligible(
        config, batch=B, q_len=T, kv_len=cache.max_len,
        chunk_offset=chunk_offset, quantized=cache.quantized))
    # This rank's rows (all of them unless they split over the row axes)
    # and tokens (a slice of T under ring attention on seq > 1); the
    # cache writes of a row-split call land after the loop.
    l_pos = sh.take_seq(sh.take(q_positions))
    l_bias, l_bias_new = sh.take(bias), sh.take(bias_new)
    l_slot_pos = (cache.pos if ring_cached
                  else sh.take_seq(sh.take(slot_pos)))
    l_index = sh.take(cache.index) if cache is not None else None
    place = sh.place(l_B, T)

    # unbind, not w[i]: its backward stacks the per-layer gradients once
    # instead of adding a zero-filled full-stack gradient per layer.
    lp = params["layers"]
    layers = [dict(zip(lp, ws))
              for ws in zip(*(w.unbind(0) for w in lp.values()))]

    hs: list = []      # each block's input (output_hidden_states)
    attns = [] if output_attentions else None

    def block(x, lp_i, drop, pos, bias_i, spos, where):
        return _block(
            x, lp_i, None, None, config=config, positions=pos,
            bias=bias_i, slot_pos=spos, cache_index=None, cos=cos,
            sin=sin, bias_new=l_bias_new, impl=impl, drop=drop,
            weights_out=attns, place=where, fsdp=sh.fsdp,
        )[0]

    if (config.remat and cache is None and torch.is_grad_enabled()
            and not output_attentions):
        block = _remat(block, config)
    new_kv = []        # a row-split cached call's K/V, landed below
    if n_stage > 1:
        # Pipeline stages (JAX :1165-1230): this rank's L / stage layers
        # over microbatches of its rows; every (layer, microbatch) draws
        # its generator masks as the unsharded run's rows.
        L_s = len(layers)
        first = mesh.axis_index("stage") * L_s
        M = config.pp_microbatches or n_stage
        mb = l_B // M if l_B % M == 0 else l_B

        def stage_fn(tree, xx, pos, spos, mb_index):
            sbias = (attention_bias(pos, spos, spos >= 0)
                     if impl == "xla" else None)
            where = sh.place(mb, T, row0=(place[2].start or 0)
                             + mb_index * mb)
            for j, lp_j in enumerate(
                    dict(zip(tree, ws))
                    for ws in zip(*(w.unbind(0) for w in tree.values()))):
                xx = block(xx, lp_j, drops[first + j], pos, sbias, spos,
                           where)
            return xx

        x = pipeline_blocks(stage_fn, lp, x, l_pos, l_slot_pos, mesh=mesh,
                            n_microbatches=M, n_layers=config.n_layers)
    for i, lp_i in enumerate(layers[:config.n_layers] if n_stage == 1
                             else []):
        if output_hidden_states:
            hs.append(x)
        if cache is None:
            x = block(x, lp_i, drops[i], l_pos, l_bias, l_slot_pos, place)
            continue
        x, k, v = _block(
            x, lp_i, sh.view(cache.k[i]), sh.view(cache.v[i]),
            config=config, positions=l_pos, bias=l_bias,
            slot_pos=l_slot_pos, cache_index=l_index,
            cos=cos, sin=sin, bias_new=l_bias_new, impl=impl,
            cache_ks=sh.view(cache.k_scale[i]) if cache.quantized else None,
            cache_vs=sh.view(cache.v_scale[i]) if cache.quantized else None,
            chunk_offset=chunk_offset, weights_out=attns, splash=splash,
            place=place, fsdp=sh.fsdp,
            ring_new_pos=new_slot_pos if ring_cached else None,
            ring_lo=ring_lo,
        )
        if sh.rows is not None:
            new_kv.append((k, v))

    if new_kv:
        # Every data rank holds every row's KV: gather this step's K/V
        # over the rows and land all of them (this rank's own rows are
        # rewritten with the same values).
        ks = sh.gather(torch.stack([k for k, _ in new_kv]), dim=1)
        vs = sh.gather(torch.stack([v for _, v in new_kv]), dim=1)
        for i in range(config.n_layers):
            _cache_write_kv(
                cache.k[i], cache.v[i],
                cache.k_scale[i] if cache.quantized else None,
                cache.v_scale[i] if cache.quantized else None,
                ks[i], vs[i], cache.index)
    with_aux = collect or output_last_hidden

    def out(t, dim=0):
        """An output of this rank's rows and tokens, gathered."""
        return sh.gather(sh.gather_seq(t, dim=dim + 1), dim=dim)

    if with_aux:
        h = rms_norm(x, params["final_norm"], config.rms_norm_eps)
        logits = (lm_head_logits(params, h, config, normed=True)
                  if compute_logits else None)
    else:
        logits = lm_head_logits(params, x, config) if compute_logits else None
    logits = out(logits)
    if cache is not None:
        cache.pos.copy_(slot_pos)
        cache.index = cache.index + T
    if with_aux:
        attentions = None
        if output_attentions:
            attentions = torch.stack(attns)  # [L, B, H, T, S]
            if sh.mesh is not None:
                attentions = sh.mesh.all_gather(attentions, "tensor", dim=2)
            attentions = sh.gather(attentions, dim=1)
        return logits, cache, AuxOutput(
            last_hidden_state=out(h),
            hidden_states=(out(torch.stack(hs + [h]), dim=1)
                           if output_hidden_states else None),
            attentions=attentions)
    return logits, cache


def _paged_shard_check(mesh, kv_heads: int, n_rows: int) -> None:
    """The paged and stock-paged kernels' per-shard clause (JAX
    ``ops/paged_attention.py:451-470``, ``ops/kernels.py:614-635``): KV
    heads divide ``tensor`` and rows divide the row axes, or the call
    raises (a batcher's mesh is validated to fit when it is built)."""
    if not fits(mesh, kv_heads, n_rows):
        tp, rp = mesh.axis_size("tensor"), mesh.axis_size(ROWS)
        raise NotImplementedError(
            f"paged kernel sharding needs kv_heads % tensor == 0 "
            f"and n_slots % (data*fsdp) == 0 (got KVH={kv_heads}, "
            f"tp={tp}, B={n_rows}, rows={rp}); use a compatible mesh "
            f"or the gathered-view path"
        )


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
    sh = _shard_ctx(params, config, B)
    x = _embed(params, sh.take(tokens), config, adt, fsdp=sh.fsdp)
    active = attn_mask[:, 0]
    if T > 1:
        steps = torch.arange(T, device=device, dtype=torch.int32)
        active = (active & (attn_mask == attn_mask[:, :1]).all(dim=1)
                  & (positions == positions[:, :1] + steps).all(dim=1))
    q_pos_row = torch.where(active, positions[:, 0], -1).to(torch.int32)
    if sh.mesh is not None:
        constrain_pool(cache, config.kv_heads)
        _paged_shard_check(sh.mesh, config.kv_heads, B)
    # This rank's rows of the table (all of them off-split).
    local = dataclasses.replace(cache, table=sh.take(cache.table),
                                fill=sh.take(cache.fill))
    l_pos, l_q_pos_row = sh.take(q_positions), sh.take(q_pos_row)

    lp = params["layers"]
    new_k, new_v = [], []
    for i in range(config.n_layers):
        x, k, v = _block(
            x, {name: w[i] for name, w in lp.items()}, None, None,
            config=config, positions=l_pos, bias=None, slot_pos=None,
            cache_index=None, cos=cos, sin=sin, bias_new=None, impl="paged",
            paged=(local, l_q_pos_row, i), fsdp=sh.fsdp,
        )
        if write_back:
            new_k.append(k)
            new_v.append(v)
    logits = lm_head_logits(params, x, config) if compute_logits else None
    logits = sh.gather(logits)
    if not write_back:
        return logits, cache

    blk, off, _ = paged_write_indices(
        cache.table, cache.fill, active, T, NB, BLK)
    # Every data rank lands every row's K/V (the pool replicates over
    # the rows), so gather them before the write.
    new_k = sh.gather(torch.stack(new_k), dim=1)
    new_v = sh.gather(torch.stack(new_v), dim=1)
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
