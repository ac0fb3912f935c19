"""Paged-attention decode: the CUDA kernel's wrapper, its plain version,
and the merge of the step's own K/V.

Port of ``jax_llama_tpu/ops/paged_attention.py`` for one query token per
row and a bf16 or float32 pool (no int8 scales):

* ``paged_pool_attention`` (JAX :232, the Pallas kernel at :371) attends
  each row's table-mapped pool blocks and returns a normalized float32
  output and the float32 row logsumexp.  CUDA tensors launch
  ``csrc/paged_decode.cu`` (or raise); CPU tensors run the plain version
  ``paged_pool_attention_reference``.
* ``paged_decode_attention`` (JAX :409 / :518) merges the step's own slot
  into that result at the softmax level.  The merge is O(B·H·d) tensor
  code, outside any kernel in the JAX package too.

Contract (the JAX one):

* q ``[B, KVH, G, d]``: the G query heads packed with each KV head (query
  head ``h_q = kvh*G + g``);
* k_pool, v_pool ``[L, KVH, NB, BLK, d]``; ``layer`` picks the plane, so
  no per-layer slice is ever copied;
* pool_pos ``[NB, BLK]`` int32 absolute slot positions, -1 for a slot
  that holds nothing;
* table ``[B, MB]`` int32 physical block ids in sequence order, ``NB``
  for an unused entry;
* q_pos ``[B]`` int32, -1 for an inactive row;
* a row attends slot s iff ``0 <= pool_pos[s] <= q_pos[b]``;
* a row that sees no live slot returns out 0 and lse ``MASK_VALUE``, so
  its merge weight ``exp(lse - m)`` underflows to 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build

KERNEL = "paged_decode"
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_GROUP = 8  # query heads per KV head the kernel holds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def paged_pool_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pool_pos: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each row's table blocks and attend them with the positional
    mask; one float32 softmax over all of a row's slots (what the kernel's
    online softmax computes).  P is rounded to the pool dtype before the
    P.V product and the row sum uses the unrounded P, as in the kernel.
    Returns (out [B, KVH, G, d] float32, lse [B, KVH, G] float32)."""
    B, KVH, G, d = q.shape
    NB, BLK = pool_pos.shape
    MB = table.shape[1]
    blk = table.long().clamp(0, NB - 1)                       # [B, MB]
    dead = (table < 0) | (table >= NB)
    k = k_pool[layer][:, blk].reshape(KVH, B, MB * BLK, d)   # [KVH, B, S, d]
    v = v_pool[layer][:, blk].reshape(KVH, B, MB * BLK, d)
    kp = torch.where(dead[:, :, None], -1, pool_pos[blk]).reshape(B, MB * BLK)
    allowed = (kp >= 0) & (kp <= q_pos[:, None])              # [B, S]
    s = torch.einsum("bhgd,hbsd->bhgs", q.float(), k.float()) / math.sqrt(d)
    s = s.masked_fill(~allowed[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    live = torch.isfinite(m)
    m = torch.where(live, m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,hbsd->bhgd", p.to(v.dtype).float(), v.float())
    out = torch.where(live, o / torch.where(live, l, torch.ones_like(l)), 0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                      MASK_VALUE)
    return out, lse[..., 0]


def _check(q, k_pool, v_pool, pool_pos, table, q_pos, layer) -> None:
    if q.dim() != 4 or k_pool.dim() != 5 or v_pool.shape != k_pool.shape:
        raise ValueError("q must be [B, KVH, G, d] and the pools "
                         "[L, KVH, NB, BLK, d]")
    B, KVH, G, d = q.shape
    L, KVHp, NB, BLK, dp = k_pool.shape
    if KVHp != KVH or dp != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}")
    if tuple(pool_pos.shape) != (NB, BLK) or table.dim() != 2 \
            or table.shape[0] != B or tuple(q_pos.shape) != (B,):
        raise ValueError(f"pool_pos must be [NB, BLK], table [B, MB] and "
                         f"q_pos [B]; got {tuple(pool_pos.shape)}, "
                         f"{tuple(table.shape)}, {tuple(q_pos.shape)}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and the pools must share one dtype of "
                        f"{list(_DTYPE_CODE)}; got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    for name, t in (("pool_pos", pool_pos), ("table", table),
                    ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (have {_HEAD_DIMS})")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"{G} query heads per KV head; the kernel holds "
                         f"1..{MAX_GROUP}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("pool_pos", pool_pos), ("table", table),
                    ("q_pos", q_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q, k_pool, v_pool, pool_pos, table, q_pos, layer):
    lib = _build.load(KERNEL)
    fn = lib.paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    B, KVH, G, d = q.shape
    NB, BLK = pool_pos.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, KVH, G), dtype=torch.float32, device=q.device)
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pool_pos.data_ptr(), table.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, KVH, G, d, NB, BLK,
            table.shape[1], layer, _DTYPE_CODE[q.dtype], scale_log2, stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError_t {rc}")
    paged_pool_attention.launches += 1
    return out, lse


def paged_pool_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pool_pos: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attend each row's table-mapped pool blocks of plane ``layer`` (see
    the module docstring).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (bf16 or float32 pool, head_dim 64 or 128,
    any block size, at most 8 query heads per KV head) or raise.
    Returns (out [B, KVH, G, d] float32, lse [B, KVH, G])."""
    if q.device.type == "cpu":
        return paged_pool_attention_reference(
            q, k_pool, v_pool, pool_pos, table, q_pos, layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged_pool_attention: unsupported device "
                         f"{q.device}")
    _check(q, k_pool, v_pool, pool_pos, table, q_pos, layer)
    return _launch(q, k_pool, v_pool, pool_pos, table, q_pos, layer)


# Launches of the CUDA kernel in this process; the plain version never
# counts.  Callers reset it by assigning 0.
paged_pool_attention.launches = 0


def paged_decode_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pool_pos: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: int = 0,
) -> torch.Tensor:
    """One decode step of attention over (pool blocks ∪ the step's own
    slot).  q [B, 1, H, d], k_new/v_new [B, 1, KVH, d]; returns
    [B, 1, H, d] in q's dtype.

    The pool pass is ``paged_pool_attention``; the new slot (always
    attendable: it is the query's own position) joins at the scores, in
    float32, so the pool stays unwritten until the step's write-back.
    Inactive rows (q_pos -1) attend only their own slot; the caller
    ignores them."""
    B, T, H, d = q.shape
    if T != 1:
        raise NotImplementedError(
            "paged decode with T > 1 (speculative verify) is not ported "
            "(ROADMAP A10)")
    KVH = k_new.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, d)
    out_pool, lse = paged_pool_attention(
        qg.contiguous(), k_pool, v_pool, pool_pos, table, q_pos, layer)
    kn = k_new.reshape(B, KVH, 1, d).float()
    vn = v_new.reshape(B, KVH, 1, d).float()
    s_new = (qg.float() * kn).sum(-1) * (1.0 / math.sqrt(d))  # [B, KVH, G]
    m_tot = torch.maximum(lse, s_new)
    w_pool = torch.exp(lse - m_tot)
    p_new = torch.exp(s_new - m_tot)
    out = (out_pool * w_pool[..., None] + p_new[..., None] * vn) \
        / (w_pool + p_new)[..., None]
    return out.reshape(B, 1, H, d).to(q.dtype)
