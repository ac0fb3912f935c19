"""Paged-attention decode: the CUDA kernel's wrapper, its plain version,
and the merge of the step's own K/V.

Port of ``jax_llama_tpu/ops/paged_attention.py`` for T >= 1 query tokens
per row (one decode token, or the speculative verify block) and a bf16,
float32 or int8 pool:

* ``paged_pool_attention`` (JAX :232, the Pallas kernel at :371) attends
  each row's table-mapped pool blocks and returns a normalized float32
  output and the float32 row logsumexp.  CUDA tensors launch
  ``csrc/paged_decode.cu`` (or raise); CPU tensors run the plain version
  ``paged_pool_attention_reference``.
* ``paged_decode_attention`` (JAX :409 / :518) merges the step's own T
  slots into that result at the softmax level.  The merge is
  O(B·H·T²·d) tensor code, outside any kernel in the JAX package too.

Contract (the JAX one):

* q ``[B, KVH, T*G, d]``: the T tokens' G query heads packed with each KV
  head as rows ``r = t*G + g`` (query head ``h_q = kvh*G + g``);
* k_pool, v_pool ``[L, KVH, NB, BLK, d]``; ``layer`` picks the plane, so
  no per-layer slice is ever copied;
* an int8 pool comes with k_scale, v_scale ``[L, KVH, NB, BLK]`` float32
  per-slot-per-head scales, folded per slot in the kernel (K's into the
  scores before the mask, V's into the probabilities before P.V), so the
  pool is read at one byte per element and never dequantized into a copy;
* pool_pos ``[NB, BLK]`` int32 absolute slot positions, -1 for a slot
  that holds nothing;
* table ``[B, MB]`` int32 physical block ids in sequence order, ``NB``
  for an unused entry;
* q_pos ``[B]`` int32, the first token's position (token t sits at
  ``q_pos + t``), -1 for an inactive row;
* packed row r of row b attends slot s iff
  ``0 <= pool_pos[s] <= q_pos[b] + r // G`` and ``q_pos[b] >= 0``;
* a packed row that sees no live slot returns out 0 and lse
  ``MASK_VALUE``, so its merge weight ``exp(lse - m)`` underflows to 0.

The kernel is split-KV flash-decoding: a split pass over fixed runs of
``SPLIT_SLOTS`` slots of each row's table writes partial (out, max, sum)
into float32 scratch that the wrapper allocates, and a combine pass joins
a row's splits into out and lse; each wrapper launch runs both passes.
It holds at most ``MAX_ROWS`` packed rows per launch; ``split_tokens``
cuts a longer block of T tokens into consecutive launches of at most
``MAX_ROWS // G`` tokens each (rows are independent and the pool is only
read, so the pieces join to the same out and lse).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

KERNEL = "paged_decode"
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_GROUP = 8  # query heads per KV head the kernel holds
MAX_ROWS = 64  # packed query rows (t_tokens x heads per KV head)
# Slots per split of the split pass: csrc/paged_decode.cu SPLIT (the C
# entry point rejects an n_split computed from another value).
SPLIT_SLOTS = 256
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
    t_tokens: int = 1,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each row's table blocks and attend them with the positional
    mask; one float32 softmax over all of a row's slots (what the kernel's
    online softmax computes).  Packed row r = t*G + g attends slots up to
    position ``q_pos + r // G``.  P is rounded to the pool dtype before
    the P.V product and the row sum uses the unrounded P, as in the
    kernel.  An int8 pool's scales fold as the kernel folds them, in
    float32 from the int8 bytes: each score times its slot's k_scale
    before the mask, each probability times its slot's v_scale before it
    is rounded to q's dtype.  Returns (out [B, KVH, T*G, d] float32, lse
    [B, KVH, T*G] float32)."""
    B, KVH, TG, d = q.shape
    NB, BLK = pool_pos.shape
    MB = table.shape[1]
    G = TG // t_tokens
    blk = table.long().clamp(0, NB - 1)                       # [B, MB]
    dead = (table < 0) | (table >= NB)
    k = k_pool[layer][:, blk].reshape(KVH, B, MB * BLK, d)   # [KVH, B, S, d]
    v = v_pool[layer][:, blk].reshape(KVH, B, MB * BLK, d)
    kp = torch.where(dead[:, :, None], -1, pool_pos[blk]).reshape(
        B, 1, MB * BLK)
    limit = q_pos[:, None] + torch.arange(TG, device=q.device)[None] // G
    allowed = ((kp >= 0) & (kp <= limit[:, :, None])
               & (q_pos >= 0)[:, None, None])                 # [B, TG, S]
    s = torch.einsum("bhrd,hbsd->bhrs", q.float(), k.float()) / math.sqrt(d)
    if k_scale is not None:
        s = s * k_scale[layer][:, blk].reshape(KVH, B, 1, MB * BLK
                                                ).transpose(0, 1)
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    live = torch.isfinite(m)
    m = torch.where(live, m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(v.dtype)
    if v_scale is not None:
        pv = (p * v_scale[layer][:, blk].reshape(KVH, B, 1, MB * BLK
                                                  ).transpose(0, 1)
              ).to(q.dtype)
    o = torch.einsum("bhrs,hbsd->bhrd", pv.float(), v.float())
    out = torch.where(live, o / torch.where(live, l, torch.ones_like(l)), 0.0)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                      MASK_VALUE)
    return out, lse[..., 0]


def _check(q, k_pool, v_pool, pool_pos, table, q_pos, layer, t_tokens,
           k_scale, v_scale) -> None:
    if q.dim() != 4 or k_pool.dim() != 5 or v_pool.shape != k_pool.shape:
        raise ValueError("q must be [B, KVH, T*G, d] and the pools "
                         "[L, KVH, NB, BLK, d]")
    B, KVH, TG, d = q.shape
    L, KVHp, NB, BLK, dp = k_pool.shape
    if KVHp != KVH or dp != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}")
    if tuple(pool_pos.shape) != (NB, BLK) or table.dim() != 2 \
            or table.shape[0] != B or tuple(q_pos.shape) != (B,):
        raise ValueError(f"pool_pos must be [NB, BLK], table [B, MB] and "
                         f"q_pos [B]; got {tuple(pool_pos.shape)}, "
                         f"{tuple(table.shape)}, {tuple(q_pos.shape)}")
    pool_dtype = q.dtype if k_scale is None else torch.int8
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(f"q must be one of {list(_DTYPE_CODE)} and the "
                        f"pools {pool_dtype} (int8 with scales); got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is not None and (t.dtype != torch.float32
                              or t.shape != k_pool.shape[:4]
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{tuple(k_pool.shape[:4])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("pool_pos", pool_pos), ("table", table),
                    ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (have {_HEAD_DIMS})")
    if t_tokens < 1 or TG % t_tokens:
        raise ValueError(f"{TG} packed query rows do not split into "
                         f"t_tokens={t_tokens} tokens")
    if not 1 <= TG // t_tokens <= MAX_GROUP:
        raise ValueError(f"{TG // t_tokens} query heads per KV head; the "
                         f"kernel holds 1..{MAX_GROUP}")
    if TG > MAX_ROWS:
        raise ValueError(f"{TG} packed query rows (t_tokens {t_tokens} x "
                         f"{TG // t_tokens} heads per KV head) exceed the "
                         f"kernel's cap MAX_ROWS={MAX_ROWS}")
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


_FN = {}


def _kernel_fn():
    """The C entry point, its argument types set once per process."""
    if "paged_decode" not in _FN:
        fn = _build.load(KERNEL).paged_decode
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _FN["paged_decode"] = fn
    return _FN["paged_decode"]


def n_splits(table: torch.Tensor, block_size: int) -> int:
    """Splits of the kernel's split pass per (row, KV head): the table's
    MB * BLK slots in runs of ``SPLIT_SLOTS``."""
    return -(-table.shape[1] * block_size // SPLIT_SLOTS)


def _launch(q, k_pool, v_pool, pool_pos, table, q_pos, layer, t_tokens,
            k_scale, v_scale):
    fn = _kernel_fn()
    int8 = k_scale is not None
    B, KVH, TG, d = q.shape
    NB, BLK = pool_pos.shape
    ns = n_splits(table, BLK)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((B, KVH, TG), dtype=torch.float32, device=q.device)
    # The split pass's partials: o [B, KVH, ns, TG, d], then m and l
    # [B, KVH, ns, TG].
    partials = torch.empty(B * KVH * ns * TG * (d + 2), dtype=torch.float32,
                           device=q.device)
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    kernels, instance = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None,
            pool_pos.data_ptr(), table.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), lse.data_ptr(), partials.data_ptr(), B, KVH,
            TG // t_tokens, t_tokens, d, NB, BLK, table.shape[1], layer,
            _DTYPE_CODE[q.dtype], ns, scale_log2, stream,
            ctypes.byref(kernels), ctypes.byref(instance),
        )
    with _build.COUNT_LOCK:
        _build.counts(paged_pool_attention).kernel_launches += kernels.value
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: cudaError_t {rc}")
    name = split_instance_name(instance.value)
    with _build.COUNT_LOCK:
        c = _build.counts(paged_pool_attention)
        c.launches += 1
        c.launches_int8 += int8
        by_t = c.launches_by_t
        by_t[t_tokens] = by_t.get(t_tokens, 0) + 1
        by = c.launches_by_instance
        by[name] = by.get(name, 0) + 1
    return out, lse


def split_instance_name(code: int) -> str:
    """The split pass's instance from the C entry point's code: +16,
    +32, +64 for the tensor-core kernel with 1, 2 or 4 m-tiles of 16
    packed rows ("mma_sync_m16" ...), -16 or -64 for the CUDA-core
    kernel holding that many rows ("cuda_cores_r16", "cuda_cores_r64")."""
    return f"mma_sync_m{code}" if code > 0 else f"cuda_cores_r{-code}"


def split_tokens(launch, q: torch.Tensor, q_pos: torch.Tensor,
                 t_tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``launch(q_piece, q_pos_piece, t_piece) -> (out, lse)`` over
    consecutive pieces of at most ``MAX_ROWS // G`` of the T tokens (one
    piece when all T*G packed rows fit).  Piece [t0, t0 + n) takes the
    packed rows ``t0*G .. (t0+n)*G`` and first position ``q_pos + t0``
    (an inactive row's -1 stays -1), so its row r' = (t - t0)*G + g
    attends up to ``q_pos + t`` as in one launch; the pieces' out and lse
    join along the packed-row axis.  ``launch`` is the kernel's (the
    tests pass the plain version)."""
    G = q.shape[2] // t_tokens
    per = max(1, MAX_ROWS // G)
    if t_tokens <= per:
        return launch(q, q_pos, t_tokens)
    outs, lses = [], []
    for t0 in range(0, t_tokens, per):
        n = min(per, t_tokens - t0)
        qp = torch.where(q_pos >= 0, q_pos + t0, q_pos)
        o, l = launch(q[:, :, t0 * G:(t0 + n) * G].contiguous(), qp, n)
        outs.append(o)
        lses.append(l)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def paged_pool_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pool_pos: torch.Tensor,
    table: torch.Tensor,
    q_pos: torch.Tensor,
    layer: int = 0,
    t_tokens: int = 1,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attend each row's table-mapped pool blocks of plane ``layer`` for
    ``t_tokens`` consecutive query tokens per row (see the module
    docstring).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (bf16 or float32 q; a pool of q's dtype, or int8 with
    ``k_scale``/``v_scale``; head_dim 64 or 128, any block size, at most
    ``MAX_GROUP`` query heads per KV head; more than ``MAX_ROWS`` packed
    rows run as several launches, ``split_tokens``) or raise.  Returns
    (out [B, KVH, T*G, d] float32, lse [B, KVH, T*G])."""
    if q.device.type == "cpu":
        return paged_pool_attention_reference(
            q, k_pool, v_pool, pool_pos, table, q_pos, layer, t_tokens,
            k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_pool_attention: unsupported device "
                         f"{q.device}")

    def launch(qq, qp, t):
        _check(qq, k_pool, v_pool, pool_pos, table, qp, layer, t, k_scale,
               v_scale)
        return _launch(qq, k_pool, v_pool, pool_pos, table, qp, layer, t,
                       k_scale, v_scale)

    if t_tokens < 1 or q.dim() != 4 or q.shape[2] % t_tokens:
        raise ValueError(f"q {tuple(q.shape)} does not split into "
                         f"t_tokens={t_tokens} tokens")
    return split_tokens(launch, q, q_pos, t_tokens)


# Launches of the CUDA kernel in this process: wrapper launches in all
# (one per piece of ``split_tokens``), of them over int8 pools, by
# t_tokens and by the split pass's instance (``split_instance_name``);
# ``kernel_launches`` counts the kernels the C entry point reports it
# launched (the split pass and the combine pass: 2 a wrapper launch).
# The plain version never counts.  Callers reset them by assigning 0, 0,
# {}, {} and 0.
paged_pool_attention.launches = 0
paged_pool_attention.launches_int8 = 0
paged_pool_attention.launches_by_t = {}
paged_pool_attention.launches_by_instance = {}
paged_pool_attention.kernel_launches = 0


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
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step of attention over (pool blocks ∪ the step's T new
    slots).  An int8 pool passes its scales (``k_scale``, ``v_scale``),
    which the pool pass folds; the step's own K/V join at full precision
    (they are quantized only for the write-back, JAX
    ``models/llama.py:738-780``).  q [B, T, H, d], k_new/v_new [B, T, KVH, d]; returns
    [B, T, H, d] in q's dtype.  Token t sits at position ``q_pos + t``
    (consecutive: the kernel's contract).

    The pool pass is ``paged_pool_attention`` (all T tokens share one
    sweep of the pool); the step's own tokens join at the scores, in
    float32 (token t attends new slots j <= t, itself included: with
    consecutive positions j <= t is the positional mask), so the pool
    stays unwritten until the step's write-back.  Inactive rows (q_pos -1)
    attend only the step's own slots; the caller ignores them."""
    B, T, H, d = q.shape
    KVH = k_new.shape[2]
    G = H // KVH
    q5 = q.reshape(B, T, KVH, G, d)
    qg = q5.transpose(1, 2).reshape(B, KVH, T * G, d)
    out_pool, lse = paged_pool_attention(
        qg.contiguous(), k_pool, v_pool, pool_pos, table, q_pos, layer, T,
        k_scale, v_scale)
    out_pool = out_pool.reshape(B, KVH, T, G, d)
    lse = lse.reshape(B, KVH, T, G)
    s_new = torch.einsum("btkgd,bjkd->bktgj", q5.float(),
                         k_new.float()) * (1.0 / math.sqrt(d))
    t_idx = torch.arange(T, device=q.device)
    causal = (t_idx[:, None] >= t_idx[None, :])[None, None, :, None, :]
    s_new = torch.where(causal, s_new, MASK_VALUE)        # [B, KVH, T, G, T]
    m_tot = torch.maximum(lse, s_new.amax(dim=-1))        # [B, KVH, T, G]
    w_pool = torch.exp(lse - m_tot)
    p_new = torch.where(causal, torch.exp(s_new - m_tot[..., None]), 0.0)
    denom = w_pool + p_new.sum(dim=-1)
    new_contrib = torch.einsum("bktgj,bjkd->bktgd", p_new, v_new.float())
    out = (out_pool * w_pool[..., None] + new_contrib) / denom[..., None]
    return out.transpose(1, 2).reshape(B, T, H, d).to(q.dtype)
