"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Port of ``jax_llama_tpu/ops/flash_attention.py``: ``flash_attention``
(:539) with its ``jax.custom_vjp`` (:688-719), the forward ``_flash_forward``
(:746) with the row logsumexp and in-kernel dropout, and the backward
``_flash_backward`` (:1178, the dQ and dK/dV Pallas kernels).  The contract
is the JAX one:

* q ``[B, T, H, d]``, k/v ``[B, S, KVH, d]`` with ``H % KVH == 0``;
* q_pos ``[B, T]`` int32 absolute query positions (already clamped >= 0),
  kv_pos ``[B, S]`` int32 slot positions, -1 for padding / unwritten slots;
* a query attends a slot iff ``0 <= kv_pos <= q_pos`` (purely positional,
  so a chunk window at a non-zero base with a -1 tail needs no special
  case);
* GQA query heads are packed into query rows (row ``r = g*T + t`` of KV
  head ``kvh`` is head ``kvh*G + g``), so each K/V tile is read once per
  KV head;
* a row that sees no live slot outputs 0, has lse +inf (so P = 0 there)
  and contributes nothing to any gradient;
* output ``[B, T, H, d]`` in q's dtype; lse float32 ``[B, KVH, G*T]``.

Dropout (training) is inverted dropout on the attention probabilities,
generated from a counter hash of (two seed words, batch, KV head, packed
row, slot) -- ``dropout_keep``, bit for bit the JAX ``_dropout_keep`` --
so the forward and both backward kernels draw the same mask without
storing it.  Batch and KV head are global: a call that holds rows or KV
heads of a larger batch (one rank of a row- or tensor-split mesh) passes
its first row and KV head as ``dropout_offsets`` and draws its slice of
the unsharded call's mask, as JAX's kernel, which GSPMD never partitions,
draws it whole.  The dropout key is the tuple (seed words, row offset,
KV-head offset); every function that takes ``dropout_seed`` also takes
such a key, and a seed of two words has offsets 0.

The forward has four instances, picked per call by ``flash_instance``
from the dtype, head_dim, the query and KV lengths, the query heads per KV
head and dropout: ``"wgmma"`` (bf16, d = 128, T a multiple of 128: the
training shape, prefill and the serving inserts; TMA loads and wgmma on
Hopper), ``"split_kv"`` (bf16, at most ``SPLIT_MAX_ROWS`` packed rows G*T
and no dropout: decode at T = 1; a split pass over runs of
``FLASH_SPLIT`` slots and a combine pass, two kernels a call),
``"mma_sync"`` (every other bf16 call: ragged T, d = 64, dropout or more
rows at small T) and ``"float32"`` (CUDA cores).  Each C entry point
reports the instance it launched, and
``flash_attention.launches_by_instance`` counts those reports
(``flash_attention.kernel_launches`` the kernels).  The backward kernels
have three instances, picked by ``flash_bwd_instance`` (``"wgmma"`` is the
Hopper TMA + wgmma pair at the training shape, then ``"mma_sync"`` and
``"float32"``); ``flash_bwd_dq.launches_by_instance`` and
``flash_bwd_dkv.launches_by_instance`` count the instance each C entry
point reports it launched.

``flash_attention`` is differentiable in q, k and v through a
``torch.autograd.Function`` whose backward is ``flash_backward``.  On CUDA
tensors the hand-written kernels run (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``); on CPU tensors their plain versions
``flash_attention_reference`` and ``flash_backward_reference``.  A CUDA
tensor either reaches a kernel or raises.

``flash_attention_quantized`` (JAX :629) is the same forward over an int8
K/V with float32 per-slot-per-head scales [B, S, KVH]: K's scale is folded
into the scores and V's into the probabilities, so the kernel
(``flash_fwd_int8`` in ``csrc/flash_fwd.cu``) reads the int8 bytes and no
dequantized copy exists.  Inference only: no dropout, no VJP.  Its
instances, picked by ``flash_int8_instance``: ``"wgmma"`` (bf16 q, d =
128, T a multiple of 128: every int8 insert and prefill; int8 tiles
landed by TMA and widened in shared memory for wgmma), ``"mma_sync"``
and ``"float32"``; ``flash_attention_quantized.launches_by_instance``
counts what its C entry points report.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build

KERNEL = "flash_fwd"
BWD_KERNEL = "flash_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_M32 = 0xFFFFFFFF
# The Hopper instance's tile: 128 packed query rows of one query head, so
# T must be a multiple of it; head_dim 128 (two 64-column TMA boxes).
WGMMA_ROWS = 128
WGMMA_HEAD_DIM = 128
# The backward's Hopper dK/dV kernel keeps each 64-token tile's smallest
# and largest q_pos in shared memory, 1024 tiles at most.
WGMMA_BWD_MAX_T = 65536
# The split-KV instance: at most this many packed rows G*T (one m16 tile
# of mma.sync), and runs of FLASH_SPLIT slots per block of its split pass:
# csrc/flash_fwd.cu sk::SPLIT (the C entry point rejects a run count
# computed from another value).
SPLIT_MAX_ROWS = 16
FLASH_SPLIT = 256
# The C entry point of each forward instance, and of each int8 instance.
_ENTRY = {"wgmma": "flash_fwd_wgmma", "split_kv": "flash_fwd_split",
          "mma_sync": "flash_fwd", "float32": "flash_fwd"}
_INT8_ENTRY = {"wgmma": "flash_fwd_int8_wgmma", "mma_sync": "flash_fwd_int8",
               "float32": "flash_fwd_int8"}
# What the C entry points (forward, int8 and backward) report they
# launched.
_INSTANCES = {1: "float32", 2: "mma_sync", 3: "wgmma", 4: "split_kv"}


def _hopper_shape(dtype, head_dim, q_len, kv_len) -> bool:
    """bf16 at head_dim 128, T a positive multiple of 128, S > 0: the
    shapes of the TMA + wgmma instances."""
    return (dtype == torch.bfloat16 and head_dim == WGMMA_HEAD_DIM
            and q_len > 0 and q_len % WGMMA_ROWS == 0 and kv_len > 0)


def flash_instance(dtype: torch.dtype, head_dim: int, q_len: int,
                   kv_len: int, group: int = 1,
                   dropout: bool = False) -> str:
    """The forward instance a CUDA call of these shapes runs: "wgmma" for
    bf16 at head_dim 128 with T (``q_len``) a positive multiple of 128 and
    a non-empty cache (S = ``kv_len``); "split_kv" for bf16 at head_dim
    64 or 128 with at most ``SPLIT_MAX_ROWS`` packed rows (``group`` query
    heads per KV head times T), S > 0 and no ``dropout``; "mma_sync" for
    every other bf16 call; "float32" for float32."""
    if dtype == torch.float32:
        return "float32"
    if _hopper_shape(dtype, head_dim, q_len, kv_len):
        return "wgmma"
    if (dtype == torch.bfloat16 and head_dim in _HEAD_DIMS
            and 0 < group * q_len <= SPLIT_MAX_ROWS and kv_len > 0
            and not dropout):
        return "split_kv"
    return "mma_sync"


def flash_int8_instance(dtype: torch.dtype, head_dim: int, q_len: int,
                        kv_len: int) -> str:
    """The instance a CUDA call of ``flash_attention_quantized`` runs:
    "wgmma" for bf16 q at head_dim 128 with T a positive multiple of 128
    and S > 0 (every int8 insert and prefill); "mma_sync" for every other
    bf16 call; "float32" for float32 q."""
    if dtype == torch.float32:
        return "float32"
    return ("wgmma" if _hopper_shape(dtype, head_dim, q_len, kv_len)
            else "mma_sync")


def flash_bwd_instance(dtype: torch.dtype, head_dim: int, q_len: int,
                       kv_len: int) -> str:
    """The backward instance (both ``flash_bwd_dq`` and ``flash_bwd_dkv``)
    a CUDA call of these shapes runs: "wgmma" (the Hopper pair: TMA rings
    and wgmma) for bf16 at head_dim 128 with T a positive multiple of 128,
    at most ``WGMMA_BWD_MAX_T``, and S > 0; "mma_sync" for every other
    bf16 call; "float32" for float32."""
    if dtype == torch.float32:
        return "float32"
    return ("wgmma" if q_len <= WGMMA_BWD_MAX_T
            and _hopper_shape(dtype, head_dim, q_len, kv_len) else "mma_sync")


# ---------------------------------------------------------------------------
# The dropout hash (JAX :81-145), on int64 tensors holding uint32 values.
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer on uint32 values held in an int64 tensor."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), 4294967295)


def _keep(seed, b, h, rows, cols, rate: float):
    """The keep mask at every broadcast (b, h, row, col) of the call: b,
    h, rows and cols are int64 tensors that broadcast against each other;
    the key's offsets make b and h global."""
    seed_lo, seed_hi, b_off, h_off = _key(seed)
    b, h = (b + b_off) & _M32, (h + h_off) & _M32
    plane = _mix32((_mul32(b, 0x9E3779B9) + _mul32(h, 0x85EBCA6B) + 1) & _M32)
    base_lo = _mix32(plane ^ seed_lo)
    base_hi = _mix32(plane ^ seed_hi ^ 0x85EBCA6B)
    bits = _mix32(_mix32(base_lo ^ rows)
                  ^ _mix32(base_hi ^ _mul32(cols, 0x9E3779B9)))
    return bits >= _threshold(rate)


def dropout_keep(seed_lo, seed_hi, b, h, row0, col0, bq, bk,
                 rate) -> torch.Tensor:
    """Keep mask [bq, bk] of the tile at global element offset (row0, col0)
    of plane (b, h): the JAX ``_dropout_keep`` (same arguments), bit for
    bit.  Element (r, c) keeps with probability 1 - rate."""
    i64 = dict(dtype=torch.int64)
    rows = torch.arange(bq, **i64)[:, None] + int(row0)
    cols = torch.arange(bk, **i64)[None, :] + int(col0)
    return _keep((int(seed_lo) & _M32, int(seed_hi) & _M32),
                 torch.tensor(int(b), **i64), torch.tensor(int(h), **i64),
                 rows & _M32, cols & _M32, rate)


def _keep_plane(seed, B, KVH, G, T, S, rate, device) -> torch.Tensor:
    """The keep mask [B, KVH, G, T, S] in the reference's layout: packed
    row g*T + t, KV head kvh, slot s."""
    i64 = dict(dtype=torch.int64, device=device)
    b = torch.arange(B, **i64)[:, None, None, None, None]
    h = torch.arange(KVH, **i64)[None, :, None, None, None]
    rows = (torch.arange(G, **i64)[:, None] * T
            + torch.arange(T, **i64)[None, :])[None, None, :, :, None]
    cols = torch.arange(S, **i64)[None, None, None, None, :]
    return _keep(seed, b, h, rows, cols, rate)


def normalize_seed(dropout_seed) -> Tuple[int, int]:
    """Two uint32 seed words from an int, or 1 or 2 words in a sequence
    (a list, tuple, 1-D array or tensor); one word is widened with a zero
    high word (JAX ``_normalize_seed``)."""
    if isinstance(dropout_seed, int):
        words = [dropout_seed]
    else:
        words = [int(w) for w in dropout_seed]
    if len(words) == 1:
        words.append(0)
    if len(words) != 2:
        raise ValueError(
            f"dropout_seed must hold 1 or 2 uint32 words, got {len(words)}")
    if any(not 0 <= w <= _M32 for w in words):
        raise ValueError(f"dropout_seed words {words} are not uint32")
    return words[0], words[1]


def _dropout_args(dropout_rate: float, dropout_seed, offsets=(0, 0)):
    """Validate the rate (in [0, 1)) and the seed (required above 0);
    return the rate and the dropout key: the seed words, then the call's
    global row and KV-head ``offsets``.  A seed of four words is such a
    key already (the functions of this module pass theirs on)."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate={dropout_rate} not in [0, 1)")
    if rate == 0.0:
        return 0.0, None
    if dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not isinstance(dropout_seed, int) and len(dropout_seed) == 4:
        if tuple(offsets) != (0, 0):
            raise ValueError("dropout_seed is a key with its offsets; "
                             "pass no dropout_offsets beside it")
        dropout_seed, offsets = dropout_seed[:2], dropout_seed[2:]
    b_off, h_off = (int(o) for o in offsets)
    if not (0 <= b_off <= _M32 and 0 <= h_off <= _M32):
        raise ValueError(f"dropout_offsets {offsets} are not uint32")
    return rate, (*normalize_seed(dropout_seed), b_off, h_off)


def _key(seed) -> Tuple[int, int, int, int]:
    """(seed_lo, seed_hi, b_off, h_off) of a dropout key of two or four
    words."""
    return tuple((*seed, 0, 0)[:4])



# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _allowed(q_pos, kv_pos) -> torch.Tensor:
    kp = kv_pos[:, None, :]
    return (kp >= 0) & (kp <= q_pos[:, :, None])  # [B, T, S]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    return_lse: bool = False,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    dropout_offsets=(0, 0),
):
    """Dense positional-mask softmax attention with the kernel's contract.

    Scores and softmax in float32; the (dropped) probabilities are rounded
    to v's dtype before the P.V product and the sum is divided by the
    float32 row sum of the undropped probabilities, as the kernels (and
    the JAX kernel) do.  ``return_lse`` also returns the row logsumexp
    [B, KVH, G*T] (+inf on rows with no live slot).  With ``k_scale`` and
    ``v_scale`` ([B, S, KVH] float32) k and v are int8: each score is
    multiplied by its slot's k_scale before the mask, and each probability
    by its slot's v_scale before it is rounded to q's dtype for P.V.
    ``dropout_offsets``: the call's first global row and KV head (module
    docstring).
    """
    rate, seed = _dropout_args(dropout_rate, dropout_seed, dropout_offsets)
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    assert H % KVH == 0, (H, KVH)
    G = H // KVH
    qg = q.reshape(B, T, KVH, G, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    s = s.masked_fill(~_allowed(q_pos, kv_pos)[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1)  # [B, KVH, G, T]
    if rate > 0.0:
        keep = _keep_plane(seed, B, KVH, G, T, S, rate, q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - rate))
    p_dtype = v.dtype
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
        p_dtype = q.dtype
    o = torch.einsum("bkgts,bskd->btkgd", p.to(p_dtype).float(), v.float())
    lt = l.permute(0, 3, 1, 2)[..., None]  # [B, T, KVH, G, 1]
    o = torch.where(lt > 0, o / torch.where(lt > 0, lt, torch.ones_like(lt)),
                    0.0)
    out = o.reshape(B, T, H, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), float("inf"))
    return out, lse.reshape(B, KVH, G * T)


def flash_attention_quantized_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
) -> torch.Tensor:
    """The plain version of ``flash_attention_quantized``: the scale fold
    in float32 from the int8 bytes (``flash_attention_reference`` with
    scales)."""
    return flash_attention_reference(q, k, v, q_pos, kv_pos,
                                     k_scale=k_scale, v_scale=v_scale)


def flash_split_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    split: int = FLASH_SPLIT,
    return_lse: bool = False,
):
    """The split-KV instance's function in plain torch (for the tests and
    ``chip_smoke.py``; the wrapper's CPU path is
    ``flash_attention_reference``): the slots cut into runs of ``split``,
    each run's base-2 max m, sum l and output o (P rounded to v's dtype
    before P.V) in float32, then the runs merged by their maxes: a run
    with no live slot for a row (m = -inf) adds nothing.  A row with no
    live slot gets out 0 and lse +inf.  Returns out [B, T, H, d] in q's
    dtype, and with ``return_lse`` the natural-log lse [B, KVH, G*T]."""
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    n = -(-S // split)
    pad = n * split - S
    qg = q.reshape(B, T, KVH, G, d).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float())
    s = s * ((1.0 / math.sqrt(d)) * math.log2(math.e))
    s = s.masked_fill(~_allowed(q_pos, kv_pos)[:, None, None], float("-inf"))
    s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    s = s.reshape(B, KVH, G, T, n, split)
    vv = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    vv = vv.reshape(B, n, split, KVH, d)
    m = s.amax(dim=-1)  # [B, KVH, G, T, n]
    live = torch.isfinite(m)
    p = torch.exp2(s - torch.where(live, m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgtns,bnskd->bkgtnd", p.to(v.dtype).float(), vv)
    M = m.amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp2(m - torch.where(live, M, 0.0)), 0.0)
    L = (w * l).sum(dim=-1)  # [B, KVH, G, T]
    O = (w[..., None] * o).sum(dim=-2)
    Lt = L[..., None]
    O = torch.where(Lt > 0, O / torch.where(Lt > 0, Lt, 1.0), 0.0)
    out = O.permute(0, 3, 1, 2, 4).reshape(B, T, H, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(L > 0, (M[..., 0] + torch.log2(torch.where(
        L > 0, L, 1.0))) * math.log(2.0), float("inf"))
    return out, lse.reshape(B, KVH, G * T)


def flash_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=(0, 0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' formulas (JAX ``_flash_backward``) in plain
    torch: P = exp(S*scale - lse) on the attended slots, dP = dO V^T (times
    the dropout mask / (1 - rate)), Delta = rowsum(dO * O),
    dS = P * (dP - Delta) * scale; dQ = dS K, dK = dS^T Q,
    dV = (mask * P)^T dO.  P and dS are rounded to the input dtype before
    their products, as the kernels round them.  Returns (dq, dk, dv) in
    the input dtype."""
    rate, seed = _dropout_args(dropout_rate, dropout_seed, dropout_offsets)
    delta = flash_delta(out, g, k.shape[2])
    return _backward_plain(q, k, v, q_pos, kv_pos, lse, delta, g, rate, seed)


def _backward_plain(q, k, v, q_pos, kv_pos, lse, delta, g, rate, seed):
    """(dq, dk, dv) from the forward's lse and Delta, both float32 [B, KVH,
    G*T]: the function of the two backward kernels, in plain torch."""
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(d)
    delta = delta.reshape(B, KVH, G, T)[..., None]
    qg = q.reshape(B, T, KVH, G, d).float()
    gg = g.reshape(B, T, KVH, G, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, kf) * scale
    lse5 = lse.reshape(B, KVH, G, T)[..., None]
    p = torch.where(_allowed(q_pos, kv_pos)[:, None, None],
                    torch.exp(s - lse5), 0.0)
    dp = torch.einsum("btkgd,bskd->bkgts", gg, vf)
    pv = p
    if rate > 0.0:
        keep = _keep_plane(seed, B, KVH, G, T, S, rate, q.device)
        inv = 1.0 / (1.0 - rate)
        pv = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    ds = p * (dp - delta) * scale
    dv = torch.einsum("bkgts,btkgd->bskd", pv.to(g.dtype).float(), gg)
    dq = torch.einsum("bkgts,bskd->btkgd", ds.to(k.dtype).float(), kf)
    dk = torch.einsum("bkgts,btkgd->bskd", ds.to(q.dtype).float(), qg)
    return (dq.reshape(B, T, H, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, q_pos, kv_pos, *extra, kv_dtype=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, d] / [B, S, KVH, d]")
    B, T, H, d = q.shape
    Bk, S, KVH, dk = k.shape
    if v.shape != k.shape or Bk != B or dk != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if KVH == 0 or H % KVH:
        raise ValueError(f"n_heads {H} not a multiple of kv heads {KVH}")
    if tuple(q_pos.shape) != (B, T) or tuple(kv_pos.shape) != (B, S):
        raise ValueError(f"positions must be [B, T] and [B, S], got "
                         f"{tuple(q_pos.shape)} and {tuple(kv_pos.shape)}")
    kv_dtype = kv_dtype or q.dtype
    if q.dtype not in _DTYPE_CODE or k.dtype != kv_dtype \
            or v.dtype != kv_dtype:
        raise TypeError(f"q must be one of {list(_DTYPE_CODE)} and k/v "
                        f"{kv_dtype}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("q_pos and kv_pos must be int32")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (have {_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)) + extra:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _drop_ctypes(rate: float, seed) -> list:
    """(with_drop, seed_lo, seed_hi, threshold, 1 / (1 - rate), b_off,
    h_off) for a C entry point, from the rate and the dropout key."""
    if rate == 0.0:
        return [0, 0, 0, 0, 1.0, 0, 0]
    lo, hi, b_off, h_off = _key(seed)
    return [1, lo, hi, _threshold(rate), 1.0 / (1.0 - rate), b_off, h_off]


_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                  ctypes.c_float, ctypes.c_uint, ctypes.c_uint]


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str, name: str, n_ptr: int, n_int: int = 7,
        n_report: int = 1):
    """C entry point ``name``: n_ptr pointers, n_int ints, the scale, the
    dropout words and the stream, then n_report ``int*`` that receive what
    it launched (the instance, then, for the split-KV entry points, the
    kernels).  Bound once per process (a decode step calls it per layer)."""
    fn = getattr(_build.load(lib_name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] + _DROP_ARGTYPES + [ctypes.c_void_p]
                   + [ctypes.POINTER(ctypes.c_int)] * n_report)
    return fn


def _count(wrapper, code: int, kernels: int = 1) -> None:
    """One launch of ``wrapper``, of the instance its C entry point
    reported (``code``), which ran ``kernels`` kernels."""
    instance = _INSTANCES[code]
    with _build.COUNT_LOCK:
        c = _build.counts(wrapper)
        c.launches += 1
        c.kernel_launches += kernels
        by = c.launches_by_instance
        by[instance] = by.get(instance, 0) + 1


def _launch(q, k, v, q_pos, kv_pos, rate, seed, need_lse, instance=None,
            split=FLASH_SPLIT):
    """Launch ``instance`` (default: the one ``flash_instance`` picks)
    through its C entry point and count the instance that entry point
    reports; the split-KV instance runs ``split`` slots a run of its split
    pass, in float32 scratch allocated here."""
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    instance = instance or flash_instance(q.dtype, d, T, S, G, rate > 0.0)
    entry = _ENTRY[instance]
    out = torch.empty_like(q)
    lse = (torch.empty((B, KVH, G * T), dtype=torch.float32,
                       device=q.device) if need_lse or rate > 0.0 else None)
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    code, kernels = ctypes.c_int(0), ctypes.c_int(1)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None]
    ints = [B, T, S, H, KVH, d, _DTYPE_CODE[q.dtype]]
    tail = [scale_log2, *_drop_ctypes(rate, seed)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if instance == "split_kv":
            n_split = -(-S // split)
            partials = torch.empty(B * KVH * n_split * G * T * (d + 2),
                                   dtype=torch.float32, device=q.device)
            if split != FLASH_SPLIT:
                entry, ints = "flash_fwd_split_at", ints + [split]
            fn = _fn(KERNEL, entry, 8, len(ints) + 1, 2)
            rc = fn(*ptrs, partials.data_ptr(), *ints, n_split, *tail, stream,
                    ctypes.byref(code), ctypes.byref(kernels))
        else:
            fn = _fn(KERNEL, entry, 7)
            rc = fn(*ptrs, *ints, *tail, stream, ctypes.byref(code))
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {rc}")
    _count(flash_attention, code.value, kernels.value)
    return out, lse


def flash_attention_launch(q, k, v, q_pos, kv_pos, instance: str,
                           split: int = FLASH_SPLIT) -> torch.Tensor:
    """``flash_attention``'s card launch (no dropout, no gradient) of a
    named ``instance`` whose C entry point takes these shapes, and for
    "split_kv" of ``split`` slots a run (a multiple of 16 in 16..512):
    the wrapper's checks, then the launch, counted on
    ``flash_attention`` by what the entry point reports.  For the card
    tests and ``chip_smoke.py``, which time an instance beside the one
    the wrapper picks; it has no plain version: tensors off the card
    raise."""
    if instance not in _ENTRY:
        raise ValueError(f"unknown flash instance {instance!r}")
    if split <= 0 or split % 16 or split > 512:
        raise ValueError(f"split {split} is not a multiple of 16 in 16..512")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_launch: needs CUDA tensors, got "
                         f"{q.device}")
    _check(q, k, v, q_pos, kv_pos)
    return _launch(q, k, v, q_pos, kv_pos, 0.0, None, False, instance,
                   split)[0]


def _forward(q, k, v, q_pos, kv_pos, rate, seed, need_lse):
    """(out, lse or None): the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        res = flash_attention_reference(q, k, v, q_pos, kv_pos, rate, seed,
                                        need_lse)
        return res if need_lse else (res, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, q_pos, kv_pos)
    return _launch(q, k, v, q_pos, kv_pos, rate, seed, need_lse)


@functools.lru_cache(maxsize=None)
def _int8_fn(name: str):
    """An int8 C entry point: eight pointers, seven ints, the scale, the
    stream and the ``int*`` that receives the instance launched."""
    fn = getattr(_build.load(KERNEL), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_int)])
    return fn


def _launch_quantized(q, k, v, k_scale, v_scale, q_pos, kv_pos,
                      instance=None):
    """Launch ``instance`` (default: the one ``flash_int8_instance``
    picks) through its C entry point and count the instance that entry
    point reports."""
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    entry = _INT8_ENTRY[instance or flash_int8_instance(q.dtype, d, T, S)]
    fn = _int8_fn(entry)
    out = torch.empty_like(q)
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    code = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            out.data_ptr(), B, T, S, H, KVH, d, _DTYPE_CODE[q.dtype],
            scale_log2, stream, ctypes.byref(code),
        )
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {rc}")
    _count(flash_attention_quantized, code.value)
    return out


def _check_quantized(q, k, v, k_scale, v_scale, q_pos, kv_pos) -> None:
    _check(q, k, v, q_pos, kv_pos, kv_dtype=torch.int8)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != torch.float32 or t.shape != k.shape[:3] \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{tuple(k.shape[:3])} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def flash_attention_quantized_launch(q, k, v, k_scale, v_scale, q_pos,
                                     kv_pos, instance: str) -> torch.Tensor:
    """``flash_attention_quantized``'s card launch of a named
    ``instance`` whose C entry point takes these shapes, counted by what
    the entry point reports: for the card tests and ``chip_smoke.py``,
    which time the replaced design beside the one the wrapper picks.
    Tensors off the card raise."""
    if instance not in _INT8_ENTRY:
        raise ValueError(f"unknown int8 flash instance {instance!r}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_quantized_launch: needs CUDA "
                         f"tensors, got {q.device}")
    _check_quantized(q, k, v, k_scale, v_scale, q_pos, kv_pos)
    return _launch_quantized(q, k, v, k_scale, v_scale, q_pos, kv_pos,
                             instance)


def flash_attention_quantized(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
) -> torch.Tensor:
    """Flash attention over an int8 KV cache (JAX :629): the semantics of
    ``flash_attention`` with ``k * k_scale`` and ``v * v_scale`` as the
    keys and values, the scales folded inside the kernel.

    q [B, T, H, d] (bf16 or float32); k, v [B, S, KVH, d] int8; k_scale,
    v_scale [B, S, KVH] float32; positions as ``flash_attention``'s.  CPU
    tensors take ``flash_attention_quantized_reference``; CUDA tensors
    launch the instance ``flash_int8_instance`` picks or raise.  Inference only: it has no
    dropout and no gradient."""
    if torch.is_grad_enabled() and q.requires_grad:
        raise ValueError("flash_attention_quantized is inference-only "
                         "(no gradient)")
    if q.device.type == "cpu":
        return flash_attention_quantized_reference(q, k, v, k_scale,
                                                   v_scale, q_pos, kv_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_quantized: unsupported device "
                         f"{q.device}")
    _check_quantized(q, k, v, k_scale, v_scale, q_pos, kv_pos)
    return _launch_quantized(q, k, v, k_scale, v_scale, q_pos, kv_pos)


def _bwd_launch(name, q, k, v, q_pos, kv_pos, lse, delta, g, outs, rate,
                seed) -> int:
    """Launch backward kernel ``name`` through the C entry point of the
    instance ``flash_bwd_instance`` picks; return the code of the instance
    that entry point reports it launched.  A failed launch raises with its
    cudaError_t; nothing retries on another instance."""
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    rows = (B, KVH, H // KVH * T) if KVH and H % KVH == 0 else None
    for label, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != rows:
            raise ValueError(f"{label} must be float32 [B, KVH, G*T], got "
                             f"{tuple(t.shape)} {t.dtype}")
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    _check(q, k, v, q_pos, kv_pos, ("g", g), ("lse", lse), ("delta", delta))
    entry = name + ("_wgmma" if flash_bwd_instance(q.dtype, d, T, S)
                    == "wgmma" else "")
    fn = _fn(BWD_KERNEL, entry, 8 + len(outs))
    code = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            q_pos.data_ptr(), kv_pos.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *[o.data_ptr() for o in outs],
            B, T, S, H, KVH, d, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(d),
            *_drop_ctypes(rate, seed), stream, ctypes.byref(code),
        )
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {rc}")
    return code.value


def flash_bwd_dq(q, k, v, q_pos, kv_pos, lse, delta, g, rate=0.0,
                 seed=None) -> torch.Tensor:
    """dQ [B, T, H, d] through the kernel ``flash_bwd_dq``
    (``csrc/flash_bwd.cu``; the instance ``flash_bwd_instance`` picks),
    from the forward's lse and Delta = rowsum(dO * O), both float32
    [B, KVH, G*T].  CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, q_pos, kv_pos, lse, delta, g, rate,
                               seed)[0]
    dq = torch.empty_like(q)
    _count(flash_bwd_dq, _bwd_launch("flash_bwd_dq", q, k, v, q_pos, kv_pos,
                                     lse, delta, g, [dq], rate, seed))
    return dq


def flash_bwd_dkv(q, k, v, q_pos, kv_pos, lse, delta, g, rate=0.0,
                  seed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B, S, KVH, d] through the kernel ``flash_bwd_dkv``
    (``csrc/flash_bwd.cu``), inputs as ``flash_bwd_dq``'s.  CPU tensors
    take the plain version."""
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, q_pos, kv_pos, lse, delta, g, rate,
                               seed)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _count(flash_bwd_dkv, _bwd_launch("flash_bwd_dkv", q, k, v, q_pos,
                                      kv_pos, lse, delta, g, [dk, dv], rate,
                                      seed))
    return dk, dv


def flash_delta(out: torch.Tensor, g: torch.Tensor,
                kv_heads: int) -> torch.Tensor:
    """Delta = rowsum(dO * O), float32 [B, KVH, G*T] in the packed-row
    layout of lse, from out and its cotangent g [B, T, H, d]: plain torch,
    as the JAX package computes it outside its kernels."""
    B, T, H, _ = out.shape
    delta = (g.float() * out.float()).sum(-1)  # [B, T, H]
    return (delta.reshape(B, T, kv_heads, H // kv_heads).permute(0, 2, 3, 1)
            .reshape(B, kv_heads, -1).contiguous())


def flash_backward(q, k, v, q_pos, kv_pos, out, lse, g, dropout_rate=0.0,
                   dropout_seed=None, dropout_offsets=(0, 0)):
    """(dq, dk, dv) of ``flash_attention`` for the cotangent g: the two
    backward kernels on CUDA tensors, ``flash_backward_reference`` on CPU
    tensors; Delta from ``flash_delta``."""
    rate, seed = _dropout_args(dropout_rate, dropout_seed, dropout_offsets)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, q_pos, kv_pos, out, lse, g,
                                        rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward: unsupported device {q.device}")
    g = g.contiguous()
    if out.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} must match q "
                         f"{tuple(q.shape)}")
    delta = flash_delta(out, g, k.shape[2])
    dq = flash_bwd_dq(q, k, v, q_pos, kv_pos, lse, delta, g, rate, seed)
    dk, dv = flash_bwd_dkv(q, k, v, q_pos, kv_pos, lse, delta, g, rate, seed)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its VJP (the JAX ``_flash`` custom_vjp):
    the forward saves out and the row lse, the backward runs
    ``flash_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, rate, seed):
        out, lse = _forward(q, k, v, q_pos, kv_pos, rate, seed, True)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        ctx.rate, ctx.seed = rate, seed
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, q_pos, kv_pos, out, lse, g,
                                    ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_offsets=(0, 0),
) -> torch.Tensor:
    """Blockwise causal attention with positional masking (see module
    docstring), differentiable in q, k and v.  CPU tensors take the plain
    versions; CUDA tensors launch the kernels (bf16 or float32, head_dim
    64 or 128) or raise.

    dropout_rate: attention-probability dropout in [0, 1) (training).
    dropout_seed: required when dropout_rate > 0: two uint32 words (an int
      or a single word is widened with a zero high word).
    dropout_offsets: (first global row, first global KV head) of this
      call's q when it holds a slice of a larger batch: the mask is that
      slice of the whole batch's mask.
    """
    rate, seed = _dropout_args(dropout_rate, dropout_seed, dropout_offsets)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, q_pos, kv_pos, rate, seed)
    return _forward(q, k, v, q_pos, kv_pos, rate, seed, False)[0]


# Launches of each wrapper's CUDA kernels in this process; the plain
# versions never count.  ``launches`` counts calls, ``kernel_launches``
# the kernels they ran (two for a split-KV call: the split and the combine
# pass) and ``launches_by_instance`` the calls per instance as each C
# entry point reports it launched.  Callers reset them by assigning 0 and
# {}.
for _wrapper in (flash_attention, flash_attention_quantized, flash_bwd_dq,
                 flash_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.kernel_launches = 0
    _wrapper.launches_by_instance = {}
del _wrapper
