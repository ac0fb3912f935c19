"""Ring attention: sequence parallelism over the ``seq`` mesh axis (port
of ``jax_llama_tpu/parallel/ring.py``).

Each rank holds one contiguous slice of the sequence: its queries, and
one KV shard.  ``ring_attention`` folds the shard it holds into a running
online-softmax state (max ``m``, denominator ``l``, float32 accumulator),
then passes the shard to the next rank of the ring with
``Mesh.ppermute``; after ``n`` folds every query has seen every key and
no rank ever held more than ``S / n`` of them.  Within a shard the fold
runs chunk by chunk (``RING_CHUNK`` slots), each chunk under
``torch.utils.checkpoint``, so neither pass holds a ``[T, S]`` score
matrix; the backward pass is autograd through the folds and the
differentiable ``ppermute`` (the gradient of a shard goes back round the
ring).  The JAX package computes the fold in ``jnp`` with no Pallas
kernel, and so does this module in plain torch.

Masks are positional (slot attendable iff ``0 <= kv_pos <= q_pos``), so
causality needs no reordering of the shards.  Attention dropout is a
counter hash of (seed, global row, global head, absolute query position,
absolute KV position) (``dropout_keep``, bit for bit the JAX one): the
same mask for every chunking and every ring layout.

``ring_decode`` does not rotate: the cache stays sharded over ``seq``
(each rank owns ``S / n`` slots) and the step's few queries run on every
seq rank; each rank reduces its own slots and one max and two sums over
``seq`` combine them exactly.  The step's own K/V merge at the softmax
level afterwards (the ``sdpa_cached`` append-free contract).

The port runs one process per rank, so every function here takes this
rank's LOCAL shards (JAX's ``shard_map`` bodies) and reads the active
mesh (``use_mesh``) for the ring.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_bias, repeat_kv, sdpa
from ..ops.flash_attention import _M32, _mix32, _mul32, normalize_seed
from .mesh import ROWS, current_mesh

BATCH_AXES = ROWS

# kv-chunk length of the fold (JAX :57).
RING_CHUNK = 512

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def dropout_base(seed, B: int, H: int, b_off: int = 0, h_off: int = 0,
                 device=None) -> torch.Tensor:
    """Per-(global row, global head) hash bases [2, B, H], uint32 values
    in int64 (JAX :64): the seed's low word keys the row-side plane, the
    high word the column side.  ``b_off``/``h_off`` are this rank's
    global row and head offsets."""
    s0, s1 = normalize_seed(seed)
    i64 = dict(dtype=torch.int64, device=device)
    gb = (torch.arange(B, **i64) + int(b_off))[:, None] & _M32
    gh = (torch.arange(H, **i64) + int(h_off))[None, :] & _M32
    plane = _mix32((_mul32(gb, 0x9E3779B9) + _mul32(gh, 0x85EBCA6B) + 1)
                   & _M32)
    return torch.stack([_mix32(plane ^ s0),
                        _mix32(plane ^ s1 ^ 0x85EBCA6B)])


def dropout_keep(base: torch.Tensor, q_pos: torch.Tensor,
                 kv_pos: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep mask [B, H, T, C] keyed on absolute (query, KV) positions
    (JAX :96).  base: [2, B, H] (``dropout_base``); q_pos: [B, T];
    kv_pos: [B, C]; a position of -1 hashes as 2**32 - 1, as JAX's uint32
    cast does."""
    rows = (q_pos.long() & _M32)[:, None, :, None]
    cols = (kv_pos.long() & _M32)[:, None, None, :]
    bits = _mix32(_mix32(base[0][:, :, None, None] ^ rows)
                  ^ _mix32(base[1][:, :, None, None]
                           ^ _mul32(cols, 0x9E3779B9)))
    return bits >= min(int(rate * 4294967296.0), 4294967295)


def _fold_chunk(qt, q_pos, kc, vc, pc, m, l, acc, *, scale,
                dropout_rate=0.0, drop_base=None):
    """Fold one KV chunk into the running state (JAX :121).  qt:
    [B, H, T, d]; kc, vc: [B, C, KVH, d]; pc: [B, C]; m, l: [B, H, T]
    float32; acc: [B, H, T, d] float32.  With dropout the accumulated
    probabilities are masked and rescaled while ``l`` keeps the full sum
    (dropout of the post-softmax weights).  Both products run in
    float32; the JAX fold rounds the probabilities to v's dtype for the
    MXU, which a float32 product here would only lose precision to."""
    group = qt.shape[1] // kc.shape[2]
    kr = repeat_kv(kc, group)
    vr = repeat_kv(vc, group)
    s = torch.einsum("bhtd,bshd->bhts", qt.float(), kr.float()) * scale
    allowed = ((pc[:, None, None, :] <= q_pos[:, None, :, None])
               & (pc >= 0)[:, None, None, :])
    s = torch.where(allowed, s, MASK_VALUE)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = alpha * l + p.sum(dim=-1)
    if dropout_rate > 0.0:
        keep = dropout_keep(drop_base, q_pos, pc, dropout_rate)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    acc = alpha[..., None] * acc + torch.einsum(
        "bhts,bshd->bhtd", p, vr.float())
    return m_new, l, acc


def _accumulate(qt, q_pos, k, v, kv_pos, m, l, acc, *, scale,
                chunk: int = RING_CHUNK, dropout_rate=0.0, drop_base=None):
    """Fold one KV shard into the running state chunk by chunk (JAX
    :160), each chunk rematerialized in the backward pass; a ragged tail
    is padded with slots at position -1.  The first chunk folded for a
    live query holds its own slot (the ring starts at the query's own
    shard), so a fully masked chunk later adds exactly zero.  The shard
    is widened to float32 once, so its gradient sums over the chunks in
    float32."""
    k, v = k.float(), v.float()
    S = k.shape[1]
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qt, k, v, m, l, acc))
    for c in range(0, k.shape[1], C):
        args = (qt, q_pos, k[:, c:c + C], v[:, c:c + C], kv_pos[:, c:c + C],
                m, l, acc)
        kw = dict(scale=scale, dropout_rate=dropout_rate,
                  drop_base=drop_base)
        if grad:
            # The mask is a pure function of (base, positions), so the
            # recompute rebuilds it bit for bit.
            m, l, acc = checkpoint(_fold_chunk, *args, use_reentrant=False,
                                   **kw)
        else:
            m, l, acc = _fold_chunk(*args, **kw)
    return m, l, acc


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    axis_name: str = "seq",
    axis_size: Optional[int] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    b_off: int = 0,
    h_off: int = 0,
    mesh=None,
) -> torch.Tensor:
    """This rank's queries against every KV shard as the shards rotate
    round the ring (JAX :211).  q: [B, T_local, H, d]; k, v:
    [B, S_local, KVH, d]; q_pos: [B, T_local]; kv_pos: [B, S_local].
    Returns [B, T_local, H, d] in q's dtype.  ``axis_size`` defaults to
    the active mesh's ``axis_name`` (1 without one: no rotation, no
    collective).  ``dropout_rate`` > 0 needs ``dropout_seed`` (two uint32
    words); ``b_off``/``h_off`` are this rank's global row and head
    offsets."""
    mesh = mesh if mesh is not None else current_mesh()
    if axis_size is None:
        axis_size = mesh.shape[axis_name] if mesh is not None else 1
    B, T, H, d = q.shape
    scale = 1.0 / (d ** 0.5)
    # float32 once: dq, dk and dv sum over every chunk and every step of
    # the ring in float32 and are rounded to their dtype once, at the
    # caller's tensors (the shards rotate as float32).
    qt = q.transpose(1, 2).float()
    k, v = k.float(), v.float()
    dev = q.device
    m = torch.full((B, H, T), MASK_VALUE, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, T, d), dtype=torch.float32, device=dev)
    drop_base = (dropout_base(dropout_seed, B, H, b_off, h_off, device=dev)
                 if dropout_rate > 0.0 else None)
    q_pos = q_pos.to(dev)
    kv_pos = kv_pos.to(dev)
    # n - 1 rotations; the last shard folds in without a trailing permute.
    for step in range(axis_size):
        m, l, acc = _accumulate(qt, q_pos, k, v, kv_pos, m, l, acc,
                                scale=scale, dropout_rate=dropout_rate,
                                drop_base=drop_base)
        if step < axis_size - 1:
            k = mesh.ppermute(k, axis_name, 1)
            v = mesh.ppermute(v, axis_name, 1)
            kv_pos = mesh.ppermute(kv_pos, axis_name, 1)
    out = acc / l[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _seed_words(dropout_rng) -> Tuple[int, int]:
    """Two uint32 seed words: drawn from a ``torch.Generator``, else the
    words (or int) given."""
    if isinstance(dropout_rng, torch.Generator):
        w = torch.randint(0, 2**32, (2,), generator=dropout_rng,
                          device=dropout_rng.device, dtype=torch.int64)
        return int(w[0]), int(w[1])
    return normalize_seed(dropout_rng)


def ring_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    axis_name: str = "seq",
    dropout_rng=None,
    dropout_rate: float = 0.0,
    b_off: Optional[int] = None,
    h_off: Optional[int] = None,
) -> torch.Tensor:
    """Attention over the active mesh's ``seq`` axis (JAX :277): with no
    mesh or ``seq == 1``, dense ``sdpa`` with a positional bias (its
    dropout drawn from ``dropout_rng``, a generator); otherwise
    ``ring_attention`` over this rank's shards, its dropout the position
    hash keyed on two seed words (``dropout_rng``: a generator they are
    drawn from, or the words).  ``b_off``/``h_off`` default to this
    rank's offsets when its rows split over ``data`` x ``fsdp`` and its
    heads over ``tensor``."""
    mesh = current_mesh()
    n = mesh.shape.get(axis_name, 1) if mesh is not None else 1
    with_drop = dropout_rng is not None and dropout_rate > 0.0
    if n == 1:
        bias = attention_bias(q_pos, kv_pos, kv_pos >= 0)
        if not with_drop:
            return sdpa(q, k, v, bias)
        if not isinstance(dropout_rng, torch.Generator):
            raise ValueError(
                "ring_sdpa without a seq axis runs sdpa, whose dropout is "
                "drawn from a torch.Generator")
        return sdpa(q, k, v, bias, dropout_rate=dropout_rate,
                    generator=dropout_rng)
    B, _, H, _ = q.shape
    if b_off is None:
        b_off = mesh.axis_index(BATCH_AXES) * B
    if h_off is None:
        h_off = mesh.axis_index("tensor") * H
    seed = _seed_words(dropout_rng) if with_drop else None
    return ring_attention(
        q, k, v, q_pos, kv_pos, axis_name=axis_name, axis_size=n,
        dropout_rate=dropout_rate if with_drop else 0.0, dropout_seed=seed,
        b_off=b_off, h_off=h_off, mesh=mesh)


# ---------------------------------------------------------------------------
# Seq-sharded cached decode
# ---------------------------------------------------------------------------

def _scale_rows(sc: torch.Tensor, group: int) -> torch.Tensor:
    """Per-slot dequant scales [B, S, KVH] -> [B, H, 1, S] (JAX :365)."""
    scr = repeat_kv(sc[..., None], group)[..., 0]
    return scr.permute(0, 2, 1)[:, :, None, :]


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """An einsum accumulated in ``dtype`` (JAX ``preferred_element_type``)."""
    return torch.einsum(eq, a.to(dtype), b.to(dtype))


def _ring_decode_body(q, kc, vc, sp, kn, vn, qp, npos, *scales, mesh,
                      axis_name: Optional[str], scale: float,
                      softmax_dtype: torch.dtype, quantized: bool = False):
    """One rank's part of ``ring_decode`` (JAX :373): the partial
    softmax over its cache shard, the exact combine over ``axis_name``
    (None: this shard is the whole cache), then the step's own tokens."""
    B, T, H, d = q.shape
    group = H // kc.shape[2]
    qt = q.transpose(1, 2)
    if quantized:
        k_scale, v_scale = scales
        kc = kc.to(q.dtype)
        vc = vc.to(q.dtype)
    kr = repeat_kv(kc, group)
    vr = repeat_kv(vc, group)
    s = _einsum("bhtd,bshd->bhts", qt, kr, softmax_dtype) * scale
    if quantized:
        s = s * _scale_rows(k_scale, group)
    allowed = ((sp[:, None, None, :] <= qp[:, None, :, None])
               & (sp >= 0)[:, None, None, :])
    s = torch.where(allowed, s, MASK_VALUE)
    m_i = s.amax(dim=-1)
    p = torch.exp(s - m_i[..., None])
    p = torch.where(allowed, p, 0.0)
    l_i = p.sum(dim=-1)
    if quantized:
        pv = (p * _scale_rows(v_scale, group)).to(vr.dtype)
    else:
        pv = p.to(vr.dtype)
    o_i = _einsum("bhts,bshd->bhtd", pv, vr, softmax_dtype)

    if axis_name is None:
        m, l, o = m_i, l_i, o_i
    else:
        m = mesh.all_reduce(m_i.clone(), axis_name, op="max")
        w = torch.exp(m_i - m)
        l = mesh.all_reduce(l_i * w, axis_name)
        o = mesh.all_reduce(o_i * w[..., None], axis_name)

    s_new = _einsum("bhtd,bjhd->bhtj", qt, repeat_kv(kn, group),
                    softmax_dtype) * scale
    allowed_new = ((npos[:, None, None, :] <= qp[:, None, :, None])
                   & (npos >= 0)[:, None, None, :])
    s_new = torch.where(allowed_new, s_new, MASK_VALUE)
    m_tot = torch.maximum(m, s_new.amax(dim=-1))
    p_new = torch.exp(s_new - m_tot[..., None])
    p_new = torch.where(allowed_new, p_new, 0.0)
    w_old = torch.exp(m - m_tot)
    denom = l * w_old + p_new.sum(dim=-1)
    denom = torch.where(denom == 0.0, 1.0, denom)
    out = (o * (w_old / denom)[..., None]
           + _einsum("bhtj,bjhd->bhtd", p_new.to(vn.dtype),
                     repeat_kv(vn, group), softmax_dtype)
           / denom[..., None])
    return out.transpose(1, 2).to(q.dtype)


def ring_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    slot_pos: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    q_pos: torch.Tensor,
    new_pos: torch.Tensor,
    *,
    softmax_dtype: torch.dtype = torch.float32,
    axis_name: str = "seq",
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Cached decode over a KV cache sharded along S over ``axis_name``
    (JAX :459).  q: [B, T, H, d], this step's queries (the same on every
    seq rank); k_cache, v_cache: [B, S_local, KVH, d], this rank's slots
    (int8 with ``k_scale``/``v_scale`` [B, S_local, KVH] float32, folded
    at the scores and probabilities); slot_pos: [B, S_local], the
    PRE-step positions of those slots (-1 invalid); k_new, v_new:
    [B, T, KVH, d] at full precision; q_pos, new_pos: [B, T] (new_pos
    -1 on padding).  The cache is not written: the caller lands the
    step's K/V afterwards."""
    mesh = current_mesh()
    n = mesh.shape.get(axis_name, 1) if mesh is not None else 1
    quantized = k_scale is not None
    scales: Sequence[torch.Tensor] = (k_scale, v_scale) if quantized else ()
    return _ring_decode_body(
        q, k_cache, v_cache, slot_pos, k_new, v_new, q_pos, new_pos,
        *scales, mesh=mesh, axis_name=axis_name if n > 1 else None,
        scale=1.0 / (q.shape[-1] ** 0.5), softmax_dtype=softmax_dtype,
        quantized=quantized)


__all__ = [
    "RING_CHUNK", "BATCH_AXES", "dropout_base", "dropout_keep",
    "ring_attention", "ring_sdpa", "ring_decode",
]
