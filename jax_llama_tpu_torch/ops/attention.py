"""Grouped-query scaled-dot-product attention, plain PyTorch (port of
``jax_llama_tpu/ops/attention.py``).

The JAX package leaves these to XLA, outside any Pallas kernel, so the
port writes them as tensor code.  Products take their inputs in float32
(exact for bf16 inputs) and accumulate in float32, like the JAX einsums
with ``preferred_element_type=float32``; the softmax runs in float32; the
probabilities are cast to the activation dtype before the P·V product,
as in the JAX package.

Dropout (``dropout``, ``sdpa(dropout_rate=...)``) is inverted dropout drawn
from an explicit ``torch.Generator``; the global RNG is never used.  Its
masks are torch's draws, not JAX's threefry bits.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator
) -> torch.Tensor:
    """Inverted dropout (expectation-preserving): each element is kept
    with probability 1 - rate and scaled by 1 / (1 - rate), drawn from
    ``generator``.  Shared by the attention probabilities and the model's
    embedding and residual sites."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Broadcast KV heads to the query heads: [B, S, KVH, D] ->
    [B, S, KVH * n_rep, D]."""
    if n_rep == 1:
        return x
    b, s, kvh, d = x.shape
    x = x[:, :, :, None, :].expand(b, s, kvh, n_rep, d)
    return x.reshape(b, s, kvh * n_rep, d)


def attention_bias(
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Additive float32 bias [B, 1, T, S]: 0 where a query may attend a
    slot (``kv_pos <= q_pos`` and ``kv_valid``), finfo.min elsewhere."""
    allowed = kv_positions[:, None, :] <= q_positions[:, :, None]
    if kv_valid is not None:
        allowed = allowed & kv_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=allowed.device)
    bias = torch.where(allowed, zero, NEG_INF)
    return bias[:, None, :, :]


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    # [B, T, KVH, G, D] x [B, S, KVH, D] -> [B, KVH, G, T, S], float32.
    return torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale


def _pv(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # [B, KVH, G, T, S] x [B, S, KVH, D] -> [B, T, KVH, G, D], float32.
    return torch.einsum("bkgts,bskd->btkgd", w.float(), v.float())


def sdpa_cached(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    bias_cache: torch.Tensor,
    bias_new: torch.Tensor,
    softmax_dtype: torch.dtype = torch.float32,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Append-free cached attention: one softmax over the (unchanged) cache
    and the step's new K/V, joined at the scores.

    Args:
      q: [B, T, H, D].
      k_cache, v_cache: [B, S, KVH, D]; unwritten slots masked by
        ``bias_cache``; int8 when ``k_scale``/``v_scale`` are given.
      k_new, v_new: [B, T, KVH, D], this step's projections.
      bias_cache: [B, 1, T, S]; bias_new: [B, 1, T, T].
      k_scale, v_scale: [B, S, KVH] float32 dequant scales of an int8
        cache.  Constant along D, they commute with both products: the
        cache scores are scaled after the dot, and v_scale is folded into
        the weights before the P.V product (JAX ``sdpa_cached``).
    Returns:
      [B, T, H, D] in q.dtype.
    """
    b, t, h, d = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, d)
    scale = 1.0 / float(d) ** 0.5
    s1 = _scores(qg, k_cache, scale)
    if k_scale is not None:
        s1 = s1 * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    s1 = s1 + bias_cache[:, :, None]
    s2 = _scores(qg, k_new, scale) + bias_new[:, :, None]
    s = torch.cat([s1, s2], dim=-1).to(softmax_dtype)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    n = s1.shape[-1]
    w1 = w[..., :n]
    if v_scale is not None:
        w1 = (w1.float() * v_scale.permute(0, 2, 1)[:, :, None, None, :]
              ).to(q.dtype)
    out = _pv(w1, v_cache) + _pv(w[..., n:], v_new)
    return out.reshape(b, t, h, d).to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    softmax_dtype: torch.dtype = torch.float32,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Scaled dot-product attention with GQA.

    Args:
      q: [B, T, H, D]; k, v: [B, S, KVH, D] with H % KVH == 0.
      bias: optional [B, 1, T, S] additive float32 bias.
      dropout_rate, generator: attention-probability dropout (training):
        inverted dropout on the post-softmax weights, drawn from
        ``generator``, which a rate above 0 requires.
    Returns:
      [B, T, H, D] in q.dtype.
    """
    if dropout_rate > 0.0 and generator is None:
        raise ValueError("dropout_rate > 0 requires a generator")
    b, t, h, d = q.shape
    kvh = k.shape[2]
    assert h % kvh == 0, (h, kvh)
    qg = q.reshape(b, t, kvh, h // kvh, d)
    scores = _scores(qg, k, 1.0 / float(d) ** 0.5)
    if bias is not None:
        scores = scores + bias[:, :, None]
    w = torch.softmax(scores.to(softmax_dtype), dim=-1).to(q.dtype)
    if dropout_rate > 0.0:
        w = dropout(w, dropout_rate, generator)
    return _pv(w, v).reshape(b, t, h, d).to(q.dtype)
