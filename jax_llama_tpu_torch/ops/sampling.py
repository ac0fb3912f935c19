"""Token sampling: greedy, temperature, nucleus (top-p), top-k (port of
``jax_llama_tpu/ops/sampling.py``).  ``sample`` draws from an explicit
``torch.Generator``; its draws differ from JAX's threefry for the same
seed, but the distribution it draws from (``warped_probs``) is the same."""

from __future__ import annotations

from typing import Optional

import torch

from .attention import NEG_INF


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab (first index on ties): [..., V] -> int32 [...]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the nucleus (smallest set with cumulative
    probability >= top_p); the best token always survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cum - sorted_probs) < top_p
    inf = torch.full_like(sorted_logits, float("inf"))
    threshold = torch.where(keep_sorted, sorted_logits, inf).min(
        dim=-1, keepdim=True
    ).values
    threshold = torch.minimum(
        threshold, logits.max(dim=-1, keepdim=True).values
    )
    return torch.where(
        logits >= threshold, logits, torch.full_like(logits, NEG_INF)
    )


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask all but the top_k logits (ties at the k-th value kept)."""
    kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
    return torch.where(
        logits >= kth, logits, torch.full_like(logits, NEG_INF)
    )


def categorical(probs: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``probs`` [N, V] from ``generator``: [N] int64.
    This is ``torch.multinomial(probs, 1)``'s own one-sample algorithm
    (the argmax of probs over Exp(1) noise: the same generator advance,
    the same token), without its validity checks, so that a CUDA graph
    can hold it; a caller guards rows that are not distributions."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def _warp(logits, temperature, top_p, top_k):
    logits = logits.float() / temperature
    if top_k is not None and top_k > 0:
        logits = top_k_filter(logits, top_k)
    if top_p is not None and top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    return logits


def warped_probs(
    logits: torch.Tensor,
    temperature: float,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """The exact distribution ``sample`` draws from, as probabilities."""
    assert temperature != 0.0, "greedy has no sampling distribution"
    return torch.softmax(_warp(logits, temperature, top_p, top_k), dim=-1)


def stop_token_hits(
    tokens: torch.Tensor, stop_table: torch.Tensor
) -> torch.Tensor:
    """Per-row stop-token membership.

    tokens: [B] or [B, T] int; negative values never match.
    stop_table: [B, S] int, each row's stop set right-padded with -1.
    Returns bool of ``tokens``' shape.
    """
    tab = stop_table[:, None, :] if tokens.dim() == 2 else stop_table
    t = tokens[..., None]
    return torch.any((t >= 0) & (t == tab), dim=-1)


def sample(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_p: Optional[float] = None,
    top_k: Optional[int] = None,
) -> torch.Tensor:
    """Sample next tokens from [B, V] logits; temperature == 0.0 is greedy
    (and needs no generator).  The generator must live on logits' device."""
    if temperature == 0.0:
        return greedy(logits)
    probs = torch.softmax(_warp(logits, temperature, top_p, top_k), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = categorical(flat, generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)
