"""Fused (chunked) softmax cross-entropy over the LM head (port of
``jax_llama_tpu/ops/loss.py``).

The head matmul is taken chunkwise over the flattened (batch * position)
rows, the row logsumexp and the target logit are folded into each chunk,
and no more than one [chunk, V] float32 logits tile exists at a time: the
[N, V] logits are never materialized.  Each chunk runs under
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``), so the backward
pass recomputes the chunk's logits instead of holding them.  The head
matmul is a plain ``torch.mm`` (the JAX package leaves it to XLA).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

# Rows per chunk (the JAX package's value): a [512, V] float32 transient.
CE_CHUNK = 512


class _F32Logits(torch.autograd.Function):
    """x [N, D] @ w [D, V] with a float32 result accumulated in float32
    (the JAX einsum's preferred_element_type=float32), without widening w.
    The backward rounds the float32 cotangent to x's dtype and runs the
    two products in that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dtype == torch.float32:
            return x @ w.float()
        if x.device.type == "cuda":
            return torch.mm(x, w.to(x.dtype), out_dtype=torch.float32)
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        wx = w.to(x.dtype)
        return g @ wx.T, (x.T @ g).to(w.dtype)


def matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, D] @ w [D, V] with a float32 result and float32 accumulation,
    without widening w; differentiable (see ``_F32Logits``)."""
    return _F32Logits.apply(x, w)


def _chunk_nll(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    logits = matmul_f32_out(h, w)  # [c, V] float32
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(1, targets[:, None].long())[:, 0]
    return ((lse - tgt) * weights).sum()


def chunked_softmax_xent(
    h: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    weights: torch.Tensor,
    *,
    head_transposed: bool = False,
    chunk: int = CE_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted next-token NLL without materializing [N, V] logits.

    Args:
      h: [N, D] post-final-norm hidden rows (activation dtype).
      head: LM head weights, [D, V], or [V, D] with ``head_transposed``
        (the tied-embedding layout; the transpose is a view).
      targets: [N] integer target token ids.
      weights: [N] float32 per-row loss weights (0 = ignore the row).
      chunk: rows per chunk.

    Returns:
      (total_nll, total_weight), float32 scalars;
      ``total_nll / max(total_weight, 1)`` is the masked mean the dense
      path computes.
    """
    w = head.T if head_transposed else head
    weights = weights.float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, h.shape[0], chunk):
        part = (h[start:start + chunk], w, targets[start:start + chunk],
                weights[start:start + chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_nll, *part, use_reentrant=False)
        else:
            tot = tot + _chunk_nll(*part)
    return tot, weights.sum()
