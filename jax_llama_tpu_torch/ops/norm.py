"""RMSNorm with an fp32 statistics island (port of
``jax_llama_tpu/ops/norm.py``): y = x * rsqrt(mean(x^2) + eps) * scale,
computed in float32 and cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Root-mean-square norm over the last axis.

    Args:
      x: [..., dim] activations, any float dtype.
      scale: [dim] learned gain.
      eps: variance epsilon.
    """
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * scale.float()
    return out.to(x.dtype)
