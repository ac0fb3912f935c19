"""Rotary position embeddings in the half-split layout (port of
``jax_llama_tpu/ops/rope.py``).

Pair i is ``(x[i], x[i + hd/2])``.  This equals Meta's interleaved complex
rotation exactly because the q/k projection weights are stored with their
head_dim axis permuted even-first (``rope_permute`` in the JAX package's
``models/llama.py``); the port takes the weights in that stored layout.
Tables are computed on the host in float64 numpy and kept as float32;
the rotation runs in float32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def llama3_scale_inv_freq(
    inv_freq: np.ndarray,
    scale_factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_len: int = 8192,
) -> np.ndarray:
    """Llama-3.1 frequency scaling for context extension: high frequencies
    are kept, low frequencies divided by ``scale_factor``, the band between
    interpolated in wavelength space."""
    wavelen = 2.0 * np.pi / inv_freq
    low_wl = original_max_len / low_freq_factor
    high_wl = original_max_len / high_freq_factor
    smooth = (original_max_len / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    mid = ((1.0 - smooth) / scale_factor + smooth) * inv_freq
    out = np.where(wavelen > low_wl, inv_freq / scale_factor, inv_freq)
    in_band = (wavelen <= low_wl) & (wavelen >= high_wl)
    return np.where(in_band, mid, out)


def rope_table(
    head_dim: int,
    max_positions: int,
    theta: float = 10000.0,
    use_scaled_rope: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables, each [max_positions, head_dim // 2] float32 numpy."""
    assert head_dim % 2 == 0
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if use_scaled_rope:
        inv_freq = llama3_scale_inv_freq(inv_freq)
    t = np.arange(max_positions, dtype=np.float64)
    angles = np.outer(t, inv_freq)
    return (
        np.cos(angles).astype(np.float32),
        np.sin(angles).astype(np.float32),
    )


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
) -> torch.Tensor:
    """Rotate q or k by position-dependent angles.

    Args:
      x: [B, T, heads, head_dim] in the half-split feature layout.
      cos, sin: [max_positions, head_dim // 2] float32 tables on x's device.
      positions: [B, T] integer absolute positions (>= 0).
    Returns:
      Rotated tensor, same shape and dtype as x.
    """
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    idx = positions.long()
    c = cos[idx][:, :, None, :]
    s = sin[idx][:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
