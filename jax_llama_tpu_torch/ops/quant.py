"""Weight-only int8 quantization (port of ``jax_llama_tpu/ops/quant.py``).

Scheme: symmetric, per output channel.  For a weight ``W`` contracted over
its input dims, ``scale[c] = max|W[:, c]| / 127`` and ``Wq = round(W /
scale)`` (round half to even, clipped to +-127).  A product computes
``(x @ Wq) * scale``: the scale is constant along every contracted dim, so
the algebra is exact and the rescale touches only the output.

The JAX package reaches int8 weights through XLA's fused convert-dot; it
has no Pallas int8 matmul.  Here the payload is cast to the activation
dtype and multiplied by ``torch.matmul``, so a call reads the int8 bytes,
writes and reads a widened copy, and then streams it through the GEMM: a
fused int8-dequant GEMM is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch

# Contracted axes of each quantizable projection in its per-layer shape
# (the stacked tree adds a leading L axis):
#   qkv [KVH, G+2, D, hd] contracts D; o [H, hd, D] contracts (H, hd);
#   gate_up [2, D, F] contracts D; down [F, D] contracts F;
#   lm_head [D, V] contracts D.
_LAYER_CONTRACT = {
    "qkv": (2,), "o": (0, 1),
    "gate_up": (1,), "down": (0,),
}

# The scale is amax times 1/127, as the JAX package's compiled programs
# compute amax / 127 (XLA folds a division by a constant into a product
# with its reciprocal); the two differ in the last bit for some amax.
_INV127 = 1.0 / 127.0

# Float32 scratch per quantization step (one layer slice, or a column
# chunk of a 2-D weight).
_CHUNK_BYTES = 1 << 28


@dataclasses.dataclass
class QuantizedTensor:
    """int8 weight and float32 per-output-channel scale.

    q:     int8, the weight's shape.
    scale: float32, the same rank; the contracted (input) dims are 1.

    Indexing and ``unbind`` act on both along the leading axes, so a
    layer-stacked weight slices per layer as a tensor does."""

    q: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dim(self) -> int:
        return self.q.dim()

    def __getitem__(self, idx) -> "QuantizedTensor":
        return QuantizedTensor(self.q[idx], self.scale[idx])

    def unbind(self, dim: int = 0) -> List["QuantizedTensor"]:
        return [QuantizedTensor(q, s) for q, s in
                zip(self.q.unbind(dim), self.scale.unbind(dim))]

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def quantize(w: torch.Tensor, contract_axes: Sequence[int]) -> QuantizedTensor:
    """Symmetric int8 quantization of ``w``, one scale per position of its
    non-contracted dims.  The float32 work runs one slice at a time along
    the first non-contracted axis (a layer of a stacked weight, or a
    column chunk of a 2-D one), so the scratch is ``_CHUNK_BYTES`` at most
    rather than four bytes per element of ``w``."""
    axes = tuple(sorted(a % w.dim() for a in contract_axes))
    free = next(a for a in range(w.dim()) if a not in axes)
    scale_shape = [1 if a in axes else n for a, n in enumerate(w.shape)]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(scale_shape, dtype=torch.float32, device=w.device)
    n = w.shape[free]
    step = max(1, _CHUNK_BYTES // max(1, 4 * w.numel() // max(n, 1)))
    for i in range(0, n, step):
        m = min(step, n - i)
        w32 = w.narrow(free, i, m).float()
        s = w32.abs().amax(dim=axes, keepdim=True).clamp(min=1e-8) * _INV127
        q.narrow(free, i, m).copy_(
            torch.round(w32 / s).clamp(-127, 127).to(torch.int8))
        scale.narrow(free, i, m).copy_(s)
    return QuantizedTensor(q=q, scale=scale)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x [N, K] @ w`` where w's leading dims (their product K) are the
    contracted ones and its trailing dims (product M) the outputs; a
    ``QuantizedTensor`` is multiplied as its payload and rescaled after
    the product, ``(x @ q) * scale``, in float32.  Returns [N, M] in x's
    dtype."""
    if not isinstance(w, QuantizedTensor):
        return x @ w.reshape(x.shape[-1], -1).to(x.dtype)
    y = x @ w.q.reshape(x.shape[-1], -1).to(x.dtype)
    return (y.float() * w.scale.reshape(-1)).to(x.dtype)


def quantize_params(params: Any) -> Any:
    """Quantize every projection of a parameter dictionary to int8: the
    layers' qkv, o, gate_up and down, and an untied lm_head.  The
    embedding and the norms stay as they are (the embedding is a gather;
    tied as the head, it stays unquantized there too).  Returns a new
    dictionary; the input is not modified."""
    out = dict(params)
    lp = dict(params["layers"])
    for name, axes in _LAYER_CONTRACT.items():
        lp[name] = quantize(lp[name], tuple(a + 1 for a in axes))
    out["layers"] = lp
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"], (0,))
    return out


def is_quantized(params: Any) -> bool:
    """True if any leaf of the parameter tree is a ``QuantizedTensor``."""
    if isinstance(params, QuantizedTensor):
        return True
    if isinstance(params, dict):
        return any(is_quantized(v) for v in params.values())
    return False


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing head_dim (JAX ``quantize_kv``,
    ``models/llama.py:409``): x [..., hd] -> (int8 [..., hd], float32 scale
    [...]).  Every int8 KV path quantizes only the step's new projections
    with it; the stored payload is never re-quantized."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp(min=1e-8) * _INV127
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale
