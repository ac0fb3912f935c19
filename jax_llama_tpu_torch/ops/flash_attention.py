"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Port of the forward half of ``jax_llama_tpu/ops/flash_attention.py``
(``flash_attention`` :539 -> ``_flash_forward`` :746, the Pallas kernel).
The contract is the JAX one:

* q ``[B, T, H, d]``, k/v ``[B, S, KVH, d]`` with ``H % KVH == 0``;
* q_pos ``[B, T]`` int32 absolute query positions (already clamped >= 0),
  kv_pos ``[B, S]`` int32 slot positions, -1 for padding / unwritten slots;
* a query attends a slot iff ``0 <= kv_pos <= q_pos`` (purely positional,
  so a chunk window at a non-zero base with a -1 tail needs no special
  case);
* GQA query heads are packed into query rows (row ``r = g*T + t`` of KV
  head ``kvh`` is head ``kvh*G + g``), so each K/V tile is read once per
  KV head;
* a row that sees no live slot outputs 0;
* output ``[B, T, H, d]`` in q's dtype.

``flash_attention`` runs the hand-written kernel ``csrc/flash_fwd.cu`` on
CUDA tensors and the plain version ``flash_attention_reference`` on CPU
tensors.  A CUDA tensor either reaches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

KERNEL = "flash_fwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
) -> torch.Tensor:
    """Dense positional-mask softmax attention with the kernel's contract.

    Scores and softmax in float32; the probabilities are rounded to v's
    dtype before the P.V product and the sum is divided by the float32
    row sum, as the kernel (and the JAX kernel) do.
    """
    B, T, H, d = q.shape
    KVH = k.shape[2]
    assert H % KVH == 0, (H, KVH)
    qg = q.reshape(B, T, KVH, H // KVH, d)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    kp = kv_pos[:, None, :]
    allowed = (kp >= 0) & (kp <= q_pos[:, :, None])  # [B, T, S]
    s = s.masked_fill(~allowed[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1)  # [B, KVH, G, T]
    o = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(), v.float())
    l = l.permute(0, 3, 1, 2)[..., None]  # [B, T, KVH, G, 1]
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)), 0.0)
    return o.reshape(B, T, H, d).to(q.dtype)


def _check(q, k, v, q_pos, kv_pos) -> None:
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
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of "
                        f"{list(_DTYPE_CODE)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("q_pos and kv_pos must be int32")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (have {_HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q, k, v, q_pos, kv_pos) -> torch.Tensor:
    lib = _build.load(KERNEL)
    fn = lib.flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(), B, T, S, H, KVH, d,
            _DTYPE_CODE[q.dtype], scale_log2, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {rc}")
    flash_attention.launches += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
) -> torch.Tensor:
    """Blockwise causal attention with positional masking (see module
    docstring).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (bf16 or float32, head_dim 64 or 128) or raise."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_pos, kv_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, q_pos, kv_pos)
    return _launch(q, k, v, q_pos, kv_pos)


# Launches of the CUDA kernel in this process; the plain version never
# counts.  Callers reset it by assigning 0.
flash_attention.launches = 0
