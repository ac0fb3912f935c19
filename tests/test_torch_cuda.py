"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips on a host without a GPU (the
kernels have no CPU mode).  This file imports neither jax nor the JAX
package, so it also runs on a GPU host without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: bf16 atol 2e-2 (output rounding plus P rounded to bf16
before P.V); float32 atol 1e-4 (summation order).
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")

# (B, T, S, H, KVH, d, query base, kv layout)
CASES = {
    "prefill_left_padded": (2, 40, 40, 8, 2, 128, 0, "left_pad"),
    "decode_cache_slots": (3, 1, 200, 8, 8, 128, None, "cache"),
    "chunk_window": (1, 24, 100, 4, 2, 64, 30, "tail"),
    "multi_tile_gqa4": (2, 130, 130, 8, 2, 64, 0, "left_pad"),
}


def _inputs(name, dtype, seed=0):
    B, T, S, H, KVH, d, base, layout = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, T, H, d), (B, S, KVH, d), (B, S, KVH, d)))
    slots = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    if layout == "left_pad":
        pads = (np.arange(B) * 7)[:, None]
        kv_pos = np.where(slots >= pads, slots - pads, -1)
        q_pos = np.maximum(kv_pos[:, :T], 0)
    elif layout == "cache":
        fill = rng.integers(1, S, B)[:, None]
        kv_pos = np.where(slots < fill, slots, -1)
        q_pos = (fill - 1).astype(np.int32)
    else:  # a chunk window at base with a -1 tail
        kv_pos = np.where(slots < base + T, slots, -1)
        q_pos = np.tile(np.arange(base, base + T, dtype=np.int32), (B, 1))
    dev = [torch.from_numpy(a).cuda().to(dtype) for a in (q, k, v)]
    pos = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
           for a in (q_pos, kv_pos)]
    return dev + pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_kernel_matches_plain(name, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _inputs(name, dtype)
    before = fa.flash_attention.launches
    out = fa.flash_attention(*args)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    want = fa.flash_attention_reference(*args)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.cuda
def test_flash_wrapper_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, q_pos, kv_pos = _inputs("chunk_window", torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half(), q_pos, kv_pos)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k, v, q_pos, kv_pos)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v, q_pos.long(), kv_pos)
