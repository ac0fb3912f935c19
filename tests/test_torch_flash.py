"""The port's flash-attention forward held against the JAX kernel.

On the CPU the port's wrapper runs its plain version; the JAX
``flash_attention`` runs its Pallas kernel in interpret mode.  Inputs are
float32, drawn with numpy from a seed; tolerance atol 1e-5 on the rows
that see at least one live slot (the JAX kernel leaves rows with no live
slot unspecified unless every kv block is skipped; the port writes 0).
The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py`` (marked ``cuda``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jax_llama_tpu.ops.flash_attention import flash_attention as jax_flash

from jax_llama_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

fa_module = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")

ATOL = 1e-5


def _case(seed, B, T, S, H, KVH, d, q_base, kv_pos):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    q_pos = (np.arange(T, dtype=np.int32)[None, :] + np.asarray(q_base)[:, None])
    return q, k, v, q_pos.astype(np.int32), np.asarray(kv_pos, np.int32)


def _left_padded(B, S, pads):
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1)) - np.asarray(pads)[:, None]
    return np.where(pos >= 0, pos, -1)


def _cases():
    # Prefill, G = 1 and G = 2, left padding (pad queries clamp to 0).
    pads = np.array([0, 5])
    kvp = _left_padded(2, 16, pads)
    qb = np.zeros(2, np.int32)
    yield "prefill_g1_padded", (0, 2, 16, 16, 4, 4, 16, qb, kvp)
    yield "prefill_g2_padded", (1, 2, 16, 16, 4, 2, 16, qb, kvp)
    # Decode: T = 1 over a 24-slot cache with unwritten (-1) slots.
    cache = np.full((2, 24), -1, np.int32)
    cache[0, :11] = np.arange(11)
    cache[1, 3:11] = np.arange(8)
    yield "decode_cache_slots", (2, 2, 1, 24, 4, 2, 16, np.array([10, 7]),
                                 cache)
    # Chunk window: queries at base 9 + [0, 6), kv holds 0..14 then a
    # -1 tail.
    win = np.full((1, 20), -1, np.int32)
    win[0, :15] = np.arange(15)
    yield "chunk_window", (3, 1, 6, 20, 4, 2, 16, np.array([9]), win)


CASES = dict(_cases())


def _live_rows(q_pos, kv_pos):
    kp = kv_pos[:, None, :]
    return ((kp >= 0) & (kp <= q_pos[:, :, None])).any(-1)  # [B, T]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_matches_jax_kernel(name):
    q, k, v, q_pos, kv_pos = _case(*CASES[name])
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(q_pos), jnp.asarray(kv_pos),
    ))
    got = flash_attention(*(torch.from_numpy(a) for a in
                            (q, k, v, q_pos, kv_pos))).numpy()
    live = _live_rows(q_pos, kv_pos)
    assert live.any()
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)


def test_dead_rows_are_zero():
    q, k, v, q_pos, _ = _case(4, 1, 4, 8, 2, 1, 16, np.array([0]),
                              np.zeros((1, 8), np.int32))
    kv_pos = np.full((1, 8), -1, np.int32)
    kv_pos[0, 4:] = np.arange(2, 6)  # row t sees a slot only when t >= 2
    out = flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos))
    ).numpy()
    assert np.all(out[0, :2] == 0.0)
    assert np.all(np.abs(out[0, 2:]).sum(-1) > 0)


def test_cpu_tensor_takes_plain_version(monkeypatch):
    q, k, v, q_pos, kv_pos = (torch.from_numpy(a) for a in
                              _case(*CASES["prefill_g2_padded"]))
    calls = []
    real = fa_module.flash_attention_reference

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(fa_module, "flash_attention_reference", spy)
    before = flash_attention.launches
    out = flash_attention(q, k, v, q_pos, kv_pos)
    assert len(calls) == 1
    assert flash_attention.launches == before
    torch.testing.assert_close(out, real(q, k, v, q_pos, kv_pos))


def test_plain_flash_bf16_keeps_dtype():
    q, k, v, q_pos, kv_pos = _case(*CASES["chunk_window"])
    args = [torch.from_numpy(a) for a in (q, k, v)]
    args = [a.to(torch.bfloat16) for a in args]
    out = flash_attention(*args, torch.from_numpy(q_pos),
                          torch.from_numpy(kv_pos))
    assert out.dtype == torch.bfloat16
    want = flash_attention_reference(*(a.float() for a in args),
                                     torch.from_numpy(q_pos),
                                     torch.from_numpy(kv_pos))
    # P is rounded to bf16 before P.V: bf16 output rounding plus that.
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=0)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 2, 2, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q, torch.zeros(1, 2, dtype=torch.int32),
                        torch.zeros(1, 2, dtype=torch.int32))


@pytest.mark.parametrize("dtype,d,T,S,want", [
    (torch.bfloat16, 128, 2048, 2048, "wgmma"),   # training shape
    (torch.bfloat16, 128, 512, 512, "wgmma"),     # generate's prefill
    (torch.bfloat16, 128, 1024, 1024, "wgmma"),   # serving insert
    (torch.bfloat16, 128, 256, 1024, "wgmma"),    # a prefill chunk window
    (torch.bfloat16, 128, 128, 1, "wgmma"),
    (torch.bfloat16, 128, 1, 1024, "mma_sync"),   # cached decode, T = 1
    (torch.bfloat16, 128, 64, 64, "mma_sync"),    # T not a multiple of 128
    (torch.bfloat16, 128, 200, 200, "mma_sync"),  # ragged T
    (torch.bfloat16, 64, 512, 512, "mma_sync"),   # head_dim 64
    (torch.bfloat16, 128, 0, 16, "mma_sync"),
    (torch.bfloat16, 128, 128, 0, "mma_sync"),
    (torch.float32, 128, 2048, 2048, "float32"),
    (torch.float32, 64, 1, 16, "float32"),
])
def test_flash_instance_dispatch(dtype, d, T, S, want):
    """The forward instance a CUDA call runs: the Hopper (TMA + wgmma) one
    only for bf16 at head_dim 128 with T a positive multiple of its 128-row
    tile, every other bf16 call on the mma.sync one, float32 on its own."""
    assert fa_module.flash_instance(dtype, d, T, S) == want


def test_cpu_calls_count_no_instance():
    """The plain version runs on CPU tensors and counts no instance, even
    at a shape the Hopper instance would take."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 128, 2, 128)).astype(
        np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((1, 128, 1, 128)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.arange(128, dtype=torch.int32)[None]
    assert fa_module.flash_instance(q.dtype, 128, 128, 128) == "wgmma"
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_instance))
    out = flash_attention(q, k, k, pos, pos)
    assert out.shape == q.shape
    assert (flash_attention.launches,
            flash_attention.launches_by_instance) == before
