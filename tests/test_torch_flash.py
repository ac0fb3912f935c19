"""The port's flash-attention forward held against the JAX kernel.

On the CPU the port's wrapper runs its plain version; the JAX
``flash_attention`` runs its Pallas kernel in interpret mode.  Inputs are
float32, drawn with numpy from a seed; tolerance atol 1e-5 on the rows
that see at least one live slot (the JAX kernel leaves rows with no live
slot unspecified unless every kv block is skipped; the port writes 0).
The split-KV instance's plain version (``flash_split_reference``) is held
the same way, out and lse, at T = 1 and 2 with G = 4 over caches that
leave whole runs dead.  The forward's instance rule and the codes the C
entry points report are checked here (the int8 rule in
``tests/test_torch_quant.py``);
the CUDA kernels themselves are held against the plain versions in
``tests/test_torch_cuda.py`` (marked ``cuda``).
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jax_llama_tpu.ops.flash_attention import flash_attention as jax_flash

jfa = importlib.import_module("jax_llama_tpu.ops.flash_attention")

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


# (dtype, head_dim, T, S, query heads per KV head, dropout, instance)
@pytest.mark.parametrize("dtype,d,T,S,G,drop,want", [
    (torch.bfloat16, 128, 2048, 2048, 4, False, "wgmma"),  # training shape
    (torch.bfloat16, 128, 2048, 2048, 4, True, "wgmma"),   # with dropout
    (torch.bfloat16, 128, 512, 512, 4, False, "wgmma"),    # generate prefill
    (torch.bfloat16, 128, 1024, 1024, 4, False, "wgmma"),  # serving insert
    (torch.bfloat16, 128, 256, 1024, 4, False, "wgmma"),   # chunk window
    (torch.bfloat16, 128, 128, 1, 1, False, "wgmma"),
    (torch.bfloat16, 128, 1, 1024, 1, False, "split_kv"),  # T = 1, G = 1
    (torch.bfloat16, 128, 1, 1024, 4, False, "split_kv"),  # cached decode
    (torch.bfloat16, 64, 1, 200, 8, False, "split_kv"),    # head_dim 64
    (torch.bfloat16, 128, 4, 1024, 4, False, "split_kv"),  # 16 packed rows
    (torch.bfloat16, 128, 1, 1024, 16, False, "split_kv"),
    (torch.bfloat16, 128, 1, 1024, 4, True, "mma_sync"),   # dropout
    (torch.bfloat16, 128, 5, 1024, 4, False, "mma_sync"),  # 20 packed rows
    (torch.bfloat16, 128, 1, 1024, 32, False, "mma_sync"),  # 32 rows
    (torch.bfloat16, 128, 1, 0, 4, False, "mma_sync"),     # empty cache
    (torch.bfloat16, 128, 64, 64, 4, False, "mma_sync"),   # T % 128 != 0
    (torch.bfloat16, 128, 200, 200, 1, False, "mma_sync"),  # ragged T
    (torch.bfloat16, 64, 512, 512, 4, False, "mma_sync"),  # head_dim 64
    (torch.bfloat16, 128, 0, 16, 4, False, "mma_sync"),
    (torch.bfloat16, 128, 128, 0, 4, False, "mma_sync"),
    (torch.float32, 128, 2048, 2048, 4, False, "float32"),
    (torch.float32, 64, 1, 16, 4, False, "float32"),
    (torch.float32, 128, 1, 1024, 4, False, "float32"),   # cached_decode f32
])
def test_flash_instance_dispatch(dtype, d, T, S, G, drop, want):
    """The forward instance a CUDA call runs: the Hopper (TMA + wgmma) one
    only for bf16 at head_dim 128 with T a positive multiple of its 128-row
    tile; the split-KV one for bf16 with at most 16 packed rows G*T, a
    non-empty cache and no dropout (T = 1 decode; T = 1 was on mma.sync
    before it); every other bf16 call on the mma.sync one, float32 on its
    own."""
    assert fa_module.flash_instance(dtype, d, T, S, G, drop) == want
    if not drop and G == 1:  # the defaults: one head per KV head, no dropout
        assert fa_module.flash_instance(dtype, d, T, S) == want


def test_instance_report_codes_cover_every_rule():
    """Every instance the three rules can return has a code the C entry
    points report, and every forward and int8 instance an entry point."""
    names = set()
    for dtype in (torch.bfloat16, torch.float32):
        for d in (64, 128):
            for T in (0, 1, 2, 4, 5, 17, 128, 256, 65536 + 128):
                for S in (0, 1, 1024):
                    names.add(fa_module.flash_bwd_instance(dtype, d, T, S))
                    names.add(fa_module.flash_int8_instance(dtype, d, T, S))
                    for G in (1, 4, 8, 32):
                        for drop in (False, True):
                            names.add(fa_module.flash_instance(
                                dtype, d, T, S, G, drop))
    codes = fa_module._INSTANCES
    assert names == set(codes.values()) == {"float32", "mma_sync", "wgmma",
                                            "split_kv"}
    assert len(codes) == len(set(codes.values()))
    assert set(fa_module._ENTRY) == names
    assert set(fa_module._INT8_ENTRY) == names - {"split_kv"}


def test_split_constant_pinned_to_the_kernel():
    """The wrapper's run length and row cap are the C entry point's SPLIT
    and MAXR (the entry point rejects a run count computed from any other
    run length, which the card test checks)."""
    src = (Path(fa_module.__file__).resolve().parent.parent / "csrc"
           / "flash_fwd.cu").read_text()
    (c_split,) = re.findall(r"constexpr int SPLIT = (\d+);", src)
    (c_rows,) = re.findall(r"constexpr int MAXR = (\d+);", src)
    assert fa_module.FLASH_SPLIT == int(c_split) == 256
    assert fa_module.SPLIT_MAX_ROWS == int(c_rows) == 16


def _pack(q, q_pos, KVH):
    """The JAX wrapper's GQA packing (rows g*T + t), for _flash_forward."""
    B, T, H, d = q.shape
    G = H // KVH
    qp = jnp.moveaxis(jnp.asarray(q).reshape(B, T, KVH, G, d), 3, 1)
    return qp.reshape(B, G * T, KVH, d), jnp.tile(jnp.asarray(q_pos), (1, G))


def _split_case(T):
    """G = 4 (H = 8, KVH = 2), d = 16, S = 96 in runs of 16: row 0 fills 90
    slots (its last run dead past its position), row 1 holds positions
    0..20 in slots 40..60 (runs 0-1 and 4-5 dead), row 2 holds nothing
    (out 0, lse +inf); T queries at the fill's last positions."""
    B, S, H, KVH, d = 3, 96, 8, 2, 16
    rng = np.random.default_rng(11 + T)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, d)).astype(np.float32)
    kv_pos = np.full((B, S), -1, np.int32)
    kv_pos[0, :90] = np.arange(90)
    kv_pos[1, 40:61] = np.arange(21)
    last = np.array([89, 20, 0])
    q_pos = (last[:, None] - np.arange(T)[::-1][None]).astype(np.int32)
    return q, k, v, np.maximum(q_pos, 0), kv_pos


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("split", [16, 32, 256])
def test_split_reference_matches_jax_kernel(T, split):
    """The split-and-combine plain version against JAX's Pallas kernel in
    interpret mode (out and lse, live rows, atol 1e-5) and against the
    port's dense plain version; the row with no live slot is out 0 and
    lse +inf exactly."""
    arrays = _split_case(T)
    q, k, v, q_pos, kv_pos = arrays
    KVH = k.shape[2]
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in arrays),
                                block_q=8, block_k=8))
    qpk, posk = _pack(q, q_pos, KVH)
    _, lse = jfa._flash_forward(
        qpk, jnp.asarray(k), jnp.asarray(v), posk, jnp.asarray(kv_pos), 8, 8,
        None, need_lse=True)
    want_lse = np.asarray(lse)[:, :, :qpk.shape[1], 0]
    args = [torch.from_numpy(a) for a in arrays]
    out, got_lse = fa_module.flash_split_reference(*args, split=split,
                                                   return_lse=True)
    live = _live_rows(q_pos, kv_pos)
    assert live[:2].all() and not live[2].any()
    np.testing.assert_allclose(out.numpy()[live], want[live], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy()[:2], want_lse[:2], atol=ATOL,
                               rtol=0)
    assert torch.all(out[2] == 0) and torch.isinf(got_lse[2]).all()
    assert (got_lse[2] > 0).all()
    dense, dense_lse = flash_attention_reference(*args, return_lse=True)
    torch.testing.assert_close(out, dense, atol=ATOL, rtol=0)
    torch.testing.assert_close(got_lse, dense_lse, atol=ATOL, rtol=0)


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
