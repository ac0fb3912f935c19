"""The port's int8 kernels and the paged kernel's launch split on the card.
Marked ``cuda``: each test skips on a host without a GPU (the kernels have
no CPU mode).  Like tests/test_torch_cuda.py, this file imports neither
jax nor the JAX package:

    python -m pytest tests/test_torch_quant_cuda.py -m cuda --noconftest -q

* ``flash_fwd_int8`` and the int8 paged kernel against their plain
  versions, at head_dim 64 and 128, bf16 and float32 q; the int8 flash
  forward's Hopper instance at T = 128 and 256 (left padding, a chunk
  window at a non-zero base with a -1 tail, a cache ending inside a TMA
  box), with its reported instance, bit-identical calls and the replaced
  mma.sync design beside it; the paged kernel
  at block sizes 128, 62 and 20, at T = 1 and T > 1 with a block that only
  the later tokens see and an active row whose pool is empty.  Tolerances:
  bf16 atol 2e-2 (flash: output rounding plus P rounded to bf16) and 1e-2
  (paged: float32 output, P rounded to bf16); float32 atol 1e-4 (flash)
  and 1e-5 (paged), summation order; lse atol 1e-4.
* The wrappers raise on what the kernels do not take.
* The split-KV kernel over an int8 pool at T = 1, 4, 5 and 8, G = 4
  and 8: one launch of up to 64 packed rows, bit-identical over two
  calls, both passes counted.
* C1: a G = 8 model at n_draft = 8 (72 packed rows a verify, past the
  kernel's 64) runs the kernel in launches of 8 + 1 tokens and emits the
  gathered view's tokens (float32, no TF32).
"""

import importlib

import numpy as np
import pytest
import torch

import jax_llama_tpu_torch as ptl
from paged_inputs import pool_state

fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _int8(x):
    """x [..., d] float32 -> (int8 payload, float32 scales) on the card."""
    q, s = ptl.quantize_kv(torch.from_numpy(x).cuda())
    return q.contiguous(), s.contiguous()


# (B, T, S, H, KVH, d, query base, kv layout), as tests/test_torch_cuda.py
FLASH_CASES = {
    "prefill_left_padded": (2, 40, 40, 8, 2, 128, 0, "left_pad"),
    "decode_cache_slots": (3, 1, 200, 8, 8, 128, None, "cache"),
    "chunk_window": (1, 24, 100, 4, 2, 64, 30, "tail"),
    "multi_tile_gqa4": (2, 130, 130, 8, 2, 64, 0, "left_pad"),
}


def _flash_inputs(name, dtype, seed=0, cases=FLASH_CASES):
    B, T, S, H, KVH, d, base, layout = cases[name]
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
    # unwritten slots hold payload 0 and scale 0, as a fresh cache does
    k[kv_pos < 0] = 0.0
    v[kv_pos < 0] = 0.0
    (kq, ks), (vq, vs) = _int8(k), _int8(v)
    pos = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
           for a in (q_pos, kv_pos)]
    return [torch.from_numpy(q).cuda().to(dtype), kq, vq, ks, vs] + pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_int8_kernel_matches_plain(name, dtype, atol):
    _needs_card()
    args = _flash_inputs(name, dtype)
    before = fa.flash_attention_quantized.launches
    out = fa.flash_attention_quantized(*args)
    torch.cuda.synchronize()
    assert fa.flash_attention_quantized.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    want = fa.flash_attention_quantized_reference(*args)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=0)


# The int8 forward's Hopper instance: bf16 q, d = 128, T a multiple of
# 128.  (B, T, S, H, KVH, d, query base, kv layout): left padding at
# T = 128 and 256 (G = 4), a chunk window at base 200 with a -1 tail, and
# one whose cache (S = 300) ends inside a landing stage.
WGMMA_CASES = {
    "t128_left_padded": (2, 128, 128, 8, 2, 128, 0, "left_pad"),
    "t256_left_padded": (2, 256, 256, 16, 4, 128, 0, "left_pad"),
    "t128_window_base200": (2, 128, 512, 8, 2, 128, 200, "tail"),
    "t128_window_s300": (1, 128, 300, 8, 1, 128, 100, "tail"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WGMMA_CASES))
def test_flash_int8_wgmma_matches_plain(name):
    """The int8 Hopper instance (TMA landing ring, int8 widened in shared
    memory, wgmma) against the plain version (atol 2e-2) and against the
    replaced mma.sync design on the same inputs; its C entry point
    reports "wgmma" as ``flash_int8_instance`` predicts; a second call
    is bit-identical."""
    _needs_card()
    args = _flash_inputs(name, torch.bfloat16, cases=WGMMA_CASES)
    q, kq = args[0], args[1]
    assert fa.flash_int8_instance(q.dtype, q.shape[3], q.shape[1],
                                  kq.shape[1]) == "wgmma"
    w = fa.flash_attention_quantized
    before = (w.launches, dict(w.launches_by_instance))
    out = fa.flash_attention_quantized(*args)
    again = fa.flash_attention_quantized(*args)
    old = fa.flash_attention_quantized_launch(*args, "mma_sync")
    torch.cuda.synchronize()
    assert w.launches == before[0] + 3
    by = w.launches_by_instance
    assert by["wgmma"] == before[1].get("wgmma", 0) + 2
    assert by["mma_sync"] == before[1].get("mma_sync", 0) + 1
    assert torch.equal(out, again)
    want = fa.flash_attention_quantized_reference(*args)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(out.float(), old.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_flash_int8_wrapper_rejects_bad_inputs():
    _needs_card()
    q, kq, vq, ks, vs, q_pos, kv_pos = _flash_inputs("chunk_window",
                                                     torch.bfloat16)
    with pytest.raises(TypeError):  # a bf16 cache is flash_attention's
        fa.flash_attention_quantized(q, kq.to(q.dtype), vq.to(q.dtype), ks,
                                     vs, q_pos, kv_pos)
    with pytest.raises(ValueError):  # scales of the wrong shape
        fa.flash_attention_quantized(q, kq, vq, ks[:, :-1].contiguous(), vs,
                                     q_pos, kv_pos)
    with pytest.raises(ValueError):  # scales not float32
        fa.flash_attention_quantized(q, kq, vq, ks.half(), vs, q_pos,
                                     kv_pos)
    with pytest.raises(ValueError):  # head_dim 32
        fa.flash_attention_quantized(q[..., :32].contiguous(),
                                     kq[..., :32].contiguous(),
                                     vq[..., :32].contiguous(), ks, vs,
                                     q_pos, kv_pos)


def _paged_inputs(dtype, B, KVH, G, d, BLK, MB, L, fills, inactive, T=1):
    k, v, pos, table, q_pos = pool_state(9, B, KVH, d, BLK, MB, L, fills,
                                         inactive)
    if T > 1:  # the last token at the fill: early tokens miss T-1 slots
        q_pos = np.asarray([-1 if b in inactive else max(f - (T - 1), 0)
                            for b, f in enumerate(fills)], np.int32)
    held = (pos >= 0)[None, None, :, :, None]
    (kq, ks), (vq, vs) = _int8(k * held), _int8(v * held)
    q = np.random.default_rng(10).standard_normal(
        (B, KVH, T * G, d)).astype(np.float32)
    ints = [torch.from_numpy(a).cuda() for a in (pos, table, q_pos)]
    return ([torch.from_numpy(q).cuda().to(dtype), kq, vq] + ints,
            dict(k_scale=ks, v_scale=vs))


# (B, KVH, G, T, d, BLK, MB, L, fills, inactive).  At T > 1 a row of fill
# BLK*k + 1 holds one slot in its last block that only the later tokens
# see; a row of fill 0 is active with an empty pool.
PAGED_CASES = {
    "t1_d128_g4_blk128": (8, 8, 4, 1, 128, 128, 4, 3,
                          (400, 130, 128, 1, 0, 64, 257, 12), (5,)),
    "t1_d64_g8_blk62": (4, 2, 8, 1, 64, 62, 5, 2, (200, 61, 0, 5), (1,)),
    "t1_d64_g2_blk20": (3, 2, 2, 1, 64, 20, 5, 2, (70, 19, 41), ()),
    "t4_d128_g4_blk128": (4, 8, 4, 4, 128, 128, 5, 2,
                          (500, 129, 0, 548), ()),
    "t4_d128_g8_blk62": (3, 2, 8, 4, 128, 62, 6, 2, (125, 0, 63), (2,)),
    "t5_d64_g2_blk20": (4, 2, 2, 5, 64, 20, 5, 2, (41, 0, 70, 21), (3,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_int8_kernel_matches_plain(name, dtype, atol):
    _needs_card()
    B, KVH, G, T, d, BLK, MB, L, fills, inactive = PAGED_CASES[name]
    args, scales = _paged_inputs(dtype, B, KVH, G, d, BLK, MB, L, fills,
                                 inactive, T)
    before = (pa.paged_pool_attention.launches,
              pa.paged_pool_attention.launches_int8)
    out, lse = pa.paged_pool_attention(*args, layer=L - 1, t_tokens=T,
                                       **scales)
    torch.cuda.synchronize()
    assert (pa.paged_pool_attention.launches,
            pa.paged_pool_attention.launches_int8) == (before[0] + 1,
                                                       before[1] + 1)
    ro, rl = pa.paged_pool_attention_reference(*args, layer=L - 1,
                                               t_tokens=T, **scales)
    torch.testing.assert_close(out, ro, atol=atol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    for b, f in enumerate(fills):
        if f == 0 or b in inactive:  # attends nothing at any token
            assert (lse[b] == pa.MASK_VALUE).all() and (out[b] == 0).all()


# The split-KV kernel's pool (see tests/test_torch_paged_cuda.py
# SPLIT_POOL): BLK = 64, MB = 20, 5 splits of 256 slots a row; one row
# over four splits, one in one, a sentinel entry, an empty pool, an
# inactive row and a bound inside a split.
SPLIT_POOL = (6, 2, 128, 64, 20, 2, (1000, 200, 513, 0, 700, 300), (4,))


def _split_instance(dtype, rows):
    """The split pass's instance the C entry point picks for ``rows``
    packed rows: bf16 q on 1, 2 or 4 tensor-core m-tiles of 16 rows,
    float32 q on the CUDA-core kernel holding 16 or 64 rows."""
    if dtype == torch.bfloat16:
        return f"mma_sync_m{16 if rows <= 16 else 32 if rows <= 32 else 64}"
    return f"cuda_cores_r{16 if rows <= 16 else 64}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("G,T", [(4, 1), (8, 1), (4, 4), (8, 4), (4, 5),
                                 (8, 5), (4, 8), (8, 8)])
def test_split_kv_int8_kernel_matches_plain(G, T, dtype, atol):
    """The int8 split pass (each tile widened once into bf16 for the
    tensor cores at bf16 q; the CUDA-core loop at float32 q) and the
    combine pass against the plain version, at T = 1, 4, 5 and 8 and
    G = 4 and 8 (one launch each, up to 64 packed rows); bit-identical
    over two calls; both passes launched."""
    _needs_card()
    B, KVH, d, BLK, MB, L, fills, inactive = SPLIT_POOL
    args, scales = _paged_inputs(dtype, B, KVH, G, d, BLK, MB, L, fills,
                                 inactive, T)
    before = (pa.paged_pool_attention.launches_int8,
              pa.paged_pool_attention.kernel_launches,
              dict(pa.paged_pool_attention.launches_by_instance))
    out, lse = pa.paged_pool_attention(*args, layer=L - 1, t_tokens=T,
                                       **scales)
    again = pa.paged_pool_attention(*args, layer=L - 1, t_tokens=T,
                                    **scales)
    torch.cuda.synchronize()
    assert pa.paged_pool_attention.launches_int8 == before[0] + 2
    # Two calls, each reported by the C entry point as a split pass and
    # a combine pass, both on the split instance these rows take.
    assert pa.paged_pool_attention.kernel_launches == before[1] + 4
    want = _split_instance(dtype, G * T)
    assert pa.paged_pool_attention.launches_by_instance.get(want) == (
        before[-1].get(want, 0) + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ro, rl = pa.paged_pool_attention_reference(*args, layer=L - 1,
                                               t_tokens=T, **scales)
    torch.testing.assert_close(out, ro, atol=atol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    for b, f in enumerate(fills):
        if f == 0 or b in inactive:
            assert (lse[b] == pa.MASK_VALUE).all() and (out[b] == 0).all()


@pytest.mark.cuda
def test_paged_int8_wrapper_rejects_bad_inputs():
    _needs_card()
    args, scales = _paged_inputs(torch.bfloat16, 3, 2, 8, 64, 24, 5, 2,
                                 (100, 30, 5), (1,))
    q, kq, vq, pos, table, q_pos = args
    with pytest.raises(TypeError):  # an int8 pool needs its scales
        pa.paged_pool_attention(*args)
    with pytest.raises(ValueError):  # scales go together
        pa.paged_pool_attention(*args, k_scale=scales["k_scale"])
    with pytest.raises(ValueError):  # scale planes of the wrong shape
        pa.paged_pool_attention(
            *args, k_scale=scales["k_scale"][:1].contiguous(),
            v_scale=scales["v_scale"][:1].contiguous())
    q9 = torch.zeros((3, 2, 9, 64), dtype=q.dtype, device=q.device)
    with pytest.raises(ValueError, match="query heads"):  # G = 9
        pa.paged_pool_attention(q9, *args[1:], **scales)


@pytest.mark.cuda
def test_tiny_g8_batcher_splits_the_verify_on_card():
    """C1: G = 8 at n_draft = 8 is 72 packed rows a verify, past the
    kernel's 64; the kernel runs it as launches of 8 + 1 tokens,
    (n_draft + 2) * n_layers * 2 per round, and the tokens are the
    gathered view's."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ptl.get_config("tiny", vocab_size=128, dim=512, n_layers=2,
                         n_heads=8, n_kv_heads=1, multiple_of=32,
                         max_seq_len=128, attn_impl="auto")
    params = ptl.init_params(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, size=rng.randint(3, 40)).tolist()
               for _ in range(4)]
    n_draft = 8
    outs = {}
    for path in ("paged", "gathered"):
        cb = ptl.ContinuousBatcher(params, cfg, n_slots=2, max_len=128,
                                   draft_params=params, draft_config=cfg,
                                   n_draft=n_draft, spec_rounds=2,
                                   use_pallas_kernel=path == "paged")
        rids = [cb.submit(p, max_new_tokens=9 + i)
                for i, p in enumerate(prompts)]
        pa.paged_pool_attention.launches_by_t = {}
        res = cb.run_to_completion()
        torch.cuda.synchronize()
        by_t = dict(pa.paged_pool_attention.launches_by_t)
        outs[path] = [res[r] for r in rids]
        rounds = (n_draft + 2) * cfg.n_layers * cb.steps_total
        if path == "paged":
            assert cb.use_pallas_kernel
            assert by_t == {8: rounds, 1: rounds}
        else:
            assert by_t == {}
    assert outs["paged"] == outs["gathered"]
    assert [len(t) for t in outs["paged"]] == [9, 10, 11, 12]
