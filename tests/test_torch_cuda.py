"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips on a host without a GPU (the
kernels have no CPU mode).  This file imports neither jax nor the JAX
package, so it also runs on a GPU host without them:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: bf16 atol 2e-2 (output rounding plus P rounded to bf16
before P.V); float32 atol 1e-4 (summation order); lse atol 1e-3.  The
split-KV instance (T = 1 decode) is held over live and dead runs, at
other run lengths through its sweep entry point, and its entry point's
refusals are checked; every entry point's instance report is counted.
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


# The split-KV instance (T = 1 decode, at most 16 packed rows): S = 1024
# slots, runs of FLASH_SPLIT = 256.  Row 0 fills 1000 slots (four runs),
# row 1 200 (one run, three dead), row 2 holds positions 0..399 in slots
# 300..699 (runs 0 and 3 dead), row 3 nothing (out 0, lse +inf); T
# queries at each fill's last positions.
SPLIT_S = 1024


def _split_inputs(B, T, H, KVH, d=128, seed=3):
    """The first B (at most 4) rows of that cache."""
    S = SPLIT_S
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, T, H, d), (B, S, KVH, d), (B, S, KVH, d)))
    kv_pos = np.full((4, S), -1, np.int32)
    kv_pos[0, :1000] = np.arange(1000)
    kv_pos[1, :200] = np.arange(200)
    kv_pos[2, 300:700] = np.arange(400)
    kv_pos = kv_pos[:B]
    last = np.array([999, 199, 399, 0])[:B]
    q_pos = np.maximum(last[:, None] - np.arange(T)[::-1][None],
                       0).astype(np.int32)
    dev = [torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v)]
    return dev + [torch.from_numpy(a).cuda() for a in (q_pos, kv_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("G,T,KVH,d", [(4, 1, 8, 128), (8, 1, 2, 128),
                                       (4, 4, 2, 128), (8, 2, 2, 64),
                                       (16, 1, 1, 128)])
def test_split_kv_kernel_matches_plain(G, T, KVH, d):
    """The split-KV instance (split and combine pass) against the plain
    versions, out (atol 2e-2) and lse (atol 1e-3), over runs that are live,
    dead past the fill, dead below it, and a row with no live slot (out 0,
    lse +inf); the C entry point reports "split_kv" and two kernels, as
    ``flash_instance`` predicts; a second call is bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _split_inputs(4, T, G * KVH, KVH, d)
    assert fa.flash_instance(torch.bfloat16, d, T, SPLIT_S, G) == "split_kv"
    w = fa.flash_attention
    before = (w.launches, w.kernel_launches, dict(w.launches_by_instance))
    out, lse = fa._forward(*args, 0.0, None, True)
    again, lse2 = fa._forward(*args, 0.0, None, True)
    torch.cuda.synchronize()
    assert (w.launches, w.kernel_launches) == (before[0] + 2, before[1] + 4)
    assert w.launches_by_instance.get("split_kv") == (
        before[2].get("split_kv", 0) + 2)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    want, want_lse = fa.flash_attention_reference(*args, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    live = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-3, rtol=0)
    assert torch.all(out[3] == 0) and torch.isinf(lse[3]).all()
    assert torch.equal(torch.isinf(lse), ~live)
    split = fa.flash_split_reference(*args)
    torch.testing.assert_close(out.float(), split.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [16, 128, 512])
def test_split_kv_other_run_lengths_and_the_old_instance(split):
    """Runs of 16, 128 and 512 slots (the sweep's entry point) give the
    plain version's output; the replaced mma.sync design still runs the
    same call through its own entry point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _split_inputs(4, 1, 32, 8)
    want = fa.flash_attention_reference(*args)
    before = dict(fa.flash_attention.launches_by_instance)
    got = fa.flash_attention_launch(*args, "split_kv", split=split)
    old = fa.flash_attention_launch(*args, "mma_sync")
    torch.cuda.synchronize()
    by = fa.flash_attention.launches_by_instance
    assert by["split_kv"] == before.get("split_kv", 0) + 1
    assert by["mma_sync"] == before.get("mma_sync", 0) + 1
    for out in (got, old):
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                                   rtol=0)


@pytest.mark.cuda
def test_split_kv_entry_point_rejects_other_run_counts():
    """flash_fwd_split takes only n_split = ceil(S / FLASH_SPLIT): a count
    computed from another run length, dropout, or more than 16 packed rows
    is refused with cudaErrorInvalidValue (1) and reports nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v, q_pos, kv_pos = _split_inputs(2, 1, 32, 8)
    B, T, H, d = q.shape
    S, KVH = k.shape[1], k.shape[2]
    fn = fa._fn(fa.KERNEL, "flash_fwd_split", 8, 8, 2)
    out = torch.empty_like(q)
    partials = torch.empty(B * KVH * 64 * 4 * (d + 2), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(n_split, drop=0, heads=H):
        code, kernels = fa.ctypes.c_int(9), fa.ctypes.c_int(9)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                kv_pos.data_ptr(), out.data_ptr(), None, partials.data_ptr(),
                B, T, S, heads, KVH, d, 1, n_split, 0.1, drop, 1, 2, 3, 1.0,
                0, 0, stream, fa.ctypes.byref(code),
                fa.ctypes.byref(kernels))
        return rc, code.value, kernels.value

    want = -(-S // fa.FLASH_SPLIT)
    assert call(want) == (0, 4, 2)
    for other in (128, 512):
        assert call(-(-S // other)) == (1, 0, 0)
    assert call(want, drop=1) == (1, 0, 0)
    assert call(want, heads=KVH * 32) == (1, 0, 0)  # 32 packed rows
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_every_flash_entry_point_reports_its_instance():
    """The wrapper counts what each C entry point reports: the Hopper,
    mma.sync, split-KV and float32 instances, each called once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    w = fa.flash_attention
    for name, dtype, want in (
            ("prefill_left_padded", torch.bfloat16, "mma_sync"),
            ("decode_cache_slots", torch.bfloat16, "split_kv"),
            ("decode_cache_slots", torch.float32, "float32")):
        args = _inputs(name, dtype)
        q, k = args[0], args[1]
        assert fa.flash_instance(dtype, q.shape[3], q.shape[1], k.shape[1],
                                 q.shape[2] // k.shape[2]) == want
        before = dict(w.launches_by_instance)
        fa.flash_attention(*args)
        torch.cuda.synchronize()
        assert w.launches_by_instance[want] == before.get(want, 0) + 1
    args = _split_inputs(2, 128, 8, 2)
    before = dict(w.launches_by_instance)
    fa.flash_attention(*args)
    torch.cuda.synchronize()
    assert w.launches_by_instance["wgmma"] == before.get("wgmma", 0) + 1


@pytest.mark.cuda
def test_fused_chunk_cell_on_the_hopper_instance():
    """The fused prefill lane's flash call (one row, a 512-token chunk at
    base 1024 of a 2048-slot view, a -1 tail past it) runs the "wgmma"
    instance; out and lse match the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    T, S, base, H, KVH, d = 512, 2048, 1024, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(1, T, H, d, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(1, S, KVH, d, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    slots = torch.arange(S, device="cuda", dtype=torch.int32)[None]
    kv_pos = torch.where(slots < base + T, slots, -1).int().contiguous()
    q_pos = (base + torch.arange(T, device="cuda", dtype=torch.int32))[None]
    args = (q, k, v, q_pos.contiguous(), kv_pos)
    assert fa.flash_instance(torch.bfloat16, d, T, S, H // KVH) == "wgmma"
    before = dict(fa.flash_attention.launches_by_instance)
    out, lse = fa._forward(*args, 0.0, None, True)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_by_instance["wgmma"]
            == before.get("wgmma", 0) + 1)
    want, want_lse = fa.flash_attention_reference(*args, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_score_on_the_card_matches_a_plain_forward():
    """``engine.score`` on the card (the flash kernel at T > 8 under
    "auto") against the xla forward's float32 log-softmax, left padding
    scoring 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import jax_llama_tpu_torch as ptl

    cfg = ptl.get_config("tiny", vocab_size=256, dim=256, n_layers=2,
                         n_heads=2, n_kv_heads=2, multiple_of=64,
                         max_seq_len=256, dtype="float32",
                         param_dtype="float32", attn_impl="auto")
    params = ptl.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 256, (2, 128), device="cuda", generator=g,
                           dtype=torch.int32)
    mask = torch.ones_like(tokens, dtype=torch.bool)
    mask[1, :5] = False
    before = fa.flash_attention.launches
    got = ptl.score(params, tokens, mask, config=cfg)
    assert fa.flash_attention.launches == before + cfg.n_layers
    pos = torch.where(mask, mask.int().cumsum(-1) - 1, -1).int()
    lg = ptl.forward(params, tokens, pos, cfg.replace(attn_impl="xla"),
                     attn_mask=mask)[0]
    want = torch.log_softmax(lg[:, :-1].float(), -1).gather(
        -1, tokens[:, 1:, None].long())[..., 0]
    want = torch.where(mask[:, :-1] & mask[:, 1:], want, 0.0)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert not got[1, :5].any()
