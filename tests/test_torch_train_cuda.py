"""The port's training kernels on the card: the flash forward with lse and
dropout, and the backward kernels ``flash_bwd_dq`` and ``flash_bwd_dkv``,
against their plain PyTorch versions; and one training step through the
kernels against the plain (xla) path.  Marked ``cuda``: each test skips on
a host without a GPU (the kernels have no CPU mode).  This file imports
neither jax nor the JAX package, so it runs on a GPU host without them:

    python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest -q

The flash forward's Hopper instance (TMA + wgmma: bf16, d = 128, T a
multiple of 128) is held at T = 128, 512 and 2048 in the left-padded,
cache and chunk-window layouts, with lse and dropout; its dropout keep
bits must equal the plain version's exactly, at offset zero and, on
every instance, for a call keyed on global row and KV-head offsets.  The
backward's Hopper pair
(``flash_bwd_dq`` and ``flash_bwd_dkv`` where ``flash_bwd_instance`` says
"wgmma") is held at T = S = 128 and 384 and at T = 256 over S = 600, with
G = 1, 4 and 8, left padding, empty (-1) slots and query rows that see no
slot (lse = +inf), with and without dropout; the dK/dV kernel's keep bits
are read back exactly from dV under a one-hot dO; two calls give the same
bits; each wrapper counts the instance its C entry point reports.

Bounds hold each row against its own scale: out and dq per packed query
row, dk and dv per KV slot, the row's max abs error over the row's max
|plain| (under the causal mask values shrink along the sequence, so one
scale for the whole tensor would hold the late rows loosely).  A row
whose plain value is all zero, or a dq row of a query that sees one or
two slots, is held against the tensor's max |plain|: with one slot dq is
exactly zero, and with two it is P0 P1 (dP0 - dP1)(k0 - k1) scale, so one
near tie of dP0 and dP1 leaves the plain value at its rounding noise.  bf16 out 1e-2 and dq/dk/dv 2e-2 (bf16
rounding of the outputs and of P and dS before their products); float32
1e-4 (summation order); lse max abs error 1e-3 in bf16 and 1e-4 in
float32 (float32 from the same inputs).
"""

import importlib

import numpy as np
import pytest
import torch

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import train as ptrain

fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")

# (B, T, H, KVH, d, left padding of row 1)
CASES = {
    "d128_g4_t130": (2, 130, 8, 2, 128, 11),
    "d64_g2_t67": (2, 67, 4, 2, 64, 5),
    "d128_g1_t64": (1, 64, 2, 2, 128, 0),
    "d64_g4_t200": (3, 200, 8, 2, 64, 70),
}
SEED = (0x2545F491, 0x9E3779B9)
BOUND = {torch.bfloat16: (1e-2, 2e-2, 1e-3), torch.float32: (1e-4, 1e-4, 1e-4)}


def _inputs(name, dtype, seed=0):
    B, T, H, KVH, d, pad = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for shape in
                  ((B, T, H, d), (B, T, KVH, d), (B, T, KVH, d), (B, T, H, d)))
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    if B > 1:
        pos[1, :pad] = -1
        pos[1, pad:] = np.arange(T - pad)
        g[1, :pad] = 0.0  # padding rows carry no cotangent
    dev = [torch.from_numpy(a).cuda().to(dtype) for a in (q, k, v, g)]
    return dev + [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                  for a in (np.maximum(pos, 0), pos)]


def _rel(got, want, loose=None):
    """The worst row's max abs error over its own max |plain| (see the
    module docstring)."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    odd = scale == 0
    if loose is not None:
        odd = odd | loose
    return (err / torch.where(odd, scale.max(), scale)).max().item()


def _short_rows(q_pos, kv_pos, H):
    """[B, T, H] True where a query attends fewer than 3 slots."""
    kp = kv_pos[:, None, :]
    live = ((kp >= 0) & (kp <= q_pos[:, :, None])).sum(-1)
    return (live < 3)[:, :, None].expand(-1, -1, H)


def _rel_tensor(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_with_lse_matches_plain(name, dtype, rate):
    _skip_without_card()
    q, k, v, _, q_pos, kv_pos = _inputs(name, dtype)
    seed = SEED if rate else None
    before = fa.flash_attention.launches
    out, lse = fa._forward(q, k, v, q_pos, kv_pos, rate, seed, True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want, want_lse = fa.flash_attention_reference(
        q, k, v, q_pos, kv_pos, rate, seed, return_lse=True)
    out_bound, _, lse_bound = BOUND[dtype]
    assert _rel(out, want) < out_bound
    assert (lse - want_lse).abs().max().item() < lse_bound


# The Hopper (TMA + wgmma) forward instance: bf16, d = 128, T a multiple
# of 128.  (B, T, S, H, KVH, layout): left padding (S = T, rows padded by
# 0 and 37), a cache whose queries sit on its last T written slots (rows
# filled to S and S - 100, a -1 tail), and a chunk window at base 300
# with a -1 tail; S = 1000 and 1300 end inside a 128-slot tile.
WGMMA_CASES = {
    "t128_left_pad": (2, 128, 128, 8, 2, "left_pad"),
    "t512_cache": (2, 512, 1000, 8, 2, "cache"),
    "t512_chunk": (1, 512, 1300, 4, 1, "chunk"),
    "t2048_left_pad": (2, 2048, 2048, 4, 1, "left_pad"),
}


def _wgmma_inputs(name, seed=2):
    B, T, S, H, KVH, layout = WGMMA_CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, T, H, 128), (B, S, KVH, 128), (B, S, KVH, 128)))
    slots = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    if layout == "left_pad":
        pads = (np.arange(B) * 37)[:, None]
        kv_pos = np.where(slots >= pads, slots - pads, -1)
        q_pos = np.maximum(kv_pos[:, :T], 0)
    elif layout == "cache":
        fill = (S - 100 * np.arange(B))[:, None]
        kv_pos = np.where(slots < fill, slots, -1)
        q_pos = fill - T + np.arange(T)[None]
    else:
        kv_pos = np.where(slots < 300 + T, slots, -1)
        q_pos = np.tile(np.arange(300, 300 + T), (B, 1))
    dev = [torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v)]
    return dev + [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
                  for a in (q_pos, kv_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(WGMMA_CASES))
def test_wgmma_forward_matches_plain(name, rate):
    """The Hopper instance (each call counted under "wgmma") against the
    plain version: out per packed query row < 1e-2 of its own max
    |plain|, lse < 1e-3 abs, with and without dropout; the inference
    launch (no lse) gives the same out."""
    _skip_without_card()
    q, k, v, q_pos, kv_pos = _wgmma_inputs(name)
    assert fa.flash_instance(q.dtype, 128, q.shape[1], k.shape[1]) == "wgmma"
    seed = SEED if rate else None
    before = fa.flash_attention.launches_by_instance.get("wgmma", 0)
    out, lse = fa._forward(q, k, v, q_pos, kv_pos, rate, seed, True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_instance["wgmma"] == before + 1
    want, want_lse = fa.flash_attention_reference(
        q, k, v, q_pos, kv_pos, rate, seed, return_lse=True)
    assert torch.isfinite(out.float()).all()
    assert _rel(out, want) < 1e-2
    assert torch.isfinite(want_lse).all()
    assert (lse - want_lse).abs().max().item() < 1e-3
    if rate == 0.0:
        plain_out = fa.flash_attention(q, k, v, q_pos, kv_pos)
        assert _rel(plain_out, want) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 512, 2048])
def test_wgmma_dropout_keep_bits_match_plain(T):
    """The Hopper instance drops exactly the (packed row, slot) pairs the
    plain version drops.  With V one-hot over one 128-slot window (v[s] =
    e_(s - 128 j) for the window's slots, 0 elsewhere), column c of a
    query row's output is non-zero iff slot 128 j + c is attended and
    kept; every window is checked, causal positions."""
    _skip_without_card()
    B, H, KVH, d, rate = 1, 2, 1, 128, 0.1
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, T, H, d)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((B, T, KVH, d)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    keep = fa._keep_plane(SEED, B, KVH, H // KVH, T, T, rate, "cuda")[0, 0]
    allowed = pos[0][None, :] <= pos[0][:, None]  # [T (query), S]
    eye = torch.eye(128, dtype=torch.bfloat16, device="cuda")
    for j in range(T // 128):
        v = torch.zeros((B, T, KVH, d), dtype=torch.bfloat16, device="cuda")
        v[0, 128 * j:128 * (j + 1), 0] = eye
        out, _ = fa._forward(q, k, v, pos, pos, rate, SEED, True)
        got = (out[0].float() != 0).permute(1, 0, 2)  # [H = G, T, 128]
        window = slice(128 * j, 128 * (j + 1))
        want = keep[:, :, window] & allowed[None, :, window]
        assert torch.equal(got, want), j


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,instance", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "mma_sync"),
    (torch.float32, 64, "float32")], ids=["wgmma", "mma_sync", "float32"])
def test_dropout_keep_bits_with_global_offsets(dtype, d, instance):
    """A call whose rows and KV heads start at global offsets (a rank of a
    split mesh) drops exactly the (packed row, slot) pairs the plain
    version keyed on those offsets drops, on each forward instance
    (one-hot V over d-slot windows, as above), and not offset zero's."""
    _skip_without_card()
    B, T, H, KVH, rate, off = 2, 128, 4, 2, 0.1, (3, 5)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((B, T, H, d)).astype(
        np.float32)).cuda().to(dtype)
    k = torch.from_numpy(rng.standard_normal((B, T, KVH, d)).astype(
        np.float32)).cuda().to(dtype)
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None].expand(
        B, T).contiguous()
    G = H // KVH
    key = SEED + off
    keep = fa._keep_plane(key, B, KVH, G, T, T, rate, "cuda")
    zero = fa._keep_plane(SEED, B, KVH, G, T, T, rate, "cuda")
    assert not torch.equal(keep, zero)
    allowed = pos[0][None, :] <= pos[0][:, None]
    eye = torch.eye(d, dtype=dtype, device="cuda")
    before = fa.flash_attention.launches_by_instance.get(instance, 0)
    for j in range(T // d):
        v = torch.zeros((B, T, KVH, d), dtype=dtype, device="cuda")
        v[:, d * j:d * (j + 1)] = eye[None, :, None, :]
        out = fa.flash_attention(q, k, v, pos, pos, dropout_rate=rate,
                                 dropout_seed=SEED, dropout_offsets=off)
        # [B, T, KVH, G, d] -> [B, KVH, G, T, d]
        got = (out.float() != 0).reshape(B, T, KVH, G, d).permute(
            0, 2, 3, 1, 4)
        window = slice(d * j, d * (j + 1))
        want = keep[..., window] & allowed[None, None, None, :, window]
        assert torch.equal(got, want), j
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_by_instance[instance] == (
        before + T // d)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_kernels_match_plain(name, dtype, rate):
    _skip_without_card()
    q, k, v, g, q_pos, kv_pos = _inputs(name, dtype, seed=1)
    seed = SEED if rate else None
    out, lse = fa.flash_attention_reference(q, k, v, q_pos, kv_pos, rate,
                                            seed, return_lse=True)
    counts = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_backward(q, k, v, q_pos, kv_pos, out, lse, g, rate, seed)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        counts[0] + 1, counts[1] + 1)
    want = fa.flash_backward_reference(q, k, v, q_pos, kv_pos, out, lse, g,
                                       rate, seed)
    _, bound, _ = BOUND[dtype]
    loose = _short_rows(q_pos, kv_pos, q.shape[2])
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        rel = _rel(a, b, loose if label == "dq" else None)
        assert rel < bound, (label, rel)


# The Hopper (TMA + wgmma) backward instances: bf16, d = 128, T a multiple
# of 128.  (B, T, S, H, KVH, layout): "left_pad" pads row b by 37 b slots
# (S = T); "dead" empties slots 0-4 of row 0 (queries 0-4 there see no
# slot: lse = +inf) and slots 40-49 of every row; "cache" puts the queries
# on the last T written slots of rows filled to S and S - 100, a -1 tail
# (S = 600 ends inside a 64- and a 128-slot tile).
BWD_WGMMA_CASES = {
    "t128_g1_dead": (2, 128, 128, 2, 2, "dead"),
    "t384_g4_left_pad": (2, 384, 384, 8, 2, "left_pad"),
    "t384_g8_dead": (1, 384, 384, 8, 1, "dead"),
    "t256_s600_g4_cache": (2, 256, 600, 8, 2, "cache"),
}
BWD_BOUND = 2e-2  # bf16 dq, dk, dv per row (TRAIN_BOUNDS in chip_smoke.py)


def _bwd_wgmma_inputs(name, seed=3):
    B, T, S, H, KVH, layout = BWD_WGMMA_CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for shape in
                  ((B, T, H, 128), (B, S, KVH, 128), (B, S, KVH, 128),
                   (B, T, H, 128)))
    slots = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    if layout == "left_pad":
        pads = (np.arange(B) * 37)[:, None]
        kv_pos = np.where(slots >= pads, slots - pads, -1)
        q_pos = np.maximum(kv_pos[:, :T], 0)
    elif layout == "dead":
        kv_pos = slots.copy()
        kv_pos[0, :5] = -1
        kv_pos[:, 40:50] = -1
        q_pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    else:
        fill = (S - 100 * np.arange(B))[:, None]
        kv_pos = np.where(slots < fill, slots, -1)
        q_pos = fill - T + np.arange(T)[None]
    dev = [torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v, g)]
    return dev + [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
                  for a in (q_pos, kv_pos)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(BWD_WGMMA_CASES))
def test_wgmma_backward_matches_plain(name, rate):
    """The Hopper pair against ``flash_backward_reference`` on the plain
    forward's out and lse: dq per packed query row, dk and dv per KV slot,
    each < 2e-2 of its own max |plain|, all finite; each wrapper counts
    one launch under "wgmma"."""
    _skip_without_card()
    q, k, v, g, q_pos, kv_pos = _bwd_wgmma_inputs(name)
    assert fa.flash_bwd_instance(q.dtype, 128, q.shape[1],
                                 k.shape[1]) == "wgmma"
    seed = SEED if rate else None
    out, lse = fa.flash_attention_reference(q, k, v, q_pos, kv_pos, rate,
                                            seed, return_lse=True)
    if BWD_WGMMA_CASES[name][5] == "dead":
        assert torch.isinf(lse).any()
    before = [dict(w.launches_by_instance)
              for w in (fa.flash_bwd_dq, fa.flash_bwd_dkv)]
    got = fa.flash_backward(q, k, v, q_pos, kv_pos, out, lse, g, rate, seed)
    torch.cuda.synchronize()
    for w, b in zip((fa.flash_bwd_dq, fa.flash_bwd_dkv), before):
        assert w.launches_by_instance["wgmma"] == b.get("wgmma", 0) + 1
    want = fa.flash_backward_reference(q, k, v, q_pos, kv_pos, out, lse, g,
                                       rate, seed)
    loose = _short_rows(q_pos, kv_pos, q.shape[2])
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.isfinite(a.float()).all(), label
        rel = _rel(a, b, loose if label == "dq" else None)
        assert rel < BWD_BOUND, (label, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [128, 384])
def test_wgmma_backward_dropout_keep_bits_from_dv(T):
    """The dK/dV kernel drops exactly the (packed row, slot) pairs the
    plain version drops, read from its transposed accumulator.  With dO
    one-hot over one 128-row window of one query head (dO[r] = e_(r - w)
    for the window's rows, 0 elsewhere), dV[s, c] is non-zero iff packed
    row w + c attends slot s and keeps it; every window of both heads is
    checked, causal positions."""
    _skip_without_card()
    B, H, KVH, d, rate = 1, 2, 1, 128, 0.1
    G = H // KVH
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(torch.bfloat16) for shape in
        ((B, T, H, d), (B, T, KVH, d), (B, T, KVH, d)))
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    out, lse = fa.flash_attention_reference(q, k, v, pos, pos, rate, SEED,
                                            return_lse=True)
    keep = fa._keep_plane(SEED, B, KVH, G, T, T, rate, "cuda")[0, 0]
    allowed = pos[0][None, :] <= pos[0][:, None]  # [T (query), S]
    eye = torch.eye(128, dtype=torch.bfloat16, device="cuda")
    for g in range(G):
        for j in range(T // 128):
            window = slice(128 * j, 128 * (j + 1))
            do = torch.zeros((B, T, H, d), dtype=torch.bfloat16,
                             device="cuda")
            do[0, window, g] = eye
            delta = fa.flash_delta(out, do, KVH)
            _, dv = fa.flash_bwd_dkv(q, k, v, pos, pos, lse, delta, do, rate,
                                     SEED)
            got = dv[0, :, 0].float() != 0  # [S, 128]
            want = (keep[g, window] & allowed[window]).T
            assert torch.equal(got, want), (g, j)


@pytest.mark.cuda
def test_wgmma_backward_two_calls_bit_identical():
    """No atomics: the same inputs give the same bits, with dropout."""
    _skip_without_card()
    q, k, v, g, q_pos, kv_pos = _bwd_wgmma_inputs("t384_g4_left_pad")
    out, lse = fa.flash_attention_reference(q, k, v, q_pos, kv_pos, 0.1,
                                            SEED, return_lse=True)
    delta = fa.flash_delta(out, g, k.shape[2])
    args = (q, k, v, q_pos, kv_pos, lse, delta, g, 0.1, SEED)
    dq = [fa.flash_bwd_dq(*args) for _ in range(2)]
    dkv = [fa.flash_bwd_dkv(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(dq[0], dq[1])
    assert torch.equal(dkv[0][0], dkv[1][0])
    assert torch.equal(dkv[0][1], dkv[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype,want", [
    ("t128_g1_dead", torch.bfloat16, "wgmma"),
    ("d64_g2_t67", torch.bfloat16, "mma_sync"),
    ("d128_g4_t130", torch.bfloat16, "mma_sync"),
    ("d128_g1_t64", torch.float32, "float32"),
])
def test_backward_launches_by_instance(case, dtype, want):
    """Each wrapper counts one launch, under the instance its C entry
    point reports, which is the one ``flash_bwd_instance`` picks."""
    _skip_without_card()
    if case in BWD_WGMMA_CASES:
        q, k, v, g, q_pos, kv_pos = _bwd_wgmma_inputs(case)
    else:
        q, k, v, g, q_pos, kv_pos = _inputs(case, dtype)
    assert fa.flash_bwd_instance(dtype, q.shape[3], q.shape[1],
                                 k.shape[1]) == want
    out, lse = fa.flash_attention_reference(q, k, v, q_pos, kv_pos,
                                            return_lse=True)
    for w in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches, w.launches_by_instance = 0, {}
    fa.flash_backward(q, k, v, q_pos, kv_pos, out, lse, g)
    torch.cuda.synchronize()
    for w in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert (w.launches, w.launches_by_instance) == (1, {want: 1})


@pytest.mark.cuda
def test_autograd_through_kernels_matches_plain_autograd():
    """flash_attention's autograd Function on the card (forward with lse,
    both backward kernels) against the same Function on CPU tensors."""
    _skip_without_card()
    q, k, v, g, q_pos, kv_pos = _inputs("d64_g2_t67", torch.float32, seed=2)
    dev = [x.clone().requires_grad_() for x in (q, k, v)]
    cpu = [x.detach().cpu().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*dev, q_pos, kv_pos, dropout_rate=0.1,
                             dropout_seed=SEED)
    got = torch.autograd.grad(out, dev, g)
    ref = fa.flash_attention(*cpu, q_pos.cpu(), kv_pos.cpu(),
                             dropout_rate=0.1, dropout_seed=SEED)
    want = torch.autograd.grad(ref, cpu, g.cpu())
    assert _rel(out.detach().cpu(), ref.detach()) < 1e-4
    loose = _short_rows(q_pos, kv_pos, q.shape[2]).cpu()
    for a, b, rows in zip(got, want, (loose, None, None)):
        assert _rel(a.cpu(), b, rows) < 1e-4


def _small_config(**kw):
    return ptl.get_config("tiny", vocab_size=512, dim=256, n_layers=2,
                          n_heads=4, n_kv_heads=2, multiple_of=64,
                          max_seq_len=256, **kw)


@pytest.mark.cuda
def test_train_step_through_kernels_matches_plain_path():
    """float32, 2 layers, head_dim 64: lm_loss value and gradients through
    the kernels (attn_impl flash, remat "dots") against the plain xla path,
    and one train_step on each with its launch counts."""
    _skip_without_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 128)).astype(np.int32)).cuda()
    grads, losses = {}, {}
    for impl in ("flash", "xla"):
        cfg = _small_config(attn_impl=impl, remat=True)
        params = ptl.init_params(cfg, seed=0, device="cuda")
        leaves = ptrain.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = ptl.lm_loss(params, tokens, cfg)
        losses[impl] = loss.item()
        grads[impl] = torch.autograd.grad(loss, leaves)
    assert abs(losses["flash"] - losses["xla"]) < 1e-4 * abs(losses["xla"])
    for a, b in zip(grads["flash"], grads["xla"]):
        assert _rel_tensor(a, b) < 1e-3

    cfg = _small_config(attn_impl="flash", remat=True)
    opt = ptl.make_optimizer()
    state = ptl.init_train_state(ptl.init_params(cfg, seed=0, device="cuda"),
                                 opt)
    fa.flash_attention.launches = 0
    fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    state, loss = ptl.train_step(state, tokens, cfg, opt)
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == (2 * L, L, L)
    assert abs(loss.item() - losses["xla"]) < 1e-4 * abs(losses["xla"])
    state, loss2 = ptl.train_step(state, tokens,
                                  cfg.replace(attn_pdrop=0.1, resid_pdrop=0.1),
                                  opt, dropout_seed=1)
    assert np.isfinite(loss2.item())
