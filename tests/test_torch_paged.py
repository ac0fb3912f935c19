"""The port's paged attention and paged forward held against the JAX
package on the same numpy inputs (CPU, float32).  The JAX Pallas kernel
runs in interpret mode, as the JAX package's own tests run it on the CPU;
the port's wrapper runs its plain version on CPU tensors.

Both run at T = 1 (a decode token) and T > 1 (the speculative verify
block, queries packed r = t*G + g at consecutive positions), over float32
pools and over int8 pools with their scale planes (the same tolerances:
the scales fold in float32 in both).  ``split_tokens`` (the launch split
that keeps T*G packed rows within the kernel's cap of 64) is held against
one plain call at G = 8, T = 9.

Tolerances: attention out/lse atol 1e-5 (summation order); logits of a
paged forward step atol 2e-4 (PARITY.md row 2.16, as in
test_torch_model.py); pool positions after the write-back identical, and
K/V identical outside the written slots and within 1e-5 in them (two
matmul libraries produce the written projections).

The CUDA kernel is held against its plain version on a card in
tests/test_torch_paged_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.models.llama import PagedKVCache as JPagedKVCache
from jax_llama_tpu.models.llama import paged_write_indices as jax_write_idx
from jax_llama_tpu.models.llama import quantize_kv as jax_quantize_kv
from jax_llama_tpu.ops import quant as jquant
from jax_llama_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode_attention,
    paged_pool_attention as jax_pool_attention,
)

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.models import llama as pllama
from paged_inputs import pool_state

pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")


def multi_token_q_pos(fills, inactive, T):
    """First-token positions for T consecutive query tokens per row: the
    last token sits at the row's fill, so the early tokens miss the row's
    last T-1 slots (a tile can be live only for the later tokens); a row
    whose pool is empty starts at 0 (its first token sees no pool slot)
    and ``inactive`` rows are -1."""
    return np.asarray([-1 if b in inactive else max(f - (T - 1), 0)
                       for b, f in enumerate(fills)], np.int32)

def int8_pool(k, v, pos):
    """The float pool quantized as the batcher's writes quantize it: int8
    payload [L, KVH, NB, BLK, d] and scales [L, KVH, NB, BLK]; slots that
    hold nothing (pos -1) carry payload 0 and scale 0."""
    held = (pos >= 0)[None, None]
    out = []
    for a in (k, v):
        q, s = (np.array(t) for t in jax.jit(jax_quantize_kv)(
            jnp.asarray(a)))
        out += [np.where(held[..., None], q, 0).astype(np.int8),
                np.where(held, s, 0.0).astype(np.float32)]
    kq, ks, vq, vs = out
    return kq, vq, ks, vs


ATOL = 1e-5
CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")


# (B, KVH, G, d, BLK, MB, L, layer, fills, inactive): fills cover an
# empty row (0), a partial block, multi-block rows and an inactive row.
CASES = {
    "g2_layer2_of_3": (5, 2, 2, 16, 8, 6, 3, 2, (37, 20, 30, 0, 5), (4,)),
    "g4_layer0": (4, 2, 4, 32, 16, 5, 1, 0, (40, 50, 16, 0), (1,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pool_attention_matches_jax(name):
    B, KVH, G, d, BLK, MB, L, layer, fills, inactive = CASES[name]
    k, v, pos, table, q_pos = pool_state(1, B, KVH, d, BLK, MB, L, fills,
                                         inactive)
    q = np.random.default_rng(2).standard_normal(
        (B, KVH, G, d)).astype(np.float32)
    want_o, want_l = jax_pool_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(table), jnp.asarray(q_pos), layer=jnp.int32(layer))
    got_o, got_l = pa.paged_pool_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, pos, table, q_pos)),
        layer=layer)
    assert got_o.dtype == torch.float32 and got_l.shape == (B, KVH, G)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL,
                               rtol=1e-6)
    # the empty and inactive rows attend nothing: out 0, lse MASK_VALUE
    dead = (q_pos < 0) | (np.asarray(fills) == 0)
    assert dead.sum() == 2
    assert (got_l.numpy()[dead] == np.float32(pa.MASK_VALUE)).all()
    assert (got_o.numpy()[dead] == 0).all()


def test_pool_attention_wrapper_runs_plain_version_on_cpu():
    k, v, pos, table, q_pos = pool_state(3, 3, 2, 64, 8, 4, 2, (9, 0, 20))
    q = torch.randn(3, 2, 4, 64)
    args = (q, *(torch.from_numpy(a) for a in (k, v, pos, table, q_pos)))
    before = pa.paged_pool_attention.launches
    got = pa.paged_pool_attention(*args, layer=1)
    want = pa.paged_pool_attention_reference(*args, layer=1)
    assert pa.paged_pool_attention.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_decode_attention_matches_jax():
    B, KVH, G, d, BLK, MB, L = 4, 2, 2, 16, 8, 6, 3
    k, v, pos, table, q_pos = pool_state(4, B, KVH, d, BLK, MB, L,
                                         (30, 12, 9, 0), inactive=(1,))
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, 1, KVH * G, d)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KVH, d)).astype(np.float32)
    vn = rng.standard_normal((B, 1, KVH, d)).astype(np.float32)
    want = jax_decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, k, v, pos, table, q_pos)),
        layer=jnp.int32(1))
    got = pa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kn, vn, k, v, pos, table, q_pos)),
        layer=1)
    assert got.shape == (B, 1, KVH * G, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


# T > 1: (B, KVH, G, T, d, BLK, MB, L, layer, fills, inactive).  Each
# row's last token sits at its fill (``multi_token_q_pos``), so with
# BLK = 8 a fill of 17 leaves position 16 alone in its block: a tile live
# only for the last tokens.  A fill of 0 is an active row whose first
# token sees an empty pool.
MULTI = {
    "g2": (5, 2, 2, 16, 8, 6, 3, 2, (37, 20, 17, 0, 30), (4,)),
    "g4": (4, 2, 4, 32, 8, 6, 1, 0, (40, 0, 17, 9), (1,)),
}


@pytest.mark.parametrize("T", [2, 5])
@pytest.mark.parametrize("name", sorted(MULTI))
def test_pool_attention_multi_token_matches_jax(name, T):
    B, KVH, G, d, BLK, MB, L, layer, fills, inactive = MULTI[name]
    k, v, pos, table, _ = pool_state(11, B, KVH, d, BLK, MB, L, fills,
                                     inactive)
    q_pos = multi_token_q_pos(fills, inactive, T)
    q = np.random.default_rng(12).standard_normal(
        (B, KVH, T * G, d)).astype(np.float32)
    want_o, want_l = jax_pool_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(table), jnp.asarray(q_pos), t_tokens=T,
        layer=jnp.int32(layer))
    got_o, got_l = pa.paged_pool_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pos, table, q_pos)),
        layer=layer, t_tokens=T)
    assert got_o.shape == (B, KVH, T * G, d)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL,
                               rtol=1e-6)
    lse = got_l.numpy().reshape(B, KVH, T, G)
    dead = np.float32(pa.MASK_VALUE)
    # the empty-pool row's tokens and the inactive row see nothing
    for b, f in enumerate(fills):
        if f == 0 or b in inactive:
            assert (lse[b] == dead).all()
    # the row of fill 17: tokens 0..T-2 miss position 16, the last sees it
    r17 = fills.index(17)
    assert q_pos[r17] == 17 - (T - 1)
    assert (lse[r17] != dead).all()


@pytest.mark.parametrize("T", [1, 3, 5])
def test_pool_attention_int8_matches_jax(T):
    """The int8 branch (scales folded per slot) at T = 1 and the verify
    shapes, against JAX's kernel in interpret mode."""
    B, KVH, G, d, BLK, MB, L, layer, fills, inactive = MULTI["g2"]
    k, v, pos, table, _ = pool_state(17, B, KVH, d, BLK, MB, L, fills,
                                     inactive)
    kq, vq, ks, vs = int8_pool(k, v, pos)
    q_pos = multi_token_q_pos(fills, inactive, T)
    q = np.random.default_rng(18).standard_normal(
        (B, KVH, T * G, d)).astype(np.float32)
    want_o, want_l = jax_pool_attention(
        *(jnp.asarray(a) for a in (q, kq, vq, pos, table, q_pos)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), t_tokens=T,
        layer=jnp.int32(layer))
    args = [torch.from_numpy(a) for a in (q, kq, vq, pos, table, q_pos)]
    before = pa.paged_pool_attention.launches
    got_o, got_l = pa.paged_pool_attention(
        *args, layer=layer, t_tokens=T, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    assert pa.paged_pool_attention.launches == before  # plain on CPU
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL,
                               rtol=1e-6)
    lse = got_l.numpy().reshape(B, KVH, T, G)
    for b, f in enumerate(fills):
        if f == 0 or b in inactive:
            assert (lse[b] == np.float32(pa.MASK_VALUE)).all()


@pytest.mark.parametrize("int8", [False, True])
def test_split_tokens_equals_one_plain_call(int8):
    """C1: at G = 8 a T = 9 verify block is 72 packed rows, past the
    kernel's 64; ``split_tokens`` runs it as 8 + 1 tokens.  With the
    plain version in the kernel's place the pieces join to the unsplit
    result, inactive rows included."""
    B, KVH, G, T, d, BLK, MB, L, layer = 4, 2, 8, 9, 16, 8, 6, 2, 1
    fills, inactive = (40, 17, 0, 23), (3,)
    k, v, pos, table, _ = pool_state(19, B, KVH, d, BLK, MB, L, fills,
                                     inactive)
    scales = {}
    if int8:
        k, v, ks, vs = int8_pool(k, v, pos)
        scales = dict(k_scale=torch.from_numpy(ks),
                      v_scale=torch.from_numpy(vs))
    q_pos = torch.from_numpy(multi_token_q_pos(fills, inactive, T))
    q = torch.from_numpy(np.random.default_rng(20).standard_normal(
        (B, KVH, T * G, d)).astype(np.float32))
    pool = [torch.from_numpy(a) for a in (k, v, pos, table)]
    pieces = []

    def launch(qq, qp, t):
        pieces.append((t, qp.clone()))
        return pa.paged_pool_attention_reference(qq, *pool, qp, layer, t,
                                                 **scales)

    assert T * G > pa.MAX_ROWS
    got = pa.split_tokens(launch, q, q_pos, T)
    want = pa.paged_pool_attention_reference(q, *pool, q_pos, layer, T,
                                             **scales)
    assert [t for t, _ in pieces] == [8, 1]
    assert (pieces[1][1] == torch.where(q_pos >= 0, q_pos + 8, -1)).all()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("G,T,pieces", [
    (8, 5, [5]),        # the 70b head layout's n_draft 4 verify: one launch
    (8, 8, [8]),        # 64 packed rows: exactly the cap
    (8, 9, [8, 1]),
    (4, 16, [16]),
    (4, 17, [16, 1]),
    (1, 64, [64]),
    (1, 130, [64, 64, 2]),
])
def test_split_tokens_cuts_at_the_64_row_cap(G, T, pieces):
    """``split_tokens`` launches once while T*G fits MAX_ROWS = 64 packed
    rows and cuts a longer block into pieces of MAX_ROWS // G tokens."""
    assert pa.MAX_ROWS == 64
    q = torch.zeros((1, 1, T * G, 4))
    q_pos = torch.tensor([3], dtype=torch.int32)
    seen = []

    def launch(qq, qp, t):
        seen.append((t, int(qp[0])))
        return (torch.zeros(qq.shape), torch.zeros(qq.shape[:3]))

    out, lse = pa.split_tokens(launch, q, q_pos, T)
    assert [t for t, _ in seen] == pieces
    assert [p for _, p in seen] == [3 + sum(pieces[:i])
                                    for i in range(len(pieces))]
    assert out.shape == q.shape and lse.shape == q.shape[:3]


@pytest.mark.parametrize("MB,BLK,want", [
    (16, 128, 8), (8, 128, 4), (5, 62, 2), (6, 8, 1), (2, 129, 2),
    (1, 256, 1), (1, 257, 2),
])
def test_split_pass_covers_the_table_in_runs_of_256_slots(MB, BLK, want):
    """The kernel's split pass cuts each row's MB*BLK table slots into
    runs of SPLIT_SLOTS = 256 in table order, whatever the block size;
    the wrapper sizes its scratch by that count."""
    assert pa.SPLIT_SLOTS == 256
    table = torch.zeros((3, MB), dtype=torch.int32)
    assert pa.n_splits(table, BLK) == want


@pytest.mark.parametrize("code,name", [
    (16, "mma_sync_m16"), (32, "mma_sync_m32"), (64, "mma_sync_m64"),
    (-16, "cuda_cores_r16"), (-64, "cuda_cores_r64"),
])
def test_split_instance_name(code, name):
    """The C entry point's instance code names the split pass's kernel:
    + for the tensor-core kernel, - for the CUDA-core one, with the
    packed rows it holds."""
    assert pa.split_instance_name(code) == name


def test_cpu_calls_count_no_paged_launch():
    """The plain version, which CPU tensors take, adds to none of the
    kernel's counters."""
    k, v, pos, table, q_pos = pool_state(5, 2, 1, 64, 8, 4, 1, (9, 20),
                                         ())
    q = torch.zeros((2, 1, 4, 64))
    counters = ("launches", "launches_int8", "launches_by_t",
                "launches_by_instance", "kernel_launches")
    before = [getattr(pa.paged_pool_attention, c) for c in counters]
    before = [dict(c) if isinstance(c, dict) else c for c in before]
    pa.paged_pool_attention(q, *(torch.as_tensor(a) for a in (
        k, v, pos, table, q_pos)))
    assert [getattr(pa.paged_pool_attention, c) for c in counters] == before


@pytest.mark.parametrize("T", [2, 5])
def test_decode_attention_multi_token_matches_jax(T):
    B, KVH, G, d, BLK, MB, L, layer, fills, inactive = MULTI["g2"]
    k, v, pos, table, _ = pool_state(13, B, KVH, d, BLK, MB, L, fills,
                                     inactive)
    q_pos = multi_token_q_pos(fills, inactive, T)
    rng = np.random.default_rng(14)
    q = rng.standard_normal((B, T, KVH * G, d)).astype(np.float32)
    kn = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    vn = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    want = jax_decode_attention(
        *(jnp.asarray(a) for a in (q, kn, vn, k, v, pos, table, q_pos)),
        layer=jnp.int32(layer))
    got = pa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kn, vn, k, v, pos, table, q_pos)),
        layer=layer)
    assert got.shape == (B, T, KVH * G, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_write_indices_match_jax():
    table = np.array([[3, 1, 4], [0, 5, 6]], np.int32)
    fill = np.array([7, 23], np.int32)
    active = np.array([True, True])
    for act in (active, np.array([True, False])):
        want = jax_write_idx(jnp.asarray(table), jnp.asarray(fill),
                             jnp.asarray(act), 3, 8, 8)
        got = pllama.paged_write_indices(
            torch.from_numpy(table), torch.from_numpy(fill),
            torch.from_numpy(act), 3, 8, 8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pool_write_drops_sentinel_pairs_even_on_shared_targets():
    """A dead pair must not land: a live pair writing block NB-1 (where a
    dead pair clamps) keeps its value, and untouched slots keep theirs."""
    NB, BLK, L, KVH, d = 4, 2, 2, 1, 3
    plane = torch.arange(L * KVH * NB * BLK * d, dtype=torch.float32
                         ).reshape(L, KVH, NB, BLK, d)
    before = plane.clone()
    blk = torch.tensor([[NB], [NB - 1], [NB], [0]])
    off = torch.tensor([[1], [1], [0], [0]])
    upd = -torch.arange(1, 1 + L * KVH * 4 * d, dtype=torch.float32
                        ).reshape(L, KVH, 4, 1, d)
    out = pllama.paged_pool_write(plane, upd, blk, off)
    assert out is plane
    want = before.clone()
    want[:, :, NB - 1, 1] = upd[:, :, 1, 0]
    want[:, :, 0, 0] = upd[:, :, 3, 0]
    torch.testing.assert_close(plane, want, atol=0, rtol=0)
    pos = torch.full((NB, BLK), -1, dtype=torch.int32)
    pllama.paged_pool_write(pos, torch.tensor([[5], [6], [7], [8]]), blk, off)
    assert pos[NB - 1, 1] == 6 and pos[0, 0] == 8 and (pos >= 0).sum() == 2
    # every pair dead (all rows inactive): nothing changes
    pllama.paged_pool_write(plane, upd, torch.full_like(blk, NB), off)
    torch.testing.assert_close(plane, want, atol=0, rtol=0)


@pytest.fixture(scope="module")
def weights():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    return jp, ptl.from_jax_params(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def test_paged_forward_step_matches_jax(weights):
    jp, pp = weights
    jc, pc = jlt.get_config("tiny", **CFG), ptl.get_config("tiny", **CFG)
    B, BLK, MB = 4, 16, 4
    L, KVH, d = CFG["n_layers"], CFG["n_kv_heads"], 16
    fills = (37, 20, 9, 0)
    k, v, pos, table, q_pos = pool_state(6, B, KVH, d, BLK, MB, L, fills,
                                         inactive=(1,))
    # the step writes at fill (the next free slot), at position fills[b]
    fill = np.asarray(fills, np.int32)
    active = q_pos >= 0
    positions = np.where(active, q_pos, -1)[:, None].astype(np.int32)
    tokens = np.random.default_rng(7).integers(
        1, CFG["vocab_size"], (B, 1)).astype(np.int32)
    jcache = JPagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                           pos=jnp.asarray(pos), table=jnp.asarray(table),
                           fill=jnp.asarray(fill))
    want, jnew = jlt.forward(jp, jnp.asarray(tokens), jnp.asarray(positions),
                             jc, cache=jcache,
                             attn_mask=jnp.asarray(active[:, None]))
    pcache = ptl.PagedKVCache(
        *(torch.from_numpy(a.copy()) for a in (k, v, pos, table, fill)))
    ptrs = [t.data_ptr() for t in (pcache.k, pcache.v, pcache.pos)]
    got, pnew = ptl.forward(pp, torch.from_numpy(tokens),
                            torch.from_numpy(positions), pc, cache=pcache,
                            attn_mask=torch.from_numpy(active[:, None]))
    assert pnew is pcache
    assert [t.data_ptr() for t in (pnew.k, pnew.v, pnew.pos)] == ptrs
    live = active
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=2e-4, rtol=0)
    np.testing.assert_array_equal(pnew.pos.numpy(), np.asarray(jnew.pos))
    written = np.asarray(jnew.pos) != pos
    assert written.sum() == active.sum()
    for got_p, want_p, old in ((pnew.k, jnew.k, k), (pnew.v, jnew.v, v)):
        got_p, want_p = got_p.numpy(), np.asarray(want_p)
        np.testing.assert_array_equal(got_p[:, :, ~written],
                                      old[:, :, ~written])
        np.testing.assert_allclose(got_p, want_p, atol=ATOL, rtol=0)


def test_paged_forward_rejects_unported_shapes(weights):
    _, pp = weights
    pc = ptl.get_config("tiny", **CFG)
    k, v, pos, table, _ = pool_state(8, 2, 2, 16, 8, 3, 2, (5, 9))
    cache = ptl.PagedKVCache(*(torch.from_numpy(a) for a in (k, v, pos,
                                                             table)),
                             fill=torch.tensor([5, 9], dtype=torch.int32))
    toks = torch.ones((2, 2), dtype=torch.int32)
    # an int8 pool (with its scale planes) runs; its write-back lands int8
    # payload and float32 scales
    kq, vq, ks, vs = (torch.from_numpy(a) for a in int8_pool(k, v, pos))
    int8 = ptl.PagedKVCache(kq, vq, cache.pos.clone(), cache.table,
                            cache.fill, ks, vs)
    lg, out = ptl.forward(pp, toks, torch.tensor([[5, 6], [9, 10]],
                                                 dtype=torch.int32), pc,
                          cache=int8)
    assert out is int8 and bool(torch.isfinite(lg).all())
    assert int8.k.dtype == torch.int8 and int8.k_scale.dtype == torch.float32
    assert (int8.pos >= 0).sum() == (pos >= 0).sum() + 4
    with pytest.raises(NotImplementedError, match="output_last_hidden"):
        ptl.forward(pp, toks[:, :1], torch.zeros((2, 1), dtype=torch.int32),
                    pc, cache=cache, output_last_hidden=True)


@pytest.mark.parametrize("T", [3, 5])
def test_paged_forward_multi_token_matches_jax(weights, T):
    """paged_forward at T > 1 (the verify shape) against JAX's: logits of
    the active rows, and the pool afterwards.  Row 1 is inactive, row 3
    has an empty pool, and row 4 breaks the consecutive-positions
    contract, so both packages fold it to inactive."""
    jp, pp = weights
    jc, pc = jlt.get_config("tiny", **CFG), ptl.get_config("tiny", **CFG)
    B, BLK, MB = 5, 8, 6
    L, KVH, d = CFG["n_layers"], CFG["n_kv_heads"], 16
    fills = (30, 20, 9, 0, 12)
    k, v, pos, table, q_pos = pool_state(15, B, KVH, d, BLK, MB, L, fills,
                                         inactive=(1,))
    fill = np.asarray(fills, np.int32)
    active = q_pos >= 0
    positions = np.where(active[:, None], q_pos[:, None] + np.arange(T),
                         -1).astype(np.int32)
    positions[4, -1] += 1  # not consecutive: folded to inactive
    tokens = np.random.default_rng(16).integers(
        1, CFG["vocab_size"], (B, T)).astype(np.int32)
    mask = np.broadcast_to(active[:, None], (B, T))
    jcache = JPagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                           pos=jnp.asarray(pos), table=jnp.asarray(table),
                           fill=jnp.asarray(fill))
    want, jnew = jlt.forward(jp, jnp.asarray(tokens), jnp.asarray(positions),
                             jc, cache=jcache, attn_mask=jnp.asarray(mask))
    pcache = ptl.PagedKVCache(
        *(torch.from_numpy(a.copy()) for a in (k, v, pos, table, fill)))
    got, pnew = ptl.forward(pp, torch.from_numpy(tokens),
                            torch.from_numpy(positions), pc, cache=pcache,
                            attn_mask=torch.from_numpy(mask.copy()))
    assert pnew is pcache and got.shape == (B, T, CFG["vocab_size"])
    live = np.array([True, False, True, True, False])
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=2e-4, rtol=0)
    np.testing.assert_array_equal(pnew.pos.numpy(), np.asarray(jnew.pos))
    written = np.asarray(jnew.pos) != pos
    assert written.sum() == live.sum() * T
    for got_p, want_p in ((pnew.k, jnew.k), (pnew.v, jnew.v)):
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                                   atol=ATOL, rtol=0)
    # write_back=False: the same logits, the pool untouched
    again = ptl.PagedKVCache(
        *(torch.from_numpy(a.copy()) for a in (k, v, pos, table, fill)))
    lg, _ = pllama.paged_forward(pp, torch.from_numpy(tokens),
                                 torch.from_numpy(positions), pc, again,
                                 attn_mask=torch.from_numpy(mask.copy()),
                                 write_back=False)
    torch.testing.assert_close(lg, got, atol=0, rtol=0)
    for t, a in ((again.k, k), (again.v, v), (again.pos, pos)):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("T", [1, 3])
def test_paged_forward_int8_matches_jax(weights, T):
    """paged_forward over an int8 pool with int8 weights, against JAX's:
    the pool read through the scale fold, the step's K/V merged at full
    precision and quantized for the write-back.  Logits atol 2e-4 on the
    active rows; positions identical; the written payload within one int8
    step and its scales within 1e-5 relative (the projections come from
    two matmul libraries, so a value on a rounding edge may land one step
    apart)."""
    jp, pp = weights
    jq = jquant.quantize_params(jp)
    pq = ptl.quantize_params(pp)
    kw = dict(CFG, kv_cache_dtype="int8")
    jc, pc = jlt.get_config("tiny", **kw), ptl.get_config("tiny", **kw)
    B, BLK, MB = 4, 8, 6
    L, KVH, d = CFG["n_layers"], CFG["n_kv_heads"], 16
    fills = (30, 20, 9, 0)
    k, v, pos, table, q_pos = pool_state(21, B, KVH, d, BLK, MB, L, fills,
                                         inactive=(1,))
    kq, vq, ks, vs = int8_pool(k, v, pos)
    fill = np.asarray(fills, np.int32)
    active = q_pos >= 0
    positions = np.where(active[:, None], q_pos[:, None] + np.arange(T),
                         -1).astype(np.int32)
    tokens = np.random.default_rng(22).integers(
        1, CFG["vocab_size"], (B, T)).astype(np.int32)
    mask = np.broadcast_to(active[:, None], (B, T))
    state = (kq, vq, pos, table, fill, ks, vs)
    jcache = JPagedKVCache(*(jnp.asarray(a) for a in state))
    want, jnew = jlt.forward(jq, jnp.asarray(tokens), jnp.asarray(positions),
                             jc, cache=jcache, attn_mask=jnp.asarray(mask))
    pcache = ptl.PagedKVCache(*(torch.from_numpy(a.copy()) for a in state))
    got, pnew = ptl.forward(pq, torch.from_numpy(tokens),
                            torch.from_numpy(positions), pc, cache=pcache,
                            attn_mask=torch.from_numpy(mask.copy()))
    assert pnew is pcache
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                               atol=2e-4, rtol=0)
    np.testing.assert_array_equal(pnew.pos.numpy(), np.asarray(jnew.pos))
    assert (np.asarray(jnew.pos) != pos).sum() == active.sum() * T
    for got_p, want_p in ((pnew.k, jnew.k), (pnew.v, jnew.v)):
        assert got_p.dtype == torch.int8
        diff = np.abs(got_p.numpy().astype(np.int32)
                      - np.asarray(want_p).astype(np.int32))
        assert diff.max() <= 1
    for got_s, want_s in ((pnew.k_scale, jnew.k_scale),
                          (pnew.v_scale, jnew.v_scale)):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=0)
