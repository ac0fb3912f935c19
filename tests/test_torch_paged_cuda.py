"""The port's paged decode kernel and its batcher on the card.  Marked
``cuda``: each test skips on a host without a GPU (the kernel has no CPU
mode).  Like tests/test_torch_cuda.py, this file imports neither jax nor
the JAX package, so it runs on a GPU host without them:

    python -m pytest tests/test_torch_paged_cuda.py -m cuda --noconftest -q

Tolerances against the plain version: out atol 1e-2 in bf16 (P rounded to
bf16 before P.V at a different running max), 1e-5 in float32 (summation
order); lse atol 1e-4 (float32 from the same inputs).
"""

import importlib

import numpy as np
import pytest
import torch

import jax_llama_tpu_torch as ptl
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


def _card_inputs(dtype, B, KVH, G, d, BLK, MB, L, fills, inactive, T=1):
    k, v, pos, table, q_pos = pool_state(9, B, KVH, d, BLK, MB, L, fills,
                                         inactive)
    if T > 1:
        q_pos = multi_token_q_pos(fills, inactive, T)
    q = np.random.default_rng(10).standard_normal((B, KVH, T * G, d))
    as_dt = [torch.from_numpy(a.astype(np.float32)).cuda().to(dtype)
             for a in (q, k, v)]
    return as_dt + [torch.from_numpy(a).cuda() for a in (pos, table, q_pos)]


CARD_CASES = {
    "d128_g4_blk128": (8, 8, 4, 128, 128, 4, 3,
                       (400, 130, 128, 1, 0, 64, 257, 12), (5,)),
    "d64_g8_blk24": (3, 2, 8, 64, 24, 5, 2, (100, 30, 5), (1,)),
    "d64_g1_blk8": (4, 4, 1, 64, 8, 6, 1, (37, 20, 0, 8), ()),
    # block sizes that are not multiples of 8 (the batcher's default for
    # max_len 1000 is 62)
    "d128_g4_blk62": (4, 8, 4, 128, 62, 8, 2, (300, 61, 62, 0), (3,)),
    "d64_g2_blk20": (3, 2, 2, 64, 20, 5, 2, (70, 19, 41), ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_paged_kernel_matches_plain_on_card(name, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, KVH, G, d, BLK, MB, L, fills, inactive = CARD_CASES[name]
    args = _card_inputs(dtype, B, KVH, G, d, BLK, MB, L, fills, inactive)
    layer = L - 1
    before = pa.paged_pool_attention.launches
    out, lse = pa.paged_pool_attention(*args, layer=layer)
    torch.cuda.synchronize()
    assert pa.paged_pool_attention.launches == before + 1
    ro, rl = pa.paged_pool_attention_reference(*args, layer=layer)
    torch.testing.assert_close(out, ro, atol=atol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)


# T > 1 (the speculative verify shape): (B, KVH, G, T, d, BLK, MB, L,
# fills, inactive).  Each row's last token sits at its fill, so the early
# tokens miss the last T-1 slots: a row of fill BLK*k + 1 holds one slot
# in its last block, a tile live only for the later tokens.  A row of
# fill 0 is active with an empty pool (its first token sees nothing).
MULTI_CASES = {
    "d128_g4_t4_blk128": (4, 8, 4, 4, 128, 128, 5, 2,
                          (500, 129, 0, 548), ()),
    "d128_g8_t4_blk62": (3, 2, 8, 4, 128, 62, 6, 2, (125, 0, 63), (2,)),
    "d64_g2_t5_blk20": (4, 2, 2, 5, 64, 20, 5, 2, (41, 0, 70, 21), (3,)),
    "d64_g4_t8_blk8": (3, 4, 4, 8, 64, 8, 8, 1, (33, 17, 0), ()),
    "d128_g1_t2_blk8": (2, 4, 1, 2, 128, 8, 6, 1, (9, 40), ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1e-2),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", sorted(MULTI_CASES))
def test_paged_kernel_multi_token_matches_plain_on_card(name, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, KVH, G, T, d, BLK, MB, L, fills, inactive = MULTI_CASES[name]
    args = _card_inputs(dtype, B, KVH, G, d, BLK, MB, L, fills, inactive, T)
    before = dict(pa.paged_pool_attention.launches_by_t)
    out, lse = pa.paged_pool_attention(*args, layer=L - 1, t_tokens=T)
    torch.cuda.synchronize()
    assert pa.paged_pool_attention.launches_by_t[T] == before.get(T, 0) + 1
    ro, rl = pa.paged_pool_attention_reference(*args, layer=L - 1,
                                               t_tokens=T)
    assert out.shape == (B, KVH, T * G, d)
    torch.testing.assert_close(out, ro, atol=atol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    # the empty-pool row attends nothing at any token
    for b, f in enumerate(fills):
        if f == 0 and b not in inactive:
            assert (lse[b] == pa.MASK_VALUE).all() and (out[b] == 0).all()


@pytest.mark.cuda
def test_paged_wrapper_rejects_rows_past_the_cap_on_card():
    """More packed rows than the kernel's MAX_ROWS are no longer refused:
    the wrapper splits the T tokens into launches of at most MAX_ROWS // G
    (here 8 + 1 at G = 8, T = 9), which together give the plain version's
    result.  A T that does not divide the packed rows still raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, pos, table, q_pos = _card_inputs(
        torch.bfloat16, 3, 2, 8, 64, 24, 5, 2, (100, 30, 5), (1,), T=9)
    assert q.shape[2] == 72 > pa.MAX_ROWS
    pa.paged_pool_attention.launches_by_t = {}
    out, lse = pa.paged_pool_attention(q, k, v, pos, table, q_pos,
                                       t_tokens=9)
    torch.cuda.synchronize()
    assert pa.paged_pool_attention.launches_by_t == {8: 1, 1: 1}
    ro, rl = pa.paged_pool_attention_reference(q, k, v, pos, table, q_pos,
                                               t_tokens=9)
    torch.testing.assert_close(out, ro, atol=1e-2, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match="t_tokens"):
        pa.paged_pool_attention(q, k, v, pos, table, q_pos, t_tokens=5)


# The split-KV kernel's cases: (B, KVH, d, BLK, MB, L, fills, inactive) at
# BLK = 64, MB = 20 (1280 slots a row, 5 splits of 256): row 0 spans four
# splits, row 1 one (with an all -1 block inside it), row 2 three with a
# sentinel entry inside, row 3 is active over an empty pool (its token 0
# sees nothing: lse MASK_VALUE), row 4 is inactive and row 5's live bound
# ends inside its second split.
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
def test_split_kv_kernel_matches_plain_on_card(G, T, dtype, atol):
    """The split pass and the combine pass against the plain version at
    T = 1, 4, 5 and 8 tokens and G = 4 and 8 (up to 64 packed rows, one
    launch each): one split, many splits, a bound inside a split, an
    inactive row, a sentinel entry and an empty pool; two calls on the
    same inputs are bit-identical, and each launches both passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, KVH, d, BLK, MB, L, fills, inactive = SPLIT_POOL
    args = _card_inputs(dtype, B, KVH, G, d, BLK, MB, L, fills, inactive, T)
    assert pa.n_splits(args[4], BLK) == 5
    before = (pa.paged_pool_attention.launches,
              pa.paged_pool_attention.kernel_launches,
              dict(pa.paged_pool_attention.launches_by_t),
              dict(pa.paged_pool_attention.launches_by_instance))
    out, lse = pa.paged_pool_attention(*args, layer=L - 1, t_tokens=T)
    again = pa.paged_pool_attention(*args, layer=L - 1, t_tokens=T)
    torch.cuda.synchronize()
    assert pa.paged_pool_attention.launches == before[0] + 2
    # Two calls, each reported by the C entry point as a split pass and
    # a combine pass, both on the split instance these rows take.
    assert pa.paged_pool_attention.kernel_launches == before[1] + 4
    want = _split_instance(dtype, G * T)
    assert pa.paged_pool_attention.launches_by_instance.get(want) == (
        before[-1].get(want, 0) + 2)
    assert pa.paged_pool_attention.launches_by_t[T] == (
        before[2].get(T, 0) + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ro, rl = pa.paged_pool_attention_reference(*args, layer=L - 1,
                                               t_tokens=T)
    torch.testing.assert_close(out, ro, atol=atol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    for b, f in enumerate(fills):
        if f == 0 or b in inactive:  # attends nothing at any token
            assert (lse[b] == pa.MASK_VALUE).all() and (out[b] == 0).all()


@pytest.mark.cuda
def test_paged_wrapper_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, pos, table, q_pos = _card_inputs(
        torch.bfloat16, 3, 2, 8, 64, 24, 5, 2, (100, 30, 5), (1,))
    with pytest.raises(TypeError):
        pa.paged_pool_attention(q, k, v, pos, table.long(), q_pos)
    with pytest.raises(ValueError):
        pa.paged_pool_attention(q, k, v, pos, table, q_pos, layer=2)
    with pytest.raises(ValueError):
        pa.paged_pool_attention(q[..., :32].contiguous(), k, v, pos, table,
                                q_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [None, 20])
def test_batcher_runs_the_kernels_on_card(block_size):
    """float32 at head_dim 64: paged = gathered tokens, and each decode
    iteration launches the paged kernel once per layer, at the default
    block size (16) and at one that is not a multiple of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = ptl.get_config("tiny", vocab_size=128, dim=128, n_layers=2,
                         n_heads=2, n_kv_heads=1, multiple_of=32,
                         max_seq_len=128, attn_impl="auto")
    params = ptl.init_params(cfg, seed=0, device="cuda")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, size=rng.randint(3, 40)).tolist()
               for _ in range(5)]
    outs = {}
    for path in ("paged", "gathered"):
        cb = ptl.ContinuousBatcher(params, cfg, n_slots=3, max_len=128,
                                   decode_chunk=4, block_size=block_size,
                                   use_pallas_kernel=path == "paged")
        rids = [cb.submit(p, max_new_tokens=6 + i)
                for i, p in enumerate(prompts)]
        before = pa.paged_pool_attention.launches
        res = cb.run_to_completion()
        launched = pa.paged_pool_attention.launches - before
        outs[path] = [res[r] for r in rids]
        if path == "paged":
            assert launched == cfg.n_layers * cb.steps_total
        else:
            assert launched == 0
    assert outs["paged"] == outs["gathered"]
