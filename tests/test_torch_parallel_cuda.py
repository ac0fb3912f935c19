"""The port's kernels at a tensor-parallel rank's shapes, and a two-rank
gloo forward on one card.  Marked ``cuda``: each test skips on a host
without a GPU (the kernels have no CPU mode).  This file imports neither
jax nor the JAX package, so it runs on a GPU host without them:

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda --noconftest -q

Under tensor = 2 (KVH = 4) and tensor = 4 (KVH = 2) a llama3-8b rank's
kernels see H = 16 or 8 query heads over KVH = 4 or 2 KV heads (G = 4):
each kernel is held against its plain version there, bf16 at atol 1e-2
(P rounded to bf16 before P.V), the paged lse at atol 1e-3.  The two
ranks of the forward share cuda:0 over gloo (NCCL refuses two ranks on
one device); their logits are held to the unsharded forward's within
2e-2 of the largest (bf16 partial sums reduced across ranks).
"""

import importlib

import numpy as np
import pytest
import torch

from torch_mesh_worker import MeshPool

fa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")
pa = importlib.import_module("jax_llama_tpu_torch.ops.paged_attention")
kn = importlib.import_module("jax_llama_tpu_torch.ops.kernels")

SHARDS = {"tp2": 4, "tp4": 2}  # KV heads per rank of llama3-8b's 8
G, D = 4, 128


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _randn(gen, *shape):
    return torch.randn(*shape, device="cuda", generator=gen).to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", list(SHARDS))
def test_flash_forward_at_a_ranks_heads(shard):
    _need_card()
    kvh = SHARDS[shard]
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, T = 4, 512
    q, k, v = (_randn(gen, B, T, h, D) for h in (kvh * G, kvh, kvh))
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].repeat(
        B, 1)
    pos[1, :100] = -1  # left padding
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, pos.clamp(min=0), pos)
    assert fa.flash_attention.launches == before + 1
    ref = fa.flash_attention_reference(q, k, v, pos.clamp(min=0), pos)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=0)


def _paged_args(gen, kvh, B=8, BLK=128, MB=8, L=2):
    NB = B * MB
    table = torch.arange(NB, dtype=torch.int32).reshape(B, MB)
    fills = [700, 513, 129, 64, 1, 0, 1000, 300]
    pos = torch.full((NB, BLK), -1, dtype=torch.int32)
    for b, f in enumerate(fills):
        for j in range(MB):
            m = max(0, min(BLK, f - j * BLK))
            pos[table[b, j], :m] = torch.arange(j * BLK, j * BLK + m)
    q_pos = torch.tensor(fills, dtype=torch.int32)
    q_pos[5] = -1
    k, v = (_randn(gen, L, kvh, NB, BLK, D) for _ in range(2))
    return k, v, pos.cuda(), table.cuda(), q_pos.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("shard", list(SHARDS))
def test_paged_decode_at_a_ranks_heads(shard):
    _need_card()
    kvh = SHARDS[shard]
    gen = torch.Generator(device="cuda").manual_seed(1)
    k, v, pos, table, q_pos = _paged_args(gen, kvh)
    q = _randn(gen, table.shape[0], kvh, G, D)
    out, lse = pa.paged_pool_attention(q, k, v, pos, table, q_pos, 1)
    ref, ref_lse = pa.paged_pool_attention_reference(q, k, v, pos, table,
                                                     q_pos, 1)
    live = q_pos >= 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=1e-2, rtol=0)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", list(SHARDS))
def test_stock_paged_at_a_ranks_heads(shard):
    _need_card()
    kvh = SHARDS[shard]
    gen = torch.Generator(device="cuda").manual_seed(2)
    k, v, _, table, q_pos = _paged_args(gen, kvh)
    B = table.shape[0]
    q = _randn(gen, B, 1, kvh * G, D)
    k_new, v_new = (_randn(gen, B, 1, kvh, D) for _ in range(2))
    args = (q, k_new, v_new, k, v, table, q_pos)
    out = kn.stock_paged_decode(*args, layer=1)
    ref = kn.stock_paged_decode_reference(*args, layer=1)
    live = q_pos >= 0
    torch.testing.assert_close(out[live].float(), ref[live].float(),
                               atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", list(SHARDS))
def test_splash_prefill_at_a_ranks_heads(shard):
    _need_card()
    kvh = SHARDS[shard]
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (_randn(gen, 2, 512, h, D) for h in (kvh * G, kvh, kvh))
    for off in (0, 256):
        kk, vv = (torch.cat([x, x[:, :off]], 1) if off else x
                  for x in (k, v))
        out = kn.splash_prefill(q, kk, vv, chunk_offset=off)
        ref = kn.splash_prefill_reference(q, kk, vv, chunk_offset=off)
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                                   rtol=0)


@pytest.mark.cuda
def test_two_rank_gloo_forward_on_one_card():
    _need_card()
    cfg = dict(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
               multiple_of=256, max_seq_len=256, dtype="bfloat16",
               param_dtype="bfloat16", attn_impl="auto")
    pool = MeshPool(2)
    try:
        res = pool.run("forward_on_card", cfg=cfg, axes=dict(tensor=2),
                       seed=0, B=2, T=64)
    finally:
        pool.close()
    for r in res:
        assert r["kvh"] == 1
        assert r["launches"] == cfg["n_layers"]  # the prefill's flash
        assert r["rel"] < 2e-2
    np.testing.assert_array_equal(res[0]["tokens"], res[1]["tokens"])
    # Greedy tokens: the unsharded run's, bar a bf16 near-tie late on.
    P = 64
    same = (res[0]["tokens"][:, P:] == res[0]["unsharded"][:, P:])
    assert same[:, :4].all()
