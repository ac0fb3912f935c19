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


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ring_fold_on_the_card(rate):
    """The ring's fold (plain torch, one shard) on CUDA tensors from bf16
    inputs: out and its gradients against the dense float32 attention
    (under the ring's hash mask with dropout), each within 2e-2 of the
    tensor's largest value."""
    _need_card()
    from jax_llama_tpu_torch.ops import attention as att
    from jax_llama_tpu_torch.parallel import ring

    gen = torch.Generator(device="cuda").manual_seed(4)
    B, T, H, KVH = 1, 1024, 8, 2
    q, k, v, g = (_randn(gen, B, T, h, D) for h in (H, KVH, KVH, H))
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None]
    words = (0x2545F491, 0x9E3779B9)

    def grads(fn):
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves).float()
        return [out.detach()] + list(torch.autograd.grad(out, leaves,
                                                         g.float()))

    def dense(qq, kk, vv):
        w = att.sdpa(qq, kk, vv, att.attention_bias(pos, pos, pos >= 0),
                     return_weights=True)[1]
        if rate:
            keep = ring.dropout_keep(ring.dropout_base(words, B, H,
                                                       device="cuda"),
                                     pos, pos, rate)
            w = torch.where(keep, w / (1.0 - rate), 0.0)
        return torch.einsum("bhts,bshd->bthd", w, att.repeat_kv(vv, H // KVH))

    want = grads(dense)
    got = grads(lambda qq, kk, vv: ring.ring_attention(
        qq.bfloat16(), kk.bfloat16(), vv.bfloat16(), pos, pos, axis_size=1,
        dropout_rate=rate, dropout_seed=words))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b, rtol=0,
                                   atol=2e-2 * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("axes,fsdp", [(dict(tensor=2), False),
                                       (dict(fsdp=2), True),
                                       (dict(seq=2), False)],
                         ids=["tensor2", "fsdp2", "seq2"])
def test_two_rank_gloo_train_step_on_one_card(axes, fsdp):
    """Two train steps on two ranks sharing cuda:0 over gloo, which takes
    the written-out routes (ppermute by all_gather_take, reduce_scatter
    by all_reduce_slice): losses and params those of the unsharded
    steps (float32, head_dim 128 so the flash kernels run)."""
    _need_card()
    cfg = dict(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
               multiple_of=256, max_seq_len=256, dtype="float32",
               param_dtype="float32", remat=True,
               attn_impl="ring" if "seq" in axes else "flash")
    pool = MeshPool(2, timeout_s=300)
    try:
        res = pool.run("train_on_card", cfg=cfg, axes=axes, fsdp=fsdp, B=2,
                       T=128)
    finally:
        pool.close()
    for r in res:
        assert r["routes"] == {"ppermute": "all_gather_take",
                               "reduce_scatter": "all_reduce_slice"}
        np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-4)
        assert r["max_diff"] < 1e-3
        # Forward and remat recompute per layer and step, where the
        # flash kernel runs (the ring's fold is plain torch).
        assert r["launches"] == (0 if "seq" in axes else 2 * 2 * 2)
    if fsdp:
        assert res[0]["collectives"][
            "reduce_scatter:all_reduce_slice/fsdp"] > 0
    if "seq" in axes:
        assert res[0]["collectives"]["ppermute:all_gather_take/seq"] > 0
