"""The port's flash attention with lse, dropout and its backward, held
against the JAX package on the CPU: the dropout hash bit for bit, the
plain forward (out and lse) and the plain backward against the JAX Pallas
kernels run in interpret mode on the same numpy inputs and seed words
(also at a shape the backward's Hopper instance takes: d = 128, T = S =
128, G = 4), the backward's instance table, and the chunked cross-entropy
against JAX's.  Tolerances: forward atol 1e-5, backward atol 1e-4
(float32; the two sides sum in other orders), loss rel 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_llama_tpu.ops.loss import chunked_softmax_xent as j_xent

from jax_llama_tpu_torch.ops.loss import chunked_softmax_xent as p_xent

# The ops packages re-export the functions under the modules' names.
jfa = importlib.import_module("jax_llama_tpu.ops.flash_attention")
pfa = importlib.import_module("jax_llama_tpu_torch.ops.flash_attention")

SEEDS = {
    "one_word": [5],
    "one_word_widened": [5, 0],
    "hi_word_set": [5, 1],
    "full_64_bit": [0xDEADBEEF, 0x12345678],
    "zero": [0],
}
TILES = [(0, 0, 1, 0, 8, 16), (64, 128, 3, 7, 16, 8), (1000, 37, 0, 1, 5, 33)]


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_dropout_keep_bit_identical_to_jax(seed):
    words = jfa._normalize_seed(jnp.asarray(SEEDS[seed], jnp.uint32))
    lo, hi = pfa.normalize_seed(SEEDS[seed])
    assert (lo, hi) == tuple(int(w) for w in np.asarray(words))
    for row0, col0, b, h, bq, bk in TILES:
        for rate in (0.1, 0.5):
            want = np.asarray(jfa._dropout_keep(
                words[0], words[1], jnp.int32(b), jnp.int32(h), row0, col0,
                bq, bk, rate))
            got = pfa.dropout_keep(lo, hi, b, h, row0, col0, bq, bk, rate)
            np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_seed_widening_and_tiles():
    """[s] and [s, 0] draw one mask and [s, 1] another; a tile is the
    slice of a larger tile at its offset (the hash is global)."""
    a = pfa.dropout_keep(*pfa.normalize_seed([7]), 0, 1, 0, 0, 32, 32, 0.3)
    b = pfa.dropout_keep(*pfa.normalize_seed([7, 0]), 0, 1, 0, 0, 32, 32, 0.3)
    c = pfa.dropout_keep(*pfa.normalize_seed([7, 1]), 0, 1, 0, 0, 32, 32, 0.3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    sub = pfa.dropout_keep(7, 0, 0, 1, 8, 16, 8, 16, 0.3)
    assert torch.equal(sub, a[8:16, 16:32])
    with pytest.raises(ValueError, match="uint32 words"):
        pfa.normalize_seed([1, 2, 3])


def _inputs(B=2, T=24, H=4, KVH=2, d=16, pad=5, seed=0):
    """q/k/v, q_pos and kv_pos with row 1 left-padded by ``pad`` slots
    (engine.prompt_positions geometry: real positions restart at 0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, d)).astype(np.float32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[1, :pad] = -1
    pos[1, pad:] = np.arange(T - pad)
    return q, k, v, np.maximum(pos, 0), pos


def _pack(q, q_pos, KVH):
    """The JAX wrapper's GQA packing (rows g*T + t), for _flash_forward."""
    B, T, H, d = q.shape
    G = H // KVH
    qp = jnp.moveaxis(jnp.asarray(q).reshape(B, T, KVH, G, d), 3, 1)
    return qp.reshape(B, G * T, KVH, d), jnp.tile(jnp.asarray(q_pos), (1, G))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_plain_forward_out_and_lse_match_jax(rate):
    q, k, v, qp, pos = _inputs()
    seed = [0x1234ABCD, 0x0BADF00D]
    KVH, T = k.shape[2], q.shape[1]
    want = np.asarray(jfa.flash_attention(
        *map(jnp.asarray, (q, k, v, qp, pos)), block_q=8, block_k=8,
        dropout_rate=rate, dropout_seed=jnp.asarray(seed, jnp.uint32)))
    qpk, posk = _pack(q, qp, KVH)
    _, lse = jfa._flash_forward(
        qpk, jnp.asarray(k), jnp.asarray(v), posk, jnp.asarray(pos), 16, 8,
        None, need_lse=True, dropout_rate=rate,
        dropout_seed=jnp.asarray(seed, jnp.uint32))
    want_lse = np.asarray(lse)[:, :, :qpk.shape[1], 0]
    out, got_lse = pfa.flash_attention_reference(
        *_t(q, k, v, qp, pos), dropout_rate=rate, dropout_seed=seed,
        return_lse=True)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)
    assert got_lse.shape == (q.shape[0], KVH, (q.shape[2] // KVH) * T)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5, rtol=0)
    # The wrapper (no grad) is the plain version on CPU tensors.
    np.testing.assert_allclose(
        pfa.flash_attention(*_t(q, k, v, qp, pos), dropout_rate=rate,
                            dropout_seed=seed).numpy(), out.numpy())


def test_dead_row_lse_is_inf_and_contributes_nothing():
    q, k, v, qp, pos = _inputs(T=12, pad=0)
    pos[0, :4] = -1  # queries 0..3 of row 0 (positions 0..3) see no slot
    out, lse = pfa.flash_attention_reference(*_t(q, k, v, qp, pos),
                                             return_lse=True)
    assert torch.all(out[0, :4] == 0)
    lse4 = lse.reshape(2, 2, 2, 12)
    assert torch.isinf(lse4[0, ..., :4]).all()
    assert torch.isfinite(lse4[0, ..., 4:]).all()
    assert torch.isfinite(lse4[1]).all()
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    dq, dk, dv = pfa.flash_backward_reference(*_t(q, k, v, qp, pos), out,
                                              lse, g)
    assert torch.all(dq[0, :4] == 0)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_matches_jax_vjp(rate):
    """GQA G=2, a left-padded row, T = 67 (not a multiple of 64 or of the
    JAX tiles), with and without dropout; through the autograd Function
    and the plain backward directly."""
    q, k, v, qp, pos = _inputs(T=67, pad=9, seed=1)
    seed = [77, 3]
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    g[1, :9] = 0.0  # pad rows are masked downstream; no cotangent flows

    def jfn(a, b, c):
        return jfa.flash_attention(
            a, b, c, jnp.asarray(qp), jnp.asarray(pos), block_q=32,
            block_k=32, dropout_rate=rate,
            dropout_seed=jnp.asarray(seed, jnp.uint32))

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tqp, tpos, tg = _t(qp, pos, g)
    out = pfa.flash_attention(tq, tk, tv, tqp, tpos, dropout_rate=rate,
                              dropout_seed=seed)
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    o, lse = pfa.flash_attention_reference(
        *_t(q, k, v, qp, pos), rate, seed, return_lse=True)
    direct = pfa.flash_backward_reference(*_t(q, k, v, qp, pos), o, lse, tg,
                                          rate, seed)
    for a, b in zip(got, direct):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_backward_matches_jax_vjp_at_hopper_shape(rate):
    """d = 128, T = S = 128, G = 4 (one KV head), one batch row, causal:
    a shape the Hopper backward instance takes; the wrappers' CPU path
    (``flash_bwd_dq``, ``flash_bwd_dkv`` from lse and Delta) is the same
    plain function."""
    assert pfa.flash_bwd_instance(torch.bfloat16, 128, 128, 128) == "wgmma"
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((1, 128, 4, 128), (1, 128, 1, 128), (1, 128, 1, 128)))
    qp = pos = np.arange(128, dtype=np.int32)[None]
    seed = [0x2545F491, 0x9E3779B9]
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def jfn(a, b, c):
        return jfa.flash_attention(
            a, b, c, jnp.asarray(qp), jnp.asarray(pos), block_q=64,
            block_k=64, dropout_rate=rate,
            dropout_seed=jnp.asarray(seed, jnp.uint32))

    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv, tqp, tpos, tg = _t(q, k, v, qp, pos, g)
    out, lse = pfa.flash_attention_reference(tq, tk, tv, tqp, tpos, rate,
                                             seed, return_lse=True)
    got = pfa.flash_backward_reference(tq, tk, tv, tqp, tpos, out, lse, tg,
                                       rate, seed)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")
    words = pfa.normalize_seed(seed) if rate else None
    delta = pfa.flash_delta(out, tg, 1)
    args = (tq, tk, tv, tqp, tpos, lse, delta, tg, rate, words)
    dk, dv = pfa.flash_bwd_dkv(*args)
    for a, b in zip((pfa.flash_bwd_dq(*args), dk, dv), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _bwd_instance_rule(dtype, d, T, S):
    """The backward instance table, spelled out."""
    if dtype == torch.float32:
        return "float32"
    if d == 128 and T > 0 and T % 128 == 0 and T <= 65536 and S > 0:
        return "wgmma"
    return "mma_sync"


@pytest.mark.parametrize("S", [0, 300])
@pytest.mark.parametrize("T", [1, 67, 128, 256, 65536 + 128])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_instance_table(dtype, d, T, S):
    assert pfa.flash_bwd_instance(dtype, d, T, S) == _bwd_instance_rule(
        dtype, d, T, S)


def test_flash_attention_argument_checks():
    q, k, v, qp, pos = _t(*_inputs(T=8))
    with pytest.raises(ValueError, match="dropout_seed"):
        pfa.flash_attention(q, k, v, qp, pos, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not in"):
        pfa.flash_attention(q, k, v, qp, pos, dropout_rate=1.0)
    # The plain versions never count, forward or backward.
    tq, tk, tv = (x.requires_grad_() for x in (q, k, v))
    out = pfa.flash_attention(tq, tk, tv, qp, pos)
    torch.autograd.grad(out.sum(), (tq, tk, tv))
    assert pfa.flash_attention.launches == 0
    assert pfa.flash_attention.launches_by_instance == {}
    for wrapper in (pfa.flash_bwd_dq, pfa.flash_bwd_dkv):
        assert wrapper.launches == 0
        assert wrapper.launches_by_instance == {}


def test_chunked_xent_matches_jax_tied_head_several_chunks():
    rng = np.random.RandomState(9)
    N, D, V = 37, 16, 24
    h = rng.randn(N, D).astype(np.float32)
    emb = rng.randn(V, D).astype(np.float32)  # tied layout [V, D]
    tgt = rng.randint(0, V, N).astype(np.int32)
    w = (rng.rand(N) > 0.2).astype(np.float32)

    def jloss(hh, ee):
        tot, wsum = j_xent(hh, ee, jnp.asarray(tgt), jnp.asarray(w),
                           head_transposed=True, chunk=8)
        return tot / wsum, (tot, wsum)

    (jl, (jtot, jwsum)), (jgh, jge) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(emb))
    th, te = (x.requires_grad_() for x in _t(h, emb))
    tot, wsum = p_xent(th, te, torch.from_numpy(tgt), torch.from_numpy(w),
                       head_transposed=True, chunk=8)
    (tot / wsum).backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-6)
    np.testing.assert_allclose(float(wsum), float(jwsum), rtol=0)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), atol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), atol=1e-6)
    # Chunk size does not change the value.
    for c in (5, 64):
        t2, _ = p_xent(th.detach(), te.detach(), torch.from_numpy(tgt),
                       torch.from_numpy(w), head_transposed=True, chunk=c)
        np.testing.assert_allclose(float(t2), float(tot.detach()), rtol=1e-6)
