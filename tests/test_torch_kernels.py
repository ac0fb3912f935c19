"""The port's kernel-selection layer (``jax_llama_tpu_torch/ops/kernels.py``)
held against the JAX package's (``jax_llama_tpu/ops/kernels.py``) on the
same numpy inputs, on the CPU, where each wrapper runs its plain version.

* Registry: ``resolve_prefill_kernel`` / ``resolve_decode_kernel`` for
  every name (an unknown one raises the same ValueError), the
  ``KernelSpec`` tables field for field, ``splash_eligible`` over a grid
  of shapes, offsets, cache types and selections.
* Splash, op level: the plain version against JAX's ``splash_prefill`` in
  interpret mode (tests/test_kernels.py's shape), float32, atol 1e-5.
* Stock-paged, op level: the plain version against a bf16-cast gathered
  reference (transcribed from tests/test_kernels.py ``_bf16_reference`` on
  its ``_stock_case`` inputs), atol 1e-5; against JAX's custom paged kernel
  in interpret mode on pools rounded to bf16 first (the cast is then
  exact), atol 1e-5, and on raw float32 pools loosely (2e-2, the stock
  kernel's extra rounding); the 5-D layer select; the refusals.
* Model and batcher level: ``paged_forward`` under ``stock-paged``, the
  splash and stock-paged batchers' greedy tokens against JAX's, the slot
  each layer ran (counted by spies on the model's two entry points), and
  the static predicates (int8 keeps flash and the paged kernel; a
  speculative round never runs the stock slot).

JAX's stock path in these tests: the stock Pallas body fails on this
image (the installed upstream body takes ``k_sems, v_sems``, JAX's
``_stock_launch`` passes one semaphore).  The tests that run JAX's stock
path replace ``jax_llama_tpu.ops.kernels._stock_launch`` inside the test
only (pytest's ``monkeypatch``) with ``_stock_launch_standin``: a jnp
gather with the same (out, m, l) contract and K/V rounded to bf16.  JAX's
own flat page offsets, ``lengths`` and merge still run; no file of
``jax_llama_tpu/`` changes, and JAX's compilation caches are cleared after
each such test so no traced stand-in outlives it.

The CUDA kernels are held against their plain versions on a card in
tests/test_torch_kernels_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu.models.llama import PagedKVCache as JPagedKVCache
from jax_llama_tpu.ops import kernels as jk
from jax_llama_tpu.ops.paged_attention import (
    paged_decode_attention as jax_decode_attention,
)
from jax_llama_tpu.serving import ContinuousBatcher as JaxBatcher

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch.models import llama as pllama
from jax_llama_tpu_torch.ops import kernels as pk

ATOL = 1e-5
# tests/test_kernels.py's configs: the stock geometry (head_dim 16) and the
# splash one (head_dim 128, attn_impl "auto").
CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")
SPLASH_CFG = dict(vocab_size=128, dim=256, n_layers=2, n_heads=2,
                  n_kv_heads=1, multiple_of=32, max_seq_len=256,
                  dtype="float32", param_dtype="float32", attn_impl="auto")
PROMPTS = [[5, 17, 99, 3], [7, 8, 9]]
MAX_NEW = 6


def _models(cfg):
    jc = jlt.get_config("tiny", **cfg)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jc, pp, ptl.get_config("tiny", **cfg)


@pytest.fixture(scope="module")
def model():
    return _models(CFG)


@pytest.fixture(scope="module")
def splash_model():
    return _models(SPLASH_CFG)


def _run(cb, prompts=PROMPTS, max_new=MAX_NEW):
    rids = [cb.submit(list(p), max_new_tokens=max_new) for p in prompts]
    out = cb.run_to_completion()
    return [out[r] for r in rids]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

NAMES = [None, "auto", "flash", "splash", "paged", "stock-paged", "gathered",
         "nosuch"]


def _cfg_pair(head_dim, kv):
    kw = dict(CFG, dim=2 * head_dim, n_heads=2, n_kv_heads=1,
              kv_cache_dtype=kv)
    return jlt.get_config("tiny", **kw), ptl.get_config("tiny", **kw)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("name", NAMES, ids=[str(n) for n in NAMES])
@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_resolve_matches_jax(role, name, head_dim, kv):
    jc, pc = _cfg_pair(head_dim, kv)
    fn = f"resolve_{role}_kernel"
    want = _outcome(getattr(jk, fn), name, jc)
    got = _outcome(getattr(pk, fn), name, pc)
    assert got == want


def test_kernel_spec_tables_match_jax():
    for jtab, ptab in ((jk.PREFILL_KERNELS, pk.PREFILL_KERNELS),
                       (jk.DECODE_KERNELS, pk.DECODE_KERNELS)):
        assert list(ptab) == list(jtab)
        for name in jtab:
            assert (dataclasses.asdict(ptab[name])
                    == dataclasses.asdict(jtab[name]))
    assert ptl.PREFILL_KERNELS is pk.PREFILL_KERNELS
    assert ptl.ops.DECODE_KERNELS is pk.DECODE_KERNELS


@pytest.mark.parametrize("prefill_kernel", ["flash", "splash"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_splash_eligible_matches_jax(head_dim, prefill_kernel):
    jc, pc = _cfg_pair(head_dim, "auto")
    jc = jc.replace(prefill_kernel=prefill_kernel)
    pc = pc.replace(prefill_kernel=prefill_kernel)
    seen = set()
    for q_len in (128, 120, 256):
        for kv_len in (256, 130, 128):
            for off in (None, 0, 128):
                for quantized in (False, True):
                    kw = dict(batch=2, q_len=q_len, kv_len=kv_len,
                              chunk_offset=off, quantized=quantized)
                    want = jk.splash_eligible(jc, **kw)
                    assert pk.splash_eligible(pc, **kw) == want, kw
                    seen.add(want)
    assert seen == ({True, False} if head_dim == 128
                    and prefill_kernel == "splash" else {False})


def test_splash_eligible_under_a_mesh_raises(splash_model):
    pc = splash_model[3].replace(prefill_kernel="splash")
    with pytest.raises(NotImplementedError, match="A14"):
        pk.splash_eligible(pc, batch=1, q_len=128, kv_len=128,
                           chunk_offset=0, mesh=object())


@pytest.mark.parametrize("field,value", [("prefill_kernel", "nosuch"),
                                         ("decode_kernel", "gathered")])
def test_config_validate_messages_match_jax(field, value):
    jc = jlt.get_config("tiny", **CFG).replace(**{field: value})
    pc = ptl.get_config("tiny", **CFG).replace(**{field: value})
    with pytest.raises(ValueError) as want:
        jc.validate()
    with pytest.raises(ValueError) as got:
        pc.validate()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Splash prefill, op level
# ---------------------------------------------------------------------------

def _splash_inputs():
    """tests/test_kernels.py:360's shape and data."""
    B, T, S, H, KVH, d = 2, 128, 256, 4, 2, 128
    rng = np.random.RandomState(1)
    q = rng.randn(B, T, H, d).astype(np.float32) * 0.5
    k = rng.randn(B, S, KVH, d).astype(np.float32) * 0.5
    v = rng.randn(B, S, KVH, d).astype(np.float32) * 0.5
    return q, k, v


@pytest.mark.parametrize("offset", [0, 128])
def test_splash_plain_matches_jax_interpret(offset):
    q, k, v = _splash_inputs()
    want = np.asarray(jk.splash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk_offset=offset,
        interpret=True))
    before = pk.splash_prefill.launches
    got = pk.splash_prefill(*(torch.from_numpy(a) for a in (q, k, v)),
                            chunk_offset=offset)
    assert pk.splash_prefill.launches == before  # the plain version
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = pk.splash_prefill_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), chunk_offset=offset)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("shape", [(120, 256, 128), (128, 200, 128),
                                   (128, 256, 64)],
                         ids=["q_len", "kv_len", "head_dim"])
def test_splash_refuses_shapes_off_128(shape):
    T, S, d = shape
    q = torch.zeros(1, T, 2, d)
    k = torch.zeros(1, S, 1, d)
    with pytest.raises(ValueError, match="multiples of 128"):
        pk.splash_prefill(q, k, k, chunk_offset=0)
    with pytest.raises(ValueError, match="chunk_offset"):
        pk.splash_prefill(torch.zeros(1, 128, 2, 128),
                          torch.zeros(1, 128, 1, 128),
                          torch.zeros(1, 128, 1, 128), chunk_offset=-1)


# ---------------------------------------------------------------------------
# Stock-paged decode, op level
# ---------------------------------------------------------------------------

def _pool_state(rng, B, KVH, d, L, NB, BLK, MB, fills):
    """tests/test_kernels.py:214: a multi-layer pool with per-row fills
    (blocks taken in order, sentinels trailing)."""
    kp = rng.randn(L, KVH, NB, BLK, d).astype(np.float32)
    vp = rng.randn(L, KVH, NB, BLK, d).astype(np.float32)
    pool_pos = np.full((NB, BLK), -1, np.int32)
    table = np.full((B, MB), NB, np.int32)
    free = list(range(NB))
    for b, fill in enumerate(fills):
        n = -(-fill // BLK) if fill else 0
        blocks = [free.pop(0) for _ in range(n)]
        table[b, :n] = blocks
        for j, blk in enumerate(blocks):
            m = min(BLK, fill - j * BLK)
            pool_pos[blk, :m] = np.arange(j * BLK, j * BLK + m)
    return kp, vp, pool_pos, table


def _stock_case(seed=0):
    """tests/test_kernels.py:236: multi-block, empty (inactive), one
    block, partial block."""
    rng = np.random.RandomState(seed)
    B, H, KVH, d = 4, 8, 2, 32
    L, NB, BLK, MB = 2, 12, 16, 5
    fills = [40, 0, 16, 7]
    qpos = np.array([40, -1, 16, 7], np.int32)
    kp, vp, pool_pos, table = _pool_state(rng, B, KVH, d, L, NB, BLK, MB,
                                          fills)
    q = rng.randn(B, 1, H, d).astype(np.float32)
    kn = rng.randn(B, 1, KVH, d).astype(np.float32)
    vn = rng.randn(B, 1, KVH, d).astype(np.float32)
    return q, kn, vn, kp, vp, pool_pos, table, qpos


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _bf16_reference(q, kn, vn, kp, vp, table, qpos, layer, b):
    """tests/test_kernels.py:252: row b's attention with pool K/V cast to
    bf16 before the math (the stock kernel's in-kernel cast); the step's
    own slot merges in float32."""
    _, _, H, d = q.shape
    KVH, NB = kp.shape[1], kp.shape[2]
    G = H // KVH
    scale = 1.0 / np.sqrt(d)
    f = int(qpos[b])
    ks = [kp[layer][:, t] for t in table[b] if t < NB]
    vs = [vp[layer][:, t] for t in table[b] if t < NB]
    kb = _bf16(np.concatenate(ks, axis=1)[:, :f])    # [KVH, f, d]
    vb = _bf16(np.concatenate(vs, axis=1)[:, :f])
    out = np.zeros((H, d), np.float32)
    for h in range(H):
        kh = h // G
        s = np.concatenate([
            (q[b, 0, h] * scale) @ kb[kh].T,
            [(q[b, 0, h] @ kn[b, 0, kh]) * scale],
        ])
        w = np.exp(s - s.max())
        w /= w.sum()
        out[h] = w[:-1] @ vb[kh] + w[-1] * vn[b, 0, kh]
    return out


def _stock(q, kn, vn, kp, vp, table, qpos, layer=None):
    t = [torch.from_numpy(np.array(a))
         for a in (q, kn, vn, kp, vp, table, qpos)]
    return pk.stock_paged_decode(*t, layer=layer).numpy()


def test_stock_plain_matches_bf16_reference():
    q, kn, vn, kp, vp, _, table, qpos = _stock_case()
    layer = 1
    before = pk.stock_paged_decode.launches
    got = _stock(q, kn, vn, kp, vp, table, qpos, layer)
    assert pk.stock_paged_decode.launches == before  # the plain version
    assert np.isfinite(got).all()
    for b in range(q.shape[0]):
        if qpos[b] < 0:
            continue
        want = _bf16_reference(q, kn, vn, kp, vp, table, qpos, layer, b)
        np.testing.assert_allclose(got[b, 0], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pools,atol", [("bf16_valued", ATOL),
                                        ("float32", 2e-2)])
def test_stock_plain_tracks_jax_custom_kernel(pools, atol):
    """Against JAX's custom paged kernel (interpret mode): exact up to
    summation order when the pool values are bf16 already, loose on raw
    float32 pools (the stock kernel rounds K/V to bf16 once more)."""
    q, kn, vn, kp, vp, pool_pos, table, qpos = _stock_case()
    if pools == "bf16_valued":
        kp, vp = _bf16(kp), _bf16(vp)
    layer = 1
    got = _stock(q, kn, vn, kp, vp, table, qpos, layer)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(kp[layer]), jnp.asarray(vp[layer]),
        jnp.asarray(pool_pos), jnp.asarray(table), jnp.asarray(qpos)))
    live = qpos >= 0
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=0)


def test_stock_layer_select_and_refusals():
    """The 5-D pool at layer 1 gives exactly the 4-D plane 1 result; an
    inactive row is finite; T > 1, int8 pools and a 5-D pool without a
    layer raise before any launch."""
    q, kn, vn, kp, vp, _, table, qpos = _stock_case(seed=3)
    five_d = _stock(q, kn, vn, kp, vp, table, qpos, layer=1)
    four_d = _stock(q, kn, vn, kp[1], vp[1], table, qpos)
    np.testing.assert_array_equal(five_d, four_d)
    assert np.isfinite(five_d[qpos < 0]).all()
    t = [torch.from_numpy(np.array(a))
         for a in (q, kn, vn, kp, vp, table, qpos)]
    with pytest.raises(ValueError, match="multi-layer pool"):
        pk.stock_paged_decode(*t)
    with pytest.raises(NotImplementedError, match="T == 1 only"):
        pk.stock_paged_decode(t[0].repeat(1, 2, 1, 1), *t[1:], layer=1)
    int8 = [x.to(torch.int8) for x in t[3:5]]
    with pytest.raises(TypeError, match="int8"):
        pk.stock_paged_decode(*t[:3], *int8, *t[5:], layer=1)


@pytest.mark.parametrize("G", [4, 8])
def test_stock_pool_pass_keeps_jax_output_dtype(G):
    """The pool pass's out is rounded to q's dtype only when G % 8 == 0
    (JAX launches float32 output otherwise); an empty row keeps m = -inf,
    l = 0, out = 0; a sentinel entry inside the length scores the mask
    value with zero values."""
    rng = np.random.default_rng(5)
    B, KVH, d, L, NB, BLK, MB = 3, 2, 64, 1, 6, 8, 3
    q = torch.from_numpy(rng.standard_normal((B, 1, KVH * G, d))).to(
        torch.bfloat16)
    kp = torch.from_numpy(rng.standard_normal((L, KVH, NB, BLK, d))).to(
        torch.bfloat16)
    table = torch.tensor([[0, 1, 2], [3, NB, 4], [5, NB, NB]],
                         dtype=torch.int32)
    q_pos = torch.tensor([20, 17, 0], dtype=torch.int32)
    out, m, l = pk.stock_paged_pool_reference(q, kp, kp, table, q_pos, 0)
    assert out.dtype == torch.float32
    rounded = torch.equal(out, out.to(torch.bfloat16).float())
    assert rounded if G % 8 == 0 else not rounded
    assert torch.isinf(m[2]).all() and (l[2] == 0).all() \
        and (out[2] == 0).all()
    # row 1 attends slots 0..7 of block 3 and 0 of block 4; slots 8..15
    # (the sentinel entry) count with weight exp(MASK - m) = 0.
    assert torch.isfinite(m[1]).all() and (l[1] >= 1).all()


@pytest.mark.parametrize("B,KVH,n_split,G,d", [(8, 8, 16, 4, 128),
                                                (3, 2, 7, 8, 64),
                                                (1, 1, 1, 1, 64)])
def test_stock_scratch_is_three_pieces_of_one_allocation(B, KVH, n_split, G,
                                                         d):
    """The split pass's partials: o_part [B, KVH, NS, G, d], then m_part
    and l_part [B, KVH, NS, G], back to back in one float32 allocation,
    each 16-byte aligned."""
    o_ptr, m_ptr, l_ptr, scratch = pk.stock_scratch(B, KVH, n_split, G, d,
                                                    "cpu")
    n = B * KVH * n_split * G
    assert scratch.dtype == torch.float32 and scratch.numel() == n * (d + 2)
    assert o_ptr == scratch.data_ptr()
    assert m_ptr - o_ptr == n * d * 4 and l_ptr - m_ptr == n * 4
    assert l_ptr + n * 4 == scratch.data_ptr() + scratch.numel() * 4
    assert o_ptr % 16 == 0 and m_ptr % 16 == 0


def test_selection_kernel_instances():
    """The card instances each dtype runs: splash "wgmma" in bf16,
    "float32" in float32; stock on the tensor cores for every q and pool
    dtype (float32 q in three bf16 terms); anything else raises."""
    assert pk.splash_instance(torch.bfloat16) == "wgmma"
    assert pk.splash_instance(torch.float32) == "float32"
    names = {(q, p): pk.stock_instance(q, p)
             for q in (torch.bfloat16, torch.float32)
             for p in (torch.bfloat16, torch.float32)}
    assert names[torch.bfloat16, torch.bfloat16] == \
        "mma_sync_q_bf16_pool_bf16"
    assert names[torch.float32, torch.float32] == "mma_sync_q_f32x3_pool_f32"
    assert len(set(names.values())) == 4
    with pytest.raises(TypeError):
        pk.splash_instance(torch.float16)
    with pytest.raises(TypeError):
        pk.stock_instance(torch.bfloat16, torch.int8)


def test_selection_kernel_instance_codes():
    """The codes the C entry points report name the instances the dtypes
    expect (splash 1 wgmma, 2 float32; stock 1 + 2*(float32 q) + (float32
    pool)); a code no instance has (0: nothing launched) raises."""
    assert pk.splash_instance_name(1) == pk.splash_instance(torch.bfloat16)
    assert pk.splash_instance_name(2) == pk.splash_instance(torch.float32)
    for q in (torch.bfloat16, torch.float32):
        for p in (torch.bfloat16, torch.float32):
            code = 1 + 2 * (q == torch.float32) + (p == torch.float32)
            assert pk.stock_instance_name(code) == pk.stock_instance(q, p)
    for bad in (0, 3, -1):
        with pytest.raises(RuntimeError):
            pk.splash_instance_name(bad)
    for bad in (0, 5):
        with pytest.raises(RuntimeError):
            pk.stock_instance_name(bad)


def test_stock_split_fits_the_kernel():
    """STOCK_SPLIT is what the C entry point takes: a multiple of its
    16-slot chunk, at most the 512 slots a block lists."""
    assert pk.STOCK_SPLIT % 16 == 0 and 0 < pk.STOCK_SPLIT <= 512


def test_stock_paged_launch_refuses_before_any_launch():
    """The explicit-split launch takes multiples of 16 in 16..512 and
    card tensors only; a refusal launches and counts nothing."""
    q, kn, vn, kp, vp, _, table, qpos = _stock_case()
    t = [torch.from_numpy(np.array(a))
         for a in (q, kn, vn, kp, vp, table, qpos)]
    before = (pk.stock_paged_decode.launches,
              dict(pk.stock_paged_decode.launches_by_instance))
    for split in (0, 8, 24, 528, 1024, 128):
        with pytest.raises(ValueError):
            pk.stock_paged_launch(*t, layer=1, split=split)
    assert before == (pk.stock_paged_decode.launches,
                      pk.stock_paged_decode.launches_by_instance)


def test_plain_versions_count_no_instance():
    """CPU tensors run the plain versions: no launch and no instance is
    counted."""
    q, kn, vn, kp, vp, _, table, qpos = _stock_case()
    before = (pk.stock_paged_decode.launches,
              dict(pk.stock_paged_decode.launches_by_instance),
              pk.splash_prefill.launches,
              dict(pk.splash_prefill.launches_by_instance))
    _stock(q, kn, vn, kp, vp, table, qpos, layer=1)
    z = torch.zeros(1, 128, 2, 128)
    pk.splash_prefill(z, z[:, :, :1], z[:, :, :1], chunk_offset=0)
    assert before == (pk.stock_paged_decode.launches,
                      pk.stock_paged_decode.launches_by_instance,
                      pk.splash_prefill.launches,
                      pk.splash_prefill.launches_by_instance)


# ---------------------------------------------------------------------------
# JAX's stock path with the stand-in launch
# ---------------------------------------------------------------------------

def _stock_launch_standin(q, k_pages, v_pages, lengths, page_indices, *,
                          pages_per_compute_block, interpret):
    """``_stock_launch``'s contract as a jnp gather: (out [B, G, d]
    normalised over slots j < lengths[b] of the row's flat pages, in q's
    dtype when G % 8 == 0 else float32; m, l [B, G] float32; a row of
    length 0 keeps m = -inf, l = 0, out = 0), K/V rounded to bf16 as the
    stock body rounds them."""
    del pages_per_compute_block, interpret
    B, G, d = q.shape
    MB = page_indices.shape[1]
    BLK = k_pages.shape[2]

    def gather(pages):
        x = pages[0][page_indices].reshape(B, MB * BLK, d)
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    k, v = gather(k_pages), gather(v_pages)
    s = jnp.einsum("bgd,bsd->bgs", q.astype(jnp.float32), k)
    live = (jnp.arange(MB * BLK)[None, :] < lengths[:, None])[:, None, :]
    has = (lengths > 0)[:, None]
    s = jnp.where(live, s, -jnp.inf)
    m = jnp.where(has, jnp.max(s, axis=-1), -jnp.inf)
    p = jnp.where(live, jnp.exp(s - jnp.where(has, m, 0.0)[..., None]), 0.0)
    l = p.sum(axis=-1)
    out = jnp.einsum("bgs,bsd->bgd", p, v)
    out = jnp.where(has[..., None],
                    out / jnp.where(has, l, 1.0)[..., None], 0.0)
    return (out.astype(q.dtype if G % 8 == 0 else jnp.float32), m, l)


@pytest.fixture
def jax_stock(monkeypatch):
    """JAX's stock path with ``_stock_launch`` replaced for this test (see
    the module docstring); JAX's caches are cleared afterwards, so no
    program traced with the stand-in is reused elsewhere."""
    monkeypatch.setattr(jk, "_stock_launch", _stock_launch_standin)
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_jax_stock_standin_matches_bf16_reference(jax_stock):
    """The stand-in under JAX's own offsets and merge reproduces
    tests/test_kernels.py's bf16 reference (so the model and batcher
    comparisons below hold the port against JAX's stock arithmetic)."""
    q, kn, vn, kp, vp, _, table, qpos = _stock_case()
    got = np.asarray(jk.stock_paged_decode(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp, table, qpos)),
        jnp.asarray(1, jnp.int32)))
    for b in np.nonzero(qpos >= 0)[0]:
        want = _bf16_reference(q, kn, vn, kp, vp, table, qpos, 1, b)
        np.testing.assert_allclose(got[b, 0], want, atol=ATOL, rtol=0)


class _Spy:
    """Counts the calls of one of the model's attention entry points."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        fn = getattr(pllama, name)

        def spy(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(pllama, name, spy)


def _spies(monkeypatch):
    return {name: _Spy(monkeypatch, name)
            for name in ("stock_paged_decode_attention",
                         "paged_decode_attention",
                         "splash_prefill_attention", "flash_attention")}


def test_paged_forward_stock_matches_jax(model, jax_stock, monkeypatch):
    """One paged_forward step under decode_kernel="stock-paged" against
    JAX's on the same pool: logits atol 2e-4 (as the paged step's), the
    write-back identical in positions; every layer ran the stock slot."""
    jp, jc, pp, pc = model
    jc = jc.replace(decode_kernel="stock-paged")
    pc = pc.replace(decode_kernel="stock-paged")
    rng = np.random.RandomState(6)
    B, BLK, MB, NB = 4, 16, 4, 16
    L, KVH, d = CFG["n_layers"], CFG["n_kv_heads"], 16
    fills = (37, 20, 9, 0)
    k, v, pos, table = _pool_state(rng, B, KVH, d, L, NB, BLK, MB, fills)
    fill = np.asarray(fills, np.int32)
    active = np.array([True, False, True, True])
    positions = np.where(active, fill, -1)[:, None].astype(np.int32)
    tokens = rng.randint(1, CFG["vocab_size"], (B, 1)).astype(np.int32)
    jcache = JPagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                           pos=jnp.asarray(pos), table=jnp.asarray(table),
                           fill=jnp.asarray(fill))
    want, jnew = jlt.forward(jp, jnp.asarray(tokens), jnp.asarray(positions),
                             jc, cache=jcache,
                             attn_mask=jnp.asarray(active[:, None]))
    spies = _spies(monkeypatch)
    pcache = ptl.PagedKVCache(
        *(torch.from_numpy(a.copy()) for a in (k, v, pos, table, fill)))
    got, pnew = ptl.forward(pp, torch.from_numpy(tokens),
                            torch.from_numpy(positions), pc, cache=pcache,
                            attn_mask=torch.from_numpy(active[:, None]))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                               atol=2e-4, rtol=0)
    np.testing.assert_array_equal(pnew.pos.numpy(), np.asarray(jnew.pos))
    assert spies["stock_paged_decode_attention"].calls == L
    assert spies["paged_decode_attention"].calls == 0


def test_forward_accepts_chunk_offset_only(model):
    _, _, pp, pc = model
    toks = torch.tensor([[1, 2, 3]])
    pos = torch.arange(3)[None]
    cache = ptl.init_cache(pc, 1, max_len=8, device="cpu")
    ptl.forward(pp, toks, pos, pc, cache=cache, chunk_offset=0)
    for kw in (dict(output_hidden_states=True),
               dict(output_attentions=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            ptl.forward(pp, toks, pos, pc, **kw)


# ---------------------------------------------------------------------------
# Batcher level
# ---------------------------------------------------------------------------

def test_splash_batcher_matches_jax_and_flash(splash_model, monkeypatch):
    """block_size=128 pads every insert to a 128-multiple P, so the whole
    prompt chunk is eligible: the port's splash batcher emits the greedy
    tokens of JAX's splash batcher (interpret mode) and of the port's
    flash batcher, and ran the splash slot on every insert layer, the
    flash slot never."""
    jp, jc, pp, pc = splash_model
    kw = dict(n_slots=2, max_len=256, block_size=128)
    want = _run(JaxBatcher(jp, jc, prefill_kernel="splash",
                           prefix_cache=False, **kw))
    flash = _run(ptl.ContinuousBatcher(pp, pc, prefill_kernel="flash",
                                       device="cpu", **kw))
    spies = _spies(monkeypatch)
    cb = ptl.ContinuousBatcher(pp, pc, prefill_kernel="splash",
                               device="cpu", **kw)
    assert cb.config.prefill_kernel == "splash"
    got = _run(cb)
    assert got == want == flash
    inserts = cb.stats()["insert_dispatches_total"]
    assert inserts >= 1
    assert spies["splash_prefill_attention"].calls == \
        SPLASH_CFG["n_layers"] * inserts
    assert spies["flash_attention"].calls == 0


def test_auto_prefill_resolves_to_splash_at_head_dim_128(splash_model):
    _, _, pp, pc = splash_model
    cb = ptl.ContinuousBatcher(pp, pc, n_slots=1, max_len=256,
                               prefill_kernel="auto", decode_kernel="auto",
                               device="cpu")
    assert (cb.config.prefill_kernel, cb.config.decode_kernel) == (
        "splash", "paged")


@pytest.mark.parametrize("decode_chunk", [1, 8])
def test_stock_batcher_matches_jax(model, jax_stock, monkeypatch,
                                   decode_chunk):
    """The port's stock-paged batcher at decode_chunk 1 and 8 emits the
    greedy tokens of JAX's stock-paged batcher; every T = 1 decode layer
    ran the stock slot, the paged slot never."""
    jp, jc, pp, pc = model
    kw = dict(n_slots=2, max_len=64, decode_kernel="stock-paged",
              decode_chunk=decode_chunk)
    want = _run(JaxBatcher(jp, jc, prefix_cache=False, **kw))
    spies = _spies(monkeypatch)
    cb = ptl.ContinuousBatcher(pp, pc, device="cpu", **kw)
    assert cb.config.decode_kernel == "stock-paged"
    assert _run(cb) == want
    steps = cb.stats()["decode_steps_total"]
    assert steps >= MAX_NEW - 1
    assert spies["stock_paged_decode_attention"].calls == \
        CFG["n_layers"] * steps
    assert spies["paged_decode_attention"].calls == 0


def test_int8_keeps_flash_and_the_paged_kernel(splash_model, monkeypatch):
    """With an int8 cache "auto" resolves to flash, and "stock-paged"
    runs the paged kernel (the int8 pool keeps it)."""
    _, _, pp, pc = splash_model
    spies = _spies(monkeypatch)
    cb = ptl.ContinuousBatcher(pp, pc.replace(kv_cache_dtype="int8"),
                               n_slots=2, max_len=256, block_size=128,
                               prefill_kernel="auto",
                               decode_kernel="stock-paged", device="cpu")
    assert (cb.config.prefill_kernel, cb.config.decode_kernel) == (
        "flash", "stock-paged")
    toks = _run(cb, max_new=4)
    assert [len(t) for t in toks] == [4, 4]
    assert spies["stock_paged_decode_attention"].calls == 0
    assert spies["paged_decode_attention"].calls == \
        SPLASH_CFG["n_layers"] * cb.stats()["decode_steps_total"]
    assert spies["splash_prefill_attention"].calls == 0


def test_spec_round_never_runs_the_stock_slot(model, monkeypatch):
    """A draft that selects stock-paged: every speculative forward is
    T = n_draft + 1, so the stock slot launches zero times, and the
    greedy tokens are the plain batcher's."""
    _, _, pp, pc = model
    plain = _run(ptl.ContinuousBatcher(pp, pc, n_slots=2, max_len=64,
                                       device="cpu"))
    spies = _spies(monkeypatch)
    cb = ptl.ContinuousBatcher(
        pp, pc, n_slots=2, max_len=64, draft_params=pp,
        draft_config=pc.replace(decode_kernel="stock-paged"), n_draft=2,
        device="cpu")
    assert cb.draft_config.decode_kernel == "stock-paged"
    assert cb.config.decode_kernel == "paged"
    assert _run(cb) == plain
    assert spies["stock_paged_decode_attention"].calls == 0
    assert spies["paged_decode_attention"].calls > 0
