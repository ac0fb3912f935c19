"""The prefill-side programs on their device scalars, and ``engine.generate``
and ``score`` as programs, held against the JAX package on the CPU (tiny
float32 config; the JAX programs' Pallas kernels run in interpret mode, as
the JAX package's own tests run them):

* ``_fused_chunk`` with its 0-d device lane scalars and write index,
  three dispatches of one prefix-hit admission (two non-final chunks, the
  final one) beside a decoding row, against JAX's ``_fused_chunk``: the
  fetches equal, the pools within 1e-5, the greedy tokens identical;
* ``_paged_insert`` with ``block_ids`` on the device (padding rows,
  sentinel entries, an all-sentinel call) against JAX's ``_paged_insert``;
* ``forward`` at a 0-d device write index against the host-int index and
  JAX's forward (2e-4), resolving to the flash path where the int does;
* ``engine.generate`` and ``score``: greedy tokens identical to JAX's, and
  each program's ``cache_size()`` delta equal to JAX's ``_cache_size()``
  delta over the same calls, both counted from empty caches.

On the CPU the programs run eagerly (no graph store); the card holds
their graphs against these eager calls (tests/test_torch_programs_cuda.py
and chip_smoke.py's ``programs`` phase).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_llama_tpu as jlt
from jax_llama_tpu import engine as jengine
from jax_llama_tpu import serving as jserving

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import engine as pengine
from jax_llama_tpu_torch import serving as pserving
from jax_llama_tpu_torch.models import llama as pllama
from jax_llama_tpu_torch.utils import programs

# "auto": chunks of more than 8 tokens run the flash path (the port's plain
# version; JAX's Pallas kernel in interpret mode).
CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32", attn_impl="auto")
BLK = 16
POOL_ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jc, pp, ptl.get_config("tiny", **CFG)


def _pools(rng, L=2, KVH=2, NB=16, hd=16):
    """The same random pool for both packages: K/V, and a position plane
    where ``valid`` {block: first position} blocks hold positions."""
    k = rng.standard_normal((L, KVH, NB, BLK, hd)).astype(np.float32)
    v = rng.standard_normal((L, KVH, NB, BLK, hd)).astype(np.float32)
    pos = np.full((NB, BLK), -1, np.int32)
    return k, v, pos


def _jpool(k, v, pos):
    return jserving.BlockPool(k=jnp.asarray(k), v=jnp.asarray(v),
                              pos=jnp.asarray(pos))


def _ppool(k, v, pos):
    return pserving.BlockPool(k=torch.from_numpy(k.copy()),
                              v=torch.from_numpy(v.copy()),
                              pos=torch.from_numpy(pos.copy()))


def _assert_pools(jpool, ppool):
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(ppool, name).numpy(),
                                   np.asarray(getattr(jpool, name)),
                                   atol=POOL_ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(ppool.pos.numpy(), np.asarray(jpool.pos))


# ---------------------------------------------------------------------------
# _fused_chunk on the device scalars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_logprobs", [False, True])
def test_fused_chunk_device_scalars_match_jax(model, with_logprobs,
                                              monkeypatch):
    """Row 0 decodes (20 tokens in blocks 0-1); row 1 is a prefix hit
    (blocks 2-3 hold its first 32 positions, ``pf_base`` = 32) whose
    40-token suffix lands in chunks of 16: off 0 and 16 are not final,
    off 32 is, and that dispatch folds the row in and emits its first
    token.  Each package carries its own state through the three
    dispatches."""
    jp, jc, pp, pc = model
    flash = []
    real = pllama.flash_attention
    monkeypatch.setattr(pllama, "flash_attention",
                        lambda *a, **kw: flash.append(1) or real(*a, **kw))
    rng = np.random.default_rng(5)
    k, v, pos = _pools(rng)
    pos[0] = np.arange(16)
    pos[1, :4] = np.arange(16, 20)
    pos[2] = np.arange(16)
    pos[3] = np.arange(16, 32)
    B, MB, C, base, n_suffix = 2, 8, 16, 32, 40
    table = np.full((B, MB), 16, np.int32)
    table[0, :3] = (0, 1, 4)
    table[1, :6] = (2, 3, 5, 6, 7, 8)
    n_alloc = np.asarray([3, 6], np.int32)
    fill = np.asarray([20, 0], np.int32)
    tau = np.asarray([7, 0], np.int32)
    tau_lp = np.zeros((B,), np.float32)
    dpos = np.asarray([20, 0], np.int32)
    active = np.asarray([True, False])
    remaining = np.asarray([12, 6], np.int32)
    stops = np.full((B, 1), -1, np.int32)
    temps = np.zeros((B,), np.float32)
    top_ps = np.ones((B,), np.float32)
    top_ks = np.zeros((B,), np.int32)
    suffix = np.zeros((64,), np.int32)
    suffix[:n_suffix] = rng.integers(1, 128, n_suffix)
    kw = dict(n_iter=2, pf_chunk=C, all_greedy=True,
              with_logprobs=with_logprobs)

    j = dict(pool=_jpool(k, v, pos), fill=jnp.asarray(fill),
             tau=jnp.asarray(tau), tau_lp=jnp.asarray(tau_lp),
             pos=jnp.asarray(dpos), active=jnp.asarray(active),
             remaining=jnp.asarray(remaining),
             keys=jnp.zeros((B, 2), jnp.uint32),
             pf_off=jnp.asarray(0, jnp.int32))
    t = torch.from_numpy
    p = dict(pool=_ppool(k, v, pos), fill=t(fill.copy()), tau=t(tau.copy()),
             tau_lp=t(tau_lp.copy()), pos=t(dpos.copy()),
             active=t(active.copy()), remaining=t(remaining.copy()))
    lane = t(np.asarray([1, n_suffix, base, 0], np.int32))
    row, n, b0, off = lane.unbind(0)
    for dispatch in range(3):
        jout = jserving._fused_chunk(
            jp, j["pool"], jnp.asarray(table), jnp.asarray(n_alloc),
            j["fill"], j["tau"], j["tau_lp"], j["pos"], j["active"],
            j["remaining"], jnp.asarray(stops), j["keys"],
            jnp.asarray(temps), jnp.asarray(top_ps), jnp.asarray(top_ks),
            jnp.asarray(1, jnp.int32), jnp.asarray(suffix),
            jnp.asarray(n_suffix, jnp.int32), jnp.asarray(base, jnp.int32),
            j["pf_off"], jnp.zeros((2,), jnp.uint32), config=jc, **kw)
        (jpacked, j["tau"], j["tau_lp"], j["fill"], j["pos"], j["active"],
         j["remaining"], j["keys"], j["pool"], j["pf_off"]) = jout
        pout = pserving._fused_chunk(
            pp, p["pool"], t(table), t(n_alloc), p["fill"], p["tau"],
            p["tau_lp"], p["pos"], p["active"], p["remaining"], t(stops),
            [None, None], t(temps), t(top_ps), t(top_ks), row, t(suffix), n,
            b0, off, None, config=pc, use_kernel=True, **kw)
        (ppacked, p["tau"], p["tau_lp"], p["fill"], p["pos"], p["active"],
         p["remaining"], p_off) = pout
        assert p_off is off and int(off) == 16 * (dispatch + 1)
        # The 16-token chunk at the 0-d device index ran the flash path,
        # once a layer.
        assert len(flash) == pc.n_layers * (dispatch + 1)
        jp_np = np.asarray(jpacked)
        np.testing.assert_array_equal(ppacked[0].numpy(), jp_np[0])
        if with_logprobs:
            np.testing.assert_allclose(ppacked[1].view(torch.float32).numpy(),
                                       jp_np[1].view(np.float32), atol=1e-5)
        for name in ("fill", "pos", "active", "remaining", "tau"):
            np.testing.assert_array_equal(p[name].numpy(),
                                          np.asarray(j[name]), err_msg=name)
        _assert_pools(j["pool"], p["pool"])
        # The row folds in on the final dispatch only, at fill0 + the
        # suffix rounded up to whole blocks.
        assert bool(p["active"][1]) == (dispatch == 2)
    # Folded at fill0 + the suffix in whole blocks, then two steps.
    assert int(p["fill"][1]) == base + 48 + 2
    assert int(p["pos"][1]) == base + n_suffix + 2


def test_fused_chunk_reads_no_host_scalar(model):
    """The lane scalars are 0-d tensors read on the device: a fused
    dispatch runs with them on the tensors' device and keeps its key when
    their values change (JAX traces them)."""
    _, _, pp, pc = model
    key = []
    for off in (0, 16):
        lane = torch.tensor([0, 40, 0, off], dtype=torch.int32)
        row, n, base, o = lane.unbind(0)
        key.append(pserving._fused_chunk.key(
            pp, pserving.init_pool(pc, 8, BLK, device="cpu"),
            torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32), *[torch.zeros(1)] * 7,
            [None], *[torch.zeros(1)] * 3, row, torch.zeros(64), n, base, o,
            None, config=pc, n_iter=1, pf_chunk=16, use_kernel=True))
    assert key[0] == key[1]


# ---------------------------------------------------------------------------
# _paged_insert with device block ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefill_chunk", [None, 16])
def test_paged_insert_device_block_ids_match_jax(model, prefill_chunk):
    """Four rows: a 3-block prompt, a 1-block prompt (its two trailing
    entries are sentinels) and two padding rows (all sentinel, no real
    token); the pool and the first tokens must be JAX's."""
    jp, jc, pp, pc = model
    rng = np.random.default_rng(9)
    k, v, pos = _pools(rng)
    kb, P, NB = 4, 48, 16
    toks = np.zeros((kb, P), np.int32)
    mask = np.zeros((kb, P), bool)
    toks[0, :40] = rng.integers(1, 128, 40)
    mask[0, :40] = True
    toks[1, :11] = rng.integers(1, 128, 11)
    mask[1, :11] = True
    bid = np.full((kb, P // BLK), NB, np.int32)
    bid[0] = (3, 9, 4)
    bid[1, 0] = 12
    temps = np.zeros((kb,), np.float32)
    top_ps = np.ones((kb,), np.float32)
    top_ks = np.zeros((kb,), np.int32)
    jtau, _, _, _, jpool = jserving._paged_insert(
        jp, _jpool(k, v, pos), jnp.asarray(bid), jnp.asarray(toks),
        jnp.asarray(mask), jnp.zeros((kb, 2), jnp.uint32),
        jnp.asarray(temps), jnp.asarray(top_ps), jnp.asarray(top_ks),
        config=jc, prefill_chunk=prefill_chunk)
    ppool = _ppool(k, v, pos)
    t = torch.from_numpy
    ptau, _ = pserving._paged_insert(
        pp, ppool, t(bid), t(toks), t(mask), [None] * kb, t(temps),
        t(top_ps), t(top_ks), config=pc, prefill_chunk=prefill_chunk)
    np.testing.assert_array_equal(ptau[:2].numpy(), np.asarray(jtau)[:2])
    _assert_pools(jpool, ppool)
    # Untouched blocks keep their bytes.
    for b in (0, 1, 2, 5, 15):
        assert torch.equal(ppool.k[:, :, b], torch.from_numpy(k[:, :, b]))


def test_paged_insert_all_sentinel_writes_nothing(model):
    _, _, pp, pc = model
    rng = np.random.default_rng(10)
    k, v, pos = _pools(rng)
    ppool = _ppool(k, v, pos)
    kb, P = 2, 16
    toks = torch.from_numpy(rng.integers(1, 128, (kb, P)).astype(np.int32))
    pserving._paged_insert(
        pp, ppool, torch.full((kb, 1), 16, dtype=torch.int32), toks,
        torch.ones((kb, P), dtype=torch.bool), [None] * kb,
        torch.zeros(kb), torch.ones(kb), torch.zeros(kb, dtype=torch.int32),
        config=pc)
    assert torch.equal(ppool.k, torch.from_numpy(k))
    assert torch.equal(ppool.v, torch.from_numpy(v))
    assert torch.equal(ppool.pos, torch.from_numpy(pos))


# ---------------------------------------------------------------------------
# forward at a 0-d device write index
# ---------------------------------------------------------------------------

def test_forward_at_a_device_index_matches_host_index_and_jax(
        model, monkeypatch):
    """A 12-token prefill, a 12-token chunk and a 1-token step through
    three caches: the host-int index, a 0-d device index and JAX's.  The
    device index resolves "auto" as the int does (flash at T > 8, each
    call launching the flash wrapper per layer) and advances on the
    device."""
    jp, jc, pp, pc = model
    calls = []
    real = pllama.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(pllama, "flash_attention", counting)
    rng = np.random.default_rng(4)
    B, S = 2, 32
    toks = rng.integers(1, 128, (B, 25)).astype(np.int32)
    host = pllama.init_cache(pc, B, max_len=S, device="cpu")
    dev = pllama.init_cache(pc, B, max_len=S, device="cpu")
    dev.index = torch.zeros((), dtype=torch.int32)
    jcache = jlt.init_cache(jc, B, max_len=S)
    for lo, hi in ((0, 12), (12, 24), (24, 25)):
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              (B, hi - lo)).copy()
        want, jcache = jlt.forward(jp, jnp.asarray(toks[:, lo:hi]),
                                   jnp.asarray(pos), jc, cache=jcache)
        outs = []
        for cache in (host, dev):
            n0 = len(calls)
            logits, got = ptl.forward(pp, torch.from_numpy(toks[:, lo:hi]),
                                      torch.from_numpy(pos), pc, cache=cache)
            assert got is cache
            outs.append((logits, len(calls) - n0))
        (lh, nh), (ld, nd) = outs
        assert nh == nd == (pc.n_layers if hi - lo > 8 else 0)
        np.testing.assert_allclose(ld.numpy(), lh.numpy(), atol=2e-4)
        np.testing.assert_allclose(ld.numpy(), np.asarray(want), atol=2e-4)
        assert host.index == hi and dev.index.dim() == 0
        assert int(dev.index) == hi
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(dev, name).numpy(),
                                   getattr(host, name).numpy(), atol=2e-4)
        np.testing.assert_allclose(
            getattr(dev, name).numpy(),
            np.asarray(getattr(jcache, name)), atol=2e-4)
    np.testing.assert_array_equal(dev.pos.numpy(), host.pos.numpy())


def test_device_index_write_clamps_as_jax():
    """A 0-d index whose window would pass the cache lands at S - T, as
    JAX's ``dynamic_update_slice`` clamps its start."""
    layer = torch.zeros((1, 6, 1, 1))
    new = torch.arange(1.0, 4.0).reshape(1, 3, 1, 1)
    pllama._cache_write(layer, new, torch.tensor(5, dtype=torch.int32))
    assert layer.flatten().tolist() == [0, 0, 0, 1, 2, 3]


# ---------------------------------------------------------------------------
# engine.generate and score as programs
# ---------------------------------------------------------------------------

def _prompts(B, P, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 128, (B, P)).astype(np.int32)
    mask = np.arange(P)[None, :] >= np.asarray([0, 3, 5][:B])[:, None]
    return np.where(mask, tokens, 0).astype(np.int32), mask


def test_generate_and_score_programs_key_like_jax(model):
    """The same calls through both packages from empty caches: tokens and
    scores equal, and each program's keys grow as JAX's jit cache
    entries do (a repeated shape adds none; a new prompt length, a new
    gen_config and a new batch add one each)."""
    jp, jc, pp, pc = model
    jax.clear_caches()
    programs.clear_caches()
    reg = programs.registry()
    calls = [(2, 8, 5, ()), (2, 8, 5, ()), (2, 12, 5, ()),
             (3, 8, 5, ()), (2, 8, 6, (9,))]
    for B, P, n, stops in calls:
        toks, mask = _prompts(B, P, seed=P + n)
        want = np.asarray(jengine.generate(
            jp, jnp.asarray(toks), jnp.asarray(mask), jax.random.PRNGKey(0),
            config=jc, gen_config=jengine.GenerationConfig(
                max_new_tokens=n, temperature=0.0, stop_tokens=stops)))
        got = pengine.generate(
            pp, torch.from_numpy(toks), torch.from_numpy(mask), None,
            config=pc, gen_config=pengine.GenerationConfig(
                max_new_tokens=n, temperature=0.0, stop_tokens=stops),
            device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    assert (reg["generate"].cache_size()
            == jengine.generate._cache_size() == 4)
    assert reg["_generate_step"].cache_size() == 4
    for B, T in ((2, 8), (2, 8), (2, 16)):
        toks, mask = _prompts(B, T, seed=T)
        want = np.asarray(jengine.score(jp, jnp.asarray(toks),
                                        jnp.asarray(mask), config=jc))
        got = pengine.score(pp, torch.from_numpy(toks),
                            torch.from_numpy(mask), config=pc)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert reg["score"].cache_size() == jengine.score._cache_size() == 2


def test_generate_stops_early_with_pad_after_the_stop(model):
    """A stop token that both rows emit early: the host reads ``done``
    every DONE_EVERY steps, the extra steps emit ``pad_id``, and the
    buffer is JAX's."""
    jp, jc, pp, pc = model
    toks, mask = _prompts(2, 8, seed=2)
    free = np.asarray(jengine.generate(
        jp, jnp.asarray(toks), jnp.asarray(mask), jax.random.PRNGKey(0),
        config=jc, gen_config=jengine.GenerationConfig(
            max_new_tokens=20, temperature=0.0)))
    stops = (int(free[0, 9]), int(free[1, 9]))
    gen = dict(max_new_tokens=20, temperature=0.0, stop_tokens=stops,
               pad_id=0)
    want = np.asarray(jengine.generate(
        jp, jnp.asarray(toks), jnp.asarray(mask), jax.random.PRNGKey(0),
        config=jc, gen_config=jengine.GenerationConfig(**gen)))
    got = pengine.generate(pp, torch.from_numpy(toks),
                           torch.from_numpy(mask), None, config=pc,
                           gen_config=pengine.GenerationConfig(**gen),
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 10:] == 0).all()


def test_generate_step_writes_in_place_at_the_device_index(model):
    """One ``_generate_step`` call: column ``cache.index`` of the buffer
    takes the pending token, the index advances by one on the device, and
    the arguments stay the same tensors."""
    _, _, pp, pc = model
    B, P, n = 2, 8, 4
    cache = pllama.init_cache(pc, B, max_len=P + n, device="cpu")
    cache.index = torch.tensor(P, dtype=torch.int32)
    index = cache.index
    buf = torch.zeros((B, P + n), dtype=torch.int32)
    nxt = torch.tensor([5, 6], dtype=torch.int32)
    done = torch.tensor([False, True])
    pengine._generate_step(
        pp, cache, buf, nxt, done, torch.tensor([8, 5], dtype=torch.int32),
        None, None, config=pc,
        gen_config=pengine.GenerationConfig(max_new_tokens=n,
                                            temperature=0.0))
    assert cache.index is index and int(index) == P + 1
    assert buf[:, P].tolist() == [5, 0]
    assert dataclasses.is_dataclass(cache)
