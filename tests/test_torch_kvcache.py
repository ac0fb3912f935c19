"""The port's KV-capacity host bookkeeping and device-boundary primitives
(``jax_llama_tpu_torch/kvcache.py``) held against the JAX package's
``kvcache.py`` on the CPU: ``chain_keys`` gives the bytes of JAX's
``router.chain_keys``; the same seeded sequence of publish, match,
retain, claim, unpublish, evict, demote, restore and host-tier calls on
each package's store gives identical match results, eviction order,
residency and ``KvDigest`` output (summary, node walk and journal; the
epoch is a fresh id per store); and the torch demote -> stage -> adopt
round trip lands a block bit-identical to the one demoted, int8 scale
planes included.  The module imports with ``jax`` and ``jax_llama_tpu``
blocked."""

import dataclasses
import gc
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax_llama_tpu import kvcache as jkv
from jax_llama_tpu.router import chain_keys as jax_chain_keys

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import kvcache as pkv
from jax_llama_tpu_torch.serving import init_pool

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=256, dtype="float32",
           param_dtype="float32")


def test_kvcache_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jax_llama_tpu'] = None; "
            "import jax_llama_tpu_torch.kvcache as k; "
            "import jax_llama_tpu_torch.serving; "
            "print(k.chain_keys(list(range(9)), 4)[0].hex())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == jax_chain_keys(list(range(9)), 4)[0].hex()


@pytest.mark.parametrize("n,block_size,seed", [
    (1, 4, 0), (4, 4, 1), (5, 4, 2), (17, 16, 3), (1024, 128, 4),
    (1025, 128, 5), (300, 7, 6),
])
def test_chain_keys_bytes_match_jax(n, block_size, seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 128256, size=n).tolist()
    got = pkv.chain_keys(tokens, block_size)
    assert got == jax_chain_keys(tokens, block_size)
    assert len(got) == (n - 1) // block_size
    # numpy ints and python ints hash alike (the int32 bytes)
    assert pkv.chain_keys(np.asarray(tokens), block_size) == got


# ---------------------------------------------------------------------------
# One operation sequence through both packages' stores
# ---------------------------------------------------------------------------

def _digest_view(store):
    """The store's digest output with the per-instance epoch removed."""
    d = store.digest
    summary = {k: v for k, v in d.summary().items() if k != "epoch"}
    return summary, d.nodes_json(), d.events_since(0)


def _match_view(m):
    return (list(m.blocks), [n.key for n in m.path],
            [n.key for n in m.restore])


def _ops(seed, n_ops=160):
    """A seeded operation script over a small key universe: chains share
    prefixes (a tree of depth <= 4 over 3 branch choices per level)."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["publish", "match", "retain", "claim",
                           "unpublish", "evict", "demote", "restore",
                           "abort", "demote_keys"],
                          p=[.22, .14, .14, .1, .04, .12, .08, .06, .04,
                             .06])
        depth = int(rng.randint(1, 5))
        branch = [int(b) for b in rng.randint(0, 3, size=depth)]
        keys = [bytes(branch[:i + 1]) * 4 for i in range(depth)]
        blocks = [int(b) for b in rng.randint(0, 48, size=depth)]
        ops.append((str(kind), keys, blocks))
    return ops


def _run_script(mod, mode, host_blocks, seed):
    """Apply ``_ops(seed)`` to ``mod``'s store; returns the trace of every
    result the store gave."""
    store = mod.make_prefix_store(mode, host_blocks=host_blocks)
    trace = []
    restoring = []

    def demote(blk):
        return {"blk": blk}

    for kind, keys, blocks in _ops(seed):
        if kind == "publish":
            trace.append(("publish", store.publish(keys, blocks)))
        elif kind == "match":
            trace.append(("match", _match_view(store.match(keys))))
        elif kind == "retain":
            trace.append(("retain", store.retain(
                [b for b in blocks if store.is_keyed(b)])))
        elif kind == "claim":
            trace.append(("claim", store.on_claim(blocks)))
        elif kind == "unpublish":
            trace.append(("unpublish", store.unpublish(blocks[0])))
        elif kind in ("evict", "demote"):
            # "demote" offers the callback to every store (only a tier
            # uses it); "evict" only where there is a tier.
            trace.append((kind, store.pop_evictable(
                demote if host_blocks or kind == "demote" else None)))
        elif kind == "demote_keys":
            trace.append(("demote_keys", store.demote_keys(
                keys, demote if host_blocks else None)))
        elif kind == "restore" and mode == "radix":
            # The chain of the first (by key) reachable demoted node.
            demoted = sorted(k for k, n in store._by_key.items()
                             if n.host is not None and not n.restoring)
            if demoted:
                node, keys = store._by_key[demoted[0]], []
                while node.parent is not None:
                    keys.insert(0, node.key)
                    node = node.parent
            m = store.match(keys)
            if m.restore:
                store.pin_restoring(m.restore)
                restoring.append(m.restore)
                trace.append(("pin", [n.key for n in m.restore]))
            elif restoring:
                nodes = restoring.pop(0)
                fresh = [100 + i for i in range(len(nodes))]
                store.complete_restore(nodes, fresh)
                trace.append(("complete", [n.key for n in nodes]))
        elif kind == "abort" and restoring:
            store.unpin_restoring(restoring.pop())
            trace.append(("abort",))
        trace.append(("state", store.evictable(), store.cached_blocks(),
                      store.nodes_total(), store.host_blocks(),
                      sorted(map(sorted, store.resident_chains()))))
    trace.append(("digest", _digest_view(store)))
    return trace


@pytest.mark.parametrize("mode,host_blocks", [
    ("radix", 0), ("radix", 3), ("exact", 0), ("off", 0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_store_operation_sequences_match_jax(mode, host_blocks, seed):
    want = _run_script(jkv, mode, host_blocks, seed)
    got = _run_script(pkv, mode, host_blocks, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)


def test_host_tier_lru_and_pins_match_jax():
    traces = []
    for mod in (jkv, pkv):
        tier = mod.HostTier(2)
        tr = [tier.put(b"a", {}), tier.put(b"b", {})]
        tier.pinned.add(b"a")
        tr += [tier.put(b"c", {}), len(tier), tier.get(b"b")]
        tier.pinned.add(b"c")
        tr += [tier.put(b"d", {}), len(tier)]
        tier.drop(b"a")
        tr += [len(tier), tier.put(b"e", {}), sorted(tier._slabs)]
        traces.append(tr)
    assert traces[0] == traces[1]


# ---------------------------------------------------------------------------
# Device-boundary primitives (the CPU path: copies run as called)
# ---------------------------------------------------------------------------

def _filled_pool(int8, n_blocks=4, block_size=8, seed=0):
    config = ptl.get_config("tiny", **CFG)
    if int8:
        config = config.replace(kv_cache_dtype="int8")
    pool = init_pool(config, n_blocks, block_size, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for name in ("k", "v", "pos", "k_scale", "v_scale"):
        a = getattr(pool, name)
        if a is None:
            continue
        if a.dtype == torch.int8:
            a.copy_(torch.randint(-127, 127, a.shape, generator=g))
        elif a.dtype == torch.int32:
            a.copy_(torch.randint(0, 50, a.shape, generator=g))
        else:
            a.copy_(torch.randn(a.shape, generator=g))
    return pool


def _block(pool, blk):
    return {n: (getattr(pool, n)[blk] if n == "pos"
                else getattr(pool, n)[:, :, blk]).clone()
            for n in ("k", "v", "pos", "k_scale", "v_scale")
            if getattr(pool, n) is not None}


@pytest.mark.parametrize("int8", [False, True])
def test_demote_restore_round_trip_bit_exact(int8):
    """fetch_slab into an arena slab, then stage_restore and
    adopt_into_pool into a DIFFERENT block: bit-identical (JAX's
    test_demote_restore_round_trip_bit_exact, through the port's
    primitives); the JAX primitives on the same bytes land the same."""
    pool = _filled_pool(int8)
    want = _block(pool, 2)
    arena = pkv.SlabArena([("", pool)], 2, pin=False)
    slab = pkv.fetch_slab(pool, 2, into=arena.take())
    pool.pos[2] = -1  # what the allocator's invalidation does
    staged = pkv.stage_restore([slab], [1], sentinel=4)
    assert pkv.restore_ready(staged) and staged.n == 1
    assert staged.ids.tolist() == [1]
    pkv.adopt_into_pool(pool, staged)
    got = _block(pool, 1)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # JAX's primitives over the same slab (as numpy) give the same block.
    from jax_llama_tpu.serving import init_pool as jinit_pool
    import jax_llama_tpu as jlt

    jc = jlt.get_config("tiny", **CFG)
    if int8:
        jc = dataclasses.replace(jc, kv_cache_dtype="int8")
    jpool = jinit_pool(jc, n_blocks=4, block_size=8)
    jstaged = jkv.stage_restore(
        [{k: v.numpy() for k, v in slab.items()}], [1], sentinel=4)
    jpool = jkv.adopt_into_pool(jpool, jstaged)
    for name in want:
        a = getattr(jpool, name)
        jgot = np.asarray(a[1] if name == "pos" else a[:, :, 1])
        np.testing.assert_array_equal(jgot, want[name].numpy(), name)


def test_stage_restore_pads_ids_to_pow2_with_the_sentinel():
    pool = _filled_pool(False, n_blocks=8)
    slabs = [pkv.fetch_slab(pool, b) for b in (0, 1, 2)]
    staged = pkv.stage_restore(slabs, [5, 6, 7], sentinel=8)
    assert staged.ids.tolist() == [5, 6, 7, 8] and staged.n == 3
    assert staged.planes["k"].shape[0] == 4
    want = [_block(pool, b) for b in (0, 1, 2)]
    pkv.adopt_into_pool(pool, staged)
    for b, w in zip((5, 6, 7), want):
        got = _block(pool, b)
        assert all(torch.equal(got[n], w[n]) for n in w)
    assert pkv.pool_block_bytes(pool) == sum(
        getattr(pool, n).nbytes for n in ("k", "v", "pos")) // 8


def test_slab_arena_reuses_released_slots():
    """A slot comes back when the last reference to its slab goes; past
    capacity the arena allocates slabs of its own."""
    pool = _filled_pool(True)
    arena = pkv.SlabArena([("", pool), ("d_", pool)], 2, pin=False)
    a, b = arena.take(), arena.take()
    assert len(arena) == 0
    assert sorted(a) == sorted(["k", "v", "pos", "k_scale", "v_scale",
                                "d_k", "d_v", "d_pos", "d_k_scale",
                                "d_v_scale"])
    c = arena.take()  # overflow: its own tensors
    assert arena.overflow_total == 1
    ptr = a["k"].data_ptr()
    del a, c
    gc.collect()
    assert len(arena) == 1
    d = arena.take()
    assert d["k"].data_ptr() == ptr
    pkv.fetch_slab(pool, 3, into=d)
    assert torch.equal(d["k"], pool.k[:, :, 3])
    pkv.fetch_slab(pool, 1, prefix="d_", into=d)
    assert torch.equal(d["d_v_scale"], pool.v_scale[:, :, 1])
