"""Cache-aware routing in the port held against the JAX package's
(tests/test_cache_routing.py's drills): ``RouterRadixIndex`` driven by
the same seeded sequences of ``replace``/``apply_events``/
``note_handoff``/``drop_replica`` answers every ``lookup`` and ``stats``
as JAX's; an epoch change forces a full resync in both; ``_pick_locked``
(and so ``_cache_pick_locked``) takes JAX's decision on the same
candidate info, spill watermark and handoff plan included; a stale digest
is counted.  On the port's batchers: export bounds and the digest delta of
``demote_after_export`` are JAX's, and an import timeout unwinds.  On a
routed port fleet (two ``LLMServer`` replicas, tiny float32 weights from
``from_jax_params``): a deep hit routes to the holder with the JAX
batcher's tokens, a spill schedules a handoff and the chain migrates, a
stale route degrades to a counted cold prefill, a replica fault in the
middle of a handoff re-routes losslessly, prefill/decode disaggregation
hands the chain to the decode replica, and the index syncs incrementally
off the health poll."""

import json
import urllib.request

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
from jax_llama_tpu import router as jrouter
from jax_llama_tpu.serving import ContinuousBatcher as JBatcher

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import kvcache as pkvcache
from jax_llama_tpu_torch import router as prouter
from jax_llama_tpu_torch import serving as pserving
from jax_llama_tpu_torch.faults import FaultInjector
from jax_llama_tpu_torch.server import LLMServer
from jax_llama_tpu_torch.tokenizers.bytes import ByteTokenizer

CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")
# Two chain-key blocks at block_size 16 (41 tokens with the byte
# tokenizer's bos), inside max_len 64 with the new tokens.
SESSION = "the quick brown fox jumps over the lazy d"
REVISIT = SESSION + " next!"
OTHER = "a completely different conversation starts h"
ROUTERS = {"jax": jrouter, "port": prouter}


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return {"jax": (jp, jc), "port": (pp, ptl.get_config("tiny", **CFG))}


def _batcher(model, pkg, **kw):
    kw = dict(dict(n_slots=2, max_len=64), **kw)
    params, config = model[pkg]
    stops = tuple(ByteTokenizer().stop_tokens)
    if pkg == "jax":
        return JBatcher(params, config, stop_tokens=stops, **kw)
    return ptl.ContinuousBatcher(params, config, device="cpu",
                                 stop_tokens=stops, **kw)


def _serve(cb, prompts, max_new=6, seeds=None):
    tok = ByteTokenizer()
    rids = [cb.submit(tok.encode(p, bos=True), max_new_tokens=max_new,
                      **({"seed": seeds[i]} if seeds else {}))
            for i, p in enumerate(prompts)]
    done = cb.run_to_completion()
    return [done[r] for r in rids]


@pytest.fixture(scope="module")
def oracle(model):
    """The JAX batcher's greedy tokens: SESSION cold, then REVISIT on the
    batcher that served it, and OTHER."""
    cb = _batcher(model, "jax")
    cold = _serve(cb, [SESSION])[0]
    return {"cold": cold, "revisit": _serve(cb, [REVISIT])[0],
            "other": _serve(_batcher(model, "jax"), [OTHER], 4)[0]}


def _post(url, payload, path="/generate", timeout=300):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _stream_tokens(url, payload, timeout=300):
    req = urllib.request.Request(
        url + "/generate",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    toks = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        hdrs = dict(r.headers)
        for line in r:
            obj = json.loads(line)
            if "token" in obj:
                toks.append(obj["token"])
    return toks, hdrs


class _Fleet:
    """Two started port replicas behind a cache-aware router with manual
    health polls."""

    def __init__(self, model, **router_kw):
        tok = ByteTokenizer()
        self.servers = [LLMServer(_batcher(model, "port"), tokenizer=tok,
                                  replica_id=i).start() for i in range(2)]
        router_kw.setdefault("policy", "cache-aware")
        router_kw.setdefault("health_interval_s", 0)
        router_kw.setdefault("tokenizer", tok)
        router_kw.setdefault("block_size",
                             self.servers[0].batcher.block_size)
        self.router = prouter.ReplicaRouter(self.servers,
                                            **router_kw).start()

    def __enter__(self):
        return self.router, self.servers

    def __exit__(self, *exc):
        self.router.stop()
        for s in self.servers:
            s.stop()


# ---------------------------------------------------------------------------
# Host-only units, each run on both packages
# ---------------------------------------------------------------------------

def test_chain_keys_is_the_one_schema():
    """The router's chain_keys is kvcache's (one implementation for the
    router, the batcher's index and the digest journal), JAX's byte for
    byte."""
    assert prouter.chain_keys is pkvcache.chain_keys
    toks = list(range(1, 40))
    assert prouter.chain_keys(toks, 16) == jrouter.chain_keys(toks, 16)
    assert prouter.chain_keys(toks, 16) == \
        pserving.ContinuousBatcher._chain_keys(toks, 16)
    assert prouter.chain_keys(toks[:10], 16) == []


def _index_script(seed, n_ops=60):
    """A seeded op sequence over 3 replicas and 3 chains of 4 keys."""
    rng = np.random.RandomState(seed)
    chains = [[f"{c:02x}{j:02x}" * 4 for j in range(4)] for c in range(3)]
    ops = []
    version = [0, 0, 0]
    for _ in range(n_ops):
        r = int(rng.randint(3))
        kind = rng.choice(["replace", "events", "events", "handoff",
                           "drop"], p=[0.2, 0.25, 0.25, 0.2, 0.1])
        version[r] += int(rng.randint(1, 4))
        if kind == "replace":
            nodes = []
            for c in rng.choice(3, size=int(rng.randint(0, 3)),
                                replace=False):
                depth = int(rng.randint(1, 5))
                nodes += [{"key": k, "depth": j + 1,
                           "tier": str(rng.choice(["hbm", "host"]))}
                          for j, k in enumerate(chains[c][:depth])]
            ops.append(("replace", r, nodes, version[r],
                        int(rng.choice([0, 512, 1024])),
                        str(rng.choice(["e1", "e2"]))))
        elif kind == "events":
            evs = []
            for _ in range(int(rng.randint(1, 5))):
                c, j = int(rng.randint(3)), int(rng.randint(4))
                op = str(rng.choice(["publish", "remove", "demote",
                                     "restore", "host_evict"]))
                evs.append({"op": op, "key": chains[c][j], "depth": j + 1,
                            "tier": "host" if op == "demote" else "hbm"})
            ops.append(("events", r, evs, version[r]))
        elif kind == "handoff":
            c = int(rng.randint(3))
            ops.append(("handoff", r, int((r + 1 + rng.randint(2)) % 3),
                        chains[c][:int(rng.randint(1, 5))]))
        else:
            ops.append(("drop", r))
    probes = [(chains[c][:d], frozenset(s))
              for c in range(3) for d in (1, 4)
              for s in ({0}, {1, 2}, {0, 1, 2})]
    return ops, probes


def _index_trace(mod, ops, probes):
    idx = mod.RouterRadixIndex()
    out = []
    for op in ops:
        if op[0] == "replace":
            idx.replace(op[1], op[2], version=op[3], block_bytes=op[4],
                        epoch=op[5])
        elif op[0] == "events":
            idx.apply_events(op[1], op[2], version=op[3])
        elif op[0] == "handoff":
            idx.note_handoff(op[1], op[2], op[3])
        else:
            idx.drop_replica(op[1])
        out.append((
            [idx.lookup(keys, reps) for keys, reps in probes],
            idx.stats(),
            [(idx.synced_version(r), idx.synced_epoch(r),
              idx.block_bytes(r)) for r in range(3)],
        ))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_radix_index_matches_jax(seed):
    ops, probes = _index_script(seed)
    got = _index_trace(prouter, ops, probes)
    want = _index_trace(jrouter, ops, probes)
    assert got == want
    # The script reaches hits, misses, both tiers and resyncs.
    flat = [r for step in got for r in step[0]]
    assert any(r is None for r in flat) and any(r for r in flat)
    assert got[-1][1]["resyncs_total"] >= 1


def _resync_asked(mod, monkeypatch):
    router = mod.ReplicaRouter(["127.0.0.1:1"], policy="cache-aware",
                               health_interval_s=0, block_size=16)
    router.index.replace(0, [], version=9, epoch="epoch-A")
    asked = []

    def fake_get(rep, path, timeout=2.0):
        asked.append(path)
        return 200, {"version": 9, "nodes": [],
                     "summary": {"epoch": "epoch-B"}}

    monkeypatch.setattr(router, "_get_replica_json", fake_get)
    rep = router._replicas[0]
    for version in (9, 9, 11):
        router._sync_index(rep, {
            "kv": {"digest": {"version": version, "epoch": "epoch-B"}}})
    return asked, router.index.synced_epoch(0)


def test_epoch_change_forces_full_resync(monkeypatch):
    """A new digest epoch at the same version fetches the full walk; the
    same epoch and version fetch nothing; a newer version is incremental
    and uncapped — the same fetches as JAX's router."""
    got = _resync_asked(prouter, monkeypatch)
    assert got == _resync_asked(jrouter, monkeypatch)
    assert got == (["/debug/kv?n=1000000", "/debug/kv?since=9&n=1000000"],
                   "epoch-B")


K = [bytes([i]).hex() * 2 for i in range(3)]
PICKS = {
    # (holder inflight, request keys, holder's live digest version)
    "deep_hit": (0, K[:2], 1),
    "spill_with_plan": (2, K[:2], 1),
    "cold": (2, [K[2]], 1),
    "stale": (0, K[:1], 7),
}


def _pick(mod, case):
    inflight, keys, live = PICKS[case]
    router = mod.ReplicaRouter(
        ["127.0.0.1:1", "127.0.0.1:2"], policy="cache-aware",
        health_interval_s=0, block_size=16, handoff_threshold=1.0,
        handoff_min_depth=1)
    router.index.replace(
        0, [{"key": K[0], "depth": 1, "tier": "hbm"},
            {"key": K[1], "depth": 2, "tier": "hbm"}],
        version=1, block_bytes=512)
    for rep in router._replicas:
        rep.last_health = {
            "replica": {"n_slots": 2},
            "kv": {"digest": {"version": live if rep.index == 0 else 0}}}
    router._replicas[0].inflight = inflight
    with router._lock:
        rep, how, stale, plan, dec = router._pick_locked(
            None, frozenset(), keys)
    counters = (router.cache_hit_depth_blocks_total,
                router.cache_stale_routes_total)
    if plan is not None:
        router._schedule_handoff(plan, None)
    counters += (router.handoffs_skipped_total,
                 router.handoffs_scheduled_total)
    return rep.index, how, stale, plan, dec, counters


@pytest.mark.parametrize("case", sorted(PICKS))
def test_cache_pick_matches_jax(case):
    """The pick decision table on the same candidate info: a deep hit
    routes to the holder, past the watermark it spills to least-loaded
    with a migration plan (which the scheduler skips: out-of-process
    replicas cannot hand off), a cold prompt goes least-loaded, a holder
    whose live digest moved past the synced one is a counted stale
    route."""
    got, want = _pick(prouter, case), _pick(jrouter, case)
    assert got == want
    index, how, stale, plan, dec, counters = got
    expect = {"deep_hit": (0, "cache-aware", False),
              "spill_with_plan": (1, "spill", False),
              "cold": (1, "least-loaded", False),
              "stale": (0, "cache-aware", True)}[case]
    assert (index, how, stale) == expect
    if case == "spill_with_plan":
        assert plan == {"src": 0, "dst": 1, "keys_hex": K[:2], "depth": 2}
        assert dec["spill_from"] == 0 and dec["handoff_score"] >= 1.0
        assert counters[2:] == (1, 0)
    if case == "stale":
        assert counters[1] == 1


def test_router_refusals_match_jax():
    for mod in ROUTERS.values():
        with pytest.raises(ValueError, match="block_size"):
            mod.ReplicaRouter(["127.0.0.1:1"], policy="cache-aware")
        with pytest.raises(ValueError, match="EACH role"):
            mod.ReplicaRouter(["127.0.0.1:1", "127.0.0.1:2"],
                              policy="cache-aware", block_size=16,
                              roles=("prefill", "prefill"))
        with pytest.raises(ValueError, match="cache-aware policy"):
            mod.ReplicaRouter(["127.0.0.1:1", "127.0.0.1:2"],
                              policy="least-loaded",
                              roles=("prefill", "decode"))


# ---------------------------------------------------------------------------
# The batcher's side of a handoff: bounds, demote-after-export, unwind
# ---------------------------------------------------------------------------

def _export_story(model, pkg):
    tok = ByteTokenizer()
    src = _batcher(model, pkg)
    _serve(src, [SESSION])
    toks = tok.encode(SESSION, bos=True)
    keys = src._chain_keys(toks, src.block_size)
    capped, slabs = src.export_prefix(toks, max_bytes=src.block_bytes)
    story = [len(keys), len(slabs), capped == keys[:1]]
    before = src.kv_digest.summary()
    free_before = len(src.free_blocks)
    full_keys, slabs = src.export_prefix(keys=keys,
                                         demote_after_export=True)
    after = src.kv_digest.summary()
    story += [len(slabs), full_keys == keys,
              before["hbm_blocks"] - after["hbm_blocks"],
              after["loss_version"] - before["loss_version"],
              src.kv_export_demoted_blocks_total,
              len(src.free_blocks) - free_before,
              src.export_prefix(keys=keys) == ([], [])]
    dst = _batcher(model, pkg)
    story.append(dst.import_prefix(full_keys, slabs))
    hits = dst.prefix_requests_hit
    tokens = _serve(dst, [REVISIT], seeds=[5])[0]
    story += [dst.prefix_requests_hit - hits,
              dst.prefix_hit_tokens_total >= 2 * dst.block_size]
    return story, tokens


def test_export_bounds_and_demote_after_export_match_jax(model):
    """A byte cap truncates the export block-aligned from the root;
    demote-after-export drops the chain's HBM residency (the digest's
    hbm count falls by 2, its loss_version moves) and frees the blocks;
    the import lands the chain and the revisit hits — each step's count
    JAX's."""
    got, got_tokens = _export_story(model, "port")
    want, _ = _export_story(model, "jax")
    assert got == want
    assert got[:3] == [2, 1, True] and got[3] == 2 and got[5] == 2
    assert got[-3:] == [2, 1, True]
    assert len(got_tokens) > 0


def test_import_timeout_unwinds_cleanly(model, monkeypatch):
    """A staged transfer that never lands unwinds at its timeout: the
    blocks are freed, nothing is published, the abort is counted, and a
    later retry of the same slabs lands."""
    src = _batcher(model, "port")
    _serve(src, [SESSION])
    keys, slabs = src.export_prefix(ByteTokenizer().encode(SESSION,
                                                           bos=True))
    dst = _batcher(model, "port")
    free_before = len(dst.free_blocks)
    monkeypatch.setattr(pserving, "restore_ready", lambda staged: False)
    with pytest.raises(TimeoutError):
        dst.import_prefix(keys, slabs, timeout_s=0.02)
    assert dst.kv_handoff_aborted_total == 1
    assert len(dst.free_blocks) == free_before
    assert dst.kv_digest.summary()["nodes"] == 0
    monkeypatch.undo()
    assert dst.import_prefix(keys, slabs, timeout_s=30.0) == len(slabs)
    assert dst.kv_digest.summary()["nodes"] == len(slabs)


# ---------------------------------------------------------------------------
# Routed port fleets
# ---------------------------------------------------------------------------

def test_cache_aware_deep_hit_token_identical_to_oracle(model, oracle):
    """The revisit of a warm session routes to the replica holding its
    chain (not the least-loaded one) with the JAX batcher's tokens:
    greedy, seeded and streaming."""
    with _Fleet(model) as (router, servers):
        st, body, hdrs = _post(router.address,
                               {"text": SESSION, "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == oracle["cold"]
        warm = int(hdrs["X-Replica-Id"])
        router.check_health_now()
        assert router.index.stats()["nodes"] >= 2
        _, body, hdrs = _post(router.address,
                              {"text": OTHER, "max_new_tokens": 4})
        assert int(hdrs["X-Replica-Id"]) != warm
        assert body["tokens"] == oracle["other"]
        _, body, hdrs = _post(router.address,
                              {"text": REVISIT, "max_new_tokens": 6})
        assert int(hdrs["X-Replica-Id"]) == warm
        assert body["tokens"] == oracle["revisit"]
        _, body, hdrs = _post(router.address, {
            "text": REVISIT, "max_new_tokens": 6, "seed": 11})
        assert int(hdrs["X-Replica-Id"]) == warm
        # A seeded draw is the port's own generator (not threefry): the
        # same seed on one port batcher gives the same tokens.
        cb = _batcher(model, "port")
        _serve(cb, [SESSION])
        assert body["tokens"] == _serve(cb, [REVISIT], seeds=[11])[0]
        toks, hdrs = _stream_tokens(router.address,
                                    {"text": REVISIT, "max_new_tokens": 6})
        assert toks == oracle["revisit"]
        assert int(hdrs["X-Replica-Id"]) == warm
        assert router.routed_by_policy["cache-aware"] >= 3
        dec = router.decisions.json(n=64, kind="route")["decisions"]
        assert any(d.get("hit_depth") == 2 for d in dec)
        assert "llm_router_cache_index_nodes" in router.metrics_text()
        h = router.health()
        assert h["cache_index"]["nodes"] >= 2
        assert h["cache_index"]["syncs_total"] >= 1


def test_spill_schedules_handoff_and_chain_migrates(model, oracle):
    """A loaded holder spills the revisit to the other replica and the
    chain migrates there (export, import, demote-after-export through
    ``call_on_loop``); the next revisit routes to the new home as a
    prefix hit, with the JAX batcher's tokens."""
    with _Fleet(model, handoff_threshold=0.5, handoff_min_depth=1) as (
            router, servers):
        _, _, hdrs = _post(router.address,
                           {"text": SESSION, "max_new_tokens": 6})
        src = int(hdrs["X-Replica-Id"])
        dst = 1 - src
        router.check_health_now()
        src_hbm = servers[src].batcher.kv_digest.summary()["hbm_blocks"]
        assert src_hbm >= 2
        with router._lock:
            router._replicas[src].inflight = 4
        st, body, hdrs = _post(router.address,
                               {"text": REVISIT, "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == oracle["revisit"]
        assert int(hdrs["X-Replica-Id"]) == dst
        assert router.wait_handoffs(20.0)
        with router._lock:
            done = (router.handoffs_scheduled_total,
                    router.handoffs_completed_total
                    + router.handoffs_empty_total,
                    router.handoffs_aborted_total)
            assert router.kv_handoffs_total == \
                router.handoffs_completed_total
        assert done == (1, 1, 0)
        assert servers[dst].batcher.kv_digest.summary()["hbm_blocks"] >= 2
        assert servers[src].batcher.kv_digest.summary()["hbm_blocks"] < \
            src_hbm
        assert servers[src].batcher.kv_export_demoted_blocks_total > 0
        with router._lock:
            router._replicas[src].inflight = 0
        router.check_health_now()
        hits = servers[dst].batcher.prefix_requests_hit
        _, body, hdrs = _post(router.address,
                              {"text": REVISIT, "max_new_tokens": 6})
        assert body["tokens"] == oracle["revisit"]
        assert int(hdrs["X-Replica-Id"]) == dst
        assert servers[dst].batcher.prefix_requests_hit == hits + 1


def test_stale_route_degrades_to_counted_cold_prefill(model, oracle):
    """The holder lost the chain after the index synced: the route still
    lands there, counted stale, and the tokens are the oracle's."""
    with _Fleet(model) as (router, servers):
        _, _, hdrs = _post(router.address,
                           {"text": SESSION, "max_new_tokens": 6})
        warm = int(hdrs["X-Replica-Id"])
        router.check_health_now()

        def drop_chains(b):
            freed = []
            for blk in list(b._store._by_block.keys()):
                freed.extend(b._store.unpublish(blk))
            b._invalidate_and_free(freed)
            return b.kv_digest.summary()["loss_version"]

        assert servers[warm].call_on_loop(drop_chains) > 0
        rep = router._replicas[warm]
        ok, payload = router._probe(rep)
        assert ok
        with router._lock:
            rep.last_health = payload
        st, body, hdrs = _post(router.address,
                               {"text": REVISIT, "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == oracle["revisit"]
        assert int(hdrs["X-Replica-Id"]) == warm
        assert router.cache_stale_routes_total >= 1


def test_mid_handoff_replica_fault_reroutes_losslessly(model, oracle):
    """A ``router_replica`` fault on the forward made while a handoff is
    scheduled re-routes the request before its first byte, with the
    oracle's tokens."""
    with _Fleet(model, handoff_threshold=0.5,
                fault_injector=FaultInjector("router_replica@1:error")) as (
            router, servers):
        _, body, hdrs = _post(router.address,
                              {"text": SESSION, "max_new_tokens": 6})
        assert body["tokens"] == oracle["cold"]
        router.check_health_now()
        with router._lock:
            router._replicas[int(hdrs["X-Replica-Id"])].inflight = 4
        st, body, _ = _post(router.address,
                            {"text": SESSION, "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == oracle["cold"]
        assert router.reroutes_total == 1
        assert router.wait_handoffs(20.0)
        router.check_health_now()
        assert all(r["healthy"] for r in router.health()["replicas"])


def test_prefill_decode_disaggregation_smoke(model, oracle):
    """Roles prefill, decode: the cold session prefills on replica 0,
    its chain streams to replica 1 when it completes, and the revisit
    decodes there warm, with the oracle's tokens throughout."""
    with _Fleet(model, roles=("prefill", "decode")) as (router, servers):
        st, body, hdrs = _post(router.address,
                               {"text": SESSION, "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == oracle["cold"]
        assert int(hdrs["X-Replica-Id"]) == 0
        assert router.routed_by_policy["prefill-role"] >= 1
        assert router.wait_handoffs(20.0)
        assert router.handoffs_completed_total == 1
        assert servers[1].batcher.kv_digest.summary()["hbm_blocks"] >= 2
        hits = servers[1].batcher.prefix_requests_hit
        _, body, hdrs = _post(router.address,
                              {"text": REVISIT, "max_new_tokens": 6})
        assert body["tokens"] == oracle["revisit"]
        assert int(hdrs["X-Replica-Id"]) == 1
        assert servers[1].batcher.prefix_requests_hit == hits + 1
        assert router.health()["roles"] == ["prefill", "decode"]


def test_incremental_sync_rides_health_poll(model):
    """After the first full walk, later digest deltas arrive as journal
    events on the health poll (no further resync), and the replica's
    /debug/kv?since= answers with the events form or, from a future
    version, the resync walk."""
    with _Fleet(model) as (router, servers):
        _post(router.address, {"text": SESSION, "max_new_tokens": 4})
        router.check_health_now()
        st1 = router.index.stats()
        assert st1["nodes"] >= 2
        _post(router.address, {"text": OTHER, "max_new_tokens": 4})
        router.check_health_now()
        st2 = router.index.stats()
        assert st2["nodes"] > st1["nodes"]
        assert st2["events_applied_total"] >= 1
        assert st2["resyncs_total"] == st1["resyncs_total"]
        ver = servers[0].batcher.kv_digest.summary()["version"]
        with urllib.request.urlopen(
                servers[0].address + f"/debug/kv?since={ver}",
                timeout=30) as r:
            doc = json.loads(r.read())
        assert doc["events"] == [] and doc["version"] == ver
        with urllib.request.urlopen(
                servers[0].address + f"/debug/kv?since={ver + 9999}",
                timeout=30) as r:
            doc = json.loads(r.read())
        assert doc.get("resync") is True and "nodes" in doc
