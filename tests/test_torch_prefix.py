"""The port's prefix cache, host tier and prefix export/import held against
the JAX package's ``ContinuousBatcher`` at its defaults (radix index, the
cache on) on the same tiny float32 weights (``from_jax_params``), CPU.

A chat with one shared system prompt (wave 1: one warm request alone,
then three more; wave 2: two second turns that extend a wave-1 prompt
past the system prompt) gives the JAX batcher's greedy tokens and the
same ``stats()`` prefix, radix, swap and digest values, with and without
the host tier (a demotion sweep between the waves), at decode_chunk 1
and 8, on the radix and exact indexes, over int8 pools and under
self-draft speculation; ``kv_debug_json`` is JAX's too (the epoch is a
fresh id per store).  Sampled rows are held hit against cold within the
port (its generator is not JAX's threefry).  The JAX drills of
``tests/test_kvcache.py`` run through the port, each against a cold
batcher's tokens.  ``export_prefix`` from one port batcher lands in
another with ``import_prefix`` as a full-depth hit.  The HTTP server's
``/debug/kv`` and ``/healthz`` ``kv`` section equal the JAX server's on
the same traffic, and ``run.py`` hands the batcher the JAX CLI's prefix
arguments."""

import dataclasses
import io
import json
import sys
import urllib.request

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
from jax_llama_tpu.serving import ContinuousBatcher as JaxBatcher

import jax_llama_tpu_torch as ptl

from test_torch_run_cli import ckpts  # noqa: F401 - the CLI's checkpoints

CFG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=256, dtype="float32",
           param_dtype="float32")
BS = 16  # block size throughout
GEOM = dict(n_slots=2, max_len=128, block_size=BS)
# The stats() keys held equal to JAX's: every prefix, radix, swap, host
# tier and digest key but the swap-in wall time.
KV_KEYS = ("prefix_", "radix_", "swap_", "host_kv_", "host_tier_", "kv_")


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    pp = ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, jc, pp, ptl.get_config("tiny", **CFG)


def _int8(model):
    jp, jc, pp, pc = model
    return (jp, dataclasses.replace(jc, kv_cache_dtype="int8"), pp,
            pc.replace(kv_cache_dtype="int8"))


def _jax(model, spec=False, **kw):
    jp, jc, _, _ = model
    if spec:
        kw.update(draft_params=jp, draft_config=jc, n_draft=2)
    return JaxBatcher(jp, jc, **dict(GEOM, **kw))


def _port(model, spec=False, **kw):
    _, _, pp, pc = model
    if spec:
        kw.update(draft_params=pp, draft_config=pc, n_draft=2)
    return ptl.ContinuousBatcher(pp, pc, device="cpu", **dict(GEOM, **kw))


def _conversation():
    rng = np.random.RandomState(7)
    system = rng.randint(1, 128, size=40).tolist()  # 2 full blocks + 8
    turns = [rng.randint(1, 128, size=n).tolist() for n in (5, 12, 20, 9)]
    return system, turns


def _run(cb, prompts, max_new=6):
    rids = [cb.submit(p, max_new_tokens=max_new) for p in prompts]
    res = cb.run_to_completion()
    return [res[r] for r in rids]


def _chat(cb, demote=False):
    """The shared-prefix traffic; returns (tokens per request, stats)."""
    system, turns = _conversation()
    got = _run(cb, [system + turns[0]])
    got += _run(cb, [system + t for t in turns[1:]])
    if demote:
        assert cb.demote_idle(64) > 0
    got += _run(cb, [system + turns[i] + got[i] + [3, 4, 5, 6, 7, 8, 9, 10]
                     for i in (0, 2)])
    return got, cb.stats()


def _kv_stats(st):
    return {k: v for k, v in st.items()
            if k.startswith(KV_KEYS) and k != "swap_in_ms_total"}


def _kv_debug(cb, **kw):
    out = cb.kv_debug_json(**kw)
    out["summary"].pop("epoch")
    return out


CASES = {
    "radix_k1": dict(decode_chunk=1),
    "radix_k8": dict(decode_chunk=8),
    "exact_k8": dict(decode_chunk=8, prefix_index="exact"),
    "tier_k1": dict(decode_chunk=1, host_kv_blocks=8),
    "tier_k8": dict(decode_chunk=8, host_kv_blocks=8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_shared_prefix_traffic_matches_jax(model, case):
    kw = CASES[case]
    tier = "host_kv_blocks" in kw
    want, jst = _chat(_jax(model, **kw), demote=tier)
    cb = _port(model, **kw)
    got, pst = _chat(cb, demote=tier)
    assert got == want
    assert _kv_stats(pst) == _kv_stats(jst)
    # hits: the wave-1 followers at the system prompt's 2 blocks, and
    # the second turns deeper (their own first-turn blocks too)
    assert pst["prefix_requests_hit_total"] >= 4
    assert pst["prefix_blocks_reused_total"] >= 8
    if tier:
        assert pst["swap_ins_total"] >= 1 and pst["swap_failures_total"] == 0
    assert all(len(t) == 6 for t in got)


@pytest.mark.parametrize("tier", [False, True], ids=["radix", "tier"])
def test_int8_pool_shared_prefix_matches_jax(model, tier):
    kw = dict(decode_chunk=8, **({"host_kv_blocks": 8} if tier else {}))
    want, jst = _chat(_jax(_int8(model), **kw), demote=tier)
    got, pst = _chat(_port(_int8(model), **kw), demote=tier)
    assert got == want
    assert _kv_stats(pst) == _kv_stats(jst)
    assert pst["prefix_requests_hit_total"] >= 4


def test_speculative_shared_prefix_matches_jax(model):
    kw = dict(host_kv_blocks=8, spec_rounds=2)
    want, jst = _chat(_jax(model, spec=True, **kw), demote=True)
    cb = _port(model, spec=True, **kw)
    got, pst = _chat(cb, demote=True)
    assert got == want
    assert _kv_stats(pst) == _kv_stats(jst)
    assert pst["swap_ins_total"] >= 1
    assert cb.acceptance_rate() == 1.0  # self-draft, twins restored too


def test_kv_debug_json_matches_jax(model):
    jb, pb = _jax(model, host_kv_blocks=8), _port(model, host_kv_blocks=8)
    _chat(jb, demote=True)
    _chat(pb, demote=True)
    assert _kv_debug(pb) == _kv_debug(jb)
    assert _kv_debug(pb, depth=2, max_nodes=3) == _kv_debug(
        jb, depth=2, max_nodes=3)
    for since in (0, 5, 10_000):
        assert _kv_debug(pb, since=since) == _kv_debug(jb, since=since)
    nodes = pb.kv_debug_json()["nodes"]
    assert {n["tier"] for n in nodes} == {"hbm", "host"}


def test_sampled_hit_matches_cold_within_the_port(model):
    system, turns = _conversation()
    prompt = system + turns[1]
    kw = dict(max_new_tokens=8, temperature=0.8, top_p=0.95, seed=7)
    cold = _port(model, prefix_cache=False)
    cold.submit(prompt, **kw)
    want = list(cold.run_to_completion().values())
    cb = _port(model)
    cb.submit(system + turns[0], max_new_tokens=4)
    cb.run_to_completion()
    cb.submit(prompt, **kw)
    got = list(cb.run_to_completion().values())
    assert got == want and cb.stats()["prefix_requests_hit_total"] == 1


def test_a_prompt_that_fills_its_slot_is_not_overwritten(model):
    """_suffix_pad's clamp: a hit whose suffix bucket (8 blocks) passes
    the row's remaining view columns (6 of blocks_per_slot 8) is clamped
    to them, the tokens are the cold batcher's, and the reused blocks
    stay bit-identical."""
    rng = np.random.RandomState(3)
    base = rng.randint(1, 128, size=33).tolist()   # 2 keyed blocks
    prompt = base[:32] + rng.randint(1, 128, size=65).tolist()
    cb = _port(model)
    _run(cb, [base], 4)
    hits = cb._match_prefix(cb._chain_keys(prompt, BS)).blocks
    assert len(hits) == 2 and cb.blocks_per_slot == 8
    assert cb._suffix_pad(65, 2) == 6 * BS
    before = [cb.pool.k[:, :, hits].clone(), cb.pool.pos[hits].clone()]
    got = _run(cb, [prompt], 8)
    assert got == _run(_port(model, prefix_cache=False), [prompt], 8)
    assert cb.stats()["prefix_blocks_reused_total"] == 2
    assert (cb.pool.k[:, :, hits] == before[0]).all()
    assert (cb.pool.pos[hits] == before[1]).all()


# ---------------------------------------------------------------------------
# tests/test_kvcache.py's drills, through the port
# ---------------------------------------------------------------------------

def _tier_batcher(model, **kw):
    """Small pool + host tier: one big filler reservation forces the idle
    session chain to demote."""
    return _port(model, **dict(dict(n_blocks=8, host_kv_blocks=4), **kw))


def _seed_and_demote(cb, session, rng):
    cb.submit(list(session), max_new_tokens=4)
    cb.run_to_completion()
    cb.submit(rng.randint(1, 128, size=112).tolist(), max_new_tokens=8)
    cb.run_to_completion()
    assert cb.stats()["host_tier_blocks"] >= 1


def _cold(model, session, max_new=4, **kw):
    cold = _port(model, n_slots=1, prefix_cache=False, **kw)
    return _run(cold, [list(session)], max_new)[0]


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_demote_restore_token_identical(model, sampling):
    rng = np.random.RandomState(41)
    session = rng.randint(1, 128, size=40).tolist()
    kw = dict(temperature=0.8, seed=7) if sampling == "sampled" else {}
    cold = _port(model, n_slots=1, prefix_cache=False)
    cold.submit(session, max_new_tokens=6, **kw)
    want = list(cold.run_to_completion().values())
    cb = _tier_batcher(model)
    _seed_and_demote(cb, session, rng)
    cb.submit(session, max_new_tokens=6, **kw)
    got = list(cb.run_to_completion().values())
    st = cb.stats()
    assert got == want
    assert st["swap_ins_total"] == 1 and st["swap_in_blocks_total"] == 2
    assert st["swap_out_blocks_total"] >= 2 and st["swap_in_ms_total"] > 0
    assert st["prefix_requests_hit_total"] == 1
    assert st["prefix_blocks_reused_total"] == 2


def test_more_live_sessions_than_the_pool_completes_via_tier(model):
    rng = np.random.RandomState(43)
    sessions = [rng.randint(1, 128, size=40).tolist() for _ in range(3)]
    cb = _port(model, n_slots=1, max_len=64, n_blocks=6, host_kv_blocks=8)
    for _ in range(2):
        for s in sessions:
            assert _run(cb, [s], 8)[0] == _cold(model, s, 8, max_len=64)
    st = cb.stats()
    assert st["prefix_requests_hit_total"] == 3
    assert st["swap_ins_total"] >= 1 and st["swap_failures_total"] == 0


def test_swap_in_flight_never_stalls_decode(model):
    """While a swap-in is in flight (``swap_poll_min`` holds it open)
    every chunk keeps emitting from the resident decode row at an
    un-collapsed K, and no fetch is added to the chunks'."""
    rng = np.random.RandomState(47)
    session = rng.randint(1, 128, size=40).tolist()
    cb = _tier_batcher(model, n_blocks=12, decode_chunk=4)
    _run(cb, [session], 4)
    assert cb.demote_idle(2) == 2 and cb.stats()["host_tier_blocks"] == 2
    r0 = cb.submit([3, 5, 9], max_new_tokens=60)
    for _ in range(3):
        cb.step()
    assert cb.decode_chunk_last == 4
    cb.swap_poll_min = 3
    rid = cb.submit(list(session), max_new_tokens=4)
    saw_restoring, first, guard = 0, None, 0
    while first is None:
        guard += 1
        assert guard < 30
        syncs = cb.host_syncs_total
        evs = cb.step()
        if cb._restoring:
            saw_restoring += 1
            assert cb.decode_chunk_last == 4
            assert any(ev[0] == r0 for ev in evs)
            assert cb.host_syncs_total == syncs + 1
        first = next((ev[1] for ev in evs if ev[0] == rid), None)
    assert saw_restoring >= 2 and cb.stats()["swap_queue_depth"] == 0
    got = [first] + [t for r, t in
                     ((r, t) for r, t, _ in _drain_all(cb)) if r == rid]
    assert got == _cold(model, session)


def _drain_all(cb):
    out = []
    while cb.pending():
        out += cb.step()
    return out


def test_cancel_mid_restore_unpins_everything(model):
    rng = np.random.RandomState(53)
    session = rng.randint(1, 128, size=40).tolist()
    cb = _tier_batcher(model, n_blocks=12, decode_chunk=4)
    _run(cb, [session], 4)
    assert cb.demote_idle(2) == 2
    cb.submit([3, 5, 9], max_new_tokens=40)
    cb.step()
    cb.step()
    cb.swap_poll_min = 100
    cap0, refs0 = cb._capacity(), dict(cb._block_refs)
    rid = cb.submit(list(session), max_new_tokens=4)
    cb.step()
    assert cb.stats()["swap_queue_depth"] == 1
    assert cb.cancel(rid)
    st = cb.stats()
    assert st["swap_queue_depth"] == 0 and st["host_tier_blocks"] >= 2
    assert cb._capacity() == cap0 and cb._block_refs == refs0
    cb.swap_poll_min = 0
    rid2 = cb.submit(list(session), max_new_tokens=4)
    got = [t for r, t, _ in _drain_all(cb) if r == rid2]
    assert got == _cold(model, session)


def test_broken_restore_path_requeues_cold(model):
    rng = np.random.RandomState(61)
    session = rng.randint(1, 128, size=40).tolist()
    cb = _tier_batcher(model, n_blocks=12, decode_chunk=4)
    _run(cb, [session], 4)
    assert cb.demote_idle(1) == 1   # the leaf only: a mixed path
    cb.submit([3, 5, 9], max_new_tokens=40)
    cb.step()
    cb.swap_poll_min = 100
    rid = cb.submit(list(session), max_new_tokens=4)
    cb.step()
    r = cb._restoring[0]
    assert r.resident and r.restore
    cb._invalidate_and_free(cb._store.unpublish(r.resident[0]))
    cb.swap_poll_min = 0
    evs = cb.step()
    assert cb.stats()["swap_queue_depth"] == 0
    got = [t for rr, t, _ in evs + _drain_all(cb) if rr == rid]
    assert got == _cold(model, session)


def test_spec_batcher_tier_round_trip(model):
    rng = np.random.RandomState(59)
    session = rng.randint(1, 128, size=40).tolist()
    cold = _port(model, spec=True, n_slots=1, prefix_cache=False)
    want = _run(cold, [session], 8)[0]
    cb = _port(model, spec=True, n_slots=1, n_blocks=8, host_kv_blocks=4)
    _seed_and_demote(cb, session, rng)
    assert _run(cb, [session], 8)[0] == want
    assert cb.stats()["swap_ins_total"] == 1
    assert cb.acceptance_rate() == 1.0


def test_kv_swap_fault_fails_only_its_request(model):
    from jax_llama_tpu_torch.faults import FaultInjector

    rng = np.random.RandomState(67)
    session = rng.randint(1, 128, size=40).tolist()
    cb = _tier_batcher(model, n_blocks=12,
                       fault_injector=FaultInjector("kv_swap@0:error"))
    _run(cb, [session], 4)
    assert cb.demote_idle(2) == 2
    rid = cb.submit(list(session), max_new_tokens=4)
    other = cb.submit([3, 5, 9], max_new_tokens=4)
    res = cb.run_to_completion()
    failed = cb.pop_failed()
    assert [f[0] for f in failed] == [rid] and "kv swap-in" in failed[0][1]
    assert list(res) == [other] and cb.stats()["swap_failures_total"] == 1
    assert cb.stats()["host_tier_blocks"] == 2  # unpinned, still there
    assert _run(cb, [session], 4)[0] == _cold(model, session)


def test_metrics_surface(model):
    cb = _tier_batcher(model)
    rng = np.random.RandomState(61)
    session = rng.randint(1, 128, size=40).tolist()
    _seed_and_demote(cb, session, rng)
    _run(cb, [session], 4)
    st = cb.stats()
    assert st["radix_nodes_total"] > 0
    assert 0 < st["prefix_hit_tokens_ratio"] < 1
    assert st["host_kv_blocks"] == 4 and st["swap_queue_depth"] == 0
    assert st["kv_block_bytes"] == cb.block_bytes > 0


# ---------------------------------------------------------------------------
# Export / import, the server's KV surfaces, run.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_export_import_between_two_batchers(model, spec):
    system, turns = _conversation()
    prompt = system + turns[2]
    a = _port(model, spec=spec)
    want = _run(a, [prompt])[0]
    keys, slabs = a.export_prefix(prompt)
    assert keys == a._chain_keys(prompt, BS) and len(slabs) == 3
    jb = _jax(model, spec=spec)
    _run(jb, [prompt])
    jkeys, _ = jb.export_prefix(prompt)
    assert keys == jkeys
    b = _port(model, spec=spec)
    assert b.import_prefix(keys, slabs) == 3
    assert b.import_prefix(keys, slabs) == 0  # already resident
    assert _run(b, [prompt])[0] == want
    st = b.stats()
    assert st["prefix_blocks_reused_total"] == 3
    assert st["kv_import_blocks_total"] == 3
    assert a.stats()["kv_export_blocks_total"] == 3
    assert b.resident_chain_keys() == [keys]
    # demote-after-export moves the idle chain out of A's pool
    a2 = _port(model, spec=spec, host_kv_blocks=4)
    _run(a2, [prompt])
    k2, s2 = a2.export_prefix(prompt, demote_after_export=True)
    st2 = a2.stats()
    assert st2["kv_export_demoted_blocks_total"] == 3
    assert st2["host_tier_blocks"] == 3 and a2.resident_chain_keys() == []
    assert _run(a2, [prompt])[0] == want


def _serve(server_cls, batcher, prompts):
    with server_cls(batcher) as srv:
        for p in prompts:
            req = urllib.request.Request(
                srv.address + "/generate",
                data=json.dumps({"prompt": p, "max_new_tokens": 4}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
        out = {}
        for path in ("/debug/kv", "/debug/kv?depth=1", "/debug/kv?since=2",
                     "/healthz"):
            with urllib.request.urlopen(srv.address + path,
                                        timeout=60) as r:
                out[path] = json.loads(r.read())
    return out


def test_server_kv_surfaces_match_jax(model):
    from jax_llama_tpu.server import LLMServer as JServer
    from jax_llama_tpu_torch.server import LLMServer as PServer

    system, turns = _conversation()
    prompts = [system + t for t in turns[:3]]
    want = _serve(JServer, _jax(model, host_kv_blocks=4), prompts)
    got = _serve(PServer, _port(model, host_kv_blocks=4), prompts)
    for path in ("/debug/kv", "/debug/kv?depth=1", "/debug/kv?since=2"):
        for side in (got, want):
            side[path]["summary"].pop("epoch")
        assert got[path] == want[path], path
    gk, wk = got["/healthz"]["kv"], want["/healthz"]["kv"]
    gk["digest"].pop("epoch")
    wk["digest"].pop("epoch")
    assert gk == wk and gk["digest"]["nodes"] == 4


@pytest.mark.parametrize("flags,want", [
    ([], dict(prefix_cache=True, prefix_index="radix", host_kv_blocks=0)),
    (["--prefix-index", "exact"],
     dict(prefix_cache=True, prefix_index="exact", host_kv_blocks=0)),
    (["--no-prefix-cache"],
     dict(prefix_cache=False, prefix_index="radix", host_kv_blocks=0)),
    (["--host-kv-blocks", "16"],
     dict(prefix_cache=True, prefix_index="radix", host_kv_blocks=16)),
], ids=["defaults", "exact", "no_cache", "tier"])
def test_run_prefix_flags_reach_the_batcher_as_in_jax(ckpts, monkeypatch,
                                                       flags, want):
    """``run.py --serve`` hands the batcher the prefix arguments the JAX
    CLI hands its own: each CLI's ContinuousBatcher is replaced by a
    recorder, after the tiny checkpoint is loaded."""
    import jax_llama_tpu.run as jrun
    import jax_llama_tpu.serving as jserving
    import jax_llama_tpu_torch.run as prun
    import jax_llama_tpu_torch.serving as pserving

    seen = {}

    class Recorder:
        def __init__(self, params, config, **kw):
            seen[tag] = {k: kw.get(k) for k in want}
            raise SystemExit(0)

    for tag, run_mod, serving_mod, ckpt, extra in (
            ("jax", jrun, jserving, ckpts[0], []),
            ("port", prun, pserving, ckpts[1], ["--device", "cpu"])):
        monkeypatch.setattr(serving_mod, "ContinuousBatcher", Recorder)
        monkeypatch.setattr(sys, "argv", [
            "run", "--ckpt-dir", str(ckpt), "--byte-tokenizer", "--serve",
            "--tensor", "1", *flags, *extra])
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        with pytest.raises(SystemExit):
            run_mod.main()
    assert seen["port"] == seen["jax"] == want
