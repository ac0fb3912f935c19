"""The fleet control plane in the port held against the JAX package's
(the router part of tests/test_controlplane.py): ``DecisionLog`` records,
filters and bounds its ring as JAX's does; ``HealthSentinel`` fed the same
canary and health observations gives the same scores, verdicts, events
and anomaly counts (host float arithmetic, compared exactly); the canary
oracle resolves by majority, re-pins and resets as JAX's.  Then the fleet
drill on two routed port replicas (tiny float32 weights from
``from_jax_params``): one replica's front door dies, its canaries fail,
its verdict flips and an anomaly counter fires, ``/debug/decisions``
explains the re-route of the next request, and ``/debug/bundle`` parses.
``EwmaDetector`` is held in tests/test_torch_obs.py."""

import json
import urllib.request

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
from jax_llama_tpu import obs as jobs
from jax_llama_tpu import router as jrouter

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import obs as pobs
from jax_llama_tpu_torch import router as prouter
from jax_llama_tpu_torch.server import LLMServer
from jax_llama_tpu_torch.tokenizers.bytes import ByteTokenizer

CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")


def _get_json(url, path, timeout=60):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _post(url, payload, rid=None, timeout=300):
    headers = {"Content-Type": "application/json"}
    if rid is not None:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(payload).encode(),
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _metrics(url):
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or " " not in line:
            continue
        name, val = line.split(" ", 1)
        try:
            out[name] = float(val)
        except ValueError:
            pass
    return out, text


# ---------------------------------------------------------------------------
# Pure host: the decision log, the sentinel, the canary oracle
# ---------------------------------------------------------------------------

def _decision_story(mod):
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    log = mod.DecisionLog(ring=4, clock=lambda: float(next(ticks)))
    for i in range(6):
        log.record("route", request_id=f"r{i % 2}", replica=i)
    log.record("reroute", request_id="r0", failed_replica=1)
    log.record("canary", replica=0, error=None, ok=True)

    def strip(doc):
        return [{k: v for k, v in d.items() if k != "unix_s"}
                for d in doc]

    return (log.total(), log.counts_snapshot(),
            {k: v for k, v in log.json().items() if k != "decisions"},
            strip(log.json()["decisions"]),
            strip(log.json(kind="reroute")["decisions"]),
            strip(log.json(n=1)["decisions"]),
            strip(log.for_request("r0")))


def test_decision_log_matches_jax():
    """Records, the ?n= / ?kind= / ?request_id= filters and the ring
    bound are JAX's (on the same clock; the wall-clock stamp aside)."""
    got = _decision_story(pobs)
    assert got == _decision_story(jobs)
    total, counts, head, ring, only, last, joined = got
    assert total == 8 and counts == {"route": 6, "reroute": 1, "canary": 1}
    assert head["events_total"] == 8 and head["ring"] == 4
    assert len(ring) == 4 and [d["seq"] for d in ring] == [4, 5, 6, 7]
    assert only[0]["failed_replica"] == 1
    assert "error" not in last[0] and last[0]["ok"] is True
    assert joined and all(d["request_id"] == "r0" for d in joined)


def _sentinel_story(mod, seed):
    """A seeded stream of canary and health observations over two
    replicas: spikes, failures, mismatches, collapsing attainment and
    stale scrapes among healthy samples."""
    rng = np.random.RandomState(seed)
    s = mod.HealthSentinel(min_samples=5, staleness_allowance_s=1.0)
    out = []
    for _ in range(80):
        r = int(rng.randint(2))
        if rng.rand() < 0.5:
            u = rng.rand()
            ok = u > 0.2
            evs = s.observe_canary(
                r, ok=ok, mismatch=(0.1 < u <= 0.2),
                latency_ms=float(rng.choice([10.0, 11.5, 5000.0],
                                            p=[0.6, 0.3, 0.1])),
                error=None if ok else "connect refused")
        else:
            reachable = rng.rand() > 0.15
            evs = s.observe_health(
                r, reachable=reachable,
                attainment=float(rng.choice([1.0, 0.0], p=[0.7, 0.3])),
                queue_wait_ms=float(rng.choice([5.0, 400.0],
                                               p=[0.85, 0.15])),
                itl_ms=float(rng.choice([20.0, 21.0, 900.0],
                                        p=[0.5, 0.4, 0.1])),
                age_s=0.0 if reachable else float(rng.choice([2.0, 10.0])))
        out.append((evs, s.score(r), s.verdict(r)))
    fleet = s.fleet_json()
    for rep in fleet["replicas"].values():
        if rep["last_canary"] is not None:
            del rep["last_canary"]["unix_s"]  # the wall clock
    return out, fleet, dict(s.anomalies_total)


@pytest.mark.parametrize("seed", range(4))
def test_sentinel_matches_jax(seed):
    """Scores, verdicts, every event and the anomaly counters after each
    observation equal JAX's exactly."""
    got = _sentinel_story(prouter, seed)
    assert got == _sentinel_story(jrouter, seed)
    steps, fleet, anomalies = got
    assert set(anomalies) == set(prouter.SENTINEL_SIGNALS)
    assert sum(anomalies.values()) >= 1
    assert {v for _, _, v in steps} >= {"healthy"}
    assert fleet["verdict"] in prouter.VERDICTS


def test_sentinel_canary_failures_flip_verdict():
    """One failed probe is a counted anomaly and a suspect verdict;
    sustained failure is critical without a second anomaly; successes
    clear it (as in the JAX package's test)."""
    s = prouter.HealthSentinel()
    assert s.observe_canary(0, ok=True, latency_ms=10.0) == []
    evs = s.observe_canary(0, ok=False, error="connect refused")
    assert {"anomaly", "verdict"} <= {e["kind"] for e in evs}
    assert s.verdict(0) == "suspect" and s.score(0) < 0.8
    s.observe_canary(0, ok=False, error="connect refused")
    s.observe_canary(0, ok=False, error="connect refused")
    assert s.verdict(0) == "critical" and s.anomalies_total["canary"] == 1
    cleared = False
    for _ in range(8):
        evs = s.observe_canary(0, ok=True, latency_ms=10.0)
        cleared = cleared or "anomaly_cleared" in [e["kind"] for e in evs]
    assert cleared and s.verdict(0) == "healthy"


def _oracle_story(mod):
    router = mod.ReplicaRouter(
        ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"],
        health_interval_s=0, canary_interval_s=0)
    reps = router._replicas
    out = []
    with router._lock:
        router._canary_oracle = [9, 9]
    sweeps = [
        [(0, [9, 9]), (1, [1, 2]), (2, [1, 2])],   # majority re-pins
        [(0, [1, 2]), (1, [7, 7])],                # 1-vs-1 keeps the pin
        "reset",
        [(0, [8, 8]), (1, [6, 6])],                # unpinned tie: no one
        [(0, [4, 4])],                             # a lone probe pins
    ]
    for sweep in sweeps:
        if sweep == "reset":
            router.reset_canary_oracle()
            continue
        results = [(reps[i], {"ok": True, "tokens": t, "latency_ms": 1.0,
                              "request_id": f"c{i}"}) for i, t in sweep]
        router._resolve_canary_oracle(results)
        with router._lock:
            out.append((router._canary_oracle,
                        router.canary_oracle_repins_total,
                        [dict(r) for _, r in results]))
    kinds = [d["kind"] for d in router.decisions.json(n=64)["decisions"]]
    return out, kinds


def test_canary_oracle_majority_repin_and_reset_match_jax():
    got = _oracle_story(prouter)
    assert got == _oracle_story(jrouter)
    steps, kinds = got
    assert steps[0][0] == [1, 2] and steps[0][1] == 1
    assert steps[0][2][0]["mismatch"] and not steps[0][2][0]["ok"]
    assert steps[1][0] == [1, 2] and steps[1][2][1]["mismatch"]
    assert steps[2][0] is None and all(r["ok"] for r in steps[2][2])
    assert steps[3][0] == [4, 4]
    assert {"canary_oracle_repin", "canary_oracle_reset",
            "canary_oracle_disagreement"} <= set(kinds)


# ---------------------------------------------------------------------------
# The fleet drill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    return (ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu"),
            ptl.get_config("tiny", **CFG))


def test_fleet_drill_canary_flags_degraded_replica(weights):
    """One replica's HTTP front door dies (its loop lives on): the
    canaries fail on it, its score drops, its verdict flips, an anomaly
    counter fires; the next request routed to it re-routes losslessly,
    ``/debug/decisions?request_id=`` shows route -> reroute -> route, and
    ``/debug/bundle`` parses with the healthy replica's bundle."""
    pp, pc = weights
    tok = ByteTokenizer()
    servers = [LLMServer(
        ptl.ContinuousBatcher(pp, pc, n_slots=2, max_len=64, device="cpu",
                              stop_tokens=tuple(tok.stop_tokens)),
        tokenizer=tok, replica_id=i).start() for i in range(2)]
    router = prouter.ReplicaRouter(
        servers, policy="least-loaded", health_interval_s=0,
        canary_interval_s=0).start()
    payload = {"prompt": [5, 6, 7], "max_new_tokens": 4,
               "temperature": 0.0}
    try:
        router.check_health_now()
        router.run_canaries_now()
        oracle = router._canary_oracle
        assert oracle and router.canary_probes_total == 2
        assert router.canary_failures_total == 0
        st, fleet = _get_json(router.address, "/debug/fleet")
        assert st == 200 and fleet["verdict"] == "healthy"
        st, want, hdrs = _post(router.address, payload, rid="drill-1")
        assert st == 200 and hdrs["X-Replica-Id"] == "0"

        servers[1].httpd.shutdown()
        servers[1].httpd.server_close()
        for _ in range(3):
            router.run_canaries_now()
        assert router.canary_failures_total >= 3
        st, fleet = _get_json(router.address, "/debug/fleet")
        by_idx = {r["replica"]: r for r in fleet["replicas"]}
        assert by_idx[0]["verdict"] == "healthy"
        assert by_idx[1]["verdict"] in ("suspect", "critical")
        assert by_idx[1]["score"] < 0.8
        assert by_idx[1]["last_canary"]["ok"] is False
        assert "canary" in by_idx[1]["anomalous"]
        assert fleet["anomalies_total"]["canary"] >= 1
        assert fleet["verdict_index"] >= 1
        assert fleet["canary"]["oracle_tokens"] == oracle

        st, body, hdrs = _post(router.address, payload, rid="drill-2")
        assert st == 200 and hdrs["X-Replica-Id"] == "0"
        assert body["tokens"] == want["tokens"]
        st, doc = _get_json(router.address, "/debug/decisions?n=256")
        assert {"route", "reroute", "canary", "anomaly", "verdict"} <= {
            d["kind"] for d in doc["decisions"]}
        st, doc2 = _get_json(router.address,
                             "/debug/decisions?request_id=drill-2")
        routes = [d for d in doc2["decisions"] if d["kind"] == "route"]
        assert [d["replica"] for d in routes] == [1, 0]
        assert all(d["candidates"] for d in routes)
        assert routes[1]["policy"] == "reroute"
        rr = [d for d in doc2["decisions"] if d["kind"] == "reroute"]
        assert rr and rr[0]["failed_replica"] == 1
        st, tl = _get_json(router.address, "/debug/requests/drill-2")
        assert st == 200 and tl["router_decisions"]

        st, bundle = _get_json(router.address, "/debug/bundle")
        assert st == 200 and bundle["kind"] == "router_bundle"
        assert bundle["fleet"]["verdict_index"] >= 1
        assert bundle["decisions"]["events_total"] >= 5
        assert isinstance(bundle["trace"]["traceEvents"], list)
        reps = bundle["replicas"]
        assert [b["replica"] for b in reps] == [0]
        assert reps[0]["kind"] == "replica_bundle"
        assert reps[0]["config"]["batcher"]["n_slots"] == 2
        assert "trace" not in reps[0]

        m, text = _metrics(router.address)
        assert m["llm_router_canary_failures_total"] >= 3
        assert m["llm_router_fleet_verdict"] >= 1
        assert 'llm_router_replica_health_score{replica="1"}' in text
        assert 'llm_router_anomalies_total{signal="canary"}' in text
        m0, _ = _metrics(servers[0].address)
        assert m0["llm_canary_requests_total"] >= 4
        assert m0["llm_requests_slo_ok_total"] == 2
    finally:
        router.stop()
        for s in servers:
            s.stop()
