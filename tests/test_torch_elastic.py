"""The port's FleetController (``jax_llama_tpu_torch/router.py``) held
against the JAX package's (tests/test_elastic.py's drills on the port):
the hysteresis decision machine on both packages, and step for step
against JAX's ``_decide_locked`` on scripted signal sequences under an
injected clock; the sentinel gate; the ``state_json``/``metrics_snapshot``
keys; and on a routed port fleet (``LLMServer`` replicas over tiny
float32 weights from ``from_jax_params``, the byte tokenizer): a
scale-down drains every session to the survivor with revisits
token-identical to the JAX one-replica oracle, a tick-driven scale-up
adds a routable replica, a rollout on the same weights passes every rung,
a bad rung fails the canary gate and rolls back, a migration with no
capacity leaves the source intact, an operator drain with no survivor
resumes the replica.  Fault drills: ``scale_event`` aborts a scale-up, a
scale-down and a rollout rung with the fleet unchanged;
``session_migrate`` fails one session's move, the source resumes and the
session's revisit still hits there.  The controller imports with
``jax`` and ``jax_llama_tpu`` blocked."""

import json
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

import jax_llama_tpu as jlt
from jax_llama_tpu import router as jrouter
from jax_llama_tpu.obs import DecisionLog as JDecisionLog
from jax_llama_tpu.serving import ContinuousBatcher as JBatcher

import jax_llama_tpu_torch as ptl
from jax_llama_tpu_torch import router as prouter
from jax_llama_tpu_torch.faults import FaultInjector
from jax_llama_tpu_torch.obs import DecisionLog as PDecisionLog
from jax_llama_tpu_torch.router import FleetController, ReplicaRouter
from jax_llama_tpu_torch.server import LLMServer
from jax_llama_tpu_torch.tokenizers.bytes import ByteTokenizer

# tests/test_cache_routing.py's geometry and sessions (test_elastic.py's).
CFG = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           multiple_of=32, max_seq_len=128, dtype="float32",
           param_dtype="float32")
SESSION = "the quick brown fox jumps over the lazy d"
REVISIT = SESSION + " next!"
OTHER = "a completely different conversation starts h"
OTHER_REVISIT = OTHER + "ere"
PKGS = {"jax": (jrouter, JDecisionLog), "port": (prouter, PDecisionLog)}


@pytest.fixture(scope="module")
def model():
    jc = jlt.get_config("tiny", **CFG)
    jp = jlt.init_params(jax.random.PRNGKey(0), jc)
    bad = jlt.init_params(jax.random.PRNGKey(9), jc)
    pc = ptl.get_config("tiny", **CFG)
    return {"jax": (jp, jc), "port": (
        ptl.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu"), pc),
        "bad": ptl.from_jax_params(jax.tree.map(np.asarray, bad),
                                   device="cpu")}


def _serve(cb, tok, prompts, max_new=6):
    rids = [cb.submit(tok.encode(p, bos=True), max_new_tokens=max_new)
            for p in prompts]
    done = cb.run_to_completion()
    return [done[r] for r in rids]


@pytest.fixture(scope="module")
def oracle(model):
    """The JAX one-replica oracle, as tests/test_elastic.py builds it:
    SESSION and OTHER on one batcher, then their revisits."""
    tok = ByteTokenizer()
    jp, jc = model["jax"]
    cb = JBatcher(jp, jc, n_slots=2, max_len=64,
                  stop_tokens=tuple(tok.stop_tokens))
    session = _serve(cb, tok, [SESSION])[0]
    _serve(cb, tok, [OTHER])
    return {"session": session, "revisit": _serve(cb, tok, [REVISIT])[0],
            "other_revisit": _serve(cb, tok, [OTHER_REVISIT])[0]}


def _mk_batcher(model, params=None, **kw):
    pp, pc = model["port"]
    kw = dict(dict(n_slots=2, max_len=64), **kw)
    return ptl.ContinuousBatcher(
        pp if params is None else params, pc, device="cpu",
        stop_tokens=tuple(ByteTokenizer().stop_tokens), **kw)


def _mk_fleet(model, n=2, **router_kw):
    tok = ByteTokenizer()
    servers = [LLMServer(_mk_batcher(model), tokenizer=tok,
                         replica_id=i).start() for i in range(n)]
    router_kw.setdefault("policy", "cache-aware")
    router_kw.setdefault("health_interval_s", 0)
    router_kw.setdefault("tokenizer", tok)
    router_kw.setdefault("block_size", servers[0].batcher.block_size)
    return ReplicaRouter(servers, **router_kw).start(), servers


def _factory(model, made, params=None):
    """A replica_factory of started port servers (kept for teardown)."""
    def make(i):
        srv = LLMServer(_mk_batcher(model, params), tokenizer=ByteTokenizer(),
                        replica_id=i).start()
        made.append(srv)
        return srv
    return make


def _post(url, payload, timeout=300, rid=None):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json",
                 **({"X-Request-Id": rid} if rid else {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _teardown(ctrl, router, servers, made=()):
    if ctrl is not None:
        ctrl.close(stop_owned=True)
    router.stop()
    for s in list(servers) + list(made):
        s.stop()


def _scale_decisions(router, **match):
    return [ev for ev in router.decisions.json(n=64, kind="scale")[
        "decisions"] if all(ev.get(k) == v for k, v in match.items())]


def test_controller_imports_without_jax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jax_llama_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from jax_llama_tpu_torch.router import FleetController\n"
        "import jax_llama_tpu_torch.run\n"
        "assert FleetController.drain_replica\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jax_llama_tpu')]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_controller_has_every_jax_method():
    def methods(cls):
        return {k for k, v in vars(cls).items()
                if callable(v) or isinstance(v, staticmethod)}

    assert methods(prouter.FleetController) == methods(
        jrouter.FleetController)


# ---------------------------------------------------------------------------
# Host-only units on both packages: the decision machine + sentinel gate
# ---------------------------------------------------------------------------

class _StubSentinel:
    def __init__(self):
        self.verdicts = {}

    def verdict(self, i):
        return self.verdicts.get(i, "healthy")


class _StubRouter:
    """tests/test_elastic.py's stub router over one package's ``_Replica``
    and ``DecisionLog``: a replica table with settable health scrapes, a
    settable sentinel, no HTTP."""

    def __init__(self, pkg, n=2, n_slots=2):
        mod, decision_log = PKGS[pkg]
        self._lock = threading.Lock()
        self._replicas = []
        for i in range(n):
            rep = mod._Replica(index=i, host="127.0.0.1", port=0)
            rep.last_health = {"replica": {"n_slots": n_slots},
                               "overload": {}}
            self._replicas.append(rep)
        self.sentinel = _StubSentinel()
        self.decisions = decision_log()
        self.fault_injector = None
        self.health_interval_s = 0.0
        self.handoff_timeout_s = 5.0
        self.controller = None

    def attach_controller(self, controller):
        self.controller = controller

    def _occupancy_locked(self, rep):
        slots = int((rep.last_health.get("replica") or {})
                    .get("n_slots") or 0)
        if slots <= 0:
            return float(rep.inflight)
        return rep.inflight / slots

    def set_overload(self, i, **kw):
        self._replicas[i].last_health["overload"].update(kw)


def _ctrl(pkg, router, **kw):
    return PKGS[pkg][0].FleetController(router, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_autoscaler_steady_holds_without_decisions(pkg):
    r = _StubRouter(pkg)
    for i in range(2):
        r.set_overload(i, interactive_attainment=1.0, queue_wait_ms_p90=1.0)
        r._replicas[i].inflight = 1  # occupancy 0.5: not calm
    out = _ctrl(pkg, r, min_replicas=1, max_replicas=4).tick()
    assert out["action"] == "hold" and out["reason"] == "steady"
    assert r.decisions.json(kind="scale")["decisions"] == []
    assert out["signals"] == {
        "replicas_active": 2, "replicas_healthy": 2, "inflight": 2,
        "attainment_min": 1.0, "queue_wait_ms_p90_max": 1.0,
        "occupancy_max": 0.5}


@pytest.mark.parametrize("pkg", PKGS)
def test_autoscaler_pressure_dwell_then_deferral_is_recorded(pkg):
    r = _StubRouter(pkg)
    r.set_overload(0, interactive_attainment=0.5)
    r.set_overload(1, interactive_attainment=1.0)
    assert _ctrl(pkg, r, min_replicas=1, max_replicas=4,
                 dwell_s=60.0).tick()["reason"] == "dwell"
    ctrl2 = _ctrl(pkg, r, min_replicas=1, max_replicas=4, dwell_s=0.0)
    assert ctrl2.tick()["reason"] == "no-replica-factory"
    evs = _scale_decisions(r, action="deferred", reason="no-replica-factory")
    assert evs and evs[-1]["signals"]["attainment_min"] == 0.5
    assert ctrl2.metrics_snapshot()["scale_events"]["deferred"] == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_autoscaler_queue_wait_pressure_and_max_gate(pkg):
    r = _StubRouter(pkg)
    r.set_overload(0, queue_wait_ms_p90=900.0)
    ctrl = _ctrl(pkg, r, replica_factory=lambda i: "127.0.0.1:1",
                 min_replicas=1, max_replicas=2, queue_wait_high_ms=500.0)
    assert ctrl.tick()["reason"] == "at-max-replicas"
    assert _scale_decisions(r, action="deferred", reason="at-max-replicas")


@pytest.mark.parametrize("pkg", PKGS)
def test_autoscaler_calm_scaledown_min_gate_and_cooldown(pkg):
    r = _StubRouter(pkg, n=2)
    for i in range(2):
        r.set_overload(i, interactive_attainment=1.0, queue_wait_ms_p90=0.0)
    assert _ctrl(pkg, r, min_replicas=2,
                 max_replicas=4).tick()["reason"] == "at-min-replicas"
    assert _scale_decisions(r, action="deferred", reason="at-min-replicas")
    ctrl2 = _ctrl(pkg, r, min_replicas=1, max_replicas=4, cooldown_s=60.0)
    with ctrl2._lock:
        ctrl2._last_action_t = time.monotonic()
    assert ctrl2.tick()["reason"] == "cooldown"


@pytest.mark.parametrize("pkg", PKGS)
def test_scale_down_sentinel_gate_defers_with_verdicts(pkg):
    r = _StubRouter(pkg, n=2)
    r.sentinel.verdicts = {0: "suspect", 1: "critical"}
    ctrl = _ctrl(pkg, r, min_replicas=1, max_replicas=4)
    out = ctrl.scale_down()
    assert out == {"ok": False, "action": "down",
                   "reason": "sentinel-cannot-explain",
                   "sentinel": {0: "suspect", 1: "critical"}}
    evs = _scale_decisions(r, action="deferred",
                           reason="sentinel-cannot-explain")
    assert evs and evs[-1]["sentinel"][0] == "suspect"
    assert ctrl.metrics_snapshot()["scale_events"]["deferred"] == 1
    assert ctrl.scale_down(victim=1)["reason"] == "sentinel-cannot-explain"


def test_state_json_and_metrics_snapshot_match_jax():
    got = {}
    for pkg in PKGS:
        r = _StubRouter(pkg)
        ctrl = _ctrl(pkg, r, min_replicas=1, max_replicas=4, dwell_s=1.5,
                     cooldown_s=9.0)
        before = ctrl.state_json()
        assert before["last_signals"] is None and before["busy"] is False
        assert before["rollout_rung"] == -1
        ctrl.tick()
        got[pkg] = (before, ctrl.state_json(), ctrl.metrics_snapshot())
    assert got["port"] == got["jax"]
    assert got["port"][1]["last_signals"]["action"] == "hold"
    assert set(got["port"][2]) == {"scale_events", "sessions_migrated",
                                   "rollout_rung"}


# Scripted signal sequences: each step advances the injected clock and
# hands both packages' _decide_locked the same signals; an "up"/"down"
# decision is followed by the action's end, as _end_action books it.
ATT = (None, 0.5, 0.95, 1.0)
QW = (None, 100.0, 900.0)
OCC = (None, 0.0, 0.2, 0.6)


def _script(seed, n=80):
    rng = np.random.RandomState(seed)
    t, steps = 1000.0, []
    for _ in range(n):
        t += float(rng.choice([0.0, 0.4, 1.0, 3.0, 12.0]))
        steps.append((t, {
            "replicas_active": int(rng.randint(1, 6)),
            "replicas_healthy": 2, "inflight": 0,
            "attainment_min": ATT[rng.randint(len(ATT))],
            "queue_wait_ms_p90_max": QW[rng.randint(len(QW))],
            "occupancy_max": OCC[rng.randint(len(OCC))],
        }, bool(rng.rand() < 0.1)))
    return steps


def _decisions(pkg, seed, factory):
    ctrl = _ctrl(pkg, _StubRouter(pkg), min_replicas=2, max_replicas=4,
                 dwell_s=1.0, cooldown_s=5.0,
                 replica_factory=(lambda i: "127.0.0.1:1") if factory
                 else None)
    out = []
    for now, sig, busy in _script(seed):
        with ctrl._lock:
            ctrl._busy = busy
            action, reason = ctrl._decide_locked(now, sig)
            if action in ("up", "down"):
                ctrl._last_action_t = now
            out.append((action, reason))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("factory", [True, False])
def test_decide_locked_matches_jax_step_for_step(seed, factory):
    got = _decisions("port", seed, factory)
    assert got == _decisions("jax", seed, factory)
    reasons = {r for _, r in got}
    assert {"steady", "dwell", "action-in-progress"} <= reasons
    assert factory <= ("cooldown" in reasons)
    assert {"at-max-replicas", "at-min-replicas"} & reasons
    assert ("up" if factory else "no-replica-factory") in {
        a if a != "hold" else r for a, r in got}


# ---------------------------------------------------------------------------
# Live-fleet drills on the port
# ---------------------------------------------------------------------------

def test_scale_down_drain_migrates_sessions_token_identical(model, oracle):
    """Scale-down drains the victim by migrating every live session's
    chain to the survivor: nobody dropped, every revisit streams the JAX
    one-replica oracle's tokens from the new home, and the decision log,
    /metrics and /debug/fleet explain the action."""
    router, servers = _mk_fleet(model, n=2)
    ctrl = FleetController(router, min_replicas=1, max_replicas=2,
                           drain_timeout_s=15.0)
    try:
        _, _, h1 = _post(router.address, {"text": SESSION,
                                          "max_new_tokens": 6})
        _, _, h2 = _post(router.address, {"text": OTHER,
                                          "max_new_tokens": 6})
        assert {int(h1["X-Replica-Id"]), int(h2["X-Replica-Id"])} == {0, 1}
        router.check_health_now()
        chains = servers[0].call_on_loop(lambda b: b.resident_chain_keys())
        out = ctrl.scale_down(victim=0)
        assert out["ok"] is True and out["replica"] == 0
        drain = out["drain"]
        assert drain["ok"] is True and drain["migrated"] == len(chains) >= 1
        snaps = router.health()["replicas"]
        assert snaps[0]["retired"] is True and snaps[1]["retired"] is False
        for text, want in ((REVISIT, oracle["revisit"]),
                           (OTHER_REVISIT, oracle["other_revisit"])):
            st, body, hdrs = _post(router.address,
                                   {"text": text, "max_new_tokens": 6})
            assert st == 200 and body["tokens"] == want
            assert int(hdrs["X-Replica-Id"]) == 1
        dst_chains = servers[1].call_on_loop(
            lambda b: b.resident_chain_keys())
        assert any(len(c) >= 2 for c in dst_chains)
        assert _scale_decisions(router, action="down", replica=0)
        drains = router.decisions.json(n=16, kind="drain")["decisions"]
        assert drains and drains[-1]["migrated"] == drain["migrated"]
        fleet = router.fleet_health_json()
        assert fleet["controller"]["drains_total"] == 1
        assert fleet["controller"]["sessions_migrated_total"] >= 1
        m = router.metrics_text()
        assert 'llm_fleet_scale_events_total{action="down"} 1' in m
        assert "llm_sessions_migrated_total" in m
        assert "llm_rollout_rung -1" in m
        assert "llm_router_replicas 1" in m
        # The retired slot keeps no reference to its stopped instance.
        assert router._replicas[0].server is None
    finally:
        _teardown(ctrl, router, servers)


def test_tick_driven_scale_up_adds_routable_replica(model):
    router, servers = _mk_fleet(model, n=2, policy="least-loaded")
    made = []
    ctrl = FleetController(router, replica_factory=_factory(model, made),
                           min_replicas=1, max_replicas=3)
    try:
        router.check_health_now()
        with router._lock:
            for rep in router._replicas:
                rep.last_health.setdefault("overload", {})[
                    "interactive_attainment"] = 0.1
        out = ctrl.tick()
        assert out["ok"] is True and out["action"] == "up"
        assert out["replica"] == 2 and len(made) == 1
        snaps = router.health()["replicas"]
        assert len(snaps) == 3 and snaps[2]["healthy"] is True
        # The grown replica shares the seed replicas' weight copy.
        assert (made[0].batcher.params["embed"]["embedding"].data_ptr()
                == servers[0].batcher.params["embed"]["embedding"]
                .data_ptr())
        seen = set()
        for _ in range(3):
            st, body, hdrs = _post(router.address, {"text": SESSION,
                                                    "max_new_tokens": 4})
            assert st == 200 and body["tokens"]
            seen.add(int(hdrs["X-Replica-Id"]))
        assert seen == {0, 1, 2}
        evs = _scale_decisions(router, action="up", replica=2)
        assert evs and evs[-1]["signals"]["attainment_min"] == 0.1
        m = router.metrics_text()
        assert 'llm_fleet_scale_events_total{action="up"} 1' in m
        assert "llm_router_replicas 3" in m
    finally:
        _teardown(ctrl, router, servers)


def test_rollout_same_weights_all_rungs_pass(model, oracle):
    router, servers = _mk_fleet(model, n=2)
    made = []
    ctrl = FleetController(router, drain_timeout_s=15.0)
    try:
        out = ctrl.rollout(_factory(model, made))
        assert out["ok"] is True, out
        assert out["planned"] == 2 and len(made) == 2
        assert [r["ok"] for r in out["rungs"]] == [True, True]
        snaps = router.health()["replicas"]
        assert len(snaps) == 2 and all(not s["retired"] for s in snaps)
        st, body, _ = _post(router.address, {"text": SESSION,
                                             "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == oracle["session"]
        rungs = router.decisions.json(n=16, kind="rollout_rung")[
            "decisions"]
        assert [ev["ok"] for ev in rungs] == [True, True]
        assert [ev["gate"] for ev in rungs] == ["oracle-pinned",
                                                "oracle-match"]
        top = router.decisions.json(n=4, kind="rollout")["decisions"]
        assert top and top[-1]["ok"] is True
        assert ctrl.state_json()["rollouts_total"] == 1
        assert ctrl.state_json()["rollbacks_total"] == 0
        assert "llm_rollout_rung -1" in router.metrics_text()
    finally:
        _teardown(ctrl, router, servers)


def test_rollout_bad_rung_fails_canary_gate_and_rolls_back(model, oracle):
    """Rung 1's instance serves other weights: its probe misses the
    rollout oracle pinned at rung 0 (oracle-mismatch, caught while the
    fleet majority still runs the old weights) and the rung rolls back
    through rollback_factory; the fleet ends whole, serving the oracle's
    tokens."""
    router, servers = _mk_fleet(model, n=2)
    made = []
    good, bad = _factory(model, made), _factory(model, made, model["bad"])
    ctrl = FleetController(router, drain_timeout_s=15.0)
    try:
        out = ctrl.rollout(lambda i: good(i) if i == 0 else bad(i),
                           rollback_factory=good)
        assert out["ok"] is False and "canary-gate" in out["reason"]
        assert out["rungs"][0]["ok"] is True
        assert out["rungs"][1]["ok"] is False
        assert out["rungs"][1]["rollback"] == "rolled-back"
        assert ctrl.state_json()["rollbacks_total"] == 1
        snaps = router.health()["replicas"]
        assert len(snaps) == 2 and all(not s["retired"] for s in snaps)
        for _ in range(2):
            st, body, _ = _post(router.address, {"text": SESSION,
                                                 "max_new_tokens": 6})
            assert st == 200 and body["tokens"] == oracle["session"]
        rungs = router.decisions.json(n=16, kind="rollout_rung")[
            "decisions"]
        assert rungs[-1]["ok"] is False
        assert "oracle-mismatch" in rungs[-1]["reason"]
        assert "llm_rollout_rung -1" in router.metrics_text()
    finally:
        _teardown(ctrl, router, servers, made)


def test_migrate_chain_no_capacity_leaves_source_intact(model, oracle):
    router, servers = _mk_fleet(model, n=2)
    try:
        _, _, hdrs = _post(router.address, {"text": SESSION,
                                            "max_new_tokens": 6})
        src = int(hdrs["X-Replica-Id"])
        dst = 1 - src
        router.check_health_now()
        chain = max(servers[src].call_on_loop(
            lambda b: b.resident_chain_keys()), key=len)
        assert len(chain) >= 2
        servers[dst].call_on_loop(
            lambda b: setattr(b, "_capacity", lambda: 0))
        empties = router.handoffs_empty_total
        router.migrate_chain([k.hex() for k in chain], src, dst)
        assert router.wait_handoffs(timeout_s=10.0)
        assert router.handoffs_empty_total == empties + 1
        evs = router.decisions.json(n=16, kind="handoff_empty")["decisions"]
        assert evs and evs[-1]["reason"] == (
            "already-resident-or-no-capacity")
        assert servers[src].call_on_loop(
            lambda b: len(b._match_prefix(list(chain)).blocks)) == len(chain)
        assert not servers[dst].call_on_loop(
            lambda b: b.resident_chain_keys())
        servers[dst].call_on_loop(lambda b: delattr(b, "_capacity"))
        st, body, hdrs = _post(router.address, {"text": REVISIT,
                                                "max_new_tokens": 6})
        assert st == 200 and body["tokens"] == oracle["revisit"]
        assert int(hdrs["X-Replica-Id"]) == src
    finally:
        _teardown(None, router, servers)


def test_drain_replica_operator_entry_no_survivor(model):
    router, servers = _mk_fleet(model, n=1)
    ctrl = FleetController(router, drain_timeout_s=10.0)
    try:
        assert _post(router.address, {"text": SESSION,
                                      "max_new_tokens": 6})[0] == 200
        out = ctrl.drain_replica(0)
        assert out["ok"] is False and out["reason"] == "no-survivor"
        snap = router.health()["replicas"][0]
        assert snap["retiring"] is False and snap["retired"] is False
        st, body, _ = _post(router.address, {"text": REVISIT,
                                             "max_new_tokens": 4})
        assert st == 200 and body["tokens"]
        assert ctrl.state_json()["drains_failed_total"] == 1
    finally:
        _teardown(ctrl, router, servers)


# ---------------------------------------------------------------------------
# Fault drills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", ["up", "down", "rollout"])
def test_scale_event_fault_aborts_with_the_fleet_unchanged(model, action):
    """``scale_event`` fires at the start of each action: an injected
    fault aborts it with the membership, the owned set and every slot's
    instance unchanged, and the abort is a recorded decision."""
    router, servers = _mk_fleet(model, n=2)
    made = []
    ctrl = FleetController(
        router, replica_factory=_factory(model, made), min_replicas=1,
        max_replicas=3, fault_injector=FaultInjector("scale_event@0:error"))
    try:
        _post(router.address, {"text": SESSION, "max_new_tokens": 4})
        router.check_health_now()
        before = [(r.index, r.server, r.retired, r.retiring)
                  for r in router._replicas]
        if action == "up":
            out = ctrl.scale_up()
        elif action == "down":
            out = ctrl.scale_down()
        else:
            out = ctrl.rollout(_factory(model, made))
        assert out["ok"] is False
        assert "injected device error" in out["reason"]
        assert [(r.index, r.server, r.retired, r.retiring)
                for r in router._replicas] == before
        assert made == [] and ctrl._owned == {}
        if action == "rollout":
            rungs = router.decisions.json(n=8, kind="rollout_rung")[
                "decisions"]
            assert rungs[-1]["ok"] is False and rungs[-1]["rung"] == 0
        else:
            assert _scale_decisions(router, action="aborted", op=action)
        assert ctrl.metrics_snapshot()["scale_events"]["aborted"] == 1
        # The next action proceeds (the fault fired once).
        assert ctrl.scale_up()["ok"] is True and len(made) == 1
    finally:
        _teardown(ctrl, router, servers)


def test_session_migrate_fault_resumes_the_source(model, oracle):
    """``session_migrate`` fails one session's move: the drain reports
    migration-failures, the source resumes admission with its chain
    intact, and the session's revisit hits there with the oracle's
    tokens."""
    router, servers = _mk_fleet(model, n=2)
    ctrl = FleetController(router, drain_timeout_s=15.0,
                           fault_injector=FaultInjector(
                               "session_migrate@0:error"))
    try:
        _, _, hdrs = _post(router.address, {"text": SESSION,
                                            "max_new_tokens": 6})
        src = int(hdrs["X-Replica-Id"])
        router.check_health_now()
        chains = servers[src].call_on_loop(lambda b: b.resident_chain_keys())
        assert len(chains) == 1
        out = ctrl.drain_replica(src)
        assert out["ok"] is False and out["reason"] == "migration-failures"
        assert out["failed"] == 1 and out["migrated"] == 0
        assert "injected device error" in out["failures"][0]["reason"]
        snap = router.health()["replicas"][src]
        assert snap["retiring"] is False and snap["retired"] is False
        assert servers[src].call_on_loop(
            lambda b: b.resident_chain_keys()) == chains
        assert not servers[1 - src].call_on_loop(
            lambda b: b.resident_chain_keys())
        st, body, hdrs = _post(router.address, {"text": REVISIT,
                                                "max_new_tokens": 6},
                               rid="revisit-after-fault")
        assert st == 200 and body["tokens"] == oracle["revisit"]
        assert int(hdrs["X-Replica-Id"]) == src
        dec = [d for d in router.decisions.json(
            n=16, request_id="revisit-after-fault")["decisions"]
            if d["kind"] == "route"]
        assert dec and dec[-1]["hit_depth"] == len(chains[0])
        st = ctrl.state_json()
        assert st["drains_failed_total"] == 1
        assert st["sessions_migrate_failed_total"] == 1
    finally:
        _teardown(ctrl, router, servers)
