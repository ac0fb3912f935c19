"""``jax_llama_tpu_torch.overload`` held against ``jax_llama_tpu.overload``:
each test body runs on both packages' module (the ``ov`` fixture) — the
brownout ladder under an injected clock (no sleeping), deadline- and
class-aware admission, the per-class queues, Retry-After, the Poisson
schedule and the flood summary — and a seeded drive of one controller per
package must make the same transitions and report the same state."""

import random
import types

import pytest

import jax_llama_tpu.overload as joverload
import jax_llama_tpu_torch.overload as poverload

MODULES = {"jax": joverload, "port": poverload}


@pytest.fixture(params=sorted(MODULES))
def ov(request):
    return MODULES[request.param]


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _controller(ov, clock, **kw):
    kw.setdefault("dwell_s", 1.0)
    kw.setdefault("cooldown_s", 2.0)
    kw.setdefault("signal_window_s", 5.0)
    kw.setdefault("min_signal_samples", 2)
    return ov.OverloadController(clock=clock, **kw)


def _miss(c, n=4):
    for _ in range(n):
        c.note_slo("interactive", False, True, False)


def _entry(priority="interactive", cost=10, deadline=None,
           disconnected=False):
    return types.SimpleNamespace(
        priority=priority, cost_tokens=cost, deadline=deadline,
        disconnected=disconnected,
    )


# ---------------------------------------------------------------------------
# Ladder state machine (injected clock, no server)
# ---------------------------------------------------------------------------

def test_ladder_escalates_with_dwell_and_one_rung_at_a_time(ov):
    clock = Clock()
    c = _controller(ov, clock)
    _miss(c)
    # Pressure just started: the dwell must elapse first.
    assert c.tick() is None
    assert c.rung == "normal"
    clock.advance(0.5)
    _miss(c)
    assert c.tick() is None  # 0.5s < dwell_s=1
    clock.advance(0.6)
    _miss(c)
    assert c.tick() == ("normal", "elevated")
    # The dwell re-arms after each transition — no straight-to-shed.
    assert c.tick() is None
    for expect in ("brownout-1", "brownout-2", "shed"):
        clock.advance(1.1)
        _miss(c)
        old, new = c.tick()
        assert new == expect
    # Top rung: sustained pressure holds, never overflows.
    clock.advance(1.1)
    _miss(c)
    assert c.tick() is None
    assert c.rung == "shed"


def test_ladder_recovers_after_cooldown_and_reports_knobs(ov):
    clock = Clock()
    c = _controller(ov, clock, batch_max_new=64, demote_blocks=8)
    c.force_rung("shed")
    kn = c.knobs()
    assert kn.shed_batch and not kn.admit_batch
    assert kn.prefill_budget_scale == 0.25
    assert kn.batch_max_new_cap == 16  # 64 halved twice past brownout-1
    # Old misses age out of the signal window -> calm; each recovery
    # step needs its own cooldown (hysteresis in time).
    _miss(c)
    clock.advance(6.0)  # > signal_window_s: samples gone
    assert c.tick() is None  # calm begins; cooldown not yet elapsed
    for expect in ("brownout-2", "brownout-1", "elevated", "normal"):
        clock.advance(2.1)
        old, new = c.tick()
        assert new == expect
    clock.advance(2.1)
    assert c.tick() is None  # at normal: nothing below to step to
    assert c.knobs().prefill_budget_scale == 1.0
    assert c.transitions_total == 4


def test_ladder_hysteresis_band_holds_the_rung(ov):
    clock = Clock()
    c = _controller(ov, clock, enter_attainment=0.80, exit_attainment=0.95)
    c.force_rung("elevated")
    # Attainment 0.9: above enter (no pressure), below exit (not
    # calm) — the band.  The rung must hold however long it lasts.
    for _ in range(20):
        for _ in range(9):
            c.note_slo("interactive", True, True, True)
        c.note_slo("interactive", False, True, False)
        clock.advance(3.0)
        assert c.tick() is None
    assert c.rung == "elevated"


def test_ladder_queue_wait_pressure_escalates(ov):
    clock = Clock()
    c = _controller(ov, clock, queue_wait_ms=100.0)
    for _ in range(4):
        c.observe_queue_wait(500.0)  # p90 far above the bar
    assert c.tick() is None  # pressure starts; dwell not yet elapsed
    clock.advance(1.1)
    for _ in range(4):
        c.observe_queue_wait(500.0)
    assert c.tick() == ("normal", "elevated")


def test_bad_hysteresis_config_refused(ov):
    with pytest.raises(ValueError):
        ov.OverloadController(enter_attainment=0.9, exit_attainment=0.8)


# ---------------------------------------------------------------------------
# Admission: deadline proof, backlog backstop, class gate
# ---------------------------------------------------------------------------

def test_admission_deadline_refusal_needs_evidence(ov):
    clock = Clock()
    c = _controller(ov, clock, max_queue=100)
    # No throughput evidence: a refusal must be provable, never
    # guessed — everything admits.
    assert c.admit("interactive", 10**6, 0.001, depth=0) is None
    # The admitted request lands in a queue and is then submitted
    # (push + pop release its backlog footprint, as the loop would).
    c.push(_entry("interactive", cost=10**6))
    assert c.pop() is not None
    # 1000 tokens/s observed prefill throughput.
    c.on_dispatch({"kind": "fused", "prefill_tokens": 1000,
                   "wall_ms": 1000.0, "k": 1, "occupancy": 1})
    r = c.admit("interactive", 10_000, 5.0, depth=0)
    assert r is not None and r.kind == "deadline"
    assert r.retry_after_s >= 1
    assert "timeout_s" in r.reason
    # The same prompt with a meetable deadline admits.
    assert c.admit("interactive", 10_000, 20.0, depth=0) is None
    # No timeout_s -> no deadline to prove against.
    assert c.admit("interactive", 10**6, None, depth=0) is None
    assert c.refused_deadline_total == 1


def test_admission_deadline_sees_inflight_admissions(ov):
    """Admitted requests still in transit through the server inbox
    (admit() ran, the loop has not yet drained them into a class
    queue) must count toward the next request's backlog estimate —
    a one-dispatch-long burst is exactly the overload window."""
    c = _controller(ov, Clock())
    c.on_dispatch({"kind": "fused", "prefill_tokens": 1000,
                   "wall_ms": 1000.0, "k": 1, "occupancy": 1})
    for _ in range(5):
        assert c.admit("interactive", 2000, 60.0, depth=0) is None
    # The sixth sees the burst's 10k in-flight tokens: est ~12 s.
    r = c.admit("interactive", 2000, 5.0, depth=0)
    assert r is not None and r.kind == "deadline"
    # Draining the inbox into the queues releases the reservations
    # (the tokens move to the queued footprint, then pop clears it).
    for _ in range(5):
        c.push(_entry("interactive", cost=2000))
    while c.pop() is not None:
        pass
    assert c.admit("interactive", 2000, 5.0, depth=0) is None


def test_admission_deadline_counts_backlog_ahead(ov):
    clock = Clock()
    c = _controller(ov, clock)
    c.on_dispatch({"kind": "fused", "prefill_tokens": 1000,
                   "wall_ms": 1000.0, "k": 1, "occupancy": 1})
    # 4000 interactive tokens queued ahead: a batch request sees them
    # all; its own 100 tokens alone would be fine.
    for _ in range(4):
        c.push(_entry("interactive", cost=1000))
    assert c.admit("batch", 100, 2.0, depth=4) is not None
    assert c.admit("batch", 100, 10.0, depth=4) is None
    c.push(_entry("batch", cost=100))  # the admitted batch request
    # Interactive-first ordering means interactive backlog only sees
    # the interactive queue — batch tokens ahead are irrelevant to it.
    c.push(_entry("batch", cost=50_000))
    assert c.admit("interactive", 100, 6.0, depth=6) is None


def test_admission_backlog_backstop_applies_even_when_disabled(ov):
    c = ov.OverloadController(enabled=False, max_queue=4)
    r = c.admit("interactive", 1, None, depth=4)
    assert r is not None and r.kind == "backlog"
    assert r.retry_after_s >= 1
    assert "overloaded" in r.reason
    # Disabled controller: no ladder, no deadline proof.
    assert c.tick() is None
    assert c.admit("batch", 10**6, 0.001, depth=0) is None


def test_admission_class_gate_at_brownout_2(ov):
    clock = Clock()
    c = _controller(ov, clock)
    c.force_rung("brownout-2")
    r = c.admit("batch", 10, None, depth=0)
    assert r is not None and r.kind == "class"
    # Interactive is the protected class — admitted at every rung.
    c.force_rung("shed")
    assert c.admit("interactive", 10, None, depth=0) is None
    assert c.refused_batch_total == 1


def test_retry_after_is_load_derived(ov):
    clock = Clock()
    c = _controller(ov, clock)
    c.on_dispatch({"kind": "insert", "prefill_tokens": 1000,
                   "wall_ms": 1000.0, "k": 1, "occupancy": 1})
    for _ in range(10):
        c.push(_entry("batch", cost=1000))
    # 10k tokens of backlog at 1k tokens/s -> ~10s (+1 rounding).
    assert 10 <= c.retry_after_s() <= 12
    # And it caps at 60 however deep the backlog.
    for _ in range(100):
        c.push(_entry("batch", cost=10_000))
    assert c.retry_after_s() == 60


# ---------------------------------------------------------------------------
# Queues: ordering, shedding, reaping
# ---------------------------------------------------------------------------

def test_disabled_controller_is_plain_fifo(ov):
    """priority_classes=off must be the genuinely pre-ladder behavior:
    one queue, arrival order — not interactive-first in disguise (the
    bench harness's static A/B arm depends on this)."""
    c = ov.OverloadController(enabled=False, max_queue=100)
    b1, i1, b2 = _entry("batch"), _entry("interactive"), _entry("batch")
    for e in (b1, i1, b2):
        c.push(e)
    assert [c.pop() for _ in range(3)] == [b1, i1, b2]


def test_queue_strict_interactive_first_fifo_within_class(ov):
    c = _controller(ov, Clock())
    b1, b2 = _entry("batch"), _entry("batch")
    i1, i2 = _entry("interactive"), _entry("interactive")
    for e in (b1, b2, i1, b_last := _entry("batch"), i2):
        c.push(e)
    assert [c.pop() for _ in range(5)] == [i1, i2, b1, b2, b_last]
    assert c.pop() is None


def test_shed_batch_only_at_shed_rung_and_only_batch(ov):
    c = _controller(ov, Clock())
    b1, b2, i1 = _entry("batch"), _entry("batch"), _entry("interactive")
    for e in (b1, i1, b2):
        c.push(e)
    assert c.shed_batch() == []  # normal rung: nothing shed
    c.force_rung("shed")
    assert c.shed_batch() == [b1, b2]
    assert c.sheds_total == 2
    assert c.pop() is i1  # interactive untouched
    assert c.queued_total() == 0


def test_reap_pulls_expired_and_disconnected(ov):
    clock = Clock(100.0)
    c = _controller(ov, clock)
    live = _entry("interactive", deadline=200.0)
    dead = _entry("interactive", deadline=99.0)
    gone = _entry("batch", disconnected=True)
    for e in (live, dead, gone):
        c.push(e)
    expired, disconnected = c.reap()
    assert expired == [dead] and disconnected == [gone]
    assert c.pop() is live and c.queued_total() == 0


def test_drain_all_empties_every_class(ov):
    c = _controller(ov, Clock())
    entries = [_entry("batch"), _entry("interactive"), _entry("batch")]
    for e in entries:
        c.push(e)
    assert set(map(id, c.drain_all())) == set(map(id, entries))
    assert c.queued_total() == 0


# ---------------------------------------------------------------------------
# Poisson schedule
# ---------------------------------------------------------------------------

def test_poisson_schedule_rate_and_determinism(ov):
    a = ov.poisson_schedule(100.0, 10.0, seed=7)
    b = ov.poisson_schedule(100.0, 10.0, seed=7)
    assert a == b  # seeded -> reproducible sweeps
    assert a == sorted(a) and all(0 <= t < 10.0 for t in a)
    # ~1000 arrivals, 4 sigma tolerance (sigma = sqrt(1000) ~ 32).
    assert 870 <= len(a) <= 1130
    assert ov.poisson_schedule(0.0, 10.0) == []
    assert ov.poisson_schedule(10.0, 0.0) == []


def test_constants_are_the_jax_packages():
    assert poverload.PRIORITIES == joverload.PRIORITIES
    assert poverload.CANARY == joverload.CANARY
    assert poverload.RUNG_INDEX == joverload.RUNG_INDEX


def test_summarize_flood_counts_classes_and_goodput(ov):
    recs = [
        dict(priority="interactive", status=200, ttft_ms=50.0,
             itl_max_ms=5.0, tokens=10, retry_after=None, hung=False),
        dict(priority="interactive", status=200, ttft_ms=500.0,
             itl_max_ms=5.0, tokens=7, retry_after=None, hung=False),
        dict(priority="batch", status=503, ttft_ms=None, itl_max_ms=None,
             tokens=0, retry_after="3", hung=False),
        dict(priority="batch", status=504, ttft_ms=None, itl_max_ms=None,
             tokens=0, retry_after=None, hung=False),
        dict(priority="batch", status=None, ttft_ms=None, itl_max_ms=None,
             tokens=0, retry_after=None, hung=True),
    ]
    s = ov.summarize_flood(recs, slo_ttft_ms=100.0, duration_s=2.0)
    assert s["offered"] == 5 and s["hung_total"] == 1
    assert s["interactive"]["served"] == 2
    assert s["interactive"]["slo_attainment"] == 0.5
    assert s["batch"]["refused_503"] == 1
    assert s["batch"]["refused_with_retry_after"] == 1
    assert s["batch"]["timeout_504"] == 1 and s["batch"]["errors"] == 1
    assert s["goodput_tokens_per_s"] == 5.0


def _drive(mod, seed):
    """A seeded mix of SLO notes, queue waits, dispatch records, pushes,
    pops, admissions and clock steps; every observable after each."""
    rng = random.Random(seed)
    clock = Clock()
    c = mod.OverloadController(clock=clock, dwell_s=1.0, cooldown_s=2.0,
                               signal_window_s=5.0, min_signal_samples=2,
                               max_queue=32)
    trace = []
    for i in range(400):
        op = rng.random()
        cls = rng.choice(("interactive", "batch"))
        if op < 0.25:
            ok = rng.random() < 0.5
            c.note_slo(cls, ok, True, ok)
        elif op < 0.35:
            c.observe_queue_wait(rng.choice((10.0, 500.0, 5000.0)))
        elif op < 0.45:
            c.on_dispatch({"kind": rng.choice(("insert", "decode")),
                           "prefill_tokens": rng.randint(0, 2000),
                           "wall_ms": rng.uniform(1.0, 500.0),
                           "k": rng.choice((1, 4, 8)),
                           "occupancy": rng.randint(0, 8)})
        elif op < 0.6:
            r = c.admit(cls, rng.randint(1, 4000),
                        rng.choice((None, 0.5, 5.0, 60.0)),
                        depth=c.queued_total())
            trace.append(None if r is None else (r.kind, r.retry_after_s,
                                                 r.reason))
            if r is None:
                c.push(types.SimpleNamespace(
                    priority=cls, cost_tokens=rng.randint(1, 4000),
                    deadline=None, disconnected=False, i=i))
        elif op < 0.7:
            e = c.pop()
            trace.append(None if e is None else e.i)
        elif op < 0.75:
            trace.append([e.i for e in c.shed_batch()])
        else:
            clock.advance(rng.choice((0.3, 1.1, 2.5)))
        trace.append((c.tick(), c.rung, c.queued_total(), c.knobs()))
    return trace, c.stats(), c.health()


@pytest.mark.parametrize("seed", [0, 1])
def test_both_packages_run_the_same_ladder(seed):
    jtrace, jstats, jhealth = _drive(joverload, seed)
    ptrace, pstats, phealth = _drive(poverload, seed)
    assert [t[:3] if isinstance(t, tuple) and len(t) == 4 else t
            for t in ptrace] == [
        t[:3] if isinstance(t, tuple) and len(t) == 4 else t
        for t in jtrace]
    assert [t[3].__dict__ if isinstance(t, tuple) and len(t) == 4 else None
            for t in ptrace] == [
        t[3].__dict__ if isinstance(t, tuple) and len(t) == 4 else None
        for t in jtrace]
    assert pstats == jstats
    assert phealth == jhealth
    assert any(isinstance(t, tuple) and len(t) == 4 and t[0]
               for t in jtrace)  # the drive moved the ladder
