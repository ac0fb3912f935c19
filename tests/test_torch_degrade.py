"""``jax_llama_tpu_torch.degrade`` held against ``jax_llama_tpu.degrade``:
each test body runs on both packages' module (the ``dg`` fixture), and the
two must behave identically — the quarantine state machine's threshold,
window, cooldown and probe transitions under an injected clock (no
sleeping), its snapshot and stats, and the transition callback."""

import random

import pytest

import jax_llama_tpu.degrade as jdegrade
import jax_llama_tpu_torch.degrade as pdegrade

MODULES = {"jax": jdegrade, "port": pdegrade}


@pytest.fixture(params=sorted(MODULES))
def dg(request):
    return MODULES[request.param]


def test_features_are_the_jax_packages():
    assert pdegrade.FEATURES == jdegrade.FEATURES
    assert (pdegrade.HEALTHY, pdegrade.QUARANTINED, pdegrade.PROBING) == (
        jdegrade.HEALTHY, jdegrade.QUARANTINED, jdegrade.PROBING)


def test_state_machine_threshold_window_probe(dg):
    clock = [0.0]
    m = dg.DegradeManager(
        threshold=3, window_s=10.0, cooldown_s=5.0, clock=lambda: clock[0]
    )
    f = "paged_kernel"
    assert m.enabled(f) and not m.degraded()
    assert m.record_failure(f) is False
    assert m.record_failure(f) is False
    assert m.enabled(f)                      # below threshold
    assert m.record_failure(f) is True       # 3rd inside window: quarantine
    assert not m.enabled(f) and m.degraded()
    assert m.quarantined() == (f,)
    assert m.due_probes() == []
    clock[0] = 5.0                           # cooldown elapsed
    assert m.due_probes() == [f]
    m.start_probe(f)
    assert m.enabled(f)                      # probing counts as enabled
    assert m.snapshot()[f]["state"] == "probing"
    assert m.record_failure(f) is True       # probe failed: back
    assert not m.enabled(f)
    clock[0] = 9.9
    assert m.due_probes() == []
    clock[0] = 10.0
    m.start_probe(f)
    assert m.record_success(f) is True       # probe passed
    assert m.enabled(f) and not m.degraded()
    st = m.snapshot()[f]
    assert st["state"] == "healthy"
    assert st["failures_total"] == 4 and st["quarantines_total"] == 2
    assert st["probes_total"] == 2


def test_state_machine_window_expires_failures(dg):
    clock = [0.0]
    m = dg.DegradeManager(
        threshold=2, window_s=1.0, cooldown_s=1.0, clock=lambda: clock[0]
    )
    assert m.record_failure("spec_decode") is False
    clock[0] = 2.0                           # first failure aged out
    assert m.record_failure("spec_decode") is False
    clock[0] = 2.5
    assert m.record_failure("spec_decode") is True


def test_state_machine_rejects_unknown_feature(dg):
    m = dg.DegradeManager()
    with pytest.raises(KeyError):
        m.record_failure("nosuch")
    # success outside probing is a no-op, never a transition
    assert m.record_success(dg.FEATURES[0]) is False


def test_manager_stats_and_snapshot_shapes(dg):
    m = dg.DegradeManager()
    snap, stats = m.snapshot(), m.stats()
    for f in dg.FEATURES:
        assert snap[f]["state"] == "healthy"
        assert stats[f"feature_quarantined_{f}"] == 0


def test_transitions_reach_the_callback(dg):
    clock = [0.0]
    seen = []
    m = dg.DegradeManager(threshold=1, window_s=5.0, cooldown_s=2.0,
                          clock=lambda: clock[0])
    m.on_transition = lambda name, **f: seen.append((name, f))
    m.record_failure("stock_paged")
    clock[0] = 2.0
    (due,) = m.due_probes()
    m.start_probe(due)
    m.record_success(due)
    assert [f.get("state") for _, f in seen] == [
        "quarantined", "probing", "healthy"]
    assert all(f.get("feature") == "stock_paged" for _, f in seen)


def _drive(mod, seed):
    """A seeded sequence of failures, successes, probes and clock steps
    over every feature; returns every observable after each event."""
    rng = random.Random(seed)
    clock = [0.0]
    seen = []
    m = mod.DegradeManager(threshold=2, window_s=3.0, cooldown_s=1.5,
                           clock=lambda: clock[0])
    m.on_transition = lambda name, **f: seen.append((name, sorted(f.items())))
    trace = []
    for _ in range(300):
        f = rng.choice(mod.FEATURES)
        op = rng.random()
        if op < 0.4:
            r = m.record_failure(f)
        elif op < 0.6:
            r = m.record_success(f)
        elif op < 0.8:
            r = m.due_probes()
            for g in r:
                m.start_probe(g)
        else:
            clock[0] += rng.choice((0.25, 0.5, 1.0, 2.0))
            r = None
        trace.append((r, m.quarantined(), m.degraded(),
                      tuple(m.enabled(g) for g in mod.FEATURES)))
    return trace, m.stats(), seen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_both_packages_make_the_same_transitions(seed):
    jtrace, jstats, jseen = _drive(jdegrade, seed)
    ptrace, pstats, pseen = _drive(pdegrade, seed)
    assert ptrace == jtrace
    assert pstats == jstats
    assert pseen == jseen
    assert any(q for _, q, _, _ in jtrace)  # the drive quarantined
