"""``jax_llama_tpu_torch.faults`` held against ``jax_llama_tpu.faults``:
each test body runs on both packages' module (the ``fl`` fixture), and the
two must behave identically — the spec grammar, counted and seeded
injection, delays, ``nan`` arming, stats, the trace sink and the
build-time hook.  The port's ``ops._build.load`` fires a serving kernel's
site on its library's first load; that is checked without a compiler by
failing the load at the hook."""

import random

import pytest

import jax_llama_tpu.faults as jfaults
import jax_llama_tpu_torch.faults as pfaults
from jax_llama_tpu_torch.ops import _build

MODULES = {"jax": jfaults, "port": pfaults}


@pytest.fixture(params=sorted(MODULES))
def fl(request):
    return MODULES[request.param]


def test_sites_and_kinds_are_the_jax_packages():
    assert pfaults.SITES == jfaults.SITES
    assert pfaults.KINDS == jfaults.KINDS


def test_fault_spec_parse(fl):
    FaultSpec = fl.FaultSpec
    specs = FaultSpec.parse(
        "step@5:error, alloc@0:oom,insert~0.25:error,step@3:delay=1.5"
    )
    assert specs[0] == FaultSpec(site="step", kind="error", at=5)
    assert specs[1] == FaultSpec(site="alloc", kind="oom", at=0)
    assert specs[2] == FaultSpec(site="insert", kind="error", p=0.25)
    assert specs[3] == FaultSpec(
        site="step", kind="delay", at=3, delay_s=1.5
    )
    # bare site defaults to index 0
    assert FaultSpec.parse("suffix_insert:error")[0].at == 0
    for bad in ("nosite@0:error", "step@0:nope", "step@0:delay",
                "step~0.0:error", "step~1.5:error", "step",
                "step@0:error=3"):
        with pytest.raises(ValueError):
            FaultSpec.parse(bad)


def test_injector_counts_and_raises(fl):
    inj = fl.FaultInjector("step@1:error,alloc@0:oom")
    inj.fire("step")                      # call 0: no match
    with pytest.raises(fl.InjectedFault) as e:
        inj.fire("step")                  # call 1: boom
    assert e.value.site == "step"
    inj.fire("step")                      # call 2: indices fire once
    with pytest.raises(fl.InjectedOOM):
        inj.fire("alloc")
    assert inj.calls["step"] == 3 and inj.calls["alloc"] == 1
    st = inj.stats()
    assert st["faults_injected_total"] == 2
    assert st["faults_injected_step_total"] == 1
    assert st["faults_injected_alloc_total"] == 1


def test_injector_probability_is_seeded(fl):
    def pattern(seed):
        inj = fl.FaultInjector("step~0.5:error", seed=seed)
        out = []
        for _ in range(64):
            try:
                inj.fire("step")
                out.append(0)
            except fl.InjectedFault:
                out.append(1)
        return out

    a, b, c = pattern(7), pattern(7), pattern(8)
    assert a == b                # deterministic per seed
    assert a != c                # varies across seeds
    assert 0 < sum(a) < 64       # actually probabilistic


def test_injector_delay(fl, monkeypatch):
    slept = []
    monkeypatch.setattr(fl.time, "sleep", slept.append)
    inj = fl.FaultInjector("step@0:delay=0.75")
    inj.fire("step")
    inj.fire("step")
    assert slept == [0.75]
    assert inj.delays_total == 1
    assert inj.injected_total == 0  # delays are not failures


def test_nan_arms_once_and_traces(fl):
    seen = []
    inj = fl.FaultInjector("paged_kernel@1:nan,insert@0:error")
    inj.trace_sink = lambda name, **f: seen.append((name, f))
    inj.fire("paged_kernel")
    assert not inj.take_nan()
    inj.fire("paged_kernel")              # arms, raises nothing
    assert inj.take_nan() and not inj.take_nan()
    with pytest.raises(fl.InjectedFault):
        inj.fire("insert")
    assert inj.stats()["fault_nans_armed_total"] == 1
    assert seen == [
        ("fault_injected", {"site": "paged_kernel", "kind": "nan",
                            "call": 1}),
        ("fault_injected", {"site": "insert", "kind": "error",
                            "call": 0}),
    ]


def _seeded_trace(mod, seed):
    rng = random.Random(seed)
    spec = ",".join(f"{s}~0.2:{rng.choice(('error', 'oom', 'nan'))}"
                    for s in mod.SITES)
    inj = mod.FaultInjector(spec, seed=seed)
    out = []
    for _ in range(400):
        site = rng.choice(mod.SITES)
        try:
            inj.fire(site)
            out.append((site, inj.take_nan()))
        except mod.InjectedFault as e:
            out.append((site, type(e).__name__, str(e), e.site))
    return out, inj.stats(), dict(inj.calls)


@pytest.mark.parametrize("seed", [0, 3])
def test_both_packages_inject_the_same_faults(seed):
    assert _seeded_trace(pfaults, seed) == _seeded_trace(jfaults, seed)


def test_trace_hook_install_and_clear(fl):
    fired = []
    fl.install_trace_hook(fired.append)
    try:
        fl.fire_trace("paged_kernel")
    finally:
        fl.install_trace_hook(None)
    fl.fire_trace("paged_kernel")         # cleared: no-op
    assert fired == ["paged_kernel"]


@pytest.mark.parametrize("source,site", [
    ("flash_fwd", "flash_kernel"), ("paged_decode", "paged_kernel"),
    ("splash_prefill", "splash_kernel"), ("stock_paged", "stock_paged_kernel"),
])
def test_first_kernel_load_fires_its_site(source, site):
    """A library's first load fires its serving site through the hook
    (what ``run.py --inject-faults`` installs), before any build: an
    armed fault fails the load with the site attached."""
    assert source not in _build._LOADED
    inj = pfaults.FaultInjector(f"{site}@0:error")
    pfaults.install_trace_hook(inj.fire)
    try:
        with pytest.raises(pfaults.InjectedFault) as e:
            _build.load(source)
    finally:
        pfaults.install_trace_hook(None)
    assert e.value.site == site and inj.calls[site] == 1
    assert source not in _build._LOADED


def test_only_serving_kernels_have_a_load_site():
    """The sites come from ``ops.kernels``' table, one for each
    selectable kernel's source; the training kernel's fires nothing."""
    from jax_llama_tpu_torch.ops import kernels

    assert kernels.fault_site_of_source("flash_bwd") is None
    assert {kernels.fault_site_of_source(s)
            for s in kernels.KERNEL_SOURCES.values()} == {
        "flash_kernel", "paged_kernel", "splash_kernel",
        "stock_paged_kernel"}
    assert set(kernels.KERNEL_SOURCES.values()) <= set(_build.loaded())
