"""The port's invariant auditor (``jax_llama_tpu_torch.analysis``) held
against the JAX package's (``jax_llama_tpu.analysis``).

The fixtures of ``tests/test_analysis.py`` that need no jaxpr (pragmas,
host boundary, lock discipline, the CLI, schedules, metrics, the passes'
robustness pins) run through both packages' checkers: the JAX fixture
as it is, the port's with its device code written in torch (``jnp``
becomes ``torch``, a jitted program a compiled one, a blocking fetch a
``.cpu()`` or a ``synchronize``), and the sorted rule names must match.
Then the port's own gates: its static audit is clean, every
cross-thread pragma has a passing schedule model, and its comms budgets
hold on a two-rank serving mesh.
"""

import json

import pytest

from jax_llama_tpu.analysis import metricscheck as jmetrics
from jax_llama_tpu.analysis import schedules as jsched
from jax_llama_tpu.analysis.__main__ import main as jcli
from jax_llama_tpu.analysis.common import Pragmas as JPragmas
from jax_llama_tpu.analysis.hostsync import HostBoundaryChecker as JHost
from jax_llama_tpu.analysis.lockcheck import (
    LockDisciplineChecker as JLock, LockGuard as JGuard,
    ThreadConfinement as JConf,
)

from jax_llama_tpu_torch.analysis import run_all
from jax_llama_tpu_torch.analysis import comms as pcomms
from jax_llama_tpu_torch.analysis import metricscheck as pmetrics
from jax_llama_tpu_torch.analysis import schedules as psched
from jax_llama_tpu_torch.analysis.__main__ import main as pcli
from jax_llama_tpu_torch.analysis.common import Pragmas as PPragmas
from jax_llama_tpu_torch.analysis.hostsync import (
    HostBoundaryChecker as PHost,
)
from jax_llama_tpu_torch.analysis.lockcheck import (
    CONFINEMENTS, LOCK_GUARDS, LockDisciplineChecker as PLock,
    LockGuard as PGuard, ThreadConfinement as PConf,
)

pytestmark = pytest.mark.analysis

BOTH = {"jax": (JPragmas, JHost, JLock, JGuard, JConf, jsched, jmetrics,
                jcli),
        "port": (PPragmas, PHost, PLock, PGuard, PConf, psched, pmetrics,
                 pcli)}


def rules(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# Pragma grammar
# ---------------------------------------------------------------------------

PRAGMA_CASES = {
    # (source, kind, span, allowed, bad)
    "single_line": ("x = 1  # audit: host-fetch(the one fetch)\n",
                    "host-fetch", (1, 1), True, False),
    "other_kind": ("x = 1  # audit: host-fetch(the one fetch)\n",
                   "host-upload", (1, 1), False, False),
    "multi_line": ("# audit: racy-read(a reason that wraps\n"
                   "# across two comment lines)\nx = 1\n",
                   "racy-read", (3, 3), True, False),
    "unknown_kind": ("# audit: host-fetchh(typo)\nx = 1\n",
                     "host-fetch", (2, 2), False, True),
    "missing_reason": ("# audit: host-fetch()\nx = 1\n",
                       "host-fetch", (2, 2), False, True),
}


@pytest.mark.parametrize("case", list(PRAGMA_CASES))
def test_pragma_grammar(case):
    src, kind, span, allowed, bad = PRAGMA_CASES[case]
    for pkg in BOTH.values():
        p = pkg[0].scan(src)
        assert p.allows(kind, span) is allowed, case
        assert bool(p.bad_lines) is bad, case


def test_bad_pragma_is_a_finding():
    for pkg in BOTH.values():
        fs = pkg[1]().check_source(
            "serving.py", "# audit: host-fetchh(typo)\nx = 1\n")
        assert rules(fs) == ["bad-pragma"]


# ---------------------------------------------------------------------------
# Host-boundary lint: JAX's fixtures and their torch counterparts
# ---------------------------------------------------------------------------

HOST_CASES = {
    # name: (JAX fixture, torch fixture, expected rules, findings)
    "stray_fetch": ("""
import numpy as np
import jax.numpy as jnp

class B:
    def step(self):
        packed = jnp.zeros((4,))
        return np.asarray(packed)
""", """
import numpy as np
import torch

class B:
    def step(self):
        packed = torch.zeros((4,))
        return np.asarray(packed)
""", ["host-fetch"], 1),
    "pragma_sanctions_fetch": ("""
import numpy as np
import jax.numpy as jnp

class B:
    def step(self):
        packed = jnp.zeros((4,))
        # audit: host-fetch(the one packed fetch per chunk)
        return np.asarray(packed)
""", """
import numpy as np
import torch

class B:
    def step(self):
        packed = torch.zeros((4,))
        # audit: host-fetch(the one packed fetch per chunk)
        return np.asarray(packed)
""", [], 0),
    "scalar_fetches": ("""
class B:
    def peek(self):
        return float(self.tau[0]), self.tau.item()
""", """
class B:
    def peek(self):
        return float(self.tau[0]), self.tau.item()
""", ["host-fetch"], 2),
    "device_control_flow": ("""
class B:
    def step(self):
        if self.d_active.any():
            return 1
        while self.tau > 0:
            pass
""", """
class B:
    def step(self):
        if self.d_active.any():
            return 1
        while self.tau > 0:
            pass
""", ["device-flow"], 2),
    "upload_in_loop": ("""
import jax.numpy as jnp

class B:
    def admit(self, rows):
        for r in rows:
            self.d_table = jnp.asarray(r)
""", """
import torch

class B:
    def admit(self, rows):
        for r in rows:
            self.d_table = torch.asarray(r)
""", ["host-upload"], 1),
    "trace_time_unrolling": ("""
import functools
import jax
import jax.numpy as jnp

def helper(n):
    out = []
    for i in range(n):
        out.append(jnp.zeros((4,)))
    return out

@functools.partial(jax.jit, static_argnames=("n",))
def program(x, *, n):
    return sum(helper(n)) + x
""", """
import functools
import torch

def helper(n):
    out = []
    for i in range(n):
        out.append(torch.zeros((4,)))
    return out

@functools.partial(torch.compile, dynamic=False)
def program(x, n):
    return sum(helper(n)) + x
""", [], 0),
    "unconditional_syncs": ("""
import jax

class B:
    def wait(self, staged):
        jax.block_until_ready(staged)
        jax.device_get(staged)
""", """
import torch

class B:
    def wait(self, staged):
        torch.cuda.synchronize()
        staged.event.synchronize()
""", ["host-fetch"], 2),
    "numpy_mirror": ("""
import numpy as np
class B:
    def f(self):
        return np.asarray(self.tau_lp)
""", """
import numpy as np
class B:
    def f(self):
        return np.asarray(self.tau_lp)
""", [], 0),
    "is_none_test": ("""
class B:
    def f(self):
        if self.pool is not None:
            return 1
""", """
class B:
    def f(self):
        if self.pool is not None:
            return 1
""", [], 0),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_boundary_fixture_matches_jax(case):
    jsrc, psrc, want, n = HOST_CASES[case]
    jfs = JHost().check_source("serving.py", jsrc, module="serving")
    pfs = PHost().check_source("serving.py", psrc, module="serving")
    assert rules(jfs) == rules(pfs) == want
    assert len(jfs) == len(pfs) == n


TORCH_CASES = {
    # The torch sinks and sources the JAX rules translate to.
    "item_cpu_tolist_numpy": ("""
import torch
class B:
    def f(self, dev):
        x = torch.zeros((4,), device=dev)
        return x.item(), x.cpu(), x.tolist(), x.numpy(), int(x[0])
""", ["host-fetch"], 5),
    "host_tensors_are_free": ("""
import numpy as np
import torch
class B:
    def f(self, a):
        x = torch.from_numpy(a)
        y = torch.zeros((4,), device="cpu")
        z = torch.empty((4,), pin_memory=True)
        return x.tolist(), y.item(), np.asarray(z), self.tau.shape[0]
""", [], 0),
    "fetch_result_is_host": ("""
class B:
    def f(self):
        arr = self.d_fill.cpu().numpy()
        if arr[0] > 0:
            return int(arr[1])
""", ["host-fetch"], 1),
    "uploads_in_loop": ("""
import torch
class B:
    def f(self, rows, host):
        for r in rows:
            a = torch.tensor(r, device=self.device)
            b = torch.from_numpy(host).to(self.device)
            c = host_t.cuda()
            d = torch.zeros((4,), device="cpu")
            e = self.d_pos.to(torch.float32)
""", ["host-upload"], 3),
    "identity_is_host": ("""
class B:
    def f(self, draft_params):
        spec = draft_params is not None
        if spec:
            return 1
""", [], 0),
}


@pytest.mark.parametrize("case", list(TORCH_CASES))
def test_host_boundary_torch_rules(case):
    src, want, n = TORCH_CASES[case]
    fs = PHost().check_source("serving.py", src, module="serving")
    assert rules(fs) == want and len(fs) == n, [f.render() for f in fs]


def test_host_boundary_package_clean():
    fs = PHost().check_package()
    assert fs == [], "\n".join(f.render() for f in fs)


# ---------------------------------------------------------------------------
# Lock discipline (the fixtures name no jax: one source, both checkers)
# ---------------------------------------------------------------------------

LOCK_FIXTURE = """
import threading

class Obs:
    def __init__(self):
        self._lock = threading.Lock()
        self.ring = []

    def good(self):
        with self._lock:
            self.ring.append(1)

    def bad(self):
        self.ring.append(2)

    def _drain_locked(self):
        self.ring.clear()

    def annotated(self):
        # audit: locked(caller holds self._lock)
        self.ring.append(3)
"""

CONFINED_FIXTURE = """
class Batcher:
    def step(self):
        self.table[0] = 1  # owner method: fine

    def stats(self):
        return len(self.table)  # foreign method, no pragma

class Server:
    def handler(self):
        return server.batcher.table  # holder access, no pragma
"""


def _fixture_registry(pkg, foreign=("stats",)):
    _, _, Lock, Guard, Conf = pkg[:5]
    return Lock(
        lock_guards=(Guard(module="fix", cls="Obs", lock="_lock",
                           fields=frozenset({"ring"})),),
        confinements=(Conf(
            module="fix", cls="Batcher", owner="the loop thread",
            fields=frozenset({"table"}),
            foreign_methods=frozenset(foreign),
            holders=frozenset({"batcher"}),
        ),),
    )


LOCK_CASES = {
    # name: (source, foreign methods, expected rules, findings, lines)
    "unguarded_write": (LOCK_FIXTURE, ("stats",), ["unlocked-access"], 1,
                        [14]),
    "confinement_and_holder": (CONFINED_FIXTURE, ("stats",),
                               ["foreign-thread-access"], 2, [7, 11]),
    "stale_foreign_method": (CONFINED_FIXTURE, ("gone",),
                             ["foreign-thread-access", "stale-registry"],
                             2, [2, 11]),
}


@pytest.mark.parametrize("case", list(LOCK_CASES))
def test_lock_fixture_matches_jax(case):
    src, foreign, want, n, lines = LOCK_CASES[case]
    got = {}
    for name, pkg in BOTH.items():
        fs = _fixture_registry(pkg, foreign).check_source(
            "fix.py", src, module="fix")
        got[name] = (rules(fs), len(fs), sorted(f.line for f in fs))
    assert got["jax"] == got["port"] == (want, n, lines)


def test_module_guard_fixture():
    """The port's module-level guard (``cls=None``): the profiler claim's
    globals outside ``with <lock>:`` are findings; inside, or in a
    ``*_locked`` function, they are not."""
    src = (
        "import threading\n"
        "_LOCK = threading.Lock()\n"
        "_OWNER = None\n"
        "def claim(o):\n"
        "    global _OWNER\n"
        "    with _LOCK:\n"
        "        _OWNER = o\n"
        "def peek():\n"
        "    return _OWNER\n"
        "def _drop_locked():\n"
        "    global _OWNER\n"
        "    _OWNER = None\n"
    )
    checker = PLock(lock_guards=(PGuard(module="fix", cls=None,
                                        lock="_LOCK",
                                        fields=frozenset({"_OWNER"})),),
                    confinements=())
    fs = checker.check_source("fix.py", src, module="fix")
    assert rules(fs) == ["unlocked-access"] and [f.line for f in fs] == [9]


def test_lock_registry_covers_the_stack():
    guarded = {(g.module, g.cls) for g in LOCK_GUARDS}
    confined = {(c.module, c.cls) for c in CONFINEMENTS}
    for want in (("obs", "Observability"), ("obs", "DecisionLog"),
                 ("degrade", "DegradeManager"),
                 ("overload", "OverloadController"),
                 ("server", "LLMServer"), ("router", "ReplicaRouter"),
                 ("router", "FleetController"), ("lockstep", "Leader"),
                 ("profiling", None)):
        assert want in guarded, want
    assert ("serving", "ContinuousBatcher") in confined
    assert ("server", "LLMServer") in confined


def test_lock_discipline_package_clean():
    fs = PLock().check_package()
    assert fs == [], "\n".join(f.render() for f in fs)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_clean_package_exits_zero(capsys):
    assert pcli(["--no-trace"]) == 0
    assert "clean" in capsys.readouterr().out


CLI_CASES = {
    # name: (JAX file, port file, basename, argv head, exit code, needle)
    "violating_file": (
        "import numpy as np\nimport jax.numpy as jnp\nclass B:\n"
        "    def f(self):\n        v = jnp.zeros((2,))\n"
        "        return np.asarray(v)\n",
        "import numpy as np\nimport torch\nclass B:\n"
        "    def f(self):\n        v = torch.zeros((2,))\n"
        "        return np.asarray(v)\n",
        "bad.py", [], 1, "host-fetch"),
    "lock_fixture": (
        "class ContinuousBatcher:\n    def stats(self):\n"
        "        return len(self.queue)\n",
        "class ContinuousBatcher:\n    def stats(self):\n"
        "        return len(self.queue)\n",
        "serving.py", [], 1, "foreign-thread-access"),
    "json_output": (
        "import jax\nclass B:\n    def f(self, staged):\n"
        "        jax.block_until_ready(staged)\n",
        "import torch\nclass B:\n    def f(self, staged):\n"
        "        torch.cuda.synchronize()\n",
        "bad.py", ["--json"], 10, "host-fetch"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_file_exit_codes_match_jax(case, tmp_path, capsys):
    jsrc, psrc, base, head, code, needle = CLI_CASES[case]
    for name, src in (("jax", jsrc), ("port", psrc)):
        d = tmp_path / name
        d.mkdir()
        (d / base).write_text(src)
        assert BOTH[name][7](head + [str(d / base)]) == code, name
        out = capsys.readouterr().out
        assert needle in out, name
        if "--json" in head:
            payload = json.loads(out)
            assert payload[0]["rule"] == "host-fetch"
            assert payload[0]["checker"] == "host-boundary"
            assert payload[0]["severity"] == "error"
            assert payload[0]["sanctionable"] in (True, False)


@pytest.mark.parametrize("argv", [
    ["--checker", "lowering"], ["--checker", "retrace"],
    ["--contracts", "anything"]], ids=["lowering", "retrace", "contracts"])
def test_cli_jaxpr_passes_name_a16_part_3(argv, capsys):
    assert pcli(argv) == 2
    assert "A16 part 3" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Schedule explorer
# ---------------------------------------------------------------------------

def _toctou_model(sched, safe):
    def make():
        class PF:
            remaining = 7

        class S:
            pass

        s = S()
        s.pf = PF()
        return s

    def racy_reader(s):
        if s.pf is not None:
            return s.pf.remaining
        return 0

    def safe_reader(s):
        pf = s.pf
        if pf is not None:
            return pf.remaining
        return 0

    return sched.ScheduleModel(
        name="fixture-toctou", module="x", func="reader",
        claim="snapshot", make=make,
        writers={"loop": (
            sched.Op("null", lambda s, c: setattr(s, "pf", None),
                     frozenset({"pf"})),
        )},
        reader=safe_reader if safe else racy_reader,
        trace_fn="safe_reader" if safe else "racy_reader",
    )


def _two_writers(sched):
    return sched.ScheduleModel(
        name="two-writers", module="x", func="f", claim="single-writer",
        make=lambda: type("S", (), {"n": 0})(),
        writers={
            "a": (sched.Op("wa", lambda s, c: setattr(s, "n", 1),
                           frozenset({"n"})),),
            "b": (sched.Op("wb", lambda s, c: setattr(s, "n", 2),
                           frozenset({"n"})),),
        })


def _happens_before(sched, edge):
    def make():
        s = type("S", (), {})()
        s.x = None
        return s

    def read(s, c):
        assert s.x is not None, "read before write"

    write = sched.Op("write", lambda s, c: setattr(s, "x", c),
                     frozenset({"x"}))
    return sched.ScheduleModel(
        name="hb", module="x", func="f", claim="happens-before", make=make,
        writers={"main": (write,), "loop": (sched.Op("read", read),)},
        after={"loop": ("main", edge)} if edge else {})


def _vacuous_edge(sched):
    return sched.ScheduleModel(
        name="vac", module="x", func="f", claim="happens-before",
        make=lambda: object(),
        writers={"main": (sched.Op("w", lambda s, c: None),),
                 "loop": (sched.Op("r", lambda s, c: None),)},
        after={"loop": ("main", "TYPO_no_such_op")})


SCHEDULE_CASES = {
    # name: (model builder, expected: fails?, substring of first failure)
    "toctou_reader_fails": (lambda m: _toctou_model(m, False), True,
                            "AttributeError"),
    "snapshot_safe_reader_passes": (lambda m: _toctou_model(m, True),
                                    False, None),
    "single_writer_violation": (_two_writers, True,
                                "single-writer claim is structurally void"),
    "happens_before_without_edge": (lambda m: _happens_before(m, None),
                                    True, None),
    "happens_before_edge_enforced": (lambda m: _happens_before(m, "write"),
                                     False, None),
    "unsatisfiable_edge_not_vacuous": (_vacuous_edge, True,
                                       "no complete schedule"),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_schedule_fixture_matches_jax(case):
    build, fails, needle = SCHEDULE_CASES[case]
    for sched in (jsched, psched):
        got = sched.explore(build(sched))
        assert bool(got) is fails, (sched.__name__, got)
        if needle:
            assert needle in got[0], got


def test_unmodeled_pragma_is_a_finding():
    src = (
        "class C:\n"
        "    def f(self):\n"
        "        # audit: racy-read(nobody modeled this)\n"
        "        return self.x\n"
    )
    for sched in (jsched, psched):
        fs = sched.check_package(models=[], sources=[("fixmod.py", src)])
        assert [f.rule for f in fs] == ["unmodeled-pragma"]


def test_stale_model_is_a_finding():
    ghost = psched.ScheduleModel(
        name="ghost", module="serving", func="no_such_method",
        claim="owner-thread", make=lambda: object(), writers={})
    fs = psched.check_package(models=[ghost])
    assert any(f.rule == "stale-model" for f in fs)


def test_every_pragma_site_has_a_passing_model():
    fs = psched.check_package()
    assert fs == [], "\n".join(f.render() for f in fs)
    keys = {(s.module, s.func) for s in psched.pragma_sites()}
    for want in (("serving", "stats"), ("serving", "_window_acceptance"),
                 ("server", "_health"), ("server", "_watchdog"),
                 ("lockstep", "stats")):
        assert want in keys, want


# ---------------------------------------------------------------------------
# Metrics-registry lint
# ---------------------------------------------------------------------------

def test_metrics_package_clean():
    fs = pmetrics.check_package()
    assert fs == [], "\n".join(f.render() for f in fs)


def test_ghost_registration_caught():
    from jax_llama_tpu_torch import obs

    reg = dict(obs.METRICS)
    reg["ghost_gauge_total"] = ("counter", "never emitted")
    fs = pmetrics.check_package(registry=reg)
    assert any(f.rule == "unemitted-metric"
               and "ghost_gauge_total" in f.message for f in fs)


METRIC_CASES = {
    # name: (source, registry, providers, rule, name in message, present)
    "unregistered_emission": (
        "class P:\n    def stats(self):\n"
        "        return {'rogue_scalar': 1}\n",
        {"known": ("gauge", "k")}, (("provider_mod", "P", "stats"),),
        "unregistered-metric", "rogue_scalar", True),
    "templated_family_matches": (
        "SITES = ('a',)\nclass P:\n    def stats(self):\n"
        "        out = {}\n        for s in SITES:\n"
        "            out[f'faults_injected_{s}_total'] = 1\n"
        "        return out\n",
        {"faults_injected_step_total": ("counter", "x")},
        (("provider_mod", "P", "stats"),),
        "unregistered-metric", "", False),
    "docstring_not_emission": (
        '"""Module docs mention ghost_gauge by name."""\nclass P:\n'
        '    """Docs: ghost_gauge again."""\n    def stats(self):\n'
        "        return {}\n",
        {"ghost_gauge": ("gauge", "x")}, (),
        "unemitted-metric", "ghost_gauge", True),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metrics_fixture_matches_jax(case):
    src, reg, providers, rule, name, present = METRIC_CASES[case]
    got = []
    for m in (jmetrics, pmetrics):
        fs = m.check_package(registry=reg,
                             sources=[("provider_mod.py", src)],
                             providers=providers)
        got.append(rules(fs))
        assert any(f.rule == rule and name in f.message
                   for f in fs) is present, [f.render() for f in fs]
    assert got[0] == got[1]


def test_router_registry_package_clean():
    fs = pmetrics.check_router_registry()
    assert fs == [], "\n".join(f.render() for f in fs)


def test_router_registry_drift_fixtures():
    src = (
        '"""Docstring naming llm_router_doc_only_total is not '
        'emission evidence."""\n'
        'ROUTER_METRICS = {\n'
        '    "llm_router_emitted_total": ("counter", "ok"),\n'
        '    "llm_router_ghost_total": ("counter", "never"),\n'
        '}\n'
        'def fam(name):\n'
        '    pass\n'
        'def render(lines, n):\n'
        '    fam("llm_router_emitted_total")\n'
        '    fam("llm_router_undeclared_total")\n'
        '    lines.append(f"llm_router_emitted_total {n}")\n'
        '    lines.append(f"llm_fleet_raw_gauge {n}")\n'
    )
    registry = {
        "llm_router_emitted_total": ("counter", "ok"),
        "llm_router_ghost_total": ("counter", "never"),
    }
    got = []
    for m in (jmetrics, pmetrics):
        fs = m.check_router_registry(registry=registry, source=src,
                                     path="fixture_router.py")
        got.append(sorted((f.rule, f.line) for f in fs))
        assert [f for f in fs if f.rule == "router-unemitted-metric"
                and "llm_router_ghost_total" in f.message]
        assert not any("llm_router_emitted_total" in f.message
                       or "llm_router_doc_only_total" in f.message
                       for f in fs)
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# The passes' own robustness pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,needle", [
    (["--checker", "comms", "--no-trace"], "vacuous"),
    (["--checker", "schedules", "x.py"], "does not take file paths")],
    ids=["comms_no_trace", "registry_pass_with_paths"])
def test_cli_usage_errors_match_jax(argv, needle, capsys):
    for cli in (jcli, pcli):
        assert cli(argv) == 2
        assert needle in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Comms budgets
# ---------------------------------------------------------------------------

POOL = {(2, 1, 8, 16, 16), (1, 8, 16, 16)}
COMMS_CASES = {
    # name: (calls, expected rules)
    "within_budget": ([("_chunk_scan", [("all_reduce", (8, 64), 2048)] * 20
                        + [("all_gather", (2, 128), 1024)] * 4)], []),
    "pool_shaped": ([("_chunk_scan", [("all_gather", (2, 1, 8, 16, 16),
                                       2048)])], ["pool-collective"]),
    "too_many": ([("_paged_insert", [("all_reduce", (8, 64), 2048)] * 6)],
                 ["comms-count"]),
    "unbudgeted_kind": ([("_chunk_scan", [("agree", (), 0)])],
                        ["comms-count"]),
    "too_large": ([("_chunk_scan", [("all_reduce", (64, 64), 16384)])],
                  ["comms-bytes"]),
    "no_budget": ([("_fused_chunk", [("all_reduce", (8, 64), 2048)])],
                  ["no-comms-budget"]),
    "silent_program": ([("_fused_chunk", [])], []),
}


@pytest.mark.parametrize("case", list(COMMS_CASES))
def test_comms_budget_rules(case):
    calls, want = COMMS_CASES[case]
    assert rules(pcomms.check_records(calls, POOL)) == want


def test_comms_budgets_hold_on_a_serving_mesh():
    """The serving programs on two gloo ranks (tensor = 2): every call
    within its budget, no pool-shaped collective, and the budgets are
    tight (each counted kind reaches its bound in some call)."""
    calls, forbidden = pcomms.run_example()
    fs = pcomms.check_records(calls, forbidden)
    assert fs == [], "\n".join(f.render() for f in fs)
    seen = pcomms.summarize(calls)
    for program, budget in pcomms.BUDGETS.items():
        assert seen[program]["max_count"] == budget.max_count, program
    assert forbidden


# ---------------------------------------------------------------------------
# run_all: the tier-1 cleanliness gate
# ---------------------------------------------------------------------------

def test_package_clean_static_gate():
    """Every static pass is clean on the port: a stray sync, an
    unguarded access or a metrics drift fails tier-1 here."""
    findings = run_all(trace=False)
    assert findings == [], "\n".join(f.render() for f in findings)
