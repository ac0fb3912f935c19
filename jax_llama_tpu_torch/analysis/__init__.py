"""Invariant auditor: static-analysis contracts for the port's serving
stack (port of ``jax_llama_tpu/analysis``, its AST passes).

The serving stack's load-bearing guarantees -- one packed fetch and no
steady-state upload per chunk dispatch, single-owner batcher state,
lock-guarded shared state, a bounded collective footprint on a serving
mesh -- are machine-checked contracts, runnable on the CPU in seconds:

  * :mod:`.hostsync` -- **host-boundary lint** (AST + taint): flags
    device->host syncs (``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` or ``np.asarray``
    of a device tensor, ``torch.cuda.synchronize``, an event's or a
    stream's ``synchronize``), Python control flow on device tensors,
    and tensors built on the device inside host loops; every sanctioned
    crossing carries an ``# audit: host-fetch(<reason>)``-style pragma,
    so ``grep 'audit: host-fetch'`` lists the stack's whole device->host
    surface with its reasons.
  * :mod:`.lockcheck` -- **lock-discipline checker** (AST): a
    guarded-field registry for ``Observability`` / ``DegradeManager`` /
    ``OverloadController`` / the router's classes / the lockstep
    ``Leader`` / the profiler claim (lock-guarded) and
    ``ContinuousBatcher`` / ``LLMServer`` (owner-thread-confined);
    unguarded touches need an ``# audit: racy-read(...)`` /
    ``locked(...)`` / ``unguarded(...)`` pragma carrying the safety
    argument.
  * :mod:`.schedules` -- **schedule explorer**: every ``racy-read`` /
    ``unguarded`` pragma maps to a deterministic interleaving model over
    the real classes; a pragma with no passing model is a finding.
  * :mod:`.metricscheck` -- **metrics-registry lint**: ``obs.METRICS``
    and the router's ``ROUTER_METRICS`` against their emission sites,
    both ways.
  * :mod:`.lowering` + :mod:`.contracts` -- **lowering auditor**: a
    declarative registry where every serving program (a
    ``utils.programs.program``: keyed like ``jax.jit``, CUDA graphs on
    the card) declares its donated args, its live-output (host-
    fetchable) surface and byte budget, and the forbidden full-pool-copy
    op classes; the auditor runs each program at a tiny example on the
    CPU under a recording dispatch mode and checks that every donated
    leaf is written in place and returned aliased.  New programs must
    register a contract (the coverage check fails otherwise).
  * :mod:`.retrace` -- **retrace auditor** (AST dataflow + runtime
    drill): every value entering a program's cache key -- static args
    and admission-shaped dims -- must flow through a bounded-domain
    constructor; each contract declares ``max_cache_keys`` and an
    admission sweep on CPU batchers holds ``serving.jit_cache_entries()``
    within it.  Sanction with ``# audit: trace-domain(...)``.
  * :mod:`.comms` -- **comms budgets**: each serving program's
    collectives on a two-rank serving mesh against its contract's
    :class:`~.contracts.CommsBudget`; a pool-shaped collective is a hard
    finding (``trace`` only: it spawns the ranks).

Run everything with ``python -m jax_llama_tpu_torch.analysis`` (exit 0
= clean); tier-1 runs the static gate through
``tests/test_torch_analysis.py``.  The pragma grammar lives in
README.md ("Static analysis").
"""

from .common import Finding, Pragmas  # noqa: F401
from .comms import BUDGETS  # noqa: F401
from .contracts import (  # noqa: F401
    REGISTRY, CommsBudget, ProgramContract,
)
from .hostsync import AUDITED_MODULES, HostBoundaryChecker  # noqa: F401
from .lockcheck import (  # noqa: F401
    CONFINEMENTS, LOCK_GUARDS, LockDisciplineChecker, LockGuard,
    ThreadConfinement,
)
from .lowering import LoweringAuditor  # noqa: F401

from typing import List


def run_all(trace: bool = True) -> List[Finding]:
    """Run every checker over the package; [] means clean.  ``trace``
    adds the layers that run programs: the lowering auditor's recorded
    runs, the retrace drill and the comms budgets (which spawn two
    ranks)."""
    from . import comms, metricscheck, retrace, schedules

    findings: List[Finding] = []
    findings.extend(HostBoundaryChecker().check_package())
    findings.extend(LockDisciplineChecker().check_package())
    findings.extend(LoweringAuditor().check_package(trace=trace))
    findings.extend(retrace.check_static())
    if trace:
        findings.extend(retrace.check_runtime())
        findings.extend(comms.check_package())
    findings.extend(schedules.check_package())
    findings.extend(metricscheck.check_package())
    return findings
