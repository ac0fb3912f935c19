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
  * :mod:`.comms` -- **comms budgets**: each serving program's
    collectives on a two-rank serving mesh against its
    :class:`~.comms.CommsBudget`; a pool-shaped collective is a hard
    finding (``trace`` only: it spawns the ranks).

The JAX package's jaxpr passes (``lowering``, ``contracts``,
``retrace``) are ROADMAP A16 part 3: they read compiled programs, and
the port has none until its CUDA graphs (A4).

Run everything with ``python -m jax_llama_tpu_torch.analysis`` (exit 0
= clean); tier-1 runs the static gate through
``tests/test_torch_analysis.py``.  The pragma grammar lives in
README.md ("Static analysis").
"""

from .common import Finding, Pragmas  # noqa: F401
from .comms import BUDGETS, CommsBudget  # noqa: F401
from .hostsync import AUDITED_MODULES, HostBoundaryChecker  # noqa: F401
from .lockcheck import (  # noqa: F401
    CONFINEMENTS, LOCK_GUARDS, LockDisciplineChecker, LockGuard,
    ThreadConfinement,
)

from typing import List


def run_all(trace: bool = True) -> List[Finding]:
    """Run every checker over the package; [] means clean.  ``trace``
    adds the comms budgets, which run the serving programs on two
    spawned ranks."""
    from . import comms, metricscheck, schedules

    findings: List[Finding] = []
    findings.extend(HostBoundaryChecker().check_package())
    findings.extend(LockDisciplineChecker().check_package())
    if trace:
        findings.extend(comms.check_package())
    findings.extend(schedules.check_package())
    findings.extend(metricscheck.check_package())
    return findings
