"""Deterministic fault injection for the serving stack (a copy of
``jax_llama_tpu/faults.py``; it imports nothing of the package).

The serving stack hangs everything off one device-owning thread: an
exception out of a dispatch (``ContinuousBatcher.step`` / the batched
insert) or a block allocation kills the loop.  This module makes those
failure paths *testable and rehearsable*: a seeded :class:`FaultInjector`
with named injection sites wraps the batcher's dispatch points and can
raise device-style errors, fail allocations, or add latency — at a chosen
call index or with a seeded per-call probability — so both the test suite
and manual chaos runs (``run.py --inject-faults`` / ``JLT_FAULTS``)
exercise crash recovery, the retry budget, and the step watchdog
deterministically.

Sites (fired by ``ContinuousBatcher`` just before the real operation).
``SITES`` keeps the JAX package's list, so the two packages' specs and
``/metrics`` series agree; the port's batcher fires the ones whose
dispatch it has:

  ``step``           a decode/speculative step dispatch.  Chunked
                     dispatches (``decode_chunk`` / ``spec_rounds``
                     > 1) fire ONCE per chunk — the K decode iterations
                     or R speculative rounds of one ``step()`` are a
                     single dispatch, so ``@N`` indices count chunks,
                     not tokens or rounds
  ``insert``         a batched full-prompt prefill (``_paged_insert``)
  ``suffix_insert``  a prefix-cache-hit suffix prefill
                     (``_paged_suffix_insert``)
  ``prefill_chunk``  a chunk dispatch CARRYING a fused prefill lane
                     (``prefill_budget`` > 0); plain decode chunks do
                     not advance its counter
  ``alloc``          a block-pool allocation (``_alloc_blocks``)
  ``kv_swap``        a host-tier swap-in begin (``_begin_restore``:
                     an injected fault fails only that request)
  ``flash_kernel``   an insert whose prefill runs the flash kernel
                     (fired by the batcher per dispatch, AND by
                     ``ops._build.load`` when the kernel's library is
                     first loaded in the process and a hook is
                     installed — the moment a build failure would
                     surface; the batcher fire comes first)
  ``paged_kernel``   a decode or speculative dispatch on the paged
                     kernel (same batcher-then-load fire order)
  ``splash_kernel``  an insert whose chunks run the splash kernel
  ``stock_paged_kernel``  a decode dispatch whose T = 1 steps run the
                     stock-paged kernel
  ``spec_decode``    a speculative draft+verify dispatch — one round
                     classically, one R-round chunk under
                     ``spec_rounds`` > 1

The kernel/spec sites carry their site name on the raised exception
(``InjectedFault.site``), which is what lets the server's degradation
layer (``degrade.py``) attribute the failure to a feature and quarantine
it onto its fallback path instead of burning the crash-recovery budget.

Over a serving mesh (``parallel.lockstep``, run.py ``--http`` under
torchrun) every rank arms an injector with the same spec and seed: each
rank's batcher replays the same calls, so a batcher site fires at the
same call on every rank and the ranks agree that the call raised.  The
``router_replica`` and controller sites fire on rank 0 only, where the
router and the fleet controller run, from an injector of their own (the
same spec and seed): a ``site~P`` draw there would otherwise move rank
0's random stream alone, and a batcher's ``site~P`` then fire on one
rank only.  An injector armed on one rank
alone makes the ranks diverge, which stops them all.

Spec grammar (comma-separated, used by the CLI flag and ``JLT_FAULTS``)::

    site@N:kind[=value]     fire when the site's call counter == N
    site~P:kind[=value]     fire each call with probability P (seeded)

kinds: ``error`` (raise :class:`InjectedFault`, a device-style runtime
error), ``oom`` (raise :class:`InjectedOOM`, an allocation failure),
``delay=SECONDS`` (sleep, then proceed — the watchdog's test lever), and
``nan`` (arm a non-finite poison: the next guarded dispatch reports its
first active row's logits as non-finite — the test lever for the
serving layer's non-finite guard; no exception is raised).

Examples::

    step@5:error                 kill the 6th decode dispatch
    insert@0:error,alloc@3:oom   first prefill + 4th allocation
    step~0.01:error              1% of steps, deterministic per seed
    step@2:delay=1.5             stall one step by 1.5 s
    paged_kernel@0:error         kill the first kernel-path decode step
    stock_paged_kernel@0:error   kill the first stock-kernel decode step
                                 (quarantine falls back to the custom
                                 paged kernel, not to the gathered view)
    step@3:nan                   poison one row's logits on step 3
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence, Union

SITES = (
    "step", "insert", "suffix_insert", "prefill_chunk", "alloc",
    # Kernel sites fire once per dispatch that runs the named kernel
    # family.  ``flash_kernel`` covers the flash kernel
    # (csrc/flash_fwd.cu) on insert dispatches; ``paged_kernel`` covers
    # the block-table decode kernel (csrc/paged_decode.cu).  The two
    # ops/kernels.py slots get their own sites so a fault (or a real
    # launch error) attributes to the kernel actually selected:
    # ``splash_kernel`` (csrc/splash_prefill.cu on splash-eligible
    # insert chunks; flash_kernel still fires on those dispatches for
    # the non-eligible remainder) and ``stock_paged_kernel``
    # (csrc/stock_paged.cu on T=1 full-precision decode steps;
    # paged_kernel still fires for the dispatch it rides).
    "kv_swap", "flash_kernel", "paged_kernel", "splash_kernel",
    "stock_paged_kernel", "spec_decode",
    # Router-side site (router.ReplicaRouter's forward): an injected
    # fault here simulates the chosen replica dying at dispatch time —
    # the router marks it unhealthy and re-routes the request to a
    # surviving replica (CONTAINED: requests that have not streamed a
    # byte re-route losslessly; in-flight requests on a genuinely
    # crashed replica replay through that replica's own crash-recovery
    # path).
    "router_replica",
    # Controller-side sites: ``router.FleetController`` fires them.
    # ``session_migrate`` fires once per live session at the start of its
    # drain migration — an injected fault aborts THAT session's move
    # only: the source copy is untouched (export never demotes before
    # destination residency is proven), the session keeps serving from
    # the source, and the drain reports the failure instead of dropping
    # anyone.  ``scale_event``
    # fires at the start of each scale-up / scale-down / rollout-rung
    # action — an injected fault aborts the whole action cleanly (fleet
    # membership unchanged, decision record explains the abort).
    "session_migrate",
    "scale_event",
)
KINDS = ("error", "oom", "delay", "nan")


class InjectedFault(RuntimeError):
    """A deliberately injected device-style failure (INTERNAL).

    ``site`` names the injection site that raised — the degradation
    layer's attribution key (real device errors carry no site and are
    attributed from the batcher's last-dispatch record instead)."""

    def __init__(self, message: str, site: Optional[str] = None):
        super().__init__(message)
        self.site = site


class InjectedOOM(InjectedFault):
    """A deliberately injected allocation failure (RESOURCE_EXHAUSTED)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule: fire ``kind`` at ``site`` when the site's call
    counter equals ``at``, or (``at`` is None) with probability ``p`` per
    call drawn from the injector's seeded RNG."""

    site: str
    kind: str
    at: Optional[int] = None
    p: float = 0.0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; have {SITES}"
            )
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {KINDS}"
            )
        if self.at is None and not (0.0 < self.p <= 1.0):
            raise ValueError(
                "a FaultSpec needs an index (site@N) or a probability "
                "in (0, 1] (site~P)"
            )

    @classmethod
    def parse(cls, text: str) -> List["FaultSpec"]:
        """Parse the comma-separated CLI/env grammar (module docstring)."""
        specs: List[FaultSpec] = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            head, sep, kind = part.partition(":")
            if not sep:
                raise ValueError(
                    f"bad fault spec {part!r}: expected site[@N|~P]:kind"
                )
            kind, _, value = kind.partition("=")
            kind = kind.strip()
            at: Optional[int] = None
            p = 0.0
            if "@" in head:
                site, _, idx = head.partition("@")
                at = int(idx)
            elif "~" in head:
                site, _, prob = head.partition("~")
                p = float(prob)
            else:
                site, at = head, 0
            delay_s = 0.0
            if kind == "delay":
                if not value:
                    raise ValueError(
                        f"bad fault spec {part!r}: delay needs =SECONDS"
                    )
                delay_s = float(value)
            elif value:
                raise ValueError(
                    f"bad fault spec {part!r}: {kind} takes no =value"
                )
            specs.append(cls(
                site=site.strip(), kind=kind, at=at, p=p, delay_s=delay_s
            ))
        return specs


# ---------------------------------------------------------------------------
# Build-time hook registry
#
# ``ops._build.load`` calls ``fire_trace(<site>)`` when a kernel's
# library is first loaded in the process (flash_kernel, paged_kernel,
# splash_kernel, stock_paged_kernel) — the moment a failed build would
# surface on the card, the port's counterpart of the JAX package's
# trace-time fire.  One registry arms or clears every site at once
# (run.py --inject-faults installs ``injector.fire`` here and clears it
# on exit); a library already loaded does not fire again, so
# per-dispatch injection is the batcher-side site of the same name.
# faults.py imports nothing from the package, so ops._build can import
# this without cycles.
# ---------------------------------------------------------------------------

_trace_hook = None


def install_trace_hook(hook) -> None:
    """Install (or clear, with None) the build-time fault hook — called
    as ``hook(site)`` when a kernel's library is first loaded."""
    global _trace_hook
    _trace_hook = hook


def fire_trace(site: str) -> None:
    """Hook point for ``ops._build.load`` (no-op when unarmed)."""
    if _trace_hook is not None:
        _trace_hook(site)


class FaultInjector:
    """Seeded, counting fault injector shared by a batcher's sites.

    ``fire(site)`` increments the site's call counter, checks every spec
    for that site, and either returns (no match), sleeps (``delay``), or
    raises (``error``/``oom``).  Counters survive a batcher rebuild (the
    recovery path hands the same injector to the fresh batcher), so
    ``step@N`` indexes the N-th dispatch of the *process*, not of one
    batcher incarnation — which is what makes "kill step 5, recover,
    don't kill step 6" expressible.
    """

    def __init__(
        self,
        specs: Union[str, Sequence[FaultSpec], None] = None,
        seed: int = 0,
    ):
        if isinstance(specs, str):
            specs = FaultSpec.parse(specs)
        self.specs: List[FaultSpec] = list(specs or [])
        self._rng = random.Random(seed)
        self.calls: Dict[str, int] = {s: 0 for s in SITES}
        self.injected: Dict[str, int] = {s: 0 for s in SITES}
        self.injected_total = 0
        self.delays_total = 0
        self.nans_armed_total = 0
        self._nan_armed = False
        # Observability sink (obs.Observability.annotate — the batcher
        # wires it when it adopts the injector): every injection /
        # armed poison / delay lands as an instant event in the serving
        # trace, so a chaos drill's fault is explainable next to the
        # dispatch spans it killed.
        self.trace_sink = None

    def _trace(self, site: str, kind: str, call: int) -> None:
        if self.trace_sink is not None:
            self.trace_sink(
                "fault_injected", site=site, kind=kind, call=call
            )

    def fire(self, site: str) -> None:
        """Hook point: called by the batcher just before the real op."""
        n = self.calls.get(site, 0)
        self.calls[site] = n + 1
        for spec in self.specs:
            if spec.site != site:
                continue
            if spec.at is not None:
                hit = spec.at == n
            else:
                hit = self._rng.random() < spec.p
            if not hit:
                continue
            if spec.kind == "delay":
                self.delays_total += 1
                self._trace(site, "delay", n)
                time.sleep(spec.delay_s)
                continue
            if spec.kind == "nan":
                # Arm a non-finite poison instead of raising: the next
                # guarded dispatch (ContinuousBatcher consumes via
                # ``take_nan``) reports its first active row's logits as
                # non-finite — exercising the serving non-finite guard
                # end-to-end without needing the model to emit NaN.
                self.nans_armed_total += 1
                self._nan_armed = True
                self._trace(site, "nan", n)
                continue
            self.injected[site] = self.injected.get(site, 0) + 1
            self.injected_total += 1
            self._trace(site, spec.kind, n)
            if spec.kind == "oom":
                raise InjectedOOM(
                    f"RESOURCE_EXHAUSTED: injected allocation failure "
                    f"({site} call #{n})", site=site,
                )
            raise InjectedFault(
                f"INTERNAL: injected device error ({site} call #{n})",
                site=site,
            )

    def take_nan(self) -> bool:
        """Consume an armed ``nan`` poison (one dispatch at most)."""
        armed, self._nan_armed = self._nan_armed, False
        return armed

    def stats(self) -> Dict[str, float]:
        """Counters for the HTTP /metrics endpoint."""
        out: Dict[str, float] = {
            "faults_injected_total": self.injected_total,
            "fault_delays_total": self.delays_total,
            "fault_nans_armed_total": self.nans_armed_total,
        }
        for site in SITES:
            out[f"faults_injected_{site}_total"] = self.injected.get(
                site, 0
            )
        return out
