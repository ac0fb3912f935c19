"""Overload control: deadline-aware admission, priority shedding, and
an SLO-driven brownout ladder (a copy of ``jax_llama_tpu/overload.py``;
it imports nothing of the package).  The brownout rungs shrink the
batcher's live fused-prefill budget (``ContinuousBatcher.prefill_budget``,
read by ``_pf_chunk`` at each fused admission) and run the host-tier
demotion sweep (``ContinuousBatcher.demote_idle``).  Over a serving mesh
of more than one rank the controller runs on rank 0 only (it reads the
clock and the sockets there); the budget write and the sweep reach the
other ranks as records of the lockstep log (``parallel.lockstep``).

A static FIFO depth count (``LLMServer.max_queue`` -> bare 503) alone
would give a 32k-token prompt and a 16-token ping the same admission
slot, and nothing would react when the SLO attainment gauges (obs.py)
crater under load.  This module is the controller: it reads the
sensors ``obs.py`` keeps (TTFT / ITL / queue-wait histograms, windowed
attainment, goodput) and turns the knobs the stack already exposes.

Three pieces, one :class:`OverloadController` (owned by ``LLMServer``,
surviving batcher rebuilds the way ``DegradeManager`` does):

  * **Deadline- and cost-aware admission with priority classes.**
    POST payloads carry an optional ``"priority"`` ("interactive" |
    "batch"; junk is a 400).  The controller keeps per-class queues
    with strict interactive-first ordering (FIFO within a class), and
    admission is cost-based: EWMAs of observed prefill/decode
    throughput — fed from the dispatch records the obs ring already
    captures, zero new device work — convert prompt length + queue
    backlog into a conservative TTFT estimate (queueing + own prefill
    alone, a LOWER bound on the real TTFT), and a request whose
    ``timeout_s`` deadline provably cannot be met even by that lower
    bound is refused immediately with 503 + a load-derived
    ``Retry-After`` instead of queuing to die in the reaper.  With no
    throughput evidence yet (cold server) everything is admitted — a
    refusal must be provable, never guessed.

  * **Brownout ladder** — deliberately distinct from ``degrade.py``'s
    failure-driven quarantine: that reacts to *crashes*, this reacts
    to *load*.  A hysteresis state machine::

        normal -> elevated -> brownout-1 -> brownout-2 -> shed

    driven by the windowed interactive-class SLO attainment and recent
    queue-wait samples.  Escalation requires the pressure to persist
    for ``dwell_s``; recovery steps DOWN one rung at a time after
    ``cooldown_s`` of calm (attainment back above the — higher —
    ``exit_attainment`` bar, or no recent traffic), the
    quarantine->probing pattern applied to load.  Each rung turns
    knobs the stack already has (the server applies them; the
    controller, like ``DegradeManager``, is pure bookkeeping and
    never touches the batcher):

      ==========  ======================================================
      rung        action (cumulative down the ladder)
      ==========  ======================================================
      normal      baseline knobs
      elevated    shrink ``prefill_budget`` to half (protect ITL:
                  smaller prefill slices per decode chunk)
      brownout-1  + cap batch-class ``max_new_tokens``; proactively
                  ``demote_idle()`` the KV host tier to free HBM
      brownout-2  + refuse NEW batch-class admissions (503 +
                  Retry-After); prefill budget to a quarter
      shed        + shed already-QUEUED batch-class entries (clean 503
                  + Retry-After — never a hang); interactive keeps
                  serving
      ==========  ======================================================

    Every transition is a structured-log line, an obs annotation, and
    a ``/metrics`` gauge + ``/healthz`` section (wired in server.py).

  * **Open-loop load harness** (:func:`poisson_schedule`,
    :func:`open_loop_flood`, :func:`summarize_flood`).  A Poisson-
    arrival generator that fires requests at their scheduled times
    REGARDLESS of completions (open-loop — the arrival process does
    not slow down when the server does, which is exactly what makes
    overload visible; a closed-loop client self-throttles and hides
    it).  ``bench.py`` sweeps it over request rate for the
    ``serving_goodput_vs_rate`` record; ``tests/test_overload.py``
    uses it for the flood drill (every refused/shed request gets a
    well-formed 503 + Retry-After, zero hung clients).

Thread-safety: handler threads call ``admit()`` while the serving loop
pushes/pops/ticks, so every method takes the one internal ``_lock``
(registered with the lock-discipline checker,
``analysis/lockcheck.py``).  Shed/deadline refusals are deliberate
load decisions and are NOT SLO-scored — counting them as latency
misses would wedge the ladder at its top rung (the misses it sheds to
avoid would keep it escalated forever).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

PRIORITIES = ("interactive", "batch")

# Reserved request class for the router's synthetic canary probes
# (router.py).  NOT a member of PRIORITIES on purpose: canaries ride
# the interactive queue for ordering (``_priority_of`` maps unknown
# classes there), but the server excludes the class from SLO
# attainment, goodput, the latency histograms/EWMAs and the brownout
# ladder's signal windows — a fleet whose only traffic is its own
# probes must read healthy and must never brown itself out.
CANARY = "canary"

# Ladder rungs, mildest first.  RUNG_INDEX is the /metrics gauge value.
RUNGS = ("normal", "elevated", "brownout-1", "brownout-2", "shed")
RUNG_INDEX = {name: i for i, name in enumerate(RUNGS)}


@dataclasses.dataclass(frozen=True)
class Refusal:
    """An admission refusal (always HTTP 503 — the request may succeed
    on retry or elsewhere; 4xx is reserved for defective payloads)."""

    reason: str
    retry_after_s: int
    kind: str  # "backlog" | "deadline" | "class"


@dataclasses.dataclass(frozen=True)
class RungKnobs:
    """The knob settings one ladder rung asks the server to apply.
    ``demote_blocks`` fires once on ENTERING the rung (an operational
    sweep, not a steady-state drain)."""

    prefill_budget_scale: float
    batch_max_new_cap: int      # 0 = uncapped
    admit_batch: bool           # False: new batch POSTs refused
    demote_blocks: int
    shed_batch: bool            # True: queued batch entries are shed


class OverloadController:
    """Load-driven admission + brownout state machine (module docstring).

    Queue entries are duck-typed: anything with ``priority``,
    ``cost_tokens``, ``deadline`` (absolute monotonic or None) and
    ``disconnected`` attributes (the server's ``_Pending``; tests use
    stubs).  ``clock`` is injectable so ladder transitions are
    unit-testable without sleeping.
    """

    def __init__(
        self,
        enabled: bool = True,
        max_queue: int = 256,
        enter_attainment: float = 0.85,
        exit_attainment: float = 0.95,
        queue_wait_ms: Optional[float] = None,
        slo_ttft_ms: Optional[float] = None,
        dwell_s: float = 2.0,
        cooldown_s: float = 10.0,
        signal_window_s: float = 10.0,
        min_signal_samples: int = 4,
        batch_max_new: int = 64,
        demote_blocks: int = 32,
        ewma_alpha: float = 0.2,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 < enter_attainment <= exit_attainment <= 1.0:
            raise ValueError(
                "need 0 < enter_attainment <= exit_attainment <= 1 "
                f"(hysteresis), got {enter_attainment}/{exit_attainment}"
            )
        self.enabled = bool(enabled)
        self.max_queue = int(max_queue)
        self.enter_attainment = float(enter_attainment)
        self.exit_attainment = float(exit_attainment)
        # Queue-wait pressure bar: explicit, or derived from the TTFT
        # SLO (a wait already 2x the whole TTFT budget is pressure by
        # definition), else a 2 s default.
        if queue_wait_ms is None:
            queue_wait_ms = 2.0 * slo_ttft_ms if slo_ttft_ms else 2000.0
        self.queue_wait_ms = float(queue_wait_ms)
        self.dwell_s = float(dwell_s)
        self.cooldown_s = float(cooldown_s)
        self.signal_window_s = float(signal_window_s)
        self.min_signal_samples = int(min_signal_samples)
        self.ewma_alpha = float(ewma_alpha)
        self._clock = clock
        # Rung -> knobs (module-docstring table).  batch_max_new halves
        # per rung past brownout-1; floors at 1 so a tiny cap still
        # yields a reply instead of a zero-token 200.
        cap = max(1, int(batch_max_new))
        demote = max(0, int(demote_blocks))
        self._ladder: Dict[str, RungKnobs] = {
            "normal": RungKnobs(1.0, 0, True, 0, False),
            "elevated": RungKnobs(0.5, 0, True, 0, False),
            "brownout-1": RungKnobs(0.5, cap, True, demote, False),
            "brownout-2": RungKnobs(0.25, max(1, cap // 2), False,
                                    demote, False),
            "shed": RungKnobs(0.25, max(1, cap // 4), False, demote,
                              True),
        }
        self._lock = threading.Lock()
        # Per-class FIFO queues (strict interactive-first pop) and the
        # backlog token sums the TTFT estimator reads.
        self._queues: Dict[str, Deque[Any]] = {
            p: deque() for p in PRIORITIES
        }
        self._queued_tokens: Dict[str, int] = {p: 0 for p in PRIORITIES}
        # Tokens of requests ADMITTED but not yet drained from the
        # server inbox into the class queues (admit() increments,
        # push() releases).  Without this, a burst landing during one
        # long dispatch would be invisible to the deadline estimator —
        # every request would see a near-empty backlog and then die in
        # the reaper, the exact outcome the refusal exists to prevent.
        self._inflight_tokens: Dict[str, int] = {
            p: 0 for p in PRIORITIES
        }
        # Throughput EWMAs (tokens/s), fed from obs dispatch records
        # (on_dispatch); None until the first sample — no evidence, no
        # deadline refusals.
        self._prefill_tps: Optional[float] = None
        self._decode_tps: Optional[float] = None
        # Ladder state + timers.
        self._rung = 0
        self._rung_since = clock()
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        # Signal windows: per-class (t, ttft_ok, itl_ok, ok) SLO scores
        # and recent queue-wait samples (t, ms).  Only entries younger
        # than signal_window_s count — a flood's misses age out, which
        # is what lets the ladder step back down.
        self._slo_windows: Dict[str, Deque[Tuple[float, bool, bool, bool]]] = {
            p: deque(maxlen=256) for p in PRIORITIES
        }
        self._wait_window: Deque[Tuple[float, float]] = deque(maxlen=256)
        # Counters / gauges for /metrics and /healthz.
        self.transitions_total = 0
        self.sheds_total = 0
        self.refused_backlog_total = 0
        self.refused_deadline_total = 0
        self.refused_batch_total = 0
        self.ttft_estimate_last_ms = 0.0

    # -- sensors ------------------------------------------------------------

    def on_dispatch(self, rec: Dict[str, Any]) -> None:
        """Feed one obs dispatch record (obs.Observability calls this
        outside its own lock).  Prefill throughput comes from any
        dispatch that advanced prompt tokens (fused chunks, classic
        inserts, suffix inserts); decode throughput from the chunk
        kinds, approximated as k iterations x occupancy rows per
        dispatch wall — coarse, but it only feeds Retry-After and the
        conservative TTFT lower bound, not anything token-exact."""
        wall_s = float(rec.get("wall_ms", 0.0)) / 1000.0
        if wall_s <= 0.0:
            return
        pf_tokens = int(rec.get("prefill_tokens", 0))
        kind = rec.get("kind")
        a = self.ewma_alpha
        with self._lock:
            if pf_tokens > 0:
                sample = pf_tokens / wall_s
                self._prefill_tps = (
                    sample if self._prefill_tps is None
                    else (1 - a) * self._prefill_tps + a * sample
                )
            if kind in ("decode", "fused", "spec"):
                toks = int(rec.get("k", 1)) * max(
                    1, int(rec.get("occupancy", 1))
                )
                sample = toks / wall_s
                self._decode_tps = (
                    sample if self._decode_tps is None
                    else (1 - a) * self._decode_tps + a * sample
                )

    def note_slo(self, priority: str, ttft_ok: bool, itl_ok: bool,
                 ok: bool) -> None:
        """One finished request's SLO score (the server's
        ``_slo_finalize`` feeds this next to ``obs.slo_account``).
        The ladder reads the INTERACTIVE window — the protected class;
        the batch window only feeds the per-class attainment gauges."""
        if priority not in PRIORITIES:
            priority = "interactive"
        with self._lock:
            self._slo_windows[priority].append(
                (self._clock(), ttft_ok, itl_ok, ok)
            )

    def observe_queue_wait(self, ms: float) -> None:
        """One request's POST-arrival -> batcher-submit wait."""
        with self._lock:
            self._wait_window.append((self._clock(), float(ms)))

    # -- queues -------------------------------------------------------------

    def _priority_of(self, entry: Any) -> str:
        """Queue an entry classifies into.  With the controller
        DISABLED everything lands in one queue in arrival order — a
        genuinely plain FIFO, so ``priority_classes=off`` (and the
        bench harness's static A/B arm) really is the pre-ladder
        behavior, not interactive-first scheduling in disguise."""
        if not self.enabled:
            return "interactive"
        p = getattr(entry, "priority", "interactive")
        return p if p in PRIORITIES else "interactive"

    @staticmethod
    def _cost_of(entry: Any) -> int:
        return max(0, int(getattr(entry, "cost_tokens", 0)))

    def push(self, entry: Any) -> None:
        with self._lock:
            p = self._priority_of(entry)
            cost = self._cost_of(entry)
            self._queues[p].append(entry)
            self._queued_tokens[p] += cost
            # Release the admit-time in-flight reservation (floored:
            # test stubs and direct pushes never went through admit).
            self._inflight_tokens[p] = max(
                0, self._inflight_tokens[p] - cost
            )

    def pop(self) -> Optional[Any]:
        """Next entry, strict interactive-first (FIFO within a class)."""
        with self._lock:
            for p in PRIORITIES:
                if self._queues[p]:
                    entry = self._queues[p].popleft()
                    self._queued_tokens[p] -= self._cost_of(entry)
                    return entry
            return None

    def queued_total(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def reap(self, now: Optional[float] = None
             ) -> Tuple[List[Any], List[Any]]:
        """Remove and return (expired, disconnected) queued entries —
        the pre-admission arm of the server's reaper (deadline and
        client-gone checks used to happen at inbox pop; entries can
        now wait in the class queues much longer)."""
        now = self._clock() if now is None else now
        expired: List[Any] = []
        gone: List[Any] = []
        with self._lock:
            for p, q in self._queues.items():
                keep: Deque[Any] = deque()
                for e in q:
                    if getattr(e, "disconnected", False):
                        gone.append(e)
                    elif (
                        getattr(e, "deadline", None) is not None
                        and now >= e.deadline
                    ):
                        expired.append(e)
                    else:
                        keep.append(e)
                        continue
                    self._queued_tokens[p] -= self._cost_of(e)
                self._queues[p] = keep
        return expired, gone

    def shed_batch(self) -> List[Any]:
        """At the ``shed`` rung: drain and return every queued
        batch-class entry (the server 503s each — clean, never a
        hang).  Empty at every other rung."""
        with self._lock:
            if not self._knobs_locked().shed_batch:
                return []
            out = list(self._queues["batch"])
            self._queues["batch"].clear()
            self._queued_tokens["batch"] = 0
            self.sheds_total += len(out)
            return out

    def drain_all(self) -> List[Any]:
        """Remove and return everything queued (server shutdown — the
        finally-drain must fail these, never strand a client)."""
        with self._lock:
            out: List[Any] = []
            for p in PRIORITIES:
                out.extend(self._queues[p])
                self._queues[p].clear()
                self._queued_tokens[p] = 0
            return out

    # -- admission ----------------------------------------------------------

    def admit(
        self,
        priority: str,
        cost_tokens: int,
        timeout_s: Optional[float],
        depth: int,
    ) -> Optional[Refusal]:
        """Admission check, called on HTTP handler threads BEFORE the
        request enqueues.  Returns None (admit) or a :class:`Refusal`.

        Order matters: the backlog bound is the hard backstop (handler
        threads and memory are finite regardless of class), then the
        ladder's class gate, then the deadline proof.  The TTFT
        estimate is a LOWER bound — backlog-ahead + own prefill at the
        observed EWMA rate, ignoring decode interference and slot
        waits — so a refusal is conservative: if even the lower bound
        misses the deadline, queuing could only add a reaper 504."""
        if priority not in PRIORITIES:  # the server validates; stubs
            priority = "interactive"    # and direct callers may not
        if depth >= self.max_queue:
            with self._lock:
                self.refused_backlog_total += 1
                retry = self._retry_after_locked()
            return Refusal(
                "server overloaded; retry later", retry, "backlog"
            )
        if not self.enabled:
            return None
        with self._lock:
            knobs = self._knobs_locked()
            if priority == "batch" and not knobs.admit_batch:
                self.refused_batch_total += 1
                return Refusal(
                    f"batch-class admissions suspended "
                    f"(overload rung {RUNGS[self._rung]}); retry later",
                    self._retry_after_locked(), "class",
                )
            if timeout_s is not None and self._prefill_tps:
                # Backlog ahead = class queues PLUS admitted requests
                # still in transit through the server inbox (the
                # in-flight reservation below) — a burst arriving
                # during one long dispatch must see its own footprint.
                ahead = (
                    self._queued_tokens["interactive"]
                    + self._inflight_tokens["interactive"]
                )
                if priority == "batch":
                    ahead += (
                        self._queued_tokens["batch"]
                        + self._inflight_tokens["batch"]
                    )
                est_s = (ahead + max(0, int(cost_tokens))) / self._prefill_tps
                self.ttft_estimate_last_ms = est_s * 1000.0
                if est_s > float(timeout_s):
                    self.refused_deadline_total += 1
                    return Refusal(
                        f"deadline unmeetable: estimated time to first "
                        f"token {est_s:.2f}s exceeds timeout_s "
                        f"{float(timeout_s):.2f}s at current load; "
                        f"retry later",
                        self._retry_after_locked(), "deadline",
                    )
            # Admitted: reserve the cost until the serving loop drains
            # the entry from the inbox into a class queue (push()).
            self._inflight_tokens[priority] += max(0, int(cost_tokens))
        return None

    def _retry_after_locked(self) -> int:
        """Load-derived Retry-After (seconds, >= 1, capped at 60):
        the time the observed prefill throughput needs to drain the
        current backlog — the queue drain rate, not a constant.  With
        no throughput evidence yet, scale coarsely with queue depth."""
        backlog = sum(self._queued_tokens.values()) + sum(
            self._inflight_tokens.values()
        )
        if self._prefill_tps:
            est = backlog / self._prefill_tps
        else:
            est = sum(len(q) for q in self._queues.values()) / 8.0
        return max(1, min(60, int(est) + 1))

    def retry_after_s(self) -> int:
        with self._lock:
            return self._retry_after_locked()

    # -- brownout ladder ----------------------------------------------------

    def _recent_locked(self, window: Sequence[Tuple], now: float) -> List[Tuple]:
        return [e for e in window if now - e[0] <= self.signal_window_s]

    def _signals_locked(self, now: float) -> Tuple[Optional[float], Optional[float]]:
        """(interactive attainment, queue-wait p90) over the recent
        window; None where there are too few samples to mean anything."""
        scores = self._recent_locked(self._slo_windows["interactive"], now)
        att = None
        if len(scores) >= self.min_signal_samples:
            att = sum(1 for e in scores if e[3]) / len(scores)
        waits = [w for _, w in self._recent_locked(self._wait_window, now)]
        p90 = None
        if len(waits) >= self.min_signal_samples:
            waits.sort()
            p90 = waits[min(len(waits) - 1, int(0.9 * len(waits)))]
        return att, p90

    def tick(self, now: Optional[float] = None
             ) -> Optional[Tuple[str, str]]:
        """Evaluate the ladder; returns ``(old_rung, new_rung)`` on a
        transition, else None.  Called by the serving loop every
        iteration (pure bookkeeping, no device work).

        Pressure: recent interactive attainment below
        ``enter_attainment``, or recent queue-wait p90 above
        ``queue_wait_ms``.  Escalation needs pressure to persist for
        ``dwell_s``.  Calm: no pressure AND attainment at/above
        ``exit_attainment`` (or no recent traffic — an idle server
        must walk back to normal); de-escalation needs calm for
        ``cooldown_s``.  One rung per transition in both directions,
        and the timers re-arm after each — no skipping straight to
        shed on one bad window, no snap-back flapping."""
        now = self._clock() if now is None else now
        if not self.enabled:
            return None
        with self._lock:
            att, wait_p90 = self._signals_locked(now)
            pressure = (
                (att is not None and att < self.enter_attainment)
                or (wait_p90 is not None and wait_p90 > self.queue_wait_ms)
            )
            calm = not pressure and (
                att is None or att >= self.exit_attainment
            )
            if pressure:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                if (
                    self._rung < len(RUNGS) - 1
                    and now - self._pressure_since >= self.dwell_s
                ):
                    old = RUNGS[self._rung]
                    self._rung += 1
                    self._rung_since = now
                    # Restart the dwell at the transition: sustained
                    # pressure climbs one rung per dwell_s, never two
                    # rungs in one tick.
                    self._pressure_since = now
                    self.transitions_total += 1
                    return old, RUNGS[self._rung]
            elif calm:
                self._pressure_since = None
                if self._calm_since is None:
                    self._calm_since = now
                if (
                    self._rung > 0
                    and now - self._calm_since >= self.cooldown_s
                ):
                    old = RUNGS[self._rung]
                    self._rung -= 1
                    self._rung_since = now
                    # Restart the cooldown at the transition: recovery
                    # steps one rung per cooldown_s of sustained calm.
                    self._calm_since = now
                    self.transitions_total += 1
                    return old, RUNGS[self._rung]
            else:
                # Hysteresis band: attainment between enter and exit —
                # neither escalate nor recover; both timers re-arm.
                self._pressure_since = None
                self._calm_since = None
        return None

    # audit: locked(every caller holds self._lock)
    def _knobs_locked(self) -> RungKnobs:
        return self._ladder[RUNGS[self._rung]]

    def knobs(self) -> RungKnobs:
        with self._lock:
            return self._knobs_locked()

    @property
    def rung(self) -> str:
        with self._lock:
            return RUNGS[self._rung]

    def force_rung(self, name: str) -> None:
        """Pin the ladder to a rung (tests/drills only — the ladder
        normally only moves through ``tick``)."""
        with self._lock:
            self._rung = RUNG_INDEX[name]
            self._rung_since = self._clock()
            self._pressure_since = None
            self._calm_since = None

    # -- exposition ---------------------------------------------------------

    def _attainment_locked(self, priority: str, now: float) -> float:
        scores = self._recent_locked(self._slo_windows[priority], now)
        if not scores:
            return 1.0
        return sum(1 for e in scores if e[3]) / len(scores)

    def stats(self) -> Dict[str, float]:
        """Scalar gauges/counters for /metrics (names registered in
        obs.METRICS)."""
        now = self._clock()
        with self._lock:
            knobs = self._knobs_locked()
            return {
                "overload_rung": self._rung,
                "overload_transitions_total": self.transitions_total,
                "overload_sheds_total": self.sheds_total,
                "overload_refused_backlog_total":
                    self.refused_backlog_total,
                "overload_refused_deadline_total":
                    self.refused_deadline_total,
                "overload_refused_batch_total": self.refused_batch_total,
                "queued_interactive": len(self._queues["interactive"]),
                "queued_batch": len(self._queues["batch"]),
                "prefill_tokens_per_s_ewma": round(
                    self._prefill_tps or 0.0, 2
                ),
                "decode_tokens_per_s_ewma": round(
                    self._decode_tps or 0.0, 2
                ),
                "overload_ttft_estimate_ms": round(
                    self.ttft_estimate_last_ms, 1
                ),
                "overload_batch_max_new_cap": knobs.batch_max_new_cap,
                "slo_interactive_attainment": round(
                    self._attainment_locked("interactive", now), 4
                ),
                "slo_batch_attainment": round(
                    self._attainment_locked("batch", now), 4
                ),
            }

    def health(self) -> Dict[str, Any]:
        """The /healthz ``overload`` section."""
        now = self._clock()
        with self._lock:
            _, wait_p90 = self._signals_locked(now)
            return {
                "enabled": self.enabled,
                "rung": RUNGS[self._rung],
                "rung_since_s": round(now - self._rung_since, 3),
                "queued": {
                    p: len(q) for p, q in self._queues.items()
                },
                "queued_tokens": dict(self._queued_tokens),
                "transitions_total": self.transitions_total,
                "sheds_total": self.sheds_total,
                "refused": {
                    "backlog": self.refused_backlog_total,
                    "deadline": self.refused_deadline_total,
                    "batch": self.refused_batch_total,
                },
                "prefill_tokens_per_s_ewma": round(
                    self._prefill_tps or 0.0, 2
                ),
                "interactive_attainment": round(
                    self._attainment_locked("interactive", now), 4
                ),
                # Recent queue-wait p90 (the ladder's second pressure
                # signal; None with too few recent samples) — the
                # router's health sentinel reads it off the scrape.
                "queue_wait_ms_p90": (
                    round(wait_p90, 3) if wait_p90 is not None else None
                ),
            }


# ---------------------------------------------------------------------------
# Open-loop load harness
# ---------------------------------------------------------------------------

def poisson_schedule(rate_hz: float, duration_s: float,
                     seed: int = 0) -> List[float]:
    """Arrival offsets (seconds) of a Poisson process at ``rate_hz``
    over ``duration_s`` — exponential inter-arrival gaps from a seeded
    PRNG, so a sweep is reproducible.  Open-loop by construction: the
    schedule exists before the first request fires and never reacts to
    the server."""
    import random

    if rate_hz <= 0.0:
        return []
    rng = random.Random(seed)
    out: List[float] = []
    t = rng.expovariate(rate_hz)
    while t < duration_s:
        out.append(t)
        t += rng.expovariate(rate_hz)
    return out


def _fire_one(address: str, payload: Dict[str, Any], rec: Dict[str, Any],
              timeout_s: float) -> None:
    """One open-loop request (its own thread): POST streaming, record
    client-observed TTFT / worst ITL / token count / status / whether
    a refusal carried Retry-After.  ``rec["hung"]`` stays True until a
    terminal outcome is recorded — the flood drill's zero-hung-clients
    assertion reads it."""
    req = urllib.request.Request(
        address + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            first = last = None
            itl_max = 0.0
            ntok = 0
            timed_out = False
            stream_error = None
            for line in r:
                now = time.monotonic()
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if "token" in obj:
                    if first is None:
                        first = now
                    elif last is not None:
                        itl_max = max(itl_max, (now - last) * 1000.0)
                    last = now
                    ntok += 1
                if obj.get("done"):
                    if obj.get("timeout"):
                        timed_out = True
                    # A mid-stream failure rides a 200 stream (the
                    # headers were sent with the first token) and
                    # surfaces only in the final line — it must not
                    # score as a served request.
                    if obj.get("error"):
                        stream_error = obj["error"]
            if timed_out:
                status = 504
            elif stream_error is not None:
                status = 500
            else:
                status = 200
            rec.update(
                status=status,
                error=stream_error,
                ttft_ms=(
                    (first - t0) * 1000.0 if first is not None else None
                ),
                itl_max_ms=itl_max if ntok > 1 else None,
                tokens=ntok, hung=False,
            )
    except urllib.error.HTTPError as e:
        rec.update(
            status=e.code,
            retry_after=e.headers.get("Retry-After"),
            hung=False,
        )
        e.read()
    except Exception as e:  # connection reset, socket timeout, ...
        rec.update(status=-1, error=repr(e), hung=False)


def open_loop_flood(
    address: str,
    arrivals: Sequence[float],
    payload_fn: Callable[[int], Dict[str, Any]],
    timeout_s: float = 60.0,
    join_timeout_s: float = 120.0,
) -> List[Dict[str, Any]]:
    """Fire ``payload_fn(i)`` at each arrival offset against a live
    server, one thread per request (open-loop: arrivals never wait for
    completions), and return one record per request.  A record whose
    ``hung`` is still True after the join timeout is a genuinely hung
    client — the failure mode the overload controller exists to make
    impossible."""
    records: List[Dict[str, Any]] = []
    threads: List[threading.Thread] = []
    t0 = time.monotonic()
    for i, at in enumerate(arrivals):
        payload = payload_fn(i)
        rec: Dict[str, Any] = {
            "i": i, "at_s": at,
            "priority": payload.get("priority", "interactive"),
            "status": None, "ttft_ms": None, "itl_max_ms": None,
            "tokens": 0, "retry_after": None, "hung": True,
        }
        records.append(rec)
        delay = at - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(
            target=_fire_one, args=(address, payload, rec, timeout_s),
            daemon=True,
        )
        th.start()
        threads.append(th)
    deadline = time.monotonic() + join_timeout_s
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    return records


def summarize_flood(
    records: Sequence[Dict[str, Any]],
    slo_ttft_ms: Optional[float] = None,
    slo_itl_ms: Optional[float] = None,
    duration_s: Optional[float] = None,
) -> Dict[str, Any]:
    """Per-class summary of an open-loop flood: served/refused/hung
    counts, TTFT percentiles, and SLO attainment over SERVED requests
    (refusals are the controller doing its job, not latency misses),
    plus goodput (tokens from served requests that met every
    configured deadline, per second of flood)."""
    def pct(vals: List[float], q: float) -> Optional[float]:
        if not vals:
            return None
        vals = sorted(vals)
        return round(vals[min(len(vals) - 1, int(q * len(vals)))], 1)

    out: Dict[str, Any] = {"offered": len(records)}
    goodput_tokens = 0
    for cls in PRIORITIES:
        rs = [r for r in records if r["priority"] == cls]
        served = [r for r in rs if r["status"] == 200]
        ttfts = [r["ttft_ms"] for r in served if r["ttft_ms"] is not None]
        ok = []
        for r in served:
            ttft_ok = slo_ttft_ms is None or (
                r["ttft_ms"] is not None and r["ttft_ms"] <= slo_ttft_ms
            )
            itl_ok = slo_itl_ms is None or (
                r["itl_max_ms"] is None or r["itl_max_ms"] <= slo_itl_ms
            )
            ok.append(ttft_ok and itl_ok)
            if ttft_ok and itl_ok:
                goodput_tokens += r["tokens"]
        refused = [r for r in rs if r["status"] == 503]
        out[cls] = {
            "offered": len(rs),
            "served": len(served),
            "refused_503": len(refused),
            "refused_with_retry_after": sum(
                1 for r in refused if r.get("retry_after")
            ),
            "timeout_504": sum(1 for r in rs if r["status"] == 504),
            "errors": sum(
                1 for r in rs if r["status"] not in (200, 503, 504)
            ),
            "hung": sum(1 for r in rs if r["hung"]),
            "ttft_ms_p50": pct(ttfts, 0.50),
            "ttft_ms_p99": pct(ttfts, 0.99),
            "slo_attainment": (
                round(sum(ok) / len(ok), 4) if ok else None
            ),
        }
    out["hung_total"] = sum(1 for r in records if r["hung"])
    if duration_s:
        out["goodput_tokens_per_s"] = round(
            goodput_tokens / duration_s, 2
        )
    return out
