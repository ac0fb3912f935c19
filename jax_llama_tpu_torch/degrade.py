"""Graceful degradation: per-feature health tracking with quarantine
(a copy of ``jax_llama_tpu/degrade.py``; it imports nothing of the
package).

The serving stack has a slower always-correct fallback for every
accelerated feature it runs (``serving.py``):

  ==================  =============================================
  feature             fallback when quarantined
  ==================  =============================================
  splash_prefill      the flash kernel (``prefill_kernel='flash'``)
  stock_paged         the paged kernel (``decode_kernel='paged'``)
  flash_attention     plain attention (``attn_impl='xla'``; a batcher
                      on the CPU only)
  paged_kernel        the gathered view, plain attention
                      (``use_pallas_kernel=False``; on the CPU only)
  spec_decode         plain non-speculative decode (no draft model)
  prefix_cache        cold full prefill (``prefix_cache=False``: the
                      flash insert kernel, on the card too)
  ==================  =============================================

Quarantine swaps ONLY the failing feature: a ``spec_decode`` fallback
rebuild drops the draft model but keeps the original ``decode_chunk``
and ``spec_rounds`` configuration (the rebuild reuses the base ctor
kwargs), so a quarantined speculative server degrades onto plain
CHUNKED decode, not the per-token loop — and a later probe re-enable
restores fused speculative serving with the same R.  Failures are
attributed once per chunk dispatch (the R rounds of one ``step()`` are
one dispatch).

Over a serving mesh of more than one rank (``parallel.lockstep``) the
state machine runs on rank 0 only, inside its ``LLMServer``: it reads
the clock there.  Its effects on the batcher (a quarantine's or a
probe's rebuild, as keyword overrides over the first construction)
reach the other ranks as records of the lockstep log.

The server recovers from a crash by rebuilding and replaying; this
module gives it *degraded* operation: a kernel that starts failing (a
build regression, a launch error, silent NaN emission) should cost
throughput, not availability, where another hand-written kernel can
take its work.  On the card the flash and paged kernels have no such
fallback (plain PyTorch is not one), so the server never attributes
their failures to these features there: they spend the crash-recovery
budget and trip its breaker.  Each feature runs a small state machine:

    healthy --[>= threshold failures inside window_s]--> quarantined
    quarantined --[cooldown_s elapsed]--> probing   (one re-trial)
    probing --[success]--> healthy
    probing --[failure]--> quarantined              (cooldown restarts)

The manager is pure bookkeeping — it never touches the batcher.  The
serving loop (``server.LLMServer``) feeds it failures attributed from
dispatch exceptions, asks ``enabled()`` when (re)building the batcher,
and applies the fallback table above.  ``clock`` is injectable so the
transitions are unit-testable without sleeping.

Thread-safety: all methods take an internal lock — ``snapshot()`` /
``stats()`` are read from HTTP handler threads while the serving loop
records failures.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

# The degradable features, in fallback-severity order.  Every name
# here must have a fallback branch in ``LLMServer._build_batcher`` — a
# feature without one would "quarantine" while the rebuild keeps
# running it.
#
# The two kernel-selection features (ops/kernels.py registry) quarantine
# to the EXISTING custom kernel, not straight to plain attention — one
# rung of the ladder at a time:
#
#   splash_prefill -> flash_attention -> plain     (prefill ladder)
#   stock_paged    -> paged_kernel    -> gathered  (decode ladder)
#
# so a splash-specific kernel failure costs the splash upside only; the
# last rung of each ladder (onto plain PyTorch) is taken on the CPU only.
FEATURES = (
    "splash_prefill",
    "stock_paged",
    "flash_attention",
    "paged_kernel",
    "spec_decode",
    "prefix_cache",
)

HEALTHY = "healthy"
QUARANTINED = "quarantined"
PROBING = "probing"


@dataclasses.dataclass
class _Feature:
    """One feature's health record (internal; ``snapshot()`` is the API)."""

    state: str = HEALTHY
    failures: Deque[float] = dataclasses.field(default_factory=deque)
    quarantined_at: Optional[float] = None
    failures_total: int = 0
    quarantines_total: int = 0
    probes_total: int = 0


class DegradeManager:
    """Failure-windowed quarantine tracker for the serving features.

    Args:
      threshold: failures inside ``window_s`` that trip quarantine.
      window_s: sliding failure window.
      cooldown_s: time a feature stays quarantined before one probe
        re-trial is allowed.
      clock: monotonic time source (injectable for tests).
    """

    def __init__(
        self,
        threshold: int = 3,
        window_s: float = 60.0,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[
            Callable[..., None]
        ] = None,
    ):
        if threshold < 1:
            raise ValueError("quarantine threshold must be >= 1")
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        # Observability sink for state EDGES (healthy->quarantined,
        # quarantined->probing, probing->healthy/quarantined), called
        # as ``on_transition("quarantine_transition", feature=...,
        # state=...)`` — the server wires obs.Observability.annotate so
        # quarantine flips are visible in the serving trace next to
        # the dispatches that caused them.  Settable after construction
        # (``mgr.on_transition = ...``); fired OUTSIDE the lock is not
        # needed — annotate only appends to a bounded deque.
        self.on_transition = on_transition

        self._features: Dict[str, _Feature] = {
            name: _Feature() for name in FEATURES
        }

    def _emit(self, feature: str, state: str) -> None:
        if self.on_transition is not None:
            self.on_transition(
                "quarantine_transition", feature=feature, state=state
            )

    # audit: locked(every caller is a public method that already holds
    # self._lock around this lookup)
    def _get(self, name: str) -> _Feature:
        if name not in self._features:
            raise KeyError(
                f"unknown degradable feature {name!r}; have {FEATURES}"
            )
        return self._features[name]

    def record_failure(self, name: str) -> bool:
        """Count one failure; returns True when this failure moved the
        feature into quarantine (from healthy past the threshold, or a
        failed probe).  The caller uses the True edge to switch the
        batcher onto the fallback path."""
        now = self._clock()
        with self._lock:
            f = self._get(name)
            f.failures_total += 1
            f.failures.append(now)
            while f.failures and now - f.failures[0] > self.window_s:
                f.failures.popleft()
            if f.state == PROBING:
                # The re-trial failed: straight back to quarantine, full
                # cooldown restarts.
                f.state = QUARANTINED
                f.quarantined_at = now
                f.quarantines_total += 1
                self._emit(name, QUARANTINED)
                return True
            if f.state == HEALTHY and len(f.failures) >= self.threshold:
                f.state = QUARANTINED
                f.quarantined_at = now
                f.quarantines_total += 1
                self._emit(name, QUARANTINED)
                return True
            return False

    def record_success(self, name: str) -> bool:
        """A dispatch exercising the feature completed.  Only meaningful
        while probing: the probe passed, the feature is healthy again
        (returns True on that edge; failure history clears)."""
        with self._lock:
            f = self._get(name)
            if f.state != PROBING:
                return False
            f.state = HEALTHY
            f.quarantined_at = None
            f.failures.clear()
            self._emit(name, HEALTHY)
            return True

    def enabled(self, name: str) -> bool:
        """Whether the batcher may run the feature: healthy or probing."""
        with self._lock:
            return self._get(name).state != QUARANTINED

    def due_probes(self) -> List[str]:
        """Quarantined features whose cooldown has expired (ready for a
        probe re-trial; call ``start_probe`` before re-enabling)."""
        now = self._clock()
        with self._lock:
            return [
                name for name, f in self._features.items()
                if f.state == QUARANTINED
                and f.quarantined_at is not None
                and now - f.quarantined_at >= self.cooldown_s
            ]

    def start_probe(self, name: str) -> None:
        with self._lock:
            f = self._get(name)
            if f.state == QUARANTINED:
                f.state = PROBING
                f.probes_total += 1
                self._emit(name, PROBING)

    def degraded(self) -> bool:
        """Any feature currently QUARANTINED (a fallback is serving).

        Probing does NOT count: the feature is re-enabled and merely
        awaiting a confirming dispatch, which may take arbitrarily long
        to arrive (e.g. a probed prefix cache needs two requests sharing
        a prefix) — reporting that as degraded would wedge a permanent
        false alert on /healthz."""
        with self._lock:
            return any(
                f.state == QUARANTINED for f in self._features.values()
            )

    def quarantined(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(
                name for name, f in self._features.items()
                if f.state == QUARANTINED
            )

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Full per-feature state for the /healthz payload."""
        now = self._clock()
        out: Dict[str, Dict[str, object]] = {}
        with self._lock:
            for name, f in self._features.items():
                probe_in = None
                if f.state == QUARANTINED and f.quarantined_at is not None:
                    probe_in = max(
                        0.0, self.cooldown_s - (now - f.quarantined_at)
                    )
                out[name] = {
                    "state": f.state,
                    "failures_in_window": sum(
                        1 for t in f.failures if now - t <= self.window_s
                    ),
                    "failures_total": f.failures_total,
                    "quarantines_total": f.quarantines_total,
                    "probes_total": f.probes_total,
                    "probe_in_s": (
                        round(probe_in, 3) if probe_in is not None else None
                    ),
                }
        return out

    def stats(self) -> Dict[str, float]:
        """Flat counters/gauges for the /metrics endpoint."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, f in self._features.items():
                out[f"feature_quarantined_{name}"] = int(
                    f.state == QUARANTINED
                )
                out[f"feature_failures_{name}_total"] = f.failures_total
                out[f"feature_quarantines_{name}_total"] = (
                    f.quarantines_total
                )
        return out
