"""Request-timeline tracing, latency histograms, SLO accounting and
structured logging (port of ``jax_llama_tpu/obs.py``).

The sensor layer of the serving stack (``server.LLMServer`` over
``serving.ContinuousBatcher``):

  * **Event timeline** (:class:`Observability`).  Every request owns a
    bounded span timeline through the admission state machine —
    ``queued -> prefilling -> decoding -> finished/failed/cancelled``
    (``restoring``, a host-tier swap-in, between them) — and every
    serving dispatch gets a span in a bounded ring recording its kind
    (``decode`` / ``spec`` / ``insert`` and the per-kernel splits),
    effective K/R, slot occupancy, prompt tokens advanced, packed-fetch
    wall time.  Request spans are causally linked to the dispatch spans
    they rode in (span.dispatches lists dispatch seq numbers), so a
    timeline answers "which dispatches carried my prefill" and a
    dispatch answers "whose tokens did I emit".
  * **Latency histograms** (:class:`Histogram`).  Prometheus cumulative-
    bucket histograms for TTFT, inter-token latency, queue wait,
    prefill latency, kernel build time, and dispatch wall time.
    ``dispatch_ms`` is a LABELED family: one series per dispatch kind.
    Rendered straight into the ``/metrics`` text exposition
    (``_bucket``/``_sum``/``_count``).
  * **Device-time attribution** (:class:`CostModel` + the
    ``mxu_utilization`` / ``hbm_utilization`` / ``host_overhead_ratio``
    gauges).  The JAX package asks XLA's ``cost_analysis`` for each
    program's FLOPs and bytes; the port has no compiler to ask, so each
    dispatch's cost is an analytic count from the batcher's geometry
    (:class:`CostModel` says which code each term counts).  The count
    rides the dispatch record; per-kind sliding windows turn measured
    dispatch wall time into a live roofline share and a
    wall-vs-device-estimate host-overhead ratio.  The peaks default to
    the H100 SXM's published dense bf16 rate and HBM3 bandwidth; run.py
    ``--peak-tflops`` / ``--peak-hbm-gbps`` repin them.
  * **Kernel-build observability**.  The port's counterpart of a backend
    jit compile is an ``nvcc`` build of one kernel source
    (``ops/_build.py``).  Each build that runs inside an attributed
    dispatch becomes a ``compile_ms`` observation, a span on the trace's
    build track, and a per-program counter
    (:meth:`Observability.record_compile`; serving.py names the program
    via :func:`attribute_compiles` around each dispatch), and
    ``/metrics`` exposes each kernel source's loaded-library count
    under ``jit_cache_entries``.
  * **SLO accounting**.  With ``slo_ttft_ms`` / ``slo_itl_ms``
    configured (run.py ``--slo-ttft-ms`` / ``--slo-itl-ms``), every
    finished request is scored against both deadlines:
    ``slo_attainment`` gauges (windowed, last 256 requests) and a
    ``goodput_tokens_total`` counter (tokens from requests that met
    every configured deadline).  An unconfigured dimension always
    passes, so with no SLO flags the gauges read 1.0 and goodput equals
    delivered tokens.
  * **Metric registry** (:data:`METRICS` / :func:`metric_meta`).  The
    explicit ``# TYPE`` + ``# HELP`` source for every scalar the
    ``/metrics`` endpoint exposes, under the JAX package's series names.
  * **Trace export**.  :meth:`Observability.trace_json` emits
    Chrome/Perfetto ``trace_event`` JSON for a recent serving window
    (the server serves it at ``GET /debug/trace``).
  * **Decision audit log** (:class:`DecisionLog`).  Every control-plane
    decision — a brownout-ladder rung move, a crash-recovery /
    quarantine / probe rebuild, a shed, a drain — lands as one
    ring-buffered structured event carrying the external request id
    where one exists (``GET /debug/decisions``).
  * **Flight recorder**.  The bounded rings above plus a periodic
    :meth:`Observability.record_metrics_snapshot` ring and the
    :class:`StructuredLogger` tail, exported by ``GET /debug/bundle`` as
    one artifact.
  * **Anomaly detection building block** (:class:`EwmaDetector`), pure
    host math, kept with the JAX package's layer (its reader is the
    replica router's health sentinel, ``router.HealthSentinel``).

Overhead contract: everything here is HOST-side bookkeeping recorded at
boundaries the serving loop already crosses (admission, the one packed
fetch per chunk, slot frees).  Recording performs no device work and no
host sync.  All methods are thread-safe (one lock; the serving loop
writes, HTTP handler threads snapshot).
"""

from __future__ import annotations

import bisect
import json
import math
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .degrade import FEATURES
from .faults import SITES

# Dispatch kinds serving.py records — each owns a labeled dispatch_ms
# histogram series and a device-time attribution window.
# record_dispatch VALIDATES against this set: a typo'd kind would
# otherwise mint a phantom metrics series nobody scrapes.
# The ":"-suffixed variants are per-kernel attribution splits
# (ops/kernels.py): same dispatch site as the base kind, but served by
# an alternative kernel — so ``llm_mxu_utilization{kind}`` turns the
# kernel A/B into a live gauge.  Fused chunks and spec rounds keep ONE
# kind each (mixed prefill/decode resp. draft/verify FLOPs — a kernel
# split would attribute the mix to one kernel and lie).
DISPATCH_KINDS = frozenset({
    "decode", "fused", "spec", "insert", "suffix_insert", "adopt",
    "decode:stock-paged", "insert:splash",
})

# Default hardware peaks for the utilization gauges: NVIDIA's published
# figures for one H100 SXM (dense bf16 tensor-core FLOP/s at the 700 W
# limit, HBM3 bytes/s), the peaks PERF.md divides by.  run.py
# --peak-tflops / --peak-hbm-gbps repin them for other cards; 0 disables
# the corresponding gauge.
DEFAULT_PEAK_FLOPS = 989.4e12        # H100 SXM bf16 dense (FLOP/s)
DEFAULT_PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (B/s)

# ---------------------------------------------------------------------------
# Histograms (Prometheus cumulative buckets)
# ---------------------------------------------------------------------------

# Default latency buckets in MILLISECONDS: sub-ms dispatches through
# multi-second prefills/swaps.  +Inf is implicit.
DEFAULT_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


class Histogram:
    """A Prometheus-style cumulative histogram (fixed upper bounds).

    ``observe(v)`` is a bisect + two adds; NOT itself synchronized —
    every caller inside :class:`Observability` holds the owner's lock,
    so a concurrent ``/metrics`` render can never see a bucket updated
    ahead of ``_count``.  ``expose(prefix)`` renders the standard
    ``_bucket{le=...}`` / ``_sum`` / ``_count`` family with its
    ``# HELP`` / ``# TYPE`` header.  ``labels`` names one series of a
    LABELED family (e.g. ``{"kind": "decode"}``): the labels render
    into every sample line and ``expose(header=False)`` suppresses the
    family header so sibling series share one ``# TYPE``.  Bucket
    counts are stored NON-cumulative and summed at exposition
    (observe stays O(log B))."""

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help_text
        self.labels = dict(labels) if labels else {}
        self.buckets: Tuple[float, ...] = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram buckets must ascend: {buckets}")
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """[(le_label, cumulative_count)] including +Inf."""
        out: List[Tuple[str, int]] = []
        acc = 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((format(b, "g"), acc))
        out.append(("+Inf", acc + self.counts[-1]))
        return out

    def expose(self, prefix: str = "", header: bool = True) -> List[str]:
        n = prefix + self.name
        lines = (
            [f"# HELP {n} {self.help}", f"# TYPE {n} histogram"]
            if header else []
        )
        base = "".join(
            f'{k}="{v}",' for k, v in sorted(self.labels.items())
        )
        for le, c in self.cumulative():
            lines.append(f'{n}_bucket{{{base}le="{le}"}} {c}')
        lab = "{" + base.rstrip(",") + "}" if base else ""
        lines.append(f"{n}_sum{lab} {round(self.sum, 3)}")
        lines.append(f"{n}_count{lab} {self.count}")
        return lines


# The serving stack's histogram families (name -> help); every
# Observability owns one of each.  All values are milliseconds.
HISTOGRAMS = {
    "ttft_ms": (
        "Time to first token per delivered request (ms; client-observed, "
        "crash-recovery replays included)"),
    "itl_ms": (
        "Inter-token latency per delivered token after the first (ms; "
        "tokens inside one fused chunk arrive together, so chunked decode "
        "shows a mass near 0 plus one chunk-period mode)"),
    "queue_wait_ms": (
        "Submit-to-admission wait per request (ms; the queued span)"),
    "prefill_chunk_ms": (
        "Wall time of prefill-carrying dispatches (ms: fused prefill "
        "chunks and classic whole-prompt inserts)"),
    "swap_in_ms": (
        "Host-tier swap-in latency per restored admission (ms: staging "
        "H2D start to pool adoption)"),
    "compile_ms": (
        "Kernel build time per nvcc build of one source (ms; fed by "
        "ops/_build.py — a busy series here means kernels are being "
        "rebuilt while serving, see jit_cache_entries)"),
    "dispatch_ms": (
        "Wall time per jitted serving dispatch incl. its packed fetch "
        "(ms; one K-iteration or R-round chunk each; LABELED by "
        "dispatch kind)"),
    "prefix_hit_depth_tokens": (
        "Prefix-cache hit depth per admission (TOKENS served from "
        "cached blocks; the 0-hit mass lands in the first bucket — "
        "a cold fleet reads as all-first-bucket)"),
    "session_kv_blocks": (
        "KV pool blocks a session held at slot free (BLOCKS, not ms; "
        "the per-session cache footprint distribution)"),
}

# Families rendered as one labeled series per dispatch kind rather
# than a single lumped series (Observability keeps one Histogram per
# kind, created lazily on first dispatch of that kind).
LABELED_HISTOGRAMS = frozenset({"dispatch_ms"})

# Non-latency families override the ms bucket ladder with their own
# unit's (tokens / blocks, pow2 — the same bucketing the admission
# paths use for jit-cache keys, so histogram edges line up with the
# actual quantization of the measured values).
HISTOGRAM_BUCKETS: Dict[str, Tuple[float, ...]] = {
    "prefix_hit_depth_tokens": tuple(
        float(1 << i) for i in range(15)  # 1 .. 16384 tokens
    ),
    "session_kv_blocks": tuple(
        float(1 << i) for i in range(11)  # 1 .. 1024 blocks
    ),
}


# ---------------------------------------------------------------------------
# Metric registry: explicit # TYPE + # HELP for every /metrics scalar
# ---------------------------------------------------------------------------

def _reg(kind: str, help_text: str) -> Tuple[str, str]:
    if kind not in ("counter", "gauge"):
        raise ValueError(kind)
    return (kind, help_text)


METRICS: Dict[str, Tuple[str, str]] = {
    # -- batcher core -------------------------------------------------------
    "emitted_tokens_total": _reg("counter", "Tokens emitted to callers"),
    "decode_steps_total": _reg(
        "counter", "Decode iterations run (K per chunked dispatch)"),
    "active_slots": _reg("gauge", "Slots holding a live request"),
    "queued_requests": _reg("gauge", "Requests waiting for admission"),
    "free_blocks": _reg("gauge", "Unallocated KV pool blocks"),
    "total_blocks": _reg("gauge", "KV pool capacity in blocks"),
    "drafts_proposed_total": _reg(
        "counter", "Draft tokens proposed (speculative serving)"),
    "drafts_accepted_total": _reg(
        "counter", "Draft tokens accepted (speculative serving)"),
    "draft_acceptance_rate": _reg(
        "gauge", "Lifetime draft acceptance fraction"),
    "nonfinite_rows_total": _reg(
        "counter", "Requests failed by the non-finite logits guard"),
    # -- prefix cache / KV capacity ----------------------------------------
    "prefix_cached_blocks": _reg(
        "gauge", "Idle HBM-resident prefix-cache blocks (pre-radix "
                 "alias of the store's idle count)"),
    "prefix_requests_hit_total": _reg(
        "counter", "Admissions that reused cached prefix blocks"),
    "prefix_blocks_reused_total": _reg(
        "counter", "Cached prefix blocks reused by admissions"),
    "radix_nodes_total": _reg(
        "gauge", "Keyed blocks in the radix prefix tree (a resident "
                 "COUNT that shrinks on eviction, not a counter)"),
    "prefix_hit_tokens_ratio": _reg(
        "gauge", "Fraction of admitted prompt tokens served from cached "
                 "prefix blocks"),
    "host_kv_blocks": _reg("gauge", "Host-DRAM KV tier capacity (blocks)"),
    "host_tier_blocks": _reg(
        "gauge", "Blocks currently demoted to the host-DRAM tier"),
    "swap_queue_depth": _reg("gauge", "Host-tier swap-ins in flight"),
    "swap_ins_total": _reg("counter", "Host-tier swap-ins started"),
    "swap_in_blocks_total": _reg(
        "counter", "Blocks restored from the host tier (H2D)"),
    "swap_out_blocks_total": _reg(
        "counter", "Blocks demoted to the host tier (D2H)"),
    "swap_in_ms_total": _reg(
        "counter", "Cumulative swap-in wall time (ms)"),
    "swap_failures_total": _reg(
        "counter", "Swap-ins failed cleanly (request-scoped)"),
    # -- KV chain digest (kvcache.KvDigest — fleet cache telemetry) ---------
    "kv_digest_version": _reg(
        "gauge", "Chain-digest content version (bumps on publish/evict/"
                 "demote/restore; resets with the store on rebuild — "
                 "compare with !=, any change means the consumer's "
                 "copy is stale)"),
    "kv_digest_loss_version": _reg(
        "gauge", "Chain-digest loss version (bumps only when a chain "
                 "can LOSE HBM residency: evict/demote/host-drop — "
                 "the affinity-freshness signal the router consults)"),
    "kv_publish_events_total": _reg(
        "counter", "Chain blocks published into the prefix index"),
    "kv_evict_events_total": _reg(
        "counter", "Chain blocks evicted out of the prefix index"),
    "kv_demote_events_total": _reg(
        "counter", "Chain blocks demoted HBM -> host tier (digest "
                   "view of the swap-out ledger)"),
    "kv_restore_events_total": _reg(
        "counter", "Chain blocks restored host tier -> HBM (digest "
                   "view of the swap-in ledger)"),
    "kv_host_evict_events_total": _reg(
        "counter", "Host-tier slabs lost to the tier's own LRU"),
    "kv_block_bytes": _reg(
        "gauge", "Pool bytes one KV block occupies (k+v+pos+scales, "
                 "draft twins included) — the duplicate-chain "
                 "accounting unit"),
    # -- scale-out serving (serve_mesh.py / router.py) ----------------------
    "kv_export_blocks_total": _reg(
        "counter", "Prefix blocks exported to peer replicas "
                   "(disaggregation handoff, prefill side)"),
    "kv_import_blocks_total": _reg(
        "counter", "Prefix blocks landed from peer replicas "
                   "(disaggregation handoff, decode side)"),
    "kv_export_events_total": _reg(
        "counter", "Prefix handoff exports that moved >= 1 block"),
    "kv_import_events_total": _reg(
        "counter", "Prefix handoff imports that landed >= 1 block"),
    "kv_handoff_aborted_total": _reg(
        "counter", "Prefix handoff imports that hit the wall timeout "
                   "and unwound cleanly (blocks freed, nothing "
                   "published)"),
    "kv_export_demoted_blocks_total": _reg(
        "counter", "Exported prefix blocks demoted/dropped at the "
                   "source after a handoff (demote-after-export: the "
                   "migration deduplicates fleet HBM)"),
    "serve_mesh_data": _reg(
        "gauge", "Serving-mesh row shards (data*fsdp axes; 1 off-mesh)"),
    "serve_mesh_tensor": _reg(
        "gauge", "Serving-mesh tensor shards (KV-head sharding; 1 "
                 "off-mesh)"),
    "replica_id": _reg(
        "gauge", "This server's replica index behind a ReplicaRouter "
                 "(-1 standalone)"),
    # -- chunked decode host boundary --------------------------------------
    "decode_chunk_size": _reg(
        "gauge", "Effective K of the most recent chunk dispatch"),
    "decode_dispatches_total": _reg(
        "counter", "Jitted decode chunk dispatches"),
    "insert_dispatches_total": _reg(
        "counter", "Batched prefill (insert) dispatches, one per admitted "
                   "burst (the port's; each runs the prefill kernel once "
                   "per layer)"),
    "host_syncs_total": _reg(
        "counter", "Device-to-host fetches the serving loop performed"),
    "state_uploads_total": _reg(
        "counter", "Host-to-device state-sync dispatches"),
    "host_syncs_per_token": _reg(
        "gauge", "Fetches per emitted token (trends to 1/K steady-state)"),
    # -- speculative serving ------------------------------------------------
    "spec_rounds_per_dispatch": _reg(
        "gauge", "Effective R of the most recent speculative dispatch"),
    "spec_dispatches_total": _reg(
        "counter", "Jitted speculative dispatches (R rounds each)"),
    "spec_host_syncs_per_token": _reg(
        "gauge", "Speculative-path fetches per emitted token"),
    "spec_window_acceptance_rate": _reg(
        "gauge", "Draft acceptance over the last 64 spec dispatches"),
    # -- fused prefill-decode scheduling ------------------------------------
    "prefill_budget": _reg(
        "gauge", "Prompt tokens a fused admission advances per dispatch"),
    "prefill_tokens_inflight": _reg(
        "gauge", "Prompt tokens of the in-flight admission still to "
                 "prefill"),
    "prefill_chunks_total": _reg(
        "counter", "Chunk dispatches that carried a prefill lane"),
    "fused_admissions_total": _reg(
        "counter", "Admissions routed through the fused prefill lane"),
    "decode_stall_ms_total": _reg(
        "counter", "Wall time classic whole-prompt admissions stalled "
                   "decoding rows (ms)"),
    "programs_captured": _reg(
        "gauge", "1 when this batcher's decode programs run as CUDA "
                 "graphs (the port's; 0: eager, as on a gloo mesh)"),
    "graph_captures_total": _reg(
        "counter", "CUDA graphs this batcher captured, one per program "
                   "key (the port's)"),
    "graph_replays_total": _reg(
        "counter", "CUDA graph replays of this batcher's programs (the "
                   "port's)"),
    # -- fault injection -----------------------------------------------------
    "faults_injected_total": _reg("counter", "Injected faults raised"),
    "fault_delays_total": _reg("counter", "Injected delays served"),
    "fault_nans_armed_total": _reg(
        "counter", "Non-finite poisons armed by the injector"),
    # -- server layer --------------------------------------------------------
    "server_recoveries_total": _reg(
        "counter", "Batcher rebuild+replay crash recoveries"),
    "watchdog_stalls_total": _reg(
        "counter", "Serving-loop heartbeat stalls detected"),
    "watchdog_stalled": _reg("gauge", "Watchdog currently tripped (0/1)"),
    "watchdog_last_step_age_seconds": _reg(
        "gauge", "Seconds since the serving loop's last heartbeat"),
    "quarantine_rebuilds_total": _reg(
        "counter", "Batcher rebuilds onto a feature fallback"),
    "probe_rebuilds_total": _reg(
        "counter", "Batcher rebuilds re-enabling a probed feature"),
    "nonfinite_requests_failed_total": _reg(
        "counter", "Requests failed with HTTP 500 by the non-finite "
                   "guard"),
    "draining": _reg("gauge", "Server in drain mode (0/1)"),
    "ttft_ms_ewma": _reg(
        "gauge", "EWMA time-to-first-token (ms, alpha 0.2; see the "
                 "ttft_ms histogram for the distribution)"),
    "itl_ms_ewma": _reg(
        "gauge", "EWMA inter-token latency (ms, alpha 0.2; the "
                 "per-replica degradation signal the router's health "
                 "sentinel z-scores; canary probes excluded)"),
    "canary_requests_total": _reg(
        "counter", "Synthetic canary-class probe requests served "
                   "(reserved class: excluded from SLO attainment, "
                   "goodput, latency histograms/EWMAs and the "
                   "brownout ladder's inputs)"),
    "decision_events_total": _reg(
        "counter", "Control-plane decisions recorded in the audit log "
                   "(brownout rung moves, recoveries, quarantines, "
                   "probes, sheds, drains — GET /debug/decisions)"),
    # -- request outcomes / SLO ---------------------------------------------
    "requests_finished_total": _reg(
        "counter", "Requests that delivered a complete generation"),
    "requests_failed_total": _reg(
        "counter", "Requests that ended in failure or timeout"),
    "requests_cancelled_total": _reg(
        "counter", "Requests cancelled (client disconnect or cancel)"),
    "slo_ttft_ms": _reg(
        "gauge", "Configured TTFT SLO deadline (ms; 0 = unset, "
                 "dimension always passes)"),
    "slo_itl_ms": _reg(
        "gauge", "Configured inter-token-latency SLO deadline (ms; "
                 "0 = unset)"),
    "requests_slo_ok_total": _reg(
        "counter", "Finished requests that met every configured SLO"),
    "goodput_tokens_total": _reg(
        "counter", "Tokens from requests that met every configured SLO "
                   "(the controller objective)"),
    "slo_ttft_attainment": _reg(
        "gauge", "Fraction of recent requests meeting the TTFT SLO "
                 "(window 256)"),
    "slo_itl_attainment": _reg(
        "gauge", "Fraction of recent requests meeting the ITL SLO "
                 "(window 256)"),
    "slo_attainment": _reg(
        "gauge", "Fraction of recent requests meeting every configured "
                 "SLO (window 256)"),
    # -- device-time attribution / jit-cache observability -------------------
    "compiles_total": _reg(
        "counter", "Kernel builds observed inside serving dispatches "
                   "(nvcc, one per source; see the compile_ms histogram "
                   "and program_compiles_total)"),
    "mxu_utilization": _reg(
        "gauge", "Modeled-FLOPs / wall-time fraction of the peak "
                 "FLOP/s over the recent dispatch window (per dispatch "
                 "kind)"),
    "hbm_utilization": _reg(
        "gauge", "Modeled bytes-accessed / wall-time fraction of the "
                 "HBM peak over the recent dispatch window (per "
                 "dispatch kind)"),
    "host_overhead_ratio": _reg(
        "gauge", "Dispatch wall time over the modeled-cost device-time "
                 "estimate (per dispatch kind; ~1 = device-bound, "
                 ">>1 = host overhead)"),
    "program_compiles_total": _reg(
        "counter", "Kernel builds attributed to each serving program "
                   "(per program)"),
    "jit_cache_entries": _reg(
        "gauge", "Cache keys seen per registered serving program (each "
                 "a CUDA graph where the program is captured; a runaway "
                 "series here is a bucketing bug re-specializing a "
                 "program per request)"),
    # -- overload control (overload.py) --------------------------------------
    "overload_rung": _reg(
        "gauge", "Brownout-ladder rung (0=normal 1=elevated "
                 "2=brownout-1 3=brownout-2 4=shed)"),
    "overload_transitions_total": _reg(
        "counter", "Brownout-ladder rung transitions (both directions)"),
    "overload_sheds_total": _reg(
        "counter", "Queued batch-class requests shed at the shed rung "
                   "(each got a clean 503 + Retry-After)"),
    "overload_refused_backlog_total": _reg(
        "counter", "Admissions refused by the queue-depth backstop "
                   "(503 + Retry-After)"),
    "overload_refused_deadline_total": _reg(
        "counter", "Admissions refused because the TTFT lower-bound "
                   "estimate provably misses the request's timeout_s"),
    "overload_refused_batch_total": _reg(
        "counter", "Batch-class admissions refused while the ladder "
                   "suspends the class (brownout-2 and above)"),
    "queued_interactive": _reg(
        "gauge", "Interactive-class requests waiting pre-admission"),
    "queued_batch": _reg(
        "gauge", "Batch-class requests waiting pre-admission"),
    "prefill_tokens_per_s_ewma": _reg(
        "gauge", "Observed prefill throughput EWMA (tokens/s; the "
                 "admission cost model's denominator)"),
    "decode_tokens_per_s_ewma": _reg(
        "gauge", "Observed decode throughput EWMA (tokens/s)"),
    "overload_ttft_estimate_ms": _reg(
        "gauge", "Most recent admission-time TTFT lower-bound estimate "
                 "(ms)"),
    "overload_batch_max_new_cap": _reg(
        "gauge", "Current brownout cap on batch-class max_new_tokens "
                 "(0 = uncapped)"),
    "slo_interactive_attainment": _reg(
        "gauge", "Interactive-class SLO attainment over the ladder's "
                 "recent signal window"),
    "slo_batch_attainment": _reg(
        "gauge", "Batch-class SLO attainment over the ladder's recent "
                 "signal window"),
}

# Generated families: per-site injection counters, per-feature
# degradation state.
for _site in SITES:
    METRICS[f"faults_injected_{_site}_total"] = _reg(
        "counter", f"Injected faults raised at site {_site}")
for _f in FEATURES:
    METRICS[f"feature_quarantined_{_f}"] = _reg(
        "gauge", f"{_f} currently quarantined onto its fallback (0/1)")
    METRICS[f"feature_failures_{_f}_total"] = _reg(
        "counter", f"Failures attributed to {_f}")
    METRICS[f"feature_quarantines_{_f}_total"] = _reg(
        "counter", f"Times {_f} entered quarantine")


def metric_meta(name: str) -> Optional[Tuple[str, str]]:
    """(type, help) for a scalar metric name (without the ``llm_``
    prefix), or None for an unregistered name — the exposition then
    falls back to the legacy heuristic and SAYS SO in the HELP line,
    which the /metrics parse test treats as a failure."""
    return METRICS.get(name)


# ---------------------------------------------------------------------------
# Analytic cost model + kernel-build attribution
# ---------------------------------------------------------------------------

def _tree_bytes(node) -> int:
    """Bytes of every weight in a params (sub)tree; a quantized weight
    (``ops.quant.QuantizedTensor``) counts its int8 payload and scales."""
    if isinstance(node, dict):
        return sum(_tree_bytes(v) for v in node.values())
    if hasattr(node, "q") and hasattr(node, "scale"):
        return _tree_bytes(node.q) + _tree_bytes(node.scale)
    return node.numel() * node.element_size()


class CostModel:
    """Analytic FLOPs and bytes of one model's serving dispatches.

    The JAX package reads each program's cost from XLA's
    ``lower().cost_analysis()`` (its ``CostModelCache``); the port has no
    compiler to ask, so the batcher counts each dispatch from its live
    geometry, on the host, before the dispatch runs.  Built once per
    batcher (and once more for a draft model) from the config and the
    weights.  Every term names the code it counts (``models/llama.py``):

      * weight matmuls, 2 FLOPs per weight element per token:
        ``_block``'s qkv, o, gate_up and down projections for every token
        a forward carries, and ``lm_head_logits`` (dim x vocab) for every
        token whose logits it computes (an insert: each row's last token;
        a decode iteration or a speculative pass: every token);
      * attention, 4 x head_dim FLOPs per (query token, attended slot)
        pair per query head per layer (q.k and p.v): token j of a row
        that starts at position p attends p + j + 1 slots, so a prompt of
        n tokens attends n(n+1)/2 pairs;
      * bytes: every weight read once per forward (the embedding table
        only as the rows the tokens gather, unless the head is tied to
        it), plus the K and V bytes (and an int8 pool's scales) of every
        slot a row's attention reads, once per forward.

    Rows the step programs carry but mask (free slots, padding rows and
    columns) count nothing: the model counts what the live requests
    need.  A speculative round's accepted length is only known after
    it, so ``spec`` advances each row by one position a round (the
    least a round advances)."""

    def __init__(self, config, params):
        L, D, H, KVH, hd, F_, V = (
            config.n_layers, config.dim, config.n_heads, config.kv_heads,
            config.head_dim, config.ffn_dim, config.vocab_size,
        )
        self.body_elems = L * (D * (H + 2 * KVH) * hd + H * hd * D
                               + 3 * D * F_)
        self.head_elems = D * V
        self.attn_flops_per_pair = 4 * hd * H * L
        int8 = config.kv_cache_dtype == "int8"
        act = 2 if config.dtype in ("bfloat16", "float16") else 4
        self.kv_bytes_per_slot = L * 2 * KVH * (
            hd * (1 if int8 else act) + (4 if int8 else 0))
        embed = params["embed"]["embedding"]
        tied = "lm_head" not in params
        self.weight_bytes = _tree_bytes(
            {k: v for k, v in params.items() if k != "embed"}
        ) + (_tree_bytes(embed) if tied else 0)
        rows = embed.q if hasattr(embed, "q") else embed
        self.embed_row_bytes = D * rows.element_size()

    def forward(self, rows, logit_tokens: int) -> Tuple[float, float]:
        """(FLOPs, bytes) of one forward over ``rows``: (start position
        p, tokens T) per live row; ``logit_tokens`` of its tokens get
        logits."""
        tokens = sum(T for _, T in rows)
        pairs = sum(T * (p + 1) + T * (T - 1) // 2 for p, T in rows)
        slots = sum(p + T for p, T in rows)
        flops = (2 * self.body_elems * tokens
                 + 2 * self.head_elems * logit_tokens
                 + self.attn_flops_per_pair * pairs)
        nbytes = (self.weight_bytes + self.embed_row_bytes * tokens
                  + self.kv_bytes_per_slot * slots)
        return float(flops), float(nbytes)

    def insert(self, lengths: Sequence[int],
               chunk: Optional[int] = None) -> Tuple[float, float]:
        """A batched prefill (``serving._paged_insert``): one forward per
        chunk of ``chunk`` positions (None: one forward), then each row's
        last-token logits."""
        P = max(lengths)
        step = chunk if chunk and chunk < P else P
        fl = by = 0.0
        for start in range(0, P, step):
            end = min(start + step, P)
            rows = [(start, min(n, end) - start) for n in lengths
                    if n > start]
            f, b = self.forward(rows, 0)
            fl, by = fl + f, by + b
        return fl + 2.0 * self.head_elems * len(lengths), by

    def decode(self, rows) -> Tuple[float, float]:
        """A decode chunk (``serving._chunk_scan``): ``rows`` is (position
        p, iterations) per live row; iteration i forwards one token at
        p + i for every row still running."""
        fl = by = 0.0
        for i in range(max((n for _, n in rows), default=0)):
            live = [(p + i, 1) for p, n in rows if n > i]
            f, b = self.forward(live, len(live))
            fl, by = fl + f, by + b
        return fl, by

    def spec(self, positions: Sequence[int], n_draft: int, rounds: int,
             draft: "CostModel") -> Tuple[float, float]:
        """``rounds`` speculative rounds (``serving._spec_round_core``):
        each runs n_draft draft chain passes and one landing pass of the
        draft (``draft``), then one target verify, every pass over
        n_draft + 1 tokens a row; the chain and the verify compute logits
        for every token, the landing pass none."""
        T = n_draft + 1
        fl = by = 0.0
        for r in range(rounds):
            rows = [(p + r, T) for p in positions]
            toks = T * len(rows)
            for model, passes, logits in ((draft, n_draft, toks),
                                          (draft, 1, 0), (self, 1, toks)):
                f, b = model.forward(rows, logits)
                fl, by = fl + passes * f, by + passes * b
        return fl, by


# Build attribution: serving.py names the program it is about to
# dispatch (thread-local — each serving loop owns one batcher), and the
# process-wide listener on ``ops._build`` books any kernel build that
# runs during the call onto that program's Observability sink.  Builds
# outside an attributed dispatch (e.g. ``build_all`` before serving
# starts) are deliberately ignored: there is no sink to misfeed.
_compile_attr = threading.local()
_listener_state = {"installed": False}
_listener_lock = threading.Lock()


def attribute_compiles(sink: "Observability", program: str) -> None:
    """Point this thread's build events at ``sink`` as ``program``
    (two attribute writes — cheap enough for every dispatch)."""
    _compile_attr.sink = sink
    _compile_attr.program = program


def _compile_listener(source: str, seconds: float) -> None:
    sink = getattr(_compile_attr, "sink", None)
    if sink is None:
        return
    try:
        sink.record_compile(
            getattr(_compile_attr, "program", "unknown"), seconds * 1000.0,
        )
    except Exception:
        pass  # a metrics sink must never break a build


def install_compile_listener() -> bool:
    """Register the process-wide build listener on ``ops._build``
    (idempotent; one record per source built, with its seconds)."""
    from .ops import _build

    with _listener_lock:
        if not _listener_state["installed"]:
            _build.BUILD_LISTENERS.append(_compile_listener)
            _listener_state["installed"] = True
        return True


# ---------------------------------------------------------------------------
# Decision audit log + anomaly-detection building block
# ---------------------------------------------------------------------------

class DecisionLog:
    """Bounded ring of structured control-plane decision events.

    One event per decision the control plane took — route / reroute /
    handoff (router.py), brownout rung move / recovery / quarantine /
    probe / shed / drain (server.py), canary result / anomaly /
    verdict flip (the health sentinel) — each a dict carrying ``seq``
    (monotonic, survives ring eviction so consumers can detect gaps),
    ``t_ms`` (relative to the log's epoch), ``unix_s`` (wall clock,
    for cross-process joins), ``kind``, the external ``request_id``
    where one exists (the join key back to request timelines), and
    whatever fields the decision point attached (candidate sets,
    scores, hit depths, errors).

    Thread-safe under its own leaf lock (registered in
    analysis/lockcheck.py): decision points record from serving-loop /
    poller / handler threads while ``/debug/decisions`` snapshots.
    The lock is never held while calling out."""

    def __init__(self, ring: int = 512, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._t0 = clock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=ring)
        self._seq = 0
        self.counts: Dict[str, int] = {}

    def record(self, kind: str, request_id: Optional[str] = None,
               **fields) -> int:
        """Append one decision event; returns its seq number."""
        ev: Dict[str, Any] = {
            "seq": -1,
            "t_ms": round((self._clock() - self._t0) * 1000.0, 3),
            "unix_s": round(time.time(), 3),
            "kind": kind,
        }
        if request_id:
            ev["request_id"] = request_id
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            self._ring.append(ev)
            self.counts[kind] = self.counts.get(kind, 0) + 1
            return ev["seq"]

    def total(self) -> int:
        """Events ever recorded (ring evictions included)."""
        with self._lock:
            return self._seq

    def counts_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def json(self, n: int = 128, kind: Optional[str] = None,
             request_id: Optional[str] = None) -> Dict[str, Any]:
        """The ``GET /debug/decisions[?n=&kind=&request_id=]`` payload:
        the most recent ``n`` events after filtering (events the ring
        already evicted are gone — ``events_total`` vs ``len`` tells a
        consumer how much history survives)."""
        with self._lock:
            evs = list(self._ring)
            total = self._seq
            counts = dict(self.counts)
            ring = self._ring.maxlen
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if request_id is not None:
            evs = [e for e in evs if e.get("request_id") == request_id]
        evs = evs[-n:] if n > 0 else []
        return {
            "decisions": [dict(e) for e in evs],
            "events_total": total,
            "counts": counts,
            "ring": ring,
        }

    def for_request(self, request_id: str,
                    n: int = 64) -> List[Dict[str, Any]]:
        """The decision events carrying ``request_id`` — the join the
        fleet request lookup attaches to a timeline."""
        return self.json(n=n, request_id=request_id)["decisions"]


class EwmaDetector:
    """Online EWMA mean/variance with z-score anomaly scoring.

    ``update(x)`` returns the z-score of ``x`` against the statistics
    BEFORE the update (so a spike scores against the healthy baseline,
    not against itself), or None during warmup (< ``min_samples``
    observations — no baseline, no verdict).  The variance follows the
    standard exponentially-weighted recurrence; the divisor is floored
    (relative to the mean, and absolutely by ``floor``) so a
    near-constant healthy signal does not turn measurement noise into
    infinite z.  ``floor`` must be set in the SIGNAL'S OWN UNITS: for
    millisecond latencies a floor of ~1 ms says "a deviation under a
    millisecond is never an anomaly, whatever the variance" — without
    it, a 0.05 ms queue-wait baseline turns one harmless 3 ms blip
    into z≈500 and a false critical verdict.

    NOT itself synchronized: the health sentinel mutates it under its
    own lock."""

    def __init__(self, alpha: float = 0.2, min_samples: int = 5,
                 floor: float = 1e-6):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self.floor = float(floor)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0

    def update(self, x: float) -> Optional[float]:
        x = float(x)
        z: Optional[float] = None
        if self.n >= self.min_samples:
            sd = math.sqrt(max(self.var, 0.0))
            z = (x - self.mean) / max(
                sd, abs(self.mean) * 0.05, self.floor
            )
        if self.n == 0:
            self.mean = x
        else:
            a = self.alpha
            d = x - self.mean
            self.mean += a * d
            self.var = (1.0 - a) * (self.var + a * d * d)
        self.n += 1
        return z


# ---------------------------------------------------------------------------
# Timeline / dispatch records
# ---------------------------------------------------------------------------

# Request lifecycle states (the batcher's admission state machine) plus
# terminal outcomes.
STATES = ("queued", "prefilling", "restoring", "decoding")
OUTCOMES = ("finished", "failed", "cancelled")

_MAX_SPANS = 64            # per timeline (replays append; bound them)
_MAX_SPAN_DISPATCHES = 512  # dispatch links per span
_MAX_RIDS = 8              # batcher incarnations indexed per timeline


class _Span:
    __slots__ = ("state", "t0", "t1", "dispatches", "dropped", "note")

    def __init__(self, state: str, t0: float, note: Optional[str] = None):
        self.state = state
        self.t0 = t0
        self.t1: Optional[float] = None
        self.dispatches: List[int] = []
        self.dropped = 0  # dispatch links past _MAX_SPAN_DISPATCHES
        self.note = note


class _Timeline:
    __slots__ = (
        "request_id", "rids", "prompt_tokens", "created", "spans",
        "outcome", "error", "route", "kv",
    )

    def __init__(self, request_id: str, rid: int, prompt_tokens: int,
                 t: float):
        self.request_id = request_id
        self.rids: List[int] = [rid]
        self.prompt_tokens = prompt_tokens
        self.created = t
        self.spans: List[_Span] = []
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        # Routing decision (ReplicaRouter via the X-Routed-By header):
        # which replica/policy served this request — shown by
        # /debug/requests/<id> next to the spans it annotates.
        self.route: Optional[str] = None
        # Per-session KV accounting (request_kv): blocks held, prefix
        # hit depth in tokens, swap bytes moved, evictions suffered.
        self.kv: Dict[str, Any] = {}


class Observability:
    """The serving stack's shared observability sink (module docstring).

    One instance is shared by a ``ContinuousBatcher`` and its
    ``LLMServer`` — and survives crash-recovery/quarantine rebuilds the
    same way the fault injector does (it rides the captured ctor
    kwargs), so timelines and histograms span batcher incarnations.

    ``ring`` bounds the dispatch ring, ``max_timelines`` the request-
    timeline LRU, ``max_events`` the annotation ring.  ``clock`` is
    injectable for tests."""

    def __init__(
        self,
        slo_ttft_ms: Optional[float] = None,
        slo_itl_ms: Optional[float] = None,
        ring: int = 512,
        max_timelines: int = 1024,
        max_events: int = 256,
        slo_window: int = 256,
        peak_flops: float = DEFAULT_PEAK_FLOPS,
        peak_bytes_per_s: float = DEFAULT_PEAK_BYTES_PER_S,
        util_window: int = 64,
        decision_ring: int = 512,
        max_snapshots: int = 128,
        clock=time.monotonic,
    ):
        self.slo_ttft_ms = (
            float(slo_ttft_ms) if slo_ttft_ms else None
        )
        self.slo_itl_ms = float(slo_itl_ms) if slo_itl_ms else None
        self._clock = clock
        self.t0 = clock()
        # Wall-clock anchor captured at the SAME instant as the
        # monotonic t0: the fleet-merge (router /debug/trace) shifts
        # each replica's relative timestamps into a common frame via
        # the difference of these anchors (clock-offset normalization).
        self.t0_unix = time.time()
        self._lock = threading.Lock()
        self._seq = 0
        self.dispatches: "deque[Dict[str, Any]]" = deque(maxlen=ring)
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=max_events)
        self._max_timelines = int(max_timelines)
        self._timelines: "OrderedDict[str, _Timeline]" = OrderedDict()
        self._by_rid: Dict[int, _Timeline] = {}
        # Decision audit log (its own leaf lock — never nested with
        # self._lock) + the flight recorder's periodic metric-snapshot
        # ring (server.py feeds it every flight_interval_s; the
        # /debug/bundle artifact exports it).  Both survive batcher
        # rebuilds with the rest of this instance.
        self.decisions = DecisionLog(ring=decision_ring, clock=clock)
        self.metric_snapshots: "deque[Dict[str, Any]]" = deque(
            maxlen=max_snapshots
        )
        # Device-time attribution: hardware peaks (0 disables the
        # corresponding gauge) and a per-kind sliding window of
        # (flops, bytes, wall_ms, device_est_ms) from dispatches that
        # carried a cost model.
        self.peak_flops = float(peak_flops or 0.0)
        self.peak_bytes_per_s = float(peak_bytes_per_s or 0.0)
        self._util_window = int(util_window)
        self._util: Dict[str, "deque[Tuple[float, float, float, float]]"]
        self._util = {}
        # Kernel-build observability: build spans (bounded ring, a
        # trace track of their own) + per-program counters, fed by the
        # process-wide ops._build listener via record_compile.
        self.compiles: "deque[Dict[str, Any]]" = deque(maxlen=max_events)
        self.compiles_total = 0
        self.compiles_by_program: Dict[str, int] = {}
        # Optional dispatch-record sink (overload.py's throughput
        # EWMAs feed off it).  Called OUTSIDE self._lock with the
        # already-built record dict — the sink takes its own lock, and
        # calling out under ours would order the two locks.  Settable
        # after construction (the server wires its controller here).
        self.on_dispatch: Optional[Any] = None
        self.hist: Dict[str, Histogram] = {
            name: Histogram(
                name, help_text,
                buckets=HISTOGRAM_BUCKETS.get(name, DEFAULT_BUCKETS_MS),
            )
            for name, help_text in HISTOGRAMS.items()
            if name not in LABELED_HISTOGRAMS
        }
        # Per-kind dispatch_ms series (one Histogram per dispatch
        # kind, created lazily under the lock on first dispatch).
        self.hist_dispatch: Dict[str, Histogram] = {}
        # Outcome / SLO accounting.
        self.requests_finished_total = 0
        self.requests_failed_total = 0
        self.requests_cancelled_total = 0
        self.requests_slo_ok_total = 0
        self.goodput_tokens_total = 0
        self._slo_window: "deque[Tuple[bool, bool, bool]]" = deque(
            maxlen=slo_window
        )

    # -- internal helpers ---------------------------------------------------

    def _now_ms(self) -> float:
        return (self._clock() - self.t0) * 1000.0

    def now_ms(self) -> float:
        """This sink's clock (ms since it was built): the ``start_ms`` a
        dispatch recorded after the fact passes to ``record_dispatch``."""
        return self._now_ms()

    def _evict_locked(self) -> None:
        while len(self._timelines) > self._max_timelines:
            # Prefer the oldest TERMINAL timeline: evicting a live one
            # mid-flight would make its later request_end a no-op (the
            # finished counter undercounts and /debug 404s for a
            # request still being served) — and the longest-lived
            # requests are exactly the ones worth debugging.  Only
            # when every entry is live (a pathological burst) does the
            # oldest go regardless, keeping the bound hard.
            key = next(
                (k for k, tl in self._timelines.items()
                 if tl.outcome is not None),
                next(iter(self._timelines)),
            )
            tl = self._timelines.pop(key)
            for rid in tl.rids:
                if self._by_rid.get(rid) is tl:
                    del self._by_rid[rid]

    def _current_span(self, tl: _Timeline) -> Optional[_Span]:
        return tl.spans[-1] if tl.spans else None

    def _span_at(self, tl: _Timeline, t: float) -> Optional[_Span]:
        """The span ``tl`` was in at time ``t`` (its first if ``t`` is
        earlier; the current one for a dispatch recorded as it ends)."""
        for sp in reversed(tl.spans):
            if sp.t0 <= t:
                return sp
        return tl.spans[0] if tl.spans else None

    def _begin_span_locked(self, tl: _Timeline, state: str,
                           note: Optional[str] = None) -> None:
        t = self._now_ms()
        cur = self._current_span(tl)
        if cur is not None and cur.t1 is None:
            cur.t1 = t
            if cur.state == "queued" and state in (
                "prefilling", "restoring"
            ):
                self.hist["queue_wait_ms"].observe(t - cur.t0)
        if len(tl.spans) >= _MAX_SPANS:
            return
        tl.spans.append(_Span(state, t, note))

    # -- request lifecycle (called by the batcher / server) -----------------

    def request_queued(self, rid: int, prompt_tokens: int) -> None:
        """A request entered the batcher queue (``submit``); creates a
        timeline under the provisional id ``r<rid>`` until the server
        binds the external one."""
        with self._lock:
            tl = _Timeline(f"r{rid}", rid, prompt_tokens, self._clock())
            self._timelines[tl.request_id] = tl
            self._by_rid[rid] = tl
            self._begin_span_locked(tl, "queued")
            self._evict_locked()

    def bind(self, rid: int, request_id: str,
             replay: bool = False) -> None:
        """Attach the server's external request id to ``rid``'s
        timeline.  On a crash-recovery replay (``replay=True``, passed
        by the server's rebuild-and-replay path) the external id
        already owns a timeline: the fresh rid (and its new ``queued``
        span) folds into it, so ``/debug/requests/<id>`` shows the
        whole story across batcher incarnations.

        A NON-replay bind that collides with an existing timeline is a
        client reusing an ``X-Request-Id`` (proxies and retry layers
        do): the new request keeps its provisional ``r<rid>`` timeline
        instead of folding — merging two unrelated requests would
        clobber the live timeline's outcome and grow the merged record
        without bound on every reuse."""
        with self._lock:
            tl_rid = self._by_rid.get(rid)
            existing = self._timelines.get(request_id)
            if existing is None:
                if tl_rid is None:
                    return
                self._timelines.pop(tl_rid.request_id, None)
                tl_rid.request_id = request_id
                self._timelines[request_id] = tl_rid
            elif existing is not tl_rid and replay:
                if tl_rid is not None:
                    self._timelines.pop(tl_rid.request_id, None)
                    room = max(0, _MAX_SPANS - len(existing.spans))
                    for sp in tl_rid.spans[:room]:
                        sp.note = sp.note or "replay"
                        existing.spans.append(sp)
                existing.rids.append(rid)
                # Bound the per-timeline rid list (and the _by_rid
                # index entries it keeps alive): only the most recent
                # incarnations stay addressable by bare rid.
                while len(existing.rids) > _MAX_RIDS:
                    old = existing.rids.pop(0)
                    if self._by_rid.get(old) is existing:
                        del self._by_rid[old]
                existing.outcome = None
                existing.error = None
                self._by_rid[rid] = existing
                self._timelines.move_to_end(request_id)

    def set_route(self, request_id: str, route: str) -> None:
        """Record a ReplicaRouter's decision on the request's timeline
        (called by the server after ``bind`` when the POST carried an
        ``X-Routed-By`` header) AND drop an instant event into the
        annotation ring, so the decision shows both in
        ``/debug/requests/<id>`` and on the trace."""
        with self._lock:
            tl = self._timelines.get(request_id)
            if tl is not None:
                tl.route = route
            self.events.append({
                "t_ms": round(self._now_ms(), 3), "name": "routed",
                "fields": {"request_id": request_id, "via": route},
            })

    def begin_span(self, rid: int, state: str,
                   note: Optional[str] = None) -> None:
        """Transition ``rid`` into a lifecycle state (ends the current
        span; queued->prefilling/restoring edges feed the queue-wait
        histogram)."""
        with self._lock:
            tl = self._by_rid.get(rid)
            if tl is not None:
                self._begin_span_locked(tl, state, note)

    def request_end(self, rid: int, outcome: str,
                    error: Optional[str] = None) -> None:
        """Terminal transition (finished / failed / cancelled)."""
        with self._lock:
            tl = self._by_rid.get(rid)
            if tl is None:
                return
            t = self._now_ms()
            cur = self._current_span(tl)
            if cur is not None and cur.t1 is None:
                cur.t1 = t
            tl.outcome = outcome
            tl.error = error
            if outcome == "finished":
                self.requests_finished_total += 1
            elif outcome == "cancelled":
                self.requests_cancelled_total += 1
            else:
                self.requests_failed_total += 1

    def request_rejected(self, request_id: str, error: str) -> None:
        """A request the server answered (504/503) without it ever
        reaching the batcher — the overload signature: it expired in
        the server inbox, so no rid exists and ``request_queued`` never
        fired.  Record a minimal terminal timeline under the external
        id and count the failure, so ``/debug/requests/<id>`` and
        ``requests_failed_total`` agree with the error the client saw
        (without this, attainment drops while the failure counter
        stays flat — the two overload signals would contradict)."""
        with self._lock:
            # The failure COUNTS regardless of id reuse — every 504 the
            # client saw is a failure, or attainment drops while the
            # counter stays flat (the divergence this method removes).
            self.requests_failed_total += 1
            if request_id in self._timelines:
                return  # id reuse: keep the existing richer record
            tl = _Timeline(request_id, rid=-1, prompt_tokens=0,
                           t=self._clock())
            tl.rids = []  # no batcher incarnation ever existed
            t = self._now_ms()
            sp = _Span("queued", t)
            sp.t1 = t
            tl.spans.append(sp)
            tl.outcome = "failed"
            tl.error = error
            self._timelines[request_id] = tl
            self._evict_locked()

    # -- dispatch spans ------------------------------------------------------

    def record_dispatch(
        self,
        kind: str,
        k: int = 1,
        occupancy: int = 0,
        prefill_tokens: int = 0,
        wall_ms: float = 0.0,
        fetch_ms: float = 0.0,
        swap_inflight: int = 0,
        rids: Sequence[int] = (),
        program: Optional[str] = None,
        flops: Optional[float] = None,
        bytes_accessed: Optional[float] = None,
        start_ms: Optional[float] = None,
    ) -> int:
        """Record one serving dispatch and link it into the CURRENT span
        of every request that rode it.  Returns the dispatch's
        ring-global seq number.  ``wall_ms`` covers dispatch submit
        through the packed fetch (what the host actually waited);
        ``fetch_ms`` isolates the device->host sync.  A dispatch that no
        fetch ends (an insert on the card) is timed on the device
        between CUDA events and recorded after the fact, once a later
        fetch has passed it: it passes ``start_ms`` (``now_ms()`` when it
        was submitted) and links into the span each request was in then.
        ``program`` names the dispatch program; ``flops`` /
        ``bytes_accessed`` are its analytic cost (CostModel) —
        when present the record carries a roofline device-time estimate
        and feeds the per-kind utilization window."""
        if kind not in DISPATCH_KINDS:
            raise ValueError(
                f"unknown dispatch kind {kind!r}; have "
                f"{sorted(DISPATCH_KINDS)}"
            )
        after_fact = start_ms is not None
        if start_ms is None:
            start_ms = self._now_ms() - wall_ms
        rec = {
            "seq": -1, "kind": kind, "k": int(k),
            "occupancy": int(occupancy),
            "prefill_tokens": int(prefill_tokens),
            "start_ms": round(start_ms, 3),
            "wall_ms": round(wall_ms, 3),
            "fetch_ms": round(fetch_ms, 3),
            "swap_inflight": int(swap_inflight),
            "rids": list(rids),
        }
        if program is not None:
            rec["program"] = program
        est_ms = None
        if flops is not None and bytes_accessed is not None:
            est = 0.0
            if self.peak_flops > 0:
                est = max(est, float(flops) / self.peak_flops * 1000.0)
            if self.peak_bytes_per_s > 0:
                est = max(
                    est,
                    float(bytes_accessed) / self.peak_bytes_per_s
                    * 1000.0,
                )
            if est > 0:
                est_ms = est
                rec["flops"] = float(flops)
                rec["bytes_accessed"] = float(bytes_accessed)
                rec["device_est_ms"] = round(est, 6)
        with self._lock:
            seq = self._seq
            self._seq += 1
            rec["seq"] = seq
            self.dispatches.append(rec)
            h = self.hist_dispatch.get(kind)
            if h is None:
                h = self.hist_dispatch[kind] = Histogram(
                    "dispatch_ms", HISTOGRAMS["dispatch_ms"],
                    labels={"kind": kind},
                )
            h.observe(wall_ms)
            if est_ms is not None:
                dq = self._util.get(kind)
                if dq is None:
                    dq = self._util[kind] = deque(
                        maxlen=self._util_window
                    )
                dq.append(
                    (float(flops), float(bytes_accessed), wall_ms,
                     est_ms)
                )
            if prefill_tokens > 0 or kind in ("insert", "suffix_insert"):
                self.hist["prefill_chunk_ms"].observe(wall_ms)
            for rid in rids:
                tl = self._by_rid.get(rid)
                if tl is None:
                    continue
                sp = (self._span_at(tl, start_ms) if after_fact
                      else self._current_span(tl))
                if sp is None:
                    continue
                if len(sp.dispatches) < _MAX_SPAN_DISPATCHES:
                    sp.dispatches.append(seq)
                else:
                    sp.dropped += 1
        # Outside the lock: the overload controller's EWMA ingest takes
        # its own lock (lock-order discipline; the record dict is
        # already fully built and never mutated after this point).
        if self.on_dispatch is not None:
            self.on_dispatch(rec)
        return seq

    def record_compile(self, program: str, dur_ms: float) -> None:
        """One kernel build landed (fed by the ops._build listener;
        ``program`` is whatever serving.py last attributed on the
        building thread).  Becomes a compile_ms observation, a span on
        the trace's ``kernel builds`` track, and a per-program
        counter."""
        with self._lock:
            t = self._now_ms()
            self.hist["compile_ms"].observe(dur_ms)
            self.compiles.append({
                "program": program, "t_ms": round(t, 3),
                "dur_ms": round(dur_ms, 3),
            })
            self.compiles_total += 1
            self.compiles_by_program[program] = (
                self.compiles_by_program.get(program, 0) + 1
            )

    def record_swap_in(self, ms: float, blocks: int) -> None:
        """A host-tier swap-in landed (staging start -> adoption)."""
        with self._lock:
            self.hist["swap_in_ms"].observe(ms)
        self.annotate("kv_swap_in", ms=round(ms, 3), blocks=blocks)

    # -- per-session KV accounting ------------------------------------------

    # request_kv fields that ACCUMULATE across calls (a replay or a
    # second swap-in adds to the session's ledger); everything else is
    # set-latest (gauge semantics: blocks_held, prefix_hit_tokens).
    _KV_ADDITIVE = frozenset({
        "swap_in_bytes", "swap_out_bytes", "evictions_suffered",
    })

    def request_kv(self, rid: int, **fields) -> None:
        """Merge per-session KV accounting onto ``rid``'s timeline —
        blocks held, prefix-hit depth in tokens, swap bytes moved,
        evictions suffered — shown under ``kv`` in
        ``/debug/requests/<id>``.  Host bookkeeping only."""
        with self._lock:
            tl = self._by_rid.get(rid)
            if tl is None:
                return
            for k, v in fields.items():
                if k in self._KV_ADDITIVE:
                    tl.kv[k] = tl.kv.get(k, 0) + v
                else:
                    tl.kv[k] = v

    def observe_kv(self, hit_depth_tokens: Optional[int] = None,
                   session_blocks: Optional[int] = None) -> None:
        """Feed the KV-capacity histograms: prefix-hit depth at
        admission, session block footprint at slot free."""
        with self._lock:
            if hit_depth_tokens is not None:
                self.hist["prefix_hit_depth_tokens"].observe(
                    hit_depth_tokens
                )
            if session_blocks is not None:
                self.hist["session_kv_blocks"].observe(session_blocks)

    def annotate(self, name: str, **fields) -> None:
        """Instant event into the bounded annotation ring (fault
        injections, quarantine transitions, kv-tier demotions...) —
        rendered as instant events in the Perfetto export."""
        with self._lock:
            self.events.append({
                "t_ms": round(self._now_ms(), 3), "name": name,
                "fields": fields,
            })

    def events_json(self, n: int = 256) -> List[Dict[str, Any]]:
        """Snapshot of the annotation ring (state transitions, fault
        injections, kv-tier events) — the flight recorder's
        state-transition record in ``/debug/bundle``."""
        with self._lock:
            items = list(self.events)[-n:] if n > 0 else []
        return [dict(e) for e in items]

    def record_metrics_snapshot(self, snapshot: Dict[str, Any]) -> None:
        """Flight recorder: append one periodic metric snapshot (a
        compact scalar dict the serving loop builds every
        ``flight_interval_s``) to the bounded ring — pure host
        bookkeeping, exported by ``/debug/bundle`` so a postmortem can
        see the trend into the incident, not just the final values."""
        rec = {
            "t_ms": round(self._now_ms(), 3),
            "unix_s": round(time.time(), 3),
        }
        rec.update(snapshot)
        with self._lock:
            self.metric_snapshots.append(rec)

    def metric_snapshots_json(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self.metric_snapshots]

    # -- server-side latency / SLO ------------------------------------------

    def observe_ttft(self, ms: float) -> None:
        # Locked: a concurrent /metrics scrape renders under the lock
        # and must never see a bucket updated ahead of _count (the
        # +Inf == _count invariant the parse test asserts).
        with self._lock:
            self.hist["ttft_ms"].observe(ms)

    def observe_itl(self, ms: float) -> None:
        with self._lock:
            self.hist["itl_ms"].observe(ms)

    def slo_account(
        self,
        ttft_ms: Optional[float],
        max_itl_ms: Optional[float],
        tokens: int,
        completed: bool = True,
    ) -> bool:
        """Score one finished request against the configured SLOs.
        ``ttft_ms`` None means no token was ever delivered (fails a
        configured TTFT SLO); an unconfigured dimension always passes;
        ``completed=False`` (failure/timeout) can never be goodput.
        Returns whether the request met every configured deadline."""
        ttft_ok = self.slo_ttft_ms is None or (
            ttft_ms is not None and ttft_ms <= self.slo_ttft_ms
        )
        itl_ok = self.slo_itl_ms is None or (
            max_itl_ms is None or max_itl_ms <= self.slo_itl_ms
        )
        ok = bool(completed and ttft_ok and itl_ok)
        with self._lock:
            self._slo_window.append((ttft_ok and completed,
                                     itl_ok and completed, ok))
            if ok:
                self.requests_slo_ok_total += 1
                self.goodput_tokens_total += int(tokens)
        return ok

    # -- exposition -----------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """Scalar gauges/counters for the /metrics exposition (the
        histograms render separately via ``expose_histograms``)."""
        # Taken BEFORE self._lock: the decision log has its own leaf
        # lock and the two must never nest.
        decisions_total = self.decisions.total()
        with self._lock:
            n = len(self._slo_window) or 1
            ttft_ok = sum(1 for a, _, _ in self._slo_window if a)
            itl_ok = sum(1 for _, b, _ in self._slo_window if b)
            both = sum(1 for _, _, c in self._slo_window if c)
            return {
                "requests_finished_total": self.requests_finished_total,
                "requests_failed_total": self.requests_failed_total,
                "requests_cancelled_total": self.requests_cancelled_total,
                "decision_events_total": decisions_total,
                "compiles_total": self.compiles_total,
                "slo_ttft_ms": self.slo_ttft_ms or 0.0,
                "slo_itl_ms": self.slo_itl_ms or 0.0,
                "requests_slo_ok_total": self.requests_slo_ok_total,
                "goodput_tokens_total": self.goodput_tokens_total,
                "slo_ttft_attainment": round(ttft_ok / n, 4),
                "slo_itl_attainment": round(itl_ok / n, 4),
                "slo_attainment": round(both / n, 4),
            }

    def expose_histograms(self, prefix: str = "llm_") -> List[str]:
        with self._lock:
            lines: List[str] = []
            for h in self.hist.values():
                lines.extend(h.expose(prefix))
            # The labeled dispatch_ms family: one HELP/TYPE header,
            # then every kind's series (header even when no dispatch
            # has landed yet, so the family is always discoverable).
            n = prefix + "dispatch_ms"
            lines.append(f"# HELP {n} {HISTOGRAMS['dispatch_ms']}")
            lines.append(f"# TYPE {n} histogram")
            for kind in sorted(self.hist_dispatch):
                lines.extend(
                    self.hist_dispatch[kind].expose(prefix, header=False)
                )
            return lines

    def utilization_metrics(
        self,
    ) -> List[Tuple[str, Dict[str, str], float]]:
        """Labeled device-time attribution samples for /metrics:
        ``(family, labels, value)`` triples — per-kind
        mxu_utilization / hbm_utilization / host_overhead_ratio over
        the recent dispatch window, plus per-program compile counters.
        Families are registered in METRICS; the server renders one
        HELP/TYPE header per family."""
        out: List[Tuple[str, Dict[str, str], float]] = []
        with self._lock:
            windows = {
                kind: list(dq) for kind, dq in self._util.items() if dq
            }
            compiles = sorted(self.compiles_by_program.items())
        for kind in sorted(windows):
            dq = windows[kind]
            wall_ms = sum(w for _, _, w, _ in dq)
            if wall_ms <= 0:
                continue
            wall_s = wall_ms / 1000.0
            lab = {"kind": kind}
            if self.peak_flops > 0:
                fl = sum(f for f, _, _, _ in dq)
                out.append((
                    "mxu_utilization", lab,
                    round(fl / wall_s / self.peak_flops, 6),
                ))
            if self.peak_bytes_per_s > 0:
                by = sum(b for _, b, _, _ in dq)
                out.append((
                    "hbm_utilization", lab,
                    round(by / wall_s / self.peak_bytes_per_s, 6),
                ))
            est_ms = sum(e for _, _, _, e in dq)
            if est_ms > 0:
                out.append((
                    "host_overhead_ratio", lab,
                    round(wall_ms / est_ms, 3),
                ))
        for prog, n in compiles:
            out.append(("program_compiles_total", {"program": prog}, n))
        return out

    # -- debug JSON ------------------------------------------------------------

    def _span_json(self, sp: _Span) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "state": sp.state,
            "start_ms": round(sp.t0, 3),
            "end_ms": round(sp.t1, 3) if sp.t1 is not None else None,
            "duration_ms": (
                round(sp.t1 - sp.t0, 3) if sp.t1 is not None else None
            ),
            "dispatches": list(sp.dispatches),
        }
        if sp.dropped:
            out["dispatches_dropped"] = sp.dropped
        if sp.note:
            out["note"] = sp.note
        return out

    def timeline_json(self, request_id: str) -> Optional[Dict[str, Any]]:
        """The ``/debug/requests/<id>`` payload: the request's span
        timeline (accepts the external id, the provisional ``r<rid>``
        id, or a bare batcher rid)."""
        with self._lock:
            tl = self._timelines.get(request_id)
            if tl is None:
                tl = self._timelines.get(f"r{request_id}")
            if tl is None:
                try:
                    tl = self._by_rid.get(int(request_id))
                except ValueError:
                    tl = None
            if tl is None:
                return None
            seqs = {
                s for sp in tl.spans for s in sp.dispatches
            }
            return {
                "request_id": tl.request_id,
                "rids": list(tl.rids),
                "prompt_tokens": tl.prompt_tokens,
                "outcome": tl.outcome,
                "error": tl.error,
                "route": tl.route,
                "kv": dict(tl.kv),
                "spans": [self._span_json(sp) for sp in tl.spans],
                "dispatch_spans": [
                    dict(d) for d in self.dispatches if d["seq"] in seqs
                ],
            }

    def requests_json(self, n: int = 64) -> Dict[str, Any]:
        """Index of recent request timelines (most recent last).
        ``n <= 0`` returns nothing (``[-0:]`` would return the whole
        store)."""
        with self._lock:
            items = list(self._timelines.values())[-n:] if n > 0 else []
            return {"requests": [
                {
                    "request_id": tl.request_id,
                    "rids": list(tl.rids),
                    "outcome": tl.outcome,
                    "states": [sp.state for sp in tl.spans],
                }
                for tl in items
            ]}

    def dispatches_json(self, n: int = 128) -> Dict[str, Any]:
        with self._lock:
            items = list(self.dispatches)[-n:] if n > 0 else []
            return {"dispatches": [dict(d) for d in items]}

    def trace_json(self, window_ms: Optional[float] = None) -> Dict[str, Any]:
        """Chrome/Perfetto ``trace_event`` JSON for the recent serving
        window (default: everything the rings still hold).  Dispatches
        render on pid 1 / tid 1, request lifecycles on one tid per
        request, annotations as instant events — load the payload in
        chrome://tracing or https://ui.perfetto.dev."""
        horizon = None
        if window_ms is not None:
            horizon = self._now_ms() - float(window_ms)
        # Snapshot under the lock, BUILD outside it: constructing tens
        # of thousands of event dicts while holding the one lock the
        # serving loop needs per dispatch would inject exactly the
        # decode-chunk stall this layer exists to measure.  Dispatch
        # and annotation dicts are created once and never mutated, so
        # the list copies are reference-shallow; only the mutable
        # _Span fields are copied out.
        with self._lock:
            dispatches = list(self.dispatches)
            events = list(self.events)
            compiles = list(self.compiles)
            now_ms = self._now_ms()
            timelines = [
                (tl.request_id, tl.outcome, [
                    (sp.state, sp.t0, sp.t1, sp.dispatches[:64])
                    for sp in tl.spans
                ])
                for tl in self._timelines.values()
            ]
        ev: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
             "args": {"name": "dispatches"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "kernel builds"}},
        ]
        for d in dispatches:
            if horizon is not None and d["start_ms"] < horizon:
                continue
            ev.append({
                "name": f"{d['kind']} k={d['k']}",
                "cat": "dispatch", "ph": "X", "pid": 1, "tid": 1,
                "ts": round(d["start_ms"] * 1000.0, 1),
                "dur": max(1, round(d["wall_ms"] * 1000.0)),
                "args": {
                    k: d[k] for k in (
                        "seq", "occupancy", "prefill_tokens",
                        "fetch_ms", "swap_inflight", "rids",
                        "program", "device_est_ms",
                    ) if k in d
                },
            })
        for c in compiles:
            end = c["t_ms"]
            if horizon is not None and end < horizon:
                continue
            ev.append({
                "name": f"compile {c['program']}",
                "cat": "compile", "ph": "X", "pid": 1, "tid": 0,
                "ts": round((end - c["dur_ms"]) * 1000.0, 1),
                "dur": max(1, round(c["dur_ms"] * 1000.0)),
                "args": {"program": c["program"]},
            })
        tid = 2
        for request_id, outcome, spans in timelines:
            spans = [
                sp for sp in spans
                if horizon is None or sp[2] is None or sp[2] >= horizon
            ]
            if not spans:
                continue
            ev.append({
                "ph": "M", "pid": 1, "tid": tid,
                "name": "thread_name",
                "args": {"name": f"req {request_id}"},
            })
            for state, t0, t1, links in spans:
                if t1 is None:
                    t1 = now_ms
                ev.append({
                    "name": state, "cat": "request", "ph": "X",
                    "pid": 1, "tid": tid,
                    "ts": round(t0 * 1000.0, 1),
                    "dur": max(1, round((t1 - t0) * 1000.0)),
                    "args": {
                        "request_id": request_id,
                        "dispatches": links,
                        "outcome": outcome,
                    },
                })
            tid += 1
        # KV-cache events (tier demotions / host-LRU drops / evictions
        # / swap-ins / handoff export+import) get their OWN track, so a
        # trace window reads cache churn as one lane instead of noise
        # interleaved with dispatch annotations.  Each instant's args
        # keep whatever rid/request_id the emitter attached — the link
        # back to the owning request's track.
        kv_tid = tid
        kv_named = False
        for e in events:
            if horizon is not None and e["t_ms"] < horizon:
                continue
            is_kv = e["name"].startswith("kv_") or e["name"] in (
                "prefix_export", "prefix_import",
            )
            if is_kv and not kv_named:
                kv_named = True
                ev.append({
                    "ph": "M", "pid": 1, "tid": kv_tid,
                    "name": "thread_name",
                    "args": {"name": "kv cache"},
                })
            ev.append({
                "name": e["name"], "cat": "annotation", "ph": "i",
                "pid": 1, "tid": kv_tid if is_kv else 1, "s": "g",
                "ts": round(e["t_ms"] * 1000.0, 1),
                "args": dict(e["fields"]),
            })
        # t0_unix_s: the wall-clock instant ts==0 corresponds to —
        # the router's fleet merge uses it to shift every replica's
        # relative timestamps into one frame (Perfetto ignores
        # unknown top-level keys).
        return {
            "traceEvents": ev, "displayTimeUnit": "ms",
            "t0_unix_s": round(self.t0_unix, 6),
        }


# ---------------------------------------------------------------------------
# Structured logging
# ---------------------------------------------------------------------------

class StructuredLogger:
    """One formatter for every server/batcher log line.

    ``json_mode=False`` (default) renders ``ts event k=v ...`` text;
    ``json_mode=True`` (run.py ``--log-json``) renders one JSON object
    per line with stable ``event`` / ``request_id`` / ``dispatch_seq``
    fields, so a fleet's log pipeline can join server lines to
    ``/debug`` timelines without regexes.  Writes are single ``print``
    calls (atomic enough under the GIL for line-oriented collectors).

    Every formatted line also lands in a bounded in-memory ring — the
    flight recorder's LOG TAIL, exported by ``/debug/bundle`` so a
    postmortem artifact carries the last ``ring`` log lines even when
    nobody captured stdout.  ``quiet=True`` keeps the ring but never
    prints (the server's default logger when the caller supplied
    none: the bundle still has a tail, stdout stays silent)."""

    def __init__(self, json_mode: bool = False, stream=None,
                 ring: int = 256, quiet: bool = False):
        self.json_mode = bool(json_mode)
        self.stream = stream if stream is not None else sys.stdout
        self.quiet = bool(quiet)
        self._lock = threading.Lock()
        self._ring: "deque[str]" = deque(maxlen=ring)

    def log(self, event: str, message: str = "", **fields) -> None:
        if self.json_mode:
            rec: Dict[str, Any] = {
                "ts": round(time.time(), 3), "event": event,
            }
            if message:
                rec["message"] = message
            rec.update({k: v for k, v in fields.items() if v is not None})
            line = json.dumps(rec, default=str)
        else:
            parts = [event]
            if message:
                parts.append(message)
            parts.extend(
                f"{k}={v}" for k, v in fields.items() if v is not None
            )
            line = " ".join(parts)
        with self._lock:
            self._ring.append(line)
        if not self.quiet:
            print(line, file=self.stream, flush=True)

    def tail(self, n: int = 256) -> List[str]:
        """The most recent formatted log lines (flight-recorder tail)."""
        with self._lock:
            out = list(self._ring)
        return out[-n:] if n > 0 else []
