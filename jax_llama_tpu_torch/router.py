"""Data-parallel replica routing: N serving replicas behind one door
(port of ``jax_llama_tpu/router.py``; the JAX names are kept, so each
part is found in both files by name).

The scale-out serving subsystem's outermost layer (each replica may
itself run over a serving mesh, below): a :class:`ReplicaRouter` fronts N
**independent** serving replicas — each an ``LLMServer`` with its own
``ContinuousBatcher``, KV pool and radix prefix index — and routes each
POST to one of them:

  * **least-loaded** (default): the healthy replica with the fewest
    router-tracked in-flight requests (ties rotate by routed count), so
    a long-generation pileup on one replica never queues new arrivals
    behind it.
  * **affinity**: sticky sessions by prompt-prefix key — a revisited
    session routes to the replica already holding its radix chain, so
    multi-turn chats keep their prefix-cache hits (and host-tier slabs)
    local instead of re-prefilling cold on a random replica.  New
    sessions fall back to least-loaded; a dead replica's sessions
    re-pin wherever their next turn lands.
  * **cache-aware**: GLOBALLY cache-aware routing off the router-side
    radix index (below) — each request routes to the replica holding
    the DEEPEST matching chain prefix fleet-wide, spilling to
    least-loaded past the occupancy watermark (``spill_occupancy``,
    in-flight/slots).  Replaces affinity's single-pinned-replica LRU
    with exact fleet-wide knowledge: N replicas behave as ONE
    coherent prefix cache, so fleet TTFT tracks the global hit depth,
    not per-replica luck.

**Global radix index** (:class:`RouterRadixIndex`, cache-aware
policy): every replica's chain digest folded into one map
``chain-prefix key -> {replica: (depth, tier)}``.  Kept fresh
INCREMENTALLY off the /healthz poller — a digest ``version`` delta in
the scrape triggers ``GET /debug/kv?since=<synced>``, whose journaled
events (publish/remove/demote/restore) replay into the index at
O(changes); the bounded journal falling short (rebuild reset, poller
too far behind) falls back to one full node-walk replace.  The
request's own chain keys come from :func:`chain_keys` (the ONE shared
key schema; tokenization happens on the router thread OUTSIDE the
routing lock, mirroring the replica's own /generate-/chat encoding).
A hit whose holder's LIVE digest version has moved past the synced
one routes anyway but counts ``llm_router_cache_stale_routes_total``
— it degrades to a cold prefill, never to wrong tokens.

**Handoff scheduler**: when the deepest-prefix replica sits past the
occupancy watermark the request spills to least-loaded, and — when
``depth x (occupancy gap)`` clears ``handoff_threshold`` (and depth
>= ``handoff_min_depth``) — the chain MIGRATES to where the request
landed: a background worker drives ``export_prefix`` (with
``demote_after_export``, so the move deduplicates fleet HBM) on the
source's serving-loop thread and ``import_prefix`` on the
destination's, through ``LLMServer.call_on_loop`` (the batchers stay
thread-confined).  Bounds: at most ONE in-flight handoff per chain,
``handoff_max_bytes_inflight`` total estimated bytes moving,
``handoff_timeout_s`` wall budget per job (timeouts unwind cleanly on
both sides and count as aborted; the serving side owns the
no-partial-publish contract).  The triggering request NEVER waits —
its first token rides a cold prefill on the spill target; the next
turn hits warm.

**Prefill/decode disaggregation** (``roles=("prefill", "decode",
...)``, run.py ``--replica-roles``; requires cache-aware): cold
prompts route to the least-loaded PREFILL replica; a request
completing there streams its freshly published chain to the
least-loaded decode replica via the same export->import path, and the
session's routing record re-pins at the destination — so first turns
prefill on the prefill pool and every revisit decodes warm on the
decode pool.  Deep index hits route to the holding replica regardless
of role (the KV is there).

**Health / quarantine.**  A poller thread scrapes each replica's
``/healthz`` (the server's own ok/draining/degraded verdict — a replica
in drain or with a dead loop stops receiving new work while its
in-flight requests finish); a forward-time connection failure (or an
injected ``router_replica`` fault) marks the replica unhealthy
immediately.  Requests that have not yet streamed a byte RE-ROUTE to a
surviving replica losslessly; requests in flight on a genuinely crashed
replica are that replica's own crash-recovery problem (the server's
rebuild + replay), not the router's: the router never duplicates a
request it may have half-delivered.

:func:`handoff_prefix` remains the direct two-batcher handoff helper
(tests/drills drive it on the owning threads); live traffic goes
through the scheduler above, which reaches each batcher via its
server's control path (``call_on_loop``).

**Over a serving mesh** (``run.py --replicas N --serve-mesh dp,tp``
under torchrun): the router, every replica's server and the fleet
controller run on rank 0, and every replica time-shares the one mesh
(JAX's geometry when the host has no device slice of its own for a
replica).  Each replica's batcher is built on every rank through the
mesh's lockstep log (``parallel.lockstep``), whose one lock orders all
replicas' logged calls.  A control closure runs on the leader's loop,
where the batcher it is given publishes each of its calls as a named
record: an export on each rank returns that rank's own head slice, and
the import of it lands each rank's own slabs.

HTTP surface (the router speaks the same protocol as a single server,
so clients need no changes):

    POST /generate, /chat    routed + proxied (streaming NDJSON relays
                             line-by-line); the response carries
                             X-Replica-Id, and the replica's request
                             timeline records the routing decision
                             (X-Routed-By -> /debug/requests/<id>)
    GET  /healthz            aggregate: ok = any replica routable, plus
                             a ``replicas`` section (per-replica
                             health/occupancy/mesh snapshot)
    GET  /metrics            router gauges + per-replica labeled series
    GET  /debug/kv/fleet     FLEET CACHE VIEW (schema below)
    GET  /debug/trace        FLEET-MERGED Perfetto trace (schema below)
    GET  /debug/fleet        the health sentinel's fleet view: per-
                             replica health score in [0,1], verdict
                             (healthy/suspect/critical), per-signal
                             subscores + active anomalies, last canary
                             result, edge-triggered anomaly counters,
                             and the fleet verdict (worst replica) —
                             what the fleet controller consults
                             before killing or draining a replica
    GET  /debug/decisions    the router's decision audit log
                             (obs.DecisionLog): route decisions WITH
                             their candidate sets/scores/hit depths,
                             reroutes, handoff outcomes, canary
                             results, anomalies, verdict flips —
                             ?n=/?kind=/?request_id= filter; the
                             request_id filter joins a decision trail
                             to its request timeline
    GET  /debug/bundle       flight-recorder postmortem artifact:
                             router config + aggregate health + fleet
                             sentinel view + last-N decisions + log
                             tail + fleet-merged trace + (default)
                             every healthy replica's own bundle
                             (?replicas=0 / ?trace=0 to slim)

**Synthetic canary probes** (``canary_interval_s > 0``; manual
``run_canaries_now()`` otherwise): the router periodically POSTs a
tiny deterministic greedy probe (fixed token prompt/seed, the RESERVED
``"canary"`` priority class — replicas serve it but exclude it from
SLO attainment, goodput, latency histograms and the brownout ladder's
inputs) DIRECTLY to every replica, routable or not.  Each sweep
probes EVERY replica first and only then judges tokens against the
fleet ORACLE — the plurality token sequence among the sweep's
successful probes (same weights + greedy decode ⇒ replica-
independent, so healthy fleets are unanimous); a pinned oracle
RE-PINS when a strict majority later agrees on a different sequence
(counted ``canary_oracle_repins_total`` — a corrupt replica probed
first, or a legitimate fleet-wide output change), and
``reset_canary_oracle()`` is the operator hook for planned rollouts.
A probe disagreeing with the settled oracle is a counted token
MISMATCH — the wrong-output failure latency metrics cannot see.
Probe success/latency feeds the per-replica **health sentinel**
(:class:`HealthSentinel`): EWMA/z-score detectors over canary
latency, replica ITL EWMA, queue-wait p90, SLO attainment and scrape
staleness produce a [0,1] health score and a healthy/suspect/critical
verdict per replica, raising edge-triggered, counted, logged
``anomaly`` events into the decision log.  The sentinel never acts —
it is the trustworthy sensor the future autoscaler reads.
    GET  /debug/requests     index aggregated across ALL healthy
                             replicas, each entry tagged ``replica``
    GET  /debug/requests/<id>  resolved through the ROUTING RECORD
                             first (the bounded request-id -> replica
                             map the relay fills from each reply's
                             X-Request-Id), then healthy-replica
                             fan-out — never first-to-answer guessing
    GET  /debug/*            (everything else) tried against each
                             healthy replica until one answers non-404

Fleet-merged tracing (``GET /debug/trace[?window_s=S]``): ONE
Chrome/Perfetto ``trace_event`` document containing

  * the router's own span track (pid 0, process_name ``router``):
    ``route`` (decision; args replica/policy/request_id), ``forward``
    (relay wall time; timeout/client-disconnect flagged), ``reroute``
    (a failed replica's lossless re-route) and ``handoff``
    (cross-replica prefix-KV moves, args request_id/blocks) spans,
    recorded in a bounded ring under ``_lock``;
  * every healthy replica's own ``/debug/trace`` export re-tagged to
    pid ``1+index`` (process_name ``replica-<index>``) with its
    timestamps shifted into the router's frame via the ``t0_unix_s``
    wall-clock anchor each Observability ring publishes (clock-offset
    normalization — replica monotonic clocks share no epoch);
  * handoff linkage: the router's ``handoff`` span and both replicas'
    ``prefix_export`` / ``prefix_import`` instants carry the same
    external request id, so a prefill-on-A / decode-on-B session
    reads as one timeline across three tracks.

**Fleet cache view** (``GET /debug/kv/fleet[?depth=D]``): the
router-side aggregation of every healthy replica's chain digest
(``GET /debug/kv``, scraped on demand with probe-class timeouts —
never from the poller; the poller's ``/healthz`` scrape already
carries each replica's O(1) digest summary under ``kv.digest``)::

    {"fleet": {
       "prefix_hit_ratio": float,        # sum(hit tokens)/sum(prompt)
       "prefix_hit_tokens_total": int, "prompt_tokens_total": int,
       "duplicate_chains": int,          # chain keys HBM-resident on
                                         # >= 2 replicas
       "duplicate_kv_blocks": int,       # copies beyond the first
       "duplicate_kv_bytes": int,        # ... priced per replica's
                                         # block_bytes — the HBM a
                                         # cache-aware scheduler
                                         # reclaims
       "replicas_scraped": [int, ...],
       "truncated_replicas": [int, ...], # digests cut at the node cap
                                         # (duplicates = LOWER bound)
       "scrape_ms": float},
     "replicas": [{"replica": int, "summary": {<replica /debug/kv
                   summary>}, "hit_ratio": float,
                   "hbm_bytes": int}, ...]}

The computed aggregate is cached for ``/metrics``:
``llm_fleet_duplicate_kv_blocks`` / ``llm_fleet_duplicate_kv_bytes`` /
``llm_fleet_prefix_hit_ratio`` / ``llm_fleet_kv_age_s`` (samples
appear after the first fleet-view computation).  Per-replica labeled
cache gauges ride every scrape of the health poller:
``llm_router_replica_kv_{nodes,hbm_blocks,host_blocks,idle_blocks,
digest_version,hit_ratio}`` — qualified by
``llm_replica_health_age_s`` (seconds since that replica's labeled
values were last refreshed; -1 = never scraped; an unroutable
replica's gauges persist STALE, so dashboards gate on the age).
Digest freshness also feeds the affinity policy: an affinity hit onto
a replica whose digest ``loss_version`` changed since the session
pinned (evictions/demotions — or a rebuild, which resets versions)
still routes there, but as a counted, logged stale event
(``llm_router_affinity_stale_routes_total``; the pin refreshes to the
observed version so one loss event counts once) instead of a silent
cache miss.

**Elastic fleet** (:class:`FleetController`): the control loop that
scales, drains and rolls the fleet with no session dropped on any
planned event.  Three actuators, every action a ``kind="scale"`` /
``"drain"`` / ``"rollout"`` decision record carrying the signals that
drove it:

  * **autoscaler** (``tick()``; periodic when ``interval_s > 0``):
    pressure -- the worst interactive attainment below
    ``attainment_floor`` or the worst queue-wait p90 above
    ``queue_wait_high_ms`` -- must hold for ``dwell_s`` before a
    scale-up, calm (no pressure, occupancy at or below
    ``occupancy_low``) must hold for ``dwell_s`` before a scale-down,
    and every action starts a ``cooldown_s`` refractory window (the
    brownout ladder's hysteresis, fleet-sized).  A scale-down victim
    must carry a ``healthy`` sentinel verdict: a suspect or critical
    replica defers the action into a recorded ``deferred`` decision.
  * **live session migration** (``drain_replica(idx)``, also the
    operator entry): the victim stops admitting (the router-side
    ``retiring`` flag), in-flight requests finish, then every
    HBM-resident chain (``resident_chain_keys`` on the victim's loop)
    moves to a survivor through the export -> import -> residency-probe
    path the handoff scheduler uses (``_execute_migration``, demote
    suppressed: the source's copies die with it), and routing records
    and affinity pins re-point, so revisits continue token-identically
    on the destination.  A failed drain resumes the victim.
  * **zero-downtime rollout** (``rollout(factory)``): replica by
    replica, drain, swap in the factory's server (``swap_replica``),
    then the rung gate: ``reset_canary_oracle()`` + a full canary sweep,
    and the restarted replica's probe must be transport-clean and match
    the rollout oracle (pinned from the first rung's probe, or from
    ``expect_tokens``).  A failed gate rolls the rung back onto
    ``rollback_factory``'s server and aborts; after the last rung one
    more reset + sweep must be unanimously clean.

Fault sites ``scale_event`` (fired at each action start: an injected
fault aborts the whole action, fleet membership unchanged) and
``session_migrate`` (fired per migrating session: an injected fault
aborts that session's move only; the session keeps serving at the
source).  ``/metrics`` carries
``llm_fleet_scale_events_total{action=up|down|deferred|aborted}``,
``llm_sessions_migrated_total`` and ``llm_rollout_rung`` (-1 idle);
``GET /debug/fleet`` gains a ``controller`` section when a controller
is attached.  A grown replica on the card comes from the caller's
``replica_factory`` (run.py's ``make_replica``, which shares the one
weight copy), so it launches the same flash and paged kernels.

Thread discipline: handler threads (forward), the health poller, and
the handoff worker share the replica table, counters, routing record,
trace ring, the handoff scheduler's dedup/bounds state, and the
cached fleet cache view — every access goes under ``_lock``.  The
global radix index keeps its own leaf lock (lock order router ->
index, never inverted).  The fleet controller keeps its own leaf lock
over its counters and hysteresis state and never holds it while
calling into the router or a replica (compute under the lock, act
outside it).  The router holds no device state at all; it is pure host-side
HTTP — batcher work it schedules runs on the replicas' own
serving-loop threads via ``LLMServer.call_on_loop``."""

from __future__ import annotations

import http.client
import json
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

from .faults import FaultInjector, InjectedFault
from .kvcache import chain_keys
from .obs import DecisionLog, EwmaDetector, StructuredLogger
from .overload import CANARY

POLICIES = ("least-loaded", "affinity", "cache-aware")
ROLES = ("prefill", "decode")

# ---------------------------------------------------------------------------
# Router-side Prometheus registry
# ---------------------------------------------------------------------------

# FULL metric name -> (type, help).  The router renders its own text
# exposition (no obs.METRICS pipeline out here), so this registry is
# its HELP/TYPE source: every registered family is emitted somewhere
# in this module, and every emitted ``llm_router_*`` / ``llm_fleet_*`` /
# ``llm_replica_*`` family is registered.
ROUTER_METRICS: Dict[str, Tuple[str, str]] = {
    "llm_router_replicas": (
        "gauge", "Replicas behind this router"),
    "llm_router_replicas_healthy": (
        "gauge", "Replicas currently routable"),
    "llm_router_routed_requests_total": (
        "counter", "Requests routed, by decision policy"),
    "llm_router_reroutes_total": (
        "counter", "Requests re-routed off a failed replica"),
    "llm_router_replica_failures_total": (
        "counter", "Forward-time replica failures observed"),
    "llm_router_kv_handoffs_total": (
        "counter", "Cross-replica prefix-KV handoffs brokered"),
    "llm_router_affinity_sessions": (
        "gauge", "Sticky sessions currently pinned"),
    "llm_router_affinity_stale_routes_total": (
        "counter",
        "Affinity routes taken onto a replica whose chain digest "
        "changed since the session pinned (possible cache miss — "
        "counted, no longer silent)"),
    "llm_router_cache_index_nodes": (
        "gauge", "Chain-prefix keys in the router's global radix "
                 "index, summed over replicas"),
    "llm_router_cache_index_replicas_synced": (
        "gauge", "Replicas whose chain digest has been folded into "
                 "the global index"),
    "llm_router_cache_index_syncs_total": (
        "counter", "Digest syncs applied to the global index "
                   "(incremental + full)"),
    "llm_router_cache_index_resyncs_total": (
        "counter", "Full node-walk resyncs (journal could not prove "
                   "completeness — rebuilds, or a poller too far "
                   "behind)"),
    "llm_router_cache_index_events_applied_total": (
        "counter", "Journaled digest events applied incrementally"),
    "llm_router_cache_stale_routes_total": (
        "counter",
        "Cache-aware routes taken onto a holder whose live digest "
        "version moved past the index's synced one (possible cold "
        "prefill — counted, never wrong tokens)"),
    "llm_router_cache_hit_depth_blocks_total": (
        "counter", "Cumulative matched prefix depth (blocks) over "
                   "cache-aware routed requests"),
    "llm_router_handoffs_scheduled_total": (
        "counter", "Chain migrations admitted into the handoff queue"),
    "llm_router_handoffs_completed_total": (
        "counter", "Chain migrations that landed blocks on the "
                   "destination"),
    "llm_router_handoffs_aborted_total": (
        "counter", "Chain migrations that failed or timed out "
                   "(unwound cleanly; chain re-eligible)"),
    "llm_router_handoffs_skipped_total": (
        "counter", "Chain migrations refused at admission "
                   "(bytes-in-flight bound, or an out-of-process "
                   "replica)"),
    "llm_router_handoff_bytes_inflight": (
        "gauge", "Estimated slab bytes currently moving between "
                 "replicas"),
    "llm_router_handoff_bytes_total": (
        "counter", "Slab bytes landed on destinations by completed "
                   "handoffs"),
    # -- fleet cache aggregate (last GET /debug/kv/fleet computation) --
    "llm_fleet_duplicate_kv_blocks": (
        "gauge", "HBM blocks holding chain prefixes duplicated on "
                 ">= 2 replicas (copies beyond the first; last "
                 "fleet-view computation)"),
    "llm_fleet_duplicate_kv_bytes": (
        "gauge", "HBM bytes behind the duplicate chain blocks — the "
                 "disaggregation scheduler's reclaimable redundancy"),
    "llm_fleet_prefix_hit_ratio": (
        "gauge", "Fleet-wide fraction of admitted prompt tokens "
                 "served from cached prefix blocks (last fleet-view "
                 "computation)"),
    "llm_fleet_kv_age_s": (
        "gauge", "Seconds since the fleet cache view was last "
                 "computed"),
    # -- control-plane observability (decision log, canaries, sentinel) --
    "llm_router_decisions_total": (
        "counter", "Control-plane decisions recorded in the router "
                   "audit log, by kind (GET /debug/decisions)"),
    "llm_router_canary_probes_total": (
        "counter", "Synthetic canary probes sent (reserved canary "
                   "request class; every replica, routable or not)"),
    "llm_router_canary_failures_total": (
        "counter", "Canary probes that failed (connect error, "
                   "non-200, timeout)"),
    "llm_router_canary_mismatches_total": (
        "counter", "Canary probes whose greedy tokens disagreed with "
                   "the fleet oracle (the wrong-output detector)"),
    "llm_router_canary_oracle_repins_total": (
        "counter", "Canary oracle re-pins: a strict majority of a "
                   "sweep's successful probes agreed on a DIFFERENT "
                   "token sequence than the pinned oracle (the pin "
                   "was wrong, or the fleet's output legitimately "
                   "changed)"),
    "llm_router_anomalies_total": (
        "counter", "Health-sentinel anomaly events by signal "
                   "(edge-triggered: one event per healthy -> "
                   "anomalous transition per replica)"),
    # -- elastic fleet controller (FleetController; zeros until one
    #    is attached — families always exposed for discovery) --------
    "llm_fleet_scale_events_total": (
        "counter", "Fleet controller scale actions by outcome "
                   "(up / down / deferred / aborted; every one is a "
                   "kind=scale decision record with its signals)"),
    "llm_sessions_migrated_total": (
        "counter", "Live sessions moved to a survivor by drain "
                   "migration (export -> import -> residency-gated "
                   "demote; zero dropped by contract)"),
    "llm_rollout_rung": (
        "gauge", "Replica index the in-progress rollout is restarting "
                 "(-1 = no rollout in progress)"),
    "llm_router_fleet_verdict": (
        "gauge", "Worst replica health verdict (0 healthy / 1 "
                 "suspect / 2 critical) — the GET /debug/fleet "
                 "verdict an autoscaler consumes"),
    # -- per-replica labeled gauges (qualified by health age) ----------
    "llm_router_replica_healthy": (
        "gauge", "Replica routable (per replica)"),
    "llm_router_replica_inflight": (
        "gauge", "Router-tracked in-flight requests (per replica)"),
    "llm_router_replica_routed_total": (
        "counter", "Requests routed to this replica"),
    "llm_router_replica_active_slots": (
        "gauge", "Replica batcher slots holding a live request (last "
                 "health scrape)"),
    "llm_router_replica_mesh_devices": (
        "gauge", "Devices in the replica's serving mesh (last health "
                 "scrape)"),
    "llm_replica_health_age_s": (
        "gauge", "Seconds since this replica's labeled gauges were "
                 "last refreshed from a successful /healthz scrape "
                 "(-1 = never scraped; stale values persist for "
                 "unroutable replicas — gate on this)"),
    "llm_router_replica_kv_nodes": (
        "gauge", "Chain-digest nodes (keyed blocks) on this replica "
                 "(last health scrape)"),
    "llm_router_replica_kv_hbm_blocks": (
        "gauge", "HBM-resident chain blocks on this replica (last "
                 "health scrape)"),
    "llm_router_replica_kv_host_blocks": (
        "gauge", "Host-tier-resident chain blocks on this replica "
                 "(last health scrape)"),
    "llm_router_replica_kv_idle_blocks": (
        "gauge", "Idle (refcount-0, evictable) chain blocks on this "
                 "replica (last health scrape)"),
    "llm_router_replica_kv_digest_version": (
        "gauge", "Chain-digest content version on this replica (last "
                 "health scrape)"),
    "llm_router_replica_kv_hit_ratio": (
        "gauge", "Replica fraction of admitted prompt tokens served "
                 "from cached prefix blocks (last health scrape)"),
    "llm_router_replica_health_score": (
        "gauge", "Sentinel health score in [0, 1] (per replica: "
                 "blends canary success, canary-latency / ITL / "
                 "queue-wait z-scores, SLO attainment, and scrape "
                 "staleness)"),
    "llm_router_replica_verdict": (
        "gauge", "Sentinel verdict per replica (0 healthy / 1 "
                 "suspect / 2 critical)"),
    "llm_router_replica_canary_latency_ms": (
        "gauge", "Last canary probe round-trip latency (per replica; "
                 "-1 = never probed)"),
    "llm_router_replica_canary_ok": (
        "gauge", "Last canary probe outcome (1 ok / 0 failed or "
                 "mismatched / -1 never probed)"),
}

# ``chain_keys`` (JAX :485) is ``kvcache.chain_keys``, re-exported: the
# router, the batcher's radix index and the digest journal share the
# one implementation.


class RouterRadixIndex:
    """The router-side GLOBAL radix index: every replica's published
    chain digest folded into one map ``chain-prefix key -> {replica:
    (depth, tier)}``, so the cache-aware policy can route each request
    to the replica holding the DEEPEST matching prefix fleet-wide.

    Kept fresh INCREMENTALLY off the health poller: each successful
    ``/healthz`` scrape carries the replica's O(1) digest summary;
    when its ``version`` differs from the index's last synced version
    the poller fetches ``GET /debug/kv?since=<synced>`` and applies
    the journaled events (``publish``/``remove``/``demote``/
    ``restore`` — ``host_evict`` is a counter-only bump), falling back
    to a full node-walk replace when the bounded journal cannot prove
    completeness (consumer too far behind, or a crash-recovery rebuild
    reset the digest).  O(changes) per poll, not O(nodes).

    Thread discipline: own leaf ``_lock`` — the health poller writes, handler threads
    read at pick time, the handoff worker applies optimistic updates.
    The router's ``_lock`` may be held while calling in (lock order
    router -> index, never inverted: sync paths take only this
    lock)."""

    def __init__(self):
        self._lock = threading.Lock()
        # replica -> {key_hex: (depth, tier)}
        self._by_replica: Dict[int, Dict[str, Tuple[int, str]]] = {}
        # replica -> last applied digest version
        self._synced: Dict[int, int] = {}
        # replica -> digest epoch the synced version belongs to: a
        # rebuild resets versions AND mints a new epoch, so version
        # arithmetic across epochs is meaningless (a replay can
        # re-advance past the synced version — version aliasing) and
        # the consumer must full-resync on any epoch change.
        self._epoch: Dict[int, Any] = {}
        # replica -> block_bytes (handoff byte-budget pricing)
        self._block_bytes: Dict[int, int] = {}
        self.syncs_total = 0
        self.resyncs_total = 0
        self.events_applied_total = 0

    def synced_version(self, replica: int) -> Optional[int]:
        with self._lock:
            return self._synced.get(replica)

    def synced_epoch(self, replica: int) -> Optional[Any]:
        with self._lock:
            return self._epoch.get(replica)

    def block_bytes(self, replica: int) -> int:
        with self._lock:
            return self._block_bytes.get(replica, 0)

    def replace(self, replica: int, nodes: Sequence[Dict[str, Any]],
                version: int, block_bytes: int = 0,
                epoch: Any = None) -> None:
        """Full resync: adopt a replica's complete node walk."""
        table = {
            str(n["key"]): (int(n.get("depth", 0)),
                            str(n.get("tier", "hbm")))
            for n in nodes if isinstance(n, dict) and n.get("key")
        }
        with self._lock:
            self._by_replica[replica] = table
            self._synced[replica] = int(version)
            if epoch is not None:
                self._epoch[replica] = epoch
            if block_bytes:
                self._block_bytes[replica] = int(block_bytes)
            self.syncs_total += 1
            self.resyncs_total += 1

    def apply_events(self, replica: int,
                     events: Sequence[Dict[str, Any]],
                     version: int, block_bytes: int = 0,
                     epoch: Any = None) -> None:
        """Incremental sync: apply journaled digest mutations in
        order (idempotent per event — optimistic handoff updates may
        have pre-applied some)."""
        with self._lock:
            table = self._by_replica.setdefault(replica, {})
            for ev in events:
                op = ev.get("op")
                key = str(ev.get("key"))
                if op == "publish":
                    table[key] = (int(ev.get("depth", 0)), "hbm")
                elif op == "remove":
                    table.pop(key, None)
                elif op in ("demote", "restore"):
                    ent = table.get(key)
                    depth = (
                        ent[0] if ent is not None
                        else int(ev.get("depth", 0))
                    )
                    table[key] = (
                        depth, "host" if op == "demote" else "hbm"
                    )
                # host_evict: counter-only (removal journals itself)
            self._synced[replica] = int(version)
            if epoch is not None:
                self._epoch[replica] = epoch
            if block_bytes:
                self._block_bytes[replica] = int(block_bytes)
            self.syncs_total += 1
            self.events_applied_total += len(events)

    def note_handoff(self, src: int, dst: int,
                     keys_hex: Sequence[str]) -> None:
        """Optimistic post-handoff update so the NEXT request routes
        to the chain's new home immediately (the poller's sync
        confirms/corrects at the next scrape): the destination gains
        the chain HBM-resident, the demoted-after-export source drops
        to host tier."""
        with self._lock:
            dmap = self._by_replica.setdefault(dst, {})
            smap = self._by_replica.setdefault(src, {})
            for i, k in enumerate(keys_hex):
                ent = smap.get(k)
                depth = ent[0] if ent is not None else i + 1
                dmap[k] = (depth, "hbm")
                if ent is not None:
                    smap[k] = (depth, "host")

    def lookup(
        self, keys_hex: Sequence[str], replicas: Set[int],
    ) -> Optional[Tuple[int, List[Tuple[int, str]]]]:
        """Deepest fleet-wide prefix match: walk the chain keys from
        the leaf back toward the root; the first key held by any of
        ``replicas`` wins.  Returns ``(depth, [(replica, tier),...])``
        — depth in blocks (1-based), holders of that deepest key —
        or None on a fleet-wide miss."""
        with self._lock:
            for i in range(len(keys_hex) - 1, -1, -1):
                k = keys_hex[i]
                holders = [
                    (r, self._by_replica[r][k][1])
                    for r in replicas
                    if k in self._by_replica.get(r, {})
                ]
                if holders:
                    return i + 1, holders
        return None

    def drop_replica(self, replica: int) -> None:
        """Forget everything synced from ``replica`` (retirement or a
        rollout swap): its table, synced version, epoch and block
        pricing — the swapped-in instance starts from a full resync,
        and a retired one stops contributing phantom holders to
        lookups."""
        with self._lock:
            self._by_replica.pop(replica, None)
            self._synced.pop(replica, None)
            self._epoch.pop(replica, None)
            self._block_bytes.pop(replica, None)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "nodes": sum(
                    len(t) for t in self._by_replica.values()
                ),
                "replicas_synced": len(self._synced),
                "syncs_total": self.syncs_total,
                "resyncs_total": self.resyncs_total,
                "events_applied_total": self.events_applied_total,
            }


# ---------------------------------------------------------------------------
# Per-replica health score + anomaly sentinel
# ---------------------------------------------------------------------------

# Sentinel signals, each contributing one [0, 1] subscore per replica:
#   canary      EWMA of canary probe success; a token MISMATCH pins 0
#   latency     canary round-trip latency z-score vs its own baseline
#   itl         replica inter-token-latency EWMA z-score (healthz)
#   queue_wait  replica queue-wait p90 z-score (healthz overload)
#   attainment  smoothed interactive SLO attainment (healthz overload)
#   staleness   age of the last successful health scrape
SENTINEL_SIGNALS = (
    "canary", "latency", "itl", "queue_wait", "attainment", "staleness",
)

VERDICTS = ("healthy", "suspect", "critical")
VERDICT_INDEX = {v: i for i, v in enumerate(VERDICTS)}


class _SentinelState:
    """One replica's sentinel state (mutated under the sentinel lock)."""

    __slots__ = (
        "sub", "anomalous", "latency", "itl", "queue_wait",
        "canary_ok_ewma", "score", "verdict", "last_canary",
    )

    def __init__(self, alpha: float, min_samples: int,
                 floor_ms: float):
        self.sub: Dict[str, float] = {s: 1.0 for s in SENTINEL_SIGNALS}
        self.anomalous: Dict[str, bool] = {
            s: False for s in SENTINEL_SIGNALS
        }
        # All three z-scored signals are MILLISECOND latencies: the
        # absolute divisor floor (floor_ms) keeps a sub-ms-baseline
        # replica's harmless single-digit-ms blip from scoring as a
        # 500-sigma anomaly.
        self.latency = EwmaDetector(
            alpha=alpha, min_samples=min_samples, floor=floor_ms
        )
        self.itl = EwmaDetector(
            alpha=alpha, min_samples=min_samples, floor=floor_ms
        )
        self.queue_wait = EwmaDetector(
            alpha=alpha, min_samples=min_samples, floor=floor_ms
        )
        self.canary_ok_ewma = 1.0
        self.score = 1.0
        self.verdict = "healthy"
        self.last_canary: Optional[Dict[str, Any]] = None


class HealthSentinel:
    """Per-replica health score + anomaly detector (module docstring).

    Pure host bookkeeping over the signals the router already has —
    canary probe results (success, token match, latency) and /healthz
    scrape values (ITL EWMA, queue-wait p90, interactive attainment,
    scrape age).  Each signal keeps a [0, 1] subscore (z-scored
    signals via :class:`~.obs.EwmaDetector` against the
    replica's OWN baseline, so a uniformly slow fleet is not five
    anomalies); the replica's health score blends them MIN-biased
    (``0.5 * min + 0.5 * mean`` — one collapsed signal must drag the
    score even while five others read 1.0) and maps to a verdict:
    ``healthy`` / ``suspect`` / ``critical``.

    Anomaly events are EDGE-triggered per (replica, signal): one
    counted event on the healthy -> anomalous transition (plus a
    cleared event on recovery), never one per poll — the counters
    count incidents, not samples.  The sentinel never ACTS: it is the
    trustworthy sensor layer the fleet controller
    (:class:`FleetController`) reads via ``GET /debug/fleet`` before it
    is allowed to kill or drain a replica; routing keeps its own
    health/quarantine rules.

    Thread discipline: observe_* are called by the canary prober and
    the health poller while handler threads read fleet_json — every
    access goes under the sentinel's own leaf lock (never held while
    calling out)."""

    def __init__(
        self,
        z_threshold: float = 3.0,
        alpha: float = 0.2,
        min_samples: int = 5,
        suspect_below: float = 0.8,
        critical_below: float = 0.5,
        attainment_floor: float = 0.75,
        staleness_allowance_s: float = 10.0,
        z_floor_ms: float = 5.0,
    ):
        self.z_threshold = float(z_threshold)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        # Absolute z-divisor floor for the ms-scale signals (canary
        # latency / ITL / queue wait): deviations under ~z_threshold x
        # this never flag, however tight the healthy baseline was.
        self.z_floor_ms = float(z_floor_ms)
        self.suspect_below = float(suspect_below)
        self.critical_below = float(critical_below)
        self.staleness_allowance_s = float(staleness_allowance_s)
        # Per-signal anomaly bars on the subscore: canary needs a few
        # consecutive successes to clear (EWMA alpha 0.5 -> ~3 probes
        # back above 0.9); attainment uses the SLO-ish floor.
        self._bars: Dict[str, float] = {
            "canary": 0.9, "latency": 0.5, "itl": 0.5,
            "queue_wait": 0.5, "attainment": float(attainment_floor),
            "staleness": 0.5,
        }
        self._lock = threading.Lock()
        self._states: Dict[int, _SentinelState] = {}
        self.anomalies_total: Dict[str, int] = {
            s: 0 for s in SENTINEL_SIGNALS
        }

    # audit: locked(every caller holds self._lock)
    def _state_locked(self, replica: int) -> _SentinelState:
        st = self._states.get(replica)
        if st is None:
            st = self._states[replica] = _SentinelState(
                self.alpha, self.min_samples, self.z_floor_ms
            )
        return st

    def _z_subscore(self, z: Optional[float]) -> float:
        """[0, 1] subscore from a one-sided z-score: 1.0 inside the
        threshold (or during warmup — no baseline, no verdict),
        decaying linearly to 0 at twice the threshold.  Only HIGH
        values are anomalous for every z-scored signal here (latency /
        ITL / queue wait dropping is good news)."""
        if z is None or z <= self.z_threshold:
            return 1.0
        return max(
            0.0, 1.0 - (z - self.z_threshold) / self.z_threshold
        )

    # audit: locked(every caller holds self._lock)
    def _signal_locked(
        self, st: _SentinelState, signal: str, sub: float,
        events: List[Dict[str, Any]], **fields,
    ) -> None:
        st.sub[signal] = round(max(0.0, min(1.0, float(sub))), 4)
        bad = st.sub[signal] < self._bars[signal]
        if bad and not st.anomalous[signal]:
            st.anomalous[signal] = True
            self.anomalies_total[signal] += 1
            events.append(dict(
                {"kind": "anomaly", "signal": signal,
                 "subscore": st.sub[signal]},
                **{k: v for k, v in fields.items() if v is not None},
            ))
        elif st.anomalous[signal] and not bad:
            st.anomalous[signal] = False
            events.append({
                "kind": "anomaly_cleared", "signal": signal,
                "subscore": st.sub[signal],
            })

    # audit: locked(every caller holds self._lock)
    def _rescore_locked(
        self, st: _SentinelState,
    ) -> List[Dict[str, Any]]:
        vals = list(st.sub.values())
        st.score = round(
            0.5 * min(vals) + 0.5 * (sum(vals) / len(vals)), 4
        )
        v = (
            "critical" if st.score < self.critical_below
            else "suspect" if st.score < self.suspect_below
            else "healthy"
        )
        if v == st.verdict:
            return []
        prev, st.verdict = st.verdict, v
        return [{
            "kind": "verdict", "verdict": v, "previous": prev,
            "score": st.score,
        }]

    def observe_canary(
        self, replica: int, ok: bool,
        latency_ms: Optional[float] = None, mismatch: bool = False,
        error: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """Feed one canary probe result; returns the emitted events
        (anomaly / anomaly_cleared / verdict) for the caller to log,
        count and record into its decision log."""
        events: List[Dict[str, Any]] = []
        with self._lock:
            st = self._state_locked(replica)
            st.last_canary = {
                "ok": bool(ok), "mismatch": bool(mismatch),
                "latency_ms": (
                    round(float(latency_ms), 3)
                    if latency_ms is not None else None
                ),
                "error": error,
                "unix_s": round(time.time(), 3),
            }
            st.canary_ok_ewma = (
                0.5 * st.canary_ok_ewma + 0.5 * (1.0 if ok else 0.0)
            )
            sub = 0.0 if mismatch else st.canary_ok_ewma
            self._signal_locked(
                st, "canary", sub, events,
                mismatch=mismatch or None, error=error,
            )
            if ok and latency_ms is not None:
                z = st.latency.update(float(latency_ms))
                self._signal_locked(
                    st, "latency", self._z_subscore(z), events,
                    z=round(z, 3) if z is not None else None,
                    latency_ms=round(float(latency_ms), 3),
                )
            events.extend(self._rescore_locked(st))
        return events

    def observe_health(
        self, replica: int, reachable: bool,
        attainment: Optional[float] = None,
        queue_wait_ms: Optional[float] = None,
        itl_ms: Optional[float] = None,
        age_s: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Feed one /healthz scrape (or scrape failure): attainment /
        queue-wait p90 / ITL EWMA from the payload, ``age_s`` = time
        since the last SUCCESSFUL scrape (0 on success; grows while a
        replica stays unreachable — the digest/telemetry staleness
        signal)."""
        events: List[Dict[str, Any]] = []
        with self._lock:
            st = self._state_locked(replica)
            if age_s is not None:
                allow = self.staleness_allowance_s
                sub = (
                    1.0 if age_s <= allow
                    else max(0.0, 1.0 - (age_s - allow) / (3.0 * allow))
                )
                self._signal_locked(
                    st, "staleness", sub, events,
                    age_s=round(age_s, 3), reachable=reachable,
                )
            if reachable:
                if attainment is not None:
                    a = self.alpha
                    sub = (
                        (1.0 - a) * st.sub["attainment"]
                        + a * float(attainment)
                    )
                    self._signal_locked(
                        st, "attainment", sub, events,
                        attainment=round(float(attainment), 4),
                    )
                if queue_wait_ms is not None:
                    z = st.queue_wait.update(float(queue_wait_ms))
                    self._signal_locked(
                        st, "queue_wait", self._z_subscore(z), events,
                        z=round(z, 3) if z is not None else None,
                        queue_wait_ms=round(float(queue_wait_ms), 3),
                    )
                if itl_ms is not None:
                    z = st.itl.update(float(itl_ms))
                    self._signal_locked(
                        st, "itl", self._z_subscore(z), events,
                        z=round(z, 3) if z is not None else None,
                        itl_ms=round(float(itl_ms), 3),
                    )
            events.extend(self._rescore_locked(st))
        return events

    def forget(self, replica: int) -> None:
        """Drop a replica's sentinel state (retirement, or a rollout
        swapping a fresh instance into its slot): the new occupant
        starts from clean baselines — inheriting the predecessor's
        EWMA latency baselines would z-flag a legitimately different
        instance, and inheriting its anomalies would block the
        autoscaler's sentinel gate on ghosts.  The edge-triggered
        anomaly counters keep their history (incidents happened)."""
        with self._lock:
            self._states.pop(replica, None)

    def score(self, replica: int) -> float:
        with self._lock:
            st = self._states.get(replica)
            return st.score if st is not None else 1.0

    def verdict(self, replica: int) -> str:
        with self._lock:
            st = self._states.get(replica)
            return st.verdict if st is not None else "healthy"

    def fleet_json(self) -> Dict[str, Any]:
        """Per-replica scores/verdicts/signals + the fleet verdict
        (worst replica) — the core of ``GET /debug/fleet``."""
        with self._lock:
            replicas = {
                i: {
                    "score": st.score,
                    "verdict": st.verdict,
                    "signals": dict(st.sub),
                    "anomalous": sorted(
                        s for s, bad in st.anomalous.items() if bad
                    ),
                    "last_canary": (
                        dict(st.last_canary)
                        if st.last_canary is not None else None
                    ),
                }
                for i, st in self._states.items()
            }
            worst = max(
                (VERDICT_INDEX[st.verdict]
                 for st in self._states.values()),
                default=0,
            )
            anomalies = dict(self.anomalies_total)
        return {
            "verdict": VERDICTS[worst],
            "verdict_index": worst,
            "replicas": replicas,
            "anomalies_total": anomalies,
        }


class _ClientDisconnect(Exception):
    """The CLIENT's socket died while relaying — the replica is fine.
    Distinct from replica-side OSErrors so a disconnecting client never
    marks a healthy replica unhealthy; ``relayed`` records whether any
    bytes reached the client before the drop."""

    def __init__(self, relayed: bool):
        super().__init__("client disconnected")
        self.relayed = relayed

# Hop-by-hop / recomputed headers never relayed from a replica reply.
_SKIP_HEADERS = frozenset({
    "connection", "transfer-encoding", "content-length", "server",
    "date",
})

# Prompt-prefix length (tokens or characters) the affinity key hashes:
# long enough to separate sessions with a shared system prompt short
# of one block, short enough that appending turns to a chat keeps the
# key (and therefore the replica holding the chain) stable.
_AFFINITY_PREFIX = 64


@dataclass
class _Replica:
    """Router-side view of one serving replica."""

    index: int
    host: str
    port: int
    server: Any = None            # in-process LLMServer (caller-owned)
    healthy: bool = True
    inflight: int = 0
    routed_total: int = 0
    failures_total: int = 0
    last_health: Dict[str, Any] = field(default_factory=dict)
    # Monotonic instant of the last SUCCESSFUL health scrape (0.0 =
    # never scraped).  A replica that goes unroutable keeps its last
    # scraped values in ``last_health`` — the per-replica labeled
    # /metrics gauges would silently serve stale numbers, so the
    # exposition emits ``llm_replica_health_age_s`` alongside them and
    # dashboards gate on it.
    last_health_t: float = 0.0
    # Elastic-fleet lifecycle (FleetController).  ``retiring``: drain
    # in progress — excluded from every routing pick but still alive
    # (scraped, canaried, /healthz ok) so its serving loop can run the
    # session-migration exports; cleared by resume or retirement.
    # ``retired``: permanently out of the fleet — never picked,
    # scraped or canaried again.  Retired entries KEEP their list slot
    # (``self._replicas[i].index == i`` is a structural invariant the
    # handoff scheduler and the labeled /metrics series rely on); new
    # replicas only ever append.
    retiring: bool = False
    retired: bool = False

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def kv_digest(self) -> Dict[str, Any]:
        """The chain-digest summary of the last health scrape (empty
        dict before the first scrape / from pre-digest replicas)."""
        return (self.last_health.get("kv") or {}).get("digest") or {}

    def snapshot(self) -> Dict[str, Any]:
        h = self.last_health
        return {
            "index": self.index,
            "address": self.address,
            "healthy": self.healthy,
            "inflight": self.inflight,
            "routed_total": self.routed_total,
            "failures_total": self.failures_total,
            "retiring": self.retiring,
            "retired": self.retired,
            "draining": h.get("draining"),
            "degraded": h.get("degraded"),
            "overload_state": (h.get("overload") or {}).get("state"),
            "replica": h.get("replica"),
            "health_age_s": (
                round(time.monotonic() - self.last_health_t, 3)
                if self.last_health_t > 0 else None
            ),
            "kv": h.get("kv"),
        }


def _parse_address(addr: str) -> Tuple[str, int]:
    """Accepts ``host:port`` or ``http://host:port`` (LLMServer's own
    ``.address`` spelling)."""
    if addr.startswith("http://"):
        addr = addr[len("http://"):]
    addr = addr.rstrip("/")
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class ReplicaRouter:
    """HTTP front-end routing requests across serving replicas
    (module docstring).  ``replicas`` mixes in-process ``LLMServer``
    instances (must already be started; their lifecycle stays with the
    caller) and ``"host:port"`` strings for out-of-process ones."""

    def __init__(
        self,
        replicas: Sequence[Any],
        host: str = "127.0.0.1",
        port: int = 0,
        policy: str = "least-loaded",
        health_interval_s: float = 0.5,  # <= 0: manual (tests) —
        #                                  check_health_now() only
        proxy_timeout_s: float = 300.0,
        affinity_max_sessions: int = 4096,
        fault_injector: Optional[FaultInjector] = None,
        logger: Optional[StructuredLogger] = None,
        # -- cache-aware routing (policy="cache-aware") -----------------
        tokenizer: Any = None,
        block_size: Optional[int] = None,
        chat_format: Any = None,
        roles: Optional[Sequence[str]] = None,
        spill_occupancy: float = 1.0,
        # -- handoff scheduler ------------------------------------------
        handoff_threshold: float = 1.0,
        handoff_min_depth: int = 1,
        handoff_max_bytes: int = 256 << 20,
        handoff_max_bytes_inflight: int = 64 << 20,
        handoff_timeout_s: float = 30.0,
        demote_after_export: bool = True,
        # -- control-plane observability --------------------------------
        canary_interval_s: float = 0.0,  # <= 0: manual (tests) —
        #                                  run_canaries_now() only
        canary_prompt: Optional[Sequence[int]] = None,
        canary_max_new: int = 4,
        canary_timeout_s: float = 10.0,
        sentinel: Optional[HealthSentinel] = None,
        decision_ring: int = 1024,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown route policy {policy!r}; have {POLICIES}"
            )
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if roles is not None:
            roles = tuple(str(r) for r in roles)
            if len(roles) != len(replicas):
                raise ValueError(
                    f"roles ({len(roles)}) must name every replica "
                    f"({len(replicas)})"
                )
            bad = sorted(set(roles) - set(ROLES))
            if bad:
                raise ValueError(
                    f"unknown replica roles {bad}; have {ROLES}"
                )
            if not ("prefill" in roles and "decode" in roles):
                raise ValueError(
                    "prefill/decode disaggregation needs at least one "
                    "replica of EACH role"
                )
            if policy != "cache-aware":
                raise ValueError(
                    "replica roles require the cache-aware policy "
                    "(the disaggregation scheduler routes off the "
                    "global radix index)"
                )
        if policy == "cache-aware" and block_size is None:
            raise ValueError(
                "cache-aware routing needs block_size (the chain-key "
                "granularity every replica's radix index uses)"
            )
        self.policy = policy
        self.fault_injector = fault_injector
        # No logger supplied -> a QUIET one (ring only): stdout stays
        # silent but the /debug/bundle flight-recorder log tail still
        # records every router lifecycle line.
        self.logger = (
            logger if logger is not None
            else StructuredLogger(quiet=True)
        )
        self.health_interval_s = float(health_interval_s)
        self.proxy_timeout_s = float(proxy_timeout_s)
        self.affinity_max_sessions = int(affinity_max_sessions)
        # Cache-aware routing + handoff scheduling knobs (ctor-stable).
        self.tokenizer = tokenizer
        self.block_size = block_size
        self.chat_format = chat_format
        self.roles = roles
        self.spill_occupancy = float(spill_occupancy)
        self.handoff_threshold = float(handoff_threshold)
        self.handoff_min_depth = int(handoff_min_depth)
        self.handoff_max_bytes = int(handoff_max_bytes)
        self.handoff_max_bytes_inflight = int(handoff_max_bytes_inflight)
        self.handoff_timeout_s = float(handoff_timeout_s)
        self.demote_after_export = bool(demote_after_export)
        self.index = RouterRadixIndex()
        # Control-plane observability: the decision audit log (own
        # leaf lock; GET /debug/decisions), the per-replica health
        # sentinel (own leaf lock; GET /debug/fleet), and the
        # synthetic canary prober's knobs/counters (counters under
        # self._lock below).
        self.decisions = DecisionLog(ring=decision_ring)
        self.sentinel = (
            sentinel if sentinel is not None else HealthSentinel()
        )
        # Elastic-fleet controller (attach_controller): written once
        # at attach time before any scale action runs; /debug/fleet
        # and /metrics read it to render the controller section.
        self.controller: Optional["FleetController"] = None
        self.canary_interval_s = float(canary_interval_s)
        self.canary_prompt = [
            int(t) for t in (canary_prompt or (1, 2, 3))
        ]
        self.canary_max_new = int(canary_max_new)
        self.canary_timeout_s = float(canary_timeout_s)
        self._lock = threading.Lock()
        self._replicas: List[_Replica] = []
        for i, rep in enumerate(replicas):
            if isinstance(rep, str):
                h, p = _parse_address(rep)
                self._replicas.append(_Replica(index=i, host=h, port=p))
            else:  # in-process LLMServer
                h, p = _parse_address(rep.address)
                self._replicas.append(
                    _Replica(index=i, host=h, port=p, server=rep)
                )
        # Sticky-session map: affinity key -> [replica index, the
        # replica's chain-digest loss_version at pin time] (bounded
        # LRU — hits refresh recency, so long-lived active sessions
        # are not the eviction victims; a dead replica's entries
        # re-pin on next use).  The loss_version is the digest-
        # freshness check: a later hit whose replica has since evicted
        # or demoted chains (loss_version changed) is routed anyway —
        # affinity is a locality HINT, not a correctness contract —
        # but as a COUNTED, logged stale-route event instead of a
        # silent cache miss (affinity_stale_routes_total; the entry
        # re-pins at the observed version so one loss event counts
        # once, not on every subsequent turn).
        self._affinity: "OrderedDict[bytes, List[Any]]" = OrderedDict()
        self.routed_by_policy: Dict[str, int] = {
            "least-loaded": 0, "affinity": 0, "reroute": 0,
            "cache-aware": 0, "spill": 0, "prefill-role": 0,
        }
        self.reroutes_total = 0
        self.replica_failures_total = 0
        self.kv_handoffs_total = 0
        self.affinity_stale_routes_total = 0
        # Canary prober state: the oracle is the FIRST successful
        # probe's greedy tokens — every replica serves the same
        # weights, and greedy decode is replica-independent (mesh
        # parity pins tokens exact), so later disagreement means a
        # replica is producing WRONG OUTPUT, the failure no latency
        # metric can see.
        self.canary_probes_total = 0
        self.canary_failures_total = 0
        self.canary_mismatches_total = 0
        self.canary_oracle_repins_total = 0
        self._canary_oracle: Optional[List[int]] = None
        self._canary_seq = 0
        # Cache-aware routing counters: stale = the index said HIT but
        # the holder's live digest version moved past the synced one
        # (eviction / rebuild mid-flight) — routed anyway, counted,
        # degrades to a cold prefill, never to wrong tokens.
        self.cache_stale_routes_total = 0
        self.cache_hit_depth_blocks_total = 0
        # Handoff scheduler state: per-chain in-flight dedup (at most
        # ONE in-flight handoff per chain), bytes-in-flight bound, and
        # the outcome ledger.  The job queue itself is a thread-safe
        # queue drained by the router-handoff worker.
        self._handoff_chains: Set[str] = set()
        self._handoff_bytes_inflight = 0
        # Role-handoff intents registered at route time, cleared once
        # _maybe_role_handoff ran (or the attempt failed) — lets
        # wait_handoffs() see a migration that a just-completed reply
        # is about to schedule.
        self._role_handoffs_pending = 0
        self.handoffs_scheduled_total = 0
        self.handoffs_completed_total = 0
        self.handoffs_aborted_total = 0
        self.handoffs_skipped_total = 0
        self.handoffs_empty_total = 0
        self.handoff_blocks_total = 0
        self.handoff_bytes_total = 0
        self._handoff_q: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        # Last computed fleet cache view (fleet_kv_json fills it; the
        # /metrics fleet gauges read it) — None until the first
        # GET /debug/kv/fleet.
        self._fleet_kv: Optional[Dict[str, Any]] = None
        # Router-local trace ring (fleet-merged /debug/trace): bounded
        # span dicts, appended under _lock by handler threads.  The
        # monotonic/wall anchors are captured at the same instant —
        # the same clock-offset contract obs.Observability publishes.
        self._t0 = time.monotonic()
        self.t0_unix = time.time()
        self._trace: "deque[Dict[str, Any]]" = deque(maxlen=1024)
        # Routing record: external request id -> replica index
        # (bounded LRU, filled by the relay from each reply's
        # X-Request-Id header) — /debug/requests/<id> consults it
        # before any fan-out.
        self._routes: "OrderedDict[str, int]" = OrderedDict()
        self.route_record_max = 4096
        self._closed = threading.Event()
        router = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet test output
                pass

            def do_GET(self):
                router._handle_get(self)

            def do_POST(self):
                router._handle_post(self)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="router-http",
        )
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="router-health",
        )
        self._handoff_thread = threading.Thread(
            target=self._handoff_loop, daemon=True,
            name="router-handoff",
        )
        self._canary_thread = threading.Thread(
            target=self._canary_loop, daemon=True,
            name="router-canary",
        )

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self) -> "ReplicaRouter":
        self._http_thread.start()
        self._health_thread.start()
        self._handoff_thread.start()
        if self.canary_interval_s > 0:
            self._canary_thread.start()
        return self

    def stop(self) -> None:
        """Stop the router (replica lifecycles stay with the caller)."""
        self._closed.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._health_thread.join(timeout=5)
        if self._handoff_thread.is_alive():
            self._handoff_thread.join(timeout=5)
        if self._canary_thread.is_alive():
            self._canary_thread.join(timeout=5)

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _log(self, event: str, message: str = "", **fields) -> None:
        # self.logger is never None (the ctor substitutes a quiet
        # ring-only logger), so every event reaches the bundle tail.
        self.logger.log(event, message, **fields)

    # -- router-local tracing / routing record -------------------------------

    def _now_ms(self) -> float:
        return (time.monotonic() - self._t0) * 1000.0

    def _span(self, name: str, t0_ms: float, **args) -> None:
        """Close a router span started at ``t0_ms`` (None-valued args
        drop, so absent request ids don't litter the trace)."""
        dur = max(0.0, self._now_ms() - t0_ms)
        rec = {
            "name": name, "t0_ms": round(t0_ms, 3),
            "dur_ms": round(dur, 3),
            "args": {k: v for k, v in args.items() if v is not None},
        }
        with self._lock:
            self._trace.append(rec)

    def _note_route(self, request_id: Optional[str],
                    index: int) -> None:
        """Record which replica served ``request_id`` (bounded LRU) —
        the /debug/requests/<id> resolution path."""
        if not request_id:
            return
        with self._lock:
            self._routes[request_id] = index
            self._routes.move_to_end(request_id)
            while len(self._routes) > self.route_record_max:
                self._routes.popitem(last=False)

    # -- health --------------------------------------------------------------

    def _probe(self, rep: _Replica) -> Tuple[bool, Dict[str, Any]]:
        """One /healthz scrape; (routable, payload).  A 503 body still
        parses (draining replicas report their state)."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=2.0
        )
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            payload = json.loads(resp.read() or b"{}")
            return bool(payload.get("ok")), payload
        finally:
            conn.close()

    def _health_loop(self) -> None:
        if self.health_interval_s <= 0:
            # Manual mode (deterministic drills/tests): health moves
            # only through check_health_now() and forward failures.
            return
        while not self._closed.is_set():
            with self._lock:
                reps = [r for r in self._replicas if not r.retired]
            for rep in reps:
                self._scrape_replica(rep)
            self._closed.wait(self.health_interval_s)

    def check_health_now(self) -> None:
        """Synchronous health sweep (tests / deterministic drills) —
        the SAME per-replica step as the poller, so manual-mode drills
        and production produce identical audit trails.  Retired
        replicas are skipped (their servers are gone; scraping them
        would only burn probe timeouts and pollute the sentinel)."""
        with self._lock:
            reps = [r for r in self._replicas if not r.retired]
        for rep in reps:
            self._scrape_replica(rep)

    def _scrape_replica(self, rep: _Replica) -> None:
        """One replica's health step, shared by the poller thread and
        ``check_health_now``: /healthz probe, lock-held health flip,
        global radix index sync (digest-version delta only), sentinel
        feed, and — on a flip — the health log line + the
        ``replica_health`` decision record."""
        try:
            ok, payload = self._probe(rep)
        except (OSError, ValueError, http.client.HTTPException):
            ok, payload = False, {}
        with self._lock:
            was = rep.healthy
            rep.healthy = ok
            if payload:
                rep.last_health = payload
                rep.last_health_t = time.monotonic()
        if payload:
            # Global radix index sync rides the poll for free: only a
            # digest-version DELTA triggers the (mostly incremental)
            # /debug/kv fetch.
            self._sync_index(rep, payload)
        self._sentinel_scrape(rep, payload)
        if was != ok:
            self._log(
                "router_replica_health",
                replica=rep.index, healthy=ok,
            )
            self.decisions.record(
                "replica_health", replica=rep.index, healthy=ok,
            )

    def _sentinel_scrape(self, rep: _Replica,
                         payload: Dict[str, Any]) -> None:
        """Feed one /healthz scrape outcome into the health sentinel
        (runs on the poller thread / check_health_now's caller, never
        under the router lock): attainment + queue-wait p90 from the
        overload section, the ITL EWMA from the replica section, and
        the scrape age as the staleness signal (0 on success, growing
        while the replica stays unreachable)."""
        if payload:
            age: Optional[float] = 0.0
        else:
            with self._lock:
                lt = rep.last_health_t
            # Never-scraped replicas have no baseline to be stale
            # against — the canary (connect failure) covers them.
            age = (time.monotonic() - lt) if lt > 0 else None
        ov = (payload.get("overload") or {}) if payload else {}
        repl = (payload.get("replica") or {}) if payload else {}
        events = self.sentinel.observe_health(
            rep.index, reachable=bool(payload),
            attainment=ov.get("interactive_attainment"),
            queue_wait_ms=ov.get("queue_wait_ms_p90"),
            itl_ms=repl.get("itl_ms_ewma"),
            age_s=age,
        )
        self._ingest_sentinel_events(rep.index, events)

    def _ingest_sentinel_events(
        self, replica: int, events: Sequence[Dict[str, Any]],
    ) -> None:
        """Record sentinel-emitted events (anomaly / anomaly_cleared /
        verdict) into the decision audit log + structured log — the
        counted, logged ``anomaly_*`` trail the acceptance drill
        asserts."""
        for ev in events:
            kind = ev.get("kind", "anomaly")
            fields = {k: v for k, v in ev.items() if k != "kind"}
            self.decisions.record(kind, replica=replica, **fields)
            self._log(f"router_{kind}", replica=replica, **fields)

    def _sync_index(self, rep: _Replica,
                    payload: Dict[str, Any]) -> None:
        """Fold ``rep``'s chain digest into the global radix index
        when its version moved past the last synced one.  Runs on the
        poller thread (or check_health_now's caller) OUTSIDE the
        router lock — the /debug/kv fetch is an HTTP round-trip.
        Incremental (``?since=``, journal replay) whenever the
        replica's bounded journal covers the gap; full node-walk
        replace otherwise."""
        if self.policy != "cache-aware":
            return  # least-loaded/affinity never read the index
        dig = (payload.get("kv") or {}).get("digest") or {}
        ver = dig.get("version")
        if ver is None:
            return  # pre-digest replica
        since = self.index.synced_version(rep.index)
        if dig.get("epoch") != self.index.synced_epoch(rep.index):
            # A rebuild minted a new digest instance: versions live in
            # a different history (a replay can re-advance PAST the
            # synced version — version aliasing), so incremental
            # deltas are meaningless.  Full resync.
            since = None
        if since is not None and since == ver:
            return
        # Both forms ask for an effectively unbounded node count: the
        # ``since`` form can FALL BACK to the full walk server-side
        # (journal gap), and the server default (2048) would silently
        # truncate large pools — adopting a truncated walk as the
        # replica's complete table would hide exactly the deepest
        # (most valuable) chains from the index with no later repair
        # (occupancy is bounded by the replica's pool blocks, so the
        # payload stays sane).
        path = (
            "/debug/kv?n=1000000" if since is None
            else f"/debug/kv?since={since}&n=1000000"
        )
        got = self._get_replica_json(rep, path)
        if got is None or got[0] != 200:
            return
        doc = got[1]
        summ = doc.get("summary") or {}
        bb = int(summ.get("block_bytes") or 0)
        epoch = summ.get("epoch", dig.get("epoch"))
        applied = doc.get("version", ver)
        if "events" in doc:
            self.index.apply_events(
                rep.index, doc["events"], applied, bb, epoch=epoch,
            )
        else:
            if doc.get("truncated"):
                self._log(
                    "router_index_truncated_sync",
                    replica=rep.index,
                    truncated=doc.get("truncated"),
                )
            self.index.replace(
                rep.index, doc.get("nodes", []), applied, bb,
                epoch=epoch,
            )
        if applied != ver:
            # The digest moved between the /healthz scrape and the
            # /debug/kv fetch: the index is now FRESHER than the
            # stored health snapshot.  Refresh the snapshot's version
            # so the pick-time staleness check (synced != live) does
            # not miscount every hit as stale until the next poll.
            with self._lock:
                dig2 = (rep.last_health.get("kv") or {}).get("digest")
                if isinstance(dig2, dict):
                    dig2["version"] = applied

    # -- routing -------------------------------------------------------------

    def _affinity_key(self, payload: Dict[str, Any]) -> Optional[bytes]:
        """Session key: the prompt's leading tokens/characters (chat
        dialogs key on the first message — the system prompt — which is
        exactly the shared radix prefix)."""
        try:
            if isinstance(payload.get("prompt"), list):
                head = payload["prompt"][:_AFFINITY_PREFIX]
                return b"p:" + json.dumps(head).encode()
            if isinstance(payload.get("text"), str):
                return b"t:" + payload["text"][:_AFFINITY_PREFIX].encode()
            msgs = payload.get("messages")
            if isinstance(msgs, list) and msgs:
                first = msgs[0]
                if isinstance(first, dict):
                    return b"m:" + str(
                        first.get("content", "")
                    )[:_AFFINITY_PREFIX].encode()
        except (TypeError, ValueError, UnicodeEncodeError):
            return None
        return None

    def _routing_keys(
        self, path: str, payload: Dict[str, Any],
    ) -> Optional[List[str]]:
        """The request's chain-prefix keys (hex) for the cache-aware
        index lookup — computed OUTSIDE the routing lock (tokenizing
        is the expensive part).  Mirrors exactly what the replica's
        ``_submit`` will encode: /chat dialogs through the chat
        format, ``prompt`` token lists verbatim, ``text`` through the
        tokenizer (bos, no eos).  None = unroutable-by-cache (no
        tokenizer for text, malformed payload, policy not
        cache-aware): the pick falls back to load/role routing."""
        if self.policy != "cache-aware" or self.block_size is None:
            return None
        try:
            if path == "/chat":
                if self.chat_format is None:
                    return None
                msgs = payload.get("messages")
                if not isinstance(msgs, list) or not msgs:
                    return None
                tokens = self.chat_format.encode_dialog_prompt(msgs)
            elif isinstance(payload.get("prompt"), list):
                tokens = [int(t) for t in payload["prompt"]]
            elif (
                isinstance(payload.get("text"), str)
                and self.tokenizer is not None
            ):
                tokens = self.tokenizer.encode(
                    payload["text"], bos=True, eos=False
                )
            else:
                return None
        except (TypeError, ValueError, KeyError, AttributeError):
            return None  # the replica will 400 it; route by load
        return [k.hex() for k in chain_keys(tokens, self.block_size)]

    def _occupancy_locked(self, rep: _Replica) -> float:
        """Replica load as a slot fraction (caller holds ``_lock``):
        router-tracked in-flight requests over the replica's slot
        count from its last health scrape.  An unscraped replica
        reports its raw in-flight count — any load reads as past the
        watermark, so cache-aware routing stays conservative until
        the poller has numbers."""
        h = (rep.last_health.get("replica") or {})
        slots = int(h.get("n_slots") or 0)
        if slots <= 0:
            return float(rep.inflight)
        return rep.inflight / slots

    def _candidates_info_locked(
        self, candidates: List[_Replica],
    ) -> List[Dict[str, Any]]:
        """The decision-audit view of the candidate set (caller holds
        ``_lock``): per candidate, the load facts the pick minimizes
        over — what lets ``/debug/decisions`` answer "why replica Y"
        with the alternatives it beat."""
        return [
            {
                "replica": r.index,
                "inflight": r.inflight,
                "occupancy": round(self._occupancy_locked(r), 4),
                "routed_total": r.routed_total,
            }
            for r in candidates
        ]

    def _cache_pick_locked(
        self, chain: Optional[List[str]],
        candidates: List[_Replica],
        decision: Dict[str, Any],
    ) -> Tuple[_Replica, str, bool, Optional[Dict[str, Any]]]:
        """The cache-aware decision (caller holds ``_lock``): route to
        the replica holding the DEEPEST matching prefix fleet-wide,
        spilling to least-loaded past the occupancy watermark;
        returns ``(replica, how, stale, handoff_plan)`` where a
        non-None plan asks the scheduler to migrate the chain to
        where the request landed (depth x load disagreement past the
        configured threshold).  Cold prompts route least-loaded — or
        to the least-loaded PREFILL replica under role
        disaggregation.  ``decision`` (the audit-log record under
        construction) gains the hit depth, holder set, staleness and
        spill facts the choice was made from."""
        least = min(
            candidates, key=lambda r: (r.inflight, r.routed_total)
        )
        hit = (
            self.index.lookup(
                chain, {r.index for r in candidates}
            ) if chain else None
        )
        if hit is None:
            decision["hit_depth"] = 0
            if self.roles is not None:
                pre = [
                    r for r in candidates
                    if self.roles[r.index] == "prefill"
                ]
                if pre:
                    chosen = min(
                        pre,
                        key=lambda r: (r.inflight, r.routed_total),
                    )
                    return chosen, "prefill-role", False, None
            return least, "least-loaded", False, None
        depth, holders = hit
        decision["hit_depth"] = depth
        decision["holders"] = [
            {"replica": h[0], "tier": h[1]} for h in holders
        ]
        by_idx = {r.index: r for r in candidates}
        best_idx, _tier = min(
            holders,
            key=lambda h: (
                h[1] != "hbm",
                by_idx[h[0]].inflight,
                by_idx[h[0]].routed_total,
            ),
        )
        rep = by_idx[best_idx]
        # Digest freshness: the holder's LIVE digest version (last
        # health scrape) vs the version the index synced at.  A delta
        # means the chain may have moved/evicted since — routed
        # anyway (locality hint), counted, degrades to a cold
        # prefill, never to wrong tokens.
        synced = self.index.synced_version(rep.index)
        live = rep.kv_digest().get("version")
        stale = synced != live
        decision["synced_version"] = synced
        decision["live_version"] = live
        occ = self._occupancy_locked(rep)
        if rep is least or occ < self.spill_occupancy:
            self.cache_hit_depth_blocks_total += depth
            if stale:
                self.cache_stale_routes_total += 1
            return rep, "cache-aware", stale, None
        # Spill: the deepest-prefix holder is past the watermark.
        # Schedule the chain's migration to where the request lands
        # when depth x load-disagreement clears the threshold — the
        # request itself NEVER waits on the handoff (first token
        # rides a cold prefill on the spill target; the next turn
        # hits warm).
        plan = None
        score = depth * max(
            0.0, occ - self._occupancy_locked(least)
        )
        decision["spill_from"] = rep.index
        decision["spill_occupancy"] = round(occ, 4)
        decision["handoff_score"] = round(score, 4)
        if (
            depth >= self.handoff_min_depth
            and score >= self.handoff_threshold
        ):
            plan = {
                "src": rep.index, "dst": least.index,
                "keys_hex": list(chain[:depth]), "depth": depth,
            }
        return least, "spill", False, plan

    def _pick_locked(
        self, key: Optional[bytes], exclude: frozenset,
        chain: Optional[List[str]] = None,
    ) -> Tuple[Optional[_Replica], str, bool,
               Optional[Dict[str, Any]], Dict[str, Any]]:
        """Choose a replica (caller holds ``_lock``): the global-
        radix-index decision under the cache-aware policy, sticky key
        first under affinity, else least-loaded among healthy
        replicas not in ``exclude`` (prior failed attempts for this
        request).

        Returns ``(replica, how, stale, handoff_plan, decision)``.
        ``stale`` is True for an affinity/cache hit whose replica's
        chain digest has changed since the decision's information was
        current — the chain may have been evicted or demoted, so the
        route is a CACHE GAMBLE rather than a known hit.  Compared
        with ``!=`` (not ``>``): a crash-recovery rebuild resets the
        digest and empties the cache — exactly a staleness event.
        ``handoff_plan`` (cache-aware spill only) asks the scheduler
        to migrate the chain to the routed replica.  ``decision`` is
        the audit-log record of the choice — the candidate set with
        its load facts plus whatever hit/staleness/spill inputs the
        policy consulted (recorded by the caller OUTSIDE the lock)."""
        candidates = [
            r for r in self._replicas
            if r.healthy and not r.retiring and not r.retired
            and r.index not in exclude
        ]
        decision: Dict[str, Any] = {
            "candidates": self._candidates_info_locked(candidates),
        }
        if not candidates:
            return None, "none", False, None, decision
        if self.policy == "cache-aware":
            rep, how, stale, plan = self._cache_pick_locked(
                chain, candidates, decision
            )
            return rep, how, stale, plan, decision
        if self.policy == "affinity" and key is not None:
            ent = self._affinity.get(key)
            if ent is not None:
                for r in candidates:
                    if r.index == ent[0]:
                        self._affinity.move_to_end(key)  # LRU refresh
                        cur = r.kv_digest().get("loss_version")
                        stale = (
                            ent[1] is not None and cur is not None
                            and cur != ent[1]
                        )
                        if stale:
                            self.affinity_stale_routes_total += 1
                            # Re-pin at the observed version: one loss
                            # event counts once, not every turn.
                            ent[1] = cur
                        elif ent[1] is None and cur is not None:
                            # The session pinned before this replica's
                            # first digest scrape (None baseline) —
                            # BACKFILL at the first observed version,
                            # or the None would disable staleness
                            # detection for the session's whole life.
                            ent[1] = cur
                        decision["affinity_hit"] = True
                        return r, "affinity", stale, None, decision
        chosen = min(
            candidates, key=lambda r: (r.inflight, r.routed_total)
        )
        if self.policy == "affinity" and key is not None:
            while len(self._affinity) >= self.affinity_max_sessions:
                self._affinity.popitem(last=False)  # evict coldest
            self._affinity[key] = [
                chosen.index, chosen.kv_digest().get("loss_version"),
            ]
        return chosen, "least-loaded", False, None, decision

    # -- proxying ------------------------------------------------------------

    def _handle_post(self, handler: BaseHTTPRequestHandler) -> None:
        if handler.path not in ("/generate", "/chat"):
            self._reply_json(handler, 404, {"error": "not found"})
            return
        try:
            n = int(handler.headers.get("Content-Length") or 0)
        except ValueError:
            n = 0
        body = handler.rfile.read(n) if n > 0 else b"{}"
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                payload = {}
        except ValueError:
            payload = {}
        key = self._affinity_key(payload)
        # Chain-prefix keys for the cache-aware index lookup —
        # tokenization happens HERE, outside the routing lock.
        chain = self._routing_keys(handler.path, payload)
        fwd_headers = {
            "Content-Type": "application/json",
            "Content-Length": str(len(body)),
        }
        for h in ("X-Request-Id",):
            if handler.headers.get(h):
                fwd_headers[h] = handler.headers[h]

        tried: set = set()
        first_attempt = True
        client_rid = handler.headers.get("X-Request-Id") or None
        while True:
            t_pick = self._now_ms()
            role_pending = False
            with self._lock:
                rep, how, stale, plan, decision = self._pick_locked(
                    key, frozenset(tried), chain
                )
                if rep is not None:
                    rep.inflight += 1
                    rep.routed_total += 1
                    if not first_attempt:
                        how = "reroute"
                    self.routed_by_policy[how] = (
                        self.routed_by_policy.get(how, 0) + 1
                    )
                    # A completed request on a prefill-role replica
                    # WILL schedule a disaggregation handoff after the
                    # relay; registering the intent here (cleared in
                    # this attempt's finally, after _maybe_role_handoff
                    # ran) closes the window where wait_handoffs()
                    # could report idle between the client seeing its
                    # reply and the job entering the queue.
                    role_pending = bool(
                        self.roles is not None and chain
                        and self.roles[rep.index] == "prefill"
                    )
                    if role_pending:
                        self._role_handoffs_pending += 1
            if rep is None:
                self.decisions.record(
                    "no_healthy_replica", request_id=client_rid,
                    path=handler.path, tried=sorted(tried),
                )
                self._reply_json(
                    handler, 503,
                    {"error": "no healthy replica"},
                    headers={"Retry-After": "5"},
                )
                return
            tried.add(rep.index)
            # Decision log: the route WITH the candidate set and the
            # policy inputs it was chosen from — recorded outside the
            # routing lock; joinable to the request timeline when the
            # client supplied an X-Request-Id (replica-minted ids
            # resolve through the routing record instead).
            self.decisions.record(
                "route", request_id=client_rid, replica=rep.index,
                policy=how, path=handler.path,
                stale_chain=stale or None,
                handoff_planned=(plan is not None) or None,
                **decision,
            )
            if stale:
                # Digest freshness said the pinned chain may be gone:
                # route anyway (locality hint, not a contract), but as
                # a counted, logged event — the cache-aware scheduler's
                # future miss signal, no longer silent.
                self._log(
                    "router_affinity_stale",
                    replica=rep.index, request_id=client_rid,
                )
            fwd_headers["X-Routed-By"] = (
                f"replica-{rep.index}/{how}"
            )
            # Route-decision span: closes immediately (the pick is a
            # lock-held min()); the forward span that follows carries
            # the relay wall time, so decision and transfer read as
            # two causally ordered slices on the router track.
            self._span(
                "route", t_pick, replica=rep.index, policy=how,
                path=handler.path, request_id=client_rid,
                stale_chain=stale or None,
            )
            if plan is not None:
                # Spill disagreement: migrate the chain to where the
                # request landed — asynchronously; the relay below
                # never waits on it.
                self._schedule_handoff(plan, client_rid)
            t_fwd = self._now_ms()
            try:
                if self.fault_injector is not None:
                    # Fires BEFORE any byte reaches the replica, so a
                    # drill's failure is always at the reroutable stage.
                    self.fault_injector.fire("router_replica")
                rid_seen = self._relay(
                    handler, rep, handler.path, body, fwd_headers
                )
                self._span(
                    "forward", t_fwd, replica=rep.index,
                    path=handler.path,
                    request_id=rid_seen or client_rid,
                )
                # Disaggregation: a completed request on a PREFILL
                # replica streams its freshly published chain to a
                # decode replica, re-pinning the session's routing
                # record there at handoff completion.
                self._maybe_role_handoff(
                    rep, chain, rid_seen or client_rid
                )
                return
            except _ClientDisconnect:
                # The CLIENT vanished mid-relay — the replica is fine
                # (it reaps the disconnect itself); nothing to reroute
                # and no health mark.
                self._span(
                    "forward", t_fwd, replica=rep.index,
                    path=handler.path, request_id=client_rid,
                    client_disconnect=True,
                )
                return
            except TimeoutError as e:
                # Proxy READ timeout from a slow-but-alive replica
                # (overload: streams defer headers until the first
                # token).  The replica has ADMITTED the request — a
                # re-submit would double the load exactly when
                # capacity is scarce, and an unhealthy mark would
                # serially quarantine loaded replicas (a retry-storm
                # amplifier).  504 the client; health stays with the
                # /healthz poller.
                self._log(
                    "router_replica_timeout", str(e), replica=rep.index,
                )
                self._span(
                    "forward", t_fwd, replica=rep.index,
                    path=handler.path, request_id=client_rid,
                    timeout=True,
                )
                if not getattr(e, "_relayed", False):
                    self._reply_json(
                        handler, 504,
                        {"error": (
                            f"replica {rep.index} did not respond "
                            f"within {self.proxy_timeout_s:.0f}s"
                        )},
                        headers={"Retry-After": "5"},
                    )
                return
            except (OSError, InjectedFault,
                    http.client.HTTPException) as e:
                relayed = getattr(e, "_relayed", False)
                with self._lock:
                    rep.healthy = False
                    rep.failures_total += 1
                    self.replica_failures_total += 1
                self._log(
                    "router_replica_failed", str(e),
                    replica=rep.index, rerouting=not relayed,
                )
                self._span(
                    "reroute", t_fwd, replica=rep.index,
                    path=handler.path, request_id=client_rid,
                    error=str(e), relayed=relayed,
                )
                self.decisions.record(
                    "reroute", request_id=client_rid,
                    failed_replica=rep.index, error=str(e),
                    relayed=relayed or None, path=handler.path,
                )
                if relayed:
                    # Bytes already reached the client: the router
                    # must NOT replay (a duplicate stream would
                    # double-deliver tokens); the client sees the
                    # truncated stream and retries with its own
                    # request id.
                    try:
                        handler.wfile.flush()
                    except OSError:
                        pass
                    return
                with self._lock:
                    self.reroutes_total += 1
                first_attempt = False
                continue  # re-route losslessly
            finally:
                with self._lock:
                    rep.inflight -= 1
                    if role_pending:
                        self._role_handoffs_pending -= 1

    def _relay(
        self, handler: BaseHTTPRequestHandler, rep: _Replica,
        path: str, body: bytes, headers: Dict[str, str],
    ) -> Optional[str]:
        """Forward one request and relay the reply (buffered when the
        replica sent Content-Length, line-by-line for close-delimited
        NDJSON streams).  Returns the reply's ``X-Request-Id`` (the
        end-to-end id — replica-minted when the client sent none),
        recorded into the routing record so ``/debug/requests/<id>``
        resolves without fan-out.  Failure attribution: REPLICA-side
        errors (connect/request/read) raise as-is, tagged ``_relayed``
        once any byte reached the client; CLIENT-side write errors
        raise :class:`_ClientDisconnect` — the replica must not be
        marked unhealthy because an impatient client hung up."""
        conn = http.client.HTTPConnection(
            rep.host, rep.port, timeout=self.proxy_timeout_s
        )
        relayed = False

        def to_client(fn, *a):
            nonlocal relayed
            try:
                out = fn(*a)
                relayed = True
                return out
            except OSError:
                raise _ClientDisconnect(relayed) from None

        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            rid_seen = resp.getheader("X-Request-Id")
            self._note_route(rid_seen, rep.index)
            out_headers = [
                (k, v) for k, v in resp.getheaders()
                if k.lower() not in _SKIP_HEADERS
            ]
            out_headers.append(("X-Replica-Id", str(rep.index)))

            def send_head(extra):
                handler.send_response(resp.status)
                for k, v in out_headers + extra:
                    handler.send_header(k, v)
                handler.end_headers()

            if resp.length is not None:
                data = resp.read()  # replica-side: raises plain OSError
                to_client(
                    send_head, [("Content-Length", str(len(data)))]
                )
                to_client(handler.wfile.write, data)
                return rid_seen
            # Close-delimited NDJSON stream: relay line-by-line so the
            # client sees tokens as the replica emits them.
            to_client(send_head, [("Connection", "close")])
            while True:
                line = resp.readline()
                if not line:
                    break
                to_client(handler.wfile.write, line)
                to_client(handler.wfile.flush)
            return rid_seen
        except (OSError, http.client.HTTPException) as e:
            e._relayed = relayed
            raise
        finally:
            conn.close()

    # -- handoff scheduler ---------------------------------------------------

    def _maybe_role_handoff(
        self, rep: _Replica, chain: Optional[List[str]],
        request_id: Optional[str],
    ) -> None:
        """Prefill/decode disaggregation: after a request COMPLETES on
        a prefill-role replica, stream its published chain to the
        least-loaded decode replica (export -> import), so the
        session's next turn admits there as a plain prefix hit."""
        if self.roles is None or not chain:
            return
        if self.roles[rep.index] != "prefill":
            return
        with self._lock:
            decode = [
                r for r in self._replicas
                if r.healthy and self.roles[r.index] == "decode"
            ]
            if not decode:
                return
            dst = min(
                decode, key=lambda r: (r.inflight, r.routed_total)
            )
            dst_index = dst.index
        if dst_index == rep.index:
            return
        self._schedule_handoff(
            {"src": rep.index, "dst": dst_index,
             "keys_hex": list(chain), "depth": len(chain)},
            request_id,
        )

    def _schedule_handoff(
        self, plan: Dict[str, Any], request_id: Optional[str],
    ) -> None:
        """Admit a migration job into the handoff queue under the
        scheduler's bounds: at most ONE in-flight handoff per chain
        (keyed by its deepest prefix key), total estimated bytes in
        flight capped (a skipped job is counted, never queued — the
        chain stays where it is and the next disagreement re-tries),
        and only in-process replicas participate (the control path
        runs on their serving-loop threads)."""
        if not plan.get("keys_hex"):
            return
        # Chain identity = the ROOT key: plans for the same chain at
        # different matched depths (growing multi-turn prompts, spill
        # vs role triggers) must dedup against each other — a leaf
        # key would admit one job per depth and burn the source's
        # loop on empty re-exports after the first demote.
        head = plan["keys_hex"][0]
        skip_reason = None
        with self._lock:
            src = self._replicas[plan["src"]]
            dst = self._replicas[plan["dst"]]
            if src.server is None or dst.server is None:
                self.handoffs_skipped_total += 1
                skip_reason = "replica-not-in-process"
            elif head in self._handoff_chains:
                # One in-flight handoff per chain: the duplicate is
                # refused, and counted — a silently vanishing
                # migrate_chain() would read as accepted.
                self.handoffs_skipped_total += 1
                skip_reason = "chain-handoff-inflight"
            else:
                est = plan["depth"] * self.index.block_bytes(
                    plan["src"]
                )
                if (
                    self._handoff_bytes_inflight > 0
                    and self._handoff_bytes_inflight + est
                    > self.handoff_max_bytes_inflight
                ):
                    self.handoffs_skipped_total += 1
                    skip_reason = "bytes-inflight-cap"
                else:
                    self._handoff_chains.add(head)
                    self._handoff_bytes_inflight += est
                    self.handoffs_scheduled_total += 1
        if skip_reason is not None:
            self.decisions.record(
                "handoff_skipped", request_id=request_id,
                src=plan["src"], dst=plan["dst"],
                depth=plan["depth"], reason=skip_reason,
            )
            return
        job = dict(plan, head=head, est=est, request_id=request_id)
        self._log(
            "router_handoff_scheduled", src=plan["src"],
            dst=plan["dst"], depth=plan["depth"],
            request_id=request_id,
        )
        self.decisions.record(
            "handoff_scheduled", request_id=request_id,
            src=plan["src"], dst=plan["dst"], depth=plan["depth"],
            est_bytes=est,
        )
        self._handoff_q.put(job)

    def _handoff_loop(self) -> None:
        """The router-handoff worker: executes migration jobs one at
        a time through the replicas' control paths.  A failed or
        timed-out job counts as aborted and UNWINDS its scheduler
        accounting — the chain is re-eligible immediately and the
        worker never dies."""
        while not self._closed.is_set():
            try:
                job = self._handoff_q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._run_handoff(job)
            except Exception as e:
                with self._lock:
                    self.handoffs_aborted_total += 1
                self._log(
                    "router_handoff_failed", str(e),
                    src=job["src"], dst=job["dst"],
                    request_id=job.get("request_id"),
                )
                self.decisions.record(
                    "handoff_aborted",
                    request_id=job.get("request_id"),
                    src=job["src"], dst=job["dst"], error=str(e),
                )
            finally:
                with self._lock:
                    self._handoff_chains.discard(job["head"])
                    self._handoff_bytes_inflight = max(
                        0, self._handoff_bytes_inflight - job["est"]
                    )

    def _execute_migration(
        self, src_idx: int, dst_idx: int, keys: Sequence[bytes],
        request_id: Optional[str] = None,
        timeout_s: Optional[float] = None,
        demote: Optional[bool] = None,
    ) -> Tuple[int, str]:
        """THE chain-move mechanics, shared by the handoff scheduler
        and the fleet controller's drain migration: export on the
        source's serving-loop thread, import on the destination's with
        the remaining wall budget (the import unwinds cleanly on
        timeout — serving.py owns that contract), demote the source's
        copy ONLY for the prefix the destination provably holds
        (residency probe), and on success fold the move into the
        global index + count/trace/re-pin the routing record
        (``note_handoff``).  Returns ``(blocks_landed, outcome)``;
        outcome is ``"completed"``, ``"nothing-resident"`` (source had
        nothing to move — benign) or
        ``"already-resident-or-no-capacity"`` (nothing landed, source
        copy intact — benign).  Export/import failures and timeouts
        RAISE: the caller owns abort accounting, and the source keeps
        its copy in every failure path — an aborted migration never
        strands or duplicates a session."""
        with self._lock:
            src = self._replicas[src_idx]
            dst = self._replicas[dst_idx]
        rid = request_id
        budget = (
            self.handoff_timeout_s if timeout_s is None
            else float(timeout_s)
        )
        t0 = self._now_ms()
        deadline = time.monotonic() + budget
        # Export WITHOUT demoting: the source gives up its copy only
        # AFTER the destination provably holds the chain (below) — an
        # abandoned/timed-out/failed handoff must never cost the
        # fleet its only HBM-resident copy.
        keys_out, slabs = src.server.call_on_loop(
            lambda b: b.export_prefix(
                keys=list(keys), request_id=rid,
                max_bytes=self.handoff_max_bytes,
            ),
            timeout_s=budget,
        )
        if not slabs:
            return 0, "nothing-resident"
        remaining = max(0.1, deadline - time.monotonic())
        n = dst.server.call_on_loop(
            lambda b: b.import_prefix(
                keys_out, slabs, request_id=rid,
                timeout_s=remaining,
            ),
            timeout_s=remaining + 1.0,
        )
        # The source gives up its copy only for the prefix the
        # destination PROVABLY holds HBM-resident now: an import can
        # return 0 both benignly (the spilled request's own prefill
        # won the race) and because the destination had no capacity,
        # and a capacity-truncated import lands a shorter prefix than
        # was exported — demoting past the landed depth would cost
        # the fleet its only copy of the tail.  One cheap host-side
        # residency probe resolves all cases exactly.  A drain passes
        # ``demote=False``: the source is being retired (its copies
        # die with it), and demoting mid-drain would hollow out the
        # shared prefixes of chains not yet exported.
        do_demote = self.demote_after_export if demote is None else demote
        if do_demote:
            try:
                resident = dst.server.call_on_loop(
                    lambda b: len(
                        b._match_prefix(list(keys_out)).blocks
                    ),
                    timeout_s=min(5.0, budget),
                )
                if resident > 0:
                    # Reuses the exported slabs (no second D2H
                    # fetch); best-effort — a busy source keeps its
                    # copy and the next disagreement re-tries.
                    src.server.call_on_loop(
                        lambda b: b.demote_exported(
                            keys_out[:resident], slabs[:resident],
                            request_id=rid,
                        ),
                        timeout_s=budget,
                    )
            except (TimeoutError, RuntimeError):
                pass
        if n <= 0:
            return 0, "already-resident-or-no-capacity"
        # note_handoff counts kv_handoffs_total, drops the linked
        # handoff span, and re-pins the routing record at dst.
        self.note_handoff(n, request_id=rid, src=src_idx, dst=dst_idx)
        self.index.note_handoff(
            src_idx, dst_idx, [k.hex() for k in keys_out[:n]],
        )
        self._span(
            "handoff_exec", t0, src=src_idx, dst=dst_idx,
            blocks=n, request_id=rid,
        )
        return n, "completed"

    def _run_handoff(self, job: Dict[str, Any]) -> None:
        """One scheduler job through :meth:`_execute_migration`, plus
        the scheduler's own ledger: empty/no-capacity outcomes count
        ``handoffs_empty_total`` (benign — the chain stayed put), a
        landed prefix counts completed blocks/bytes.  Failures raise
        into the worker loop (counted aborted, accounting unwound)."""
        rid = job.get("request_id")
        keys = [bytes.fromhex(k) for k in job["keys_hex"]]
        n, outcome = self._execute_migration(
            job["src"], job["dst"], keys, request_id=rid,
        )
        if outcome != "completed":
            with self._lock:
                self.handoffs_empty_total += 1
            self.decisions.record(
                "handoff_empty", request_id=rid, src=job["src"],
                dst=job["dst"], reason=outcome,
            )
            return
        bb = self.index.block_bytes(job["src"])
        with self._lock:
            self.handoffs_completed_total += 1
            self.handoff_blocks_total += n
            self.handoff_bytes_total += n * bb
        self.decisions.record(
            "handoff_completed", request_id=rid, src=job["src"],
            dst=job["dst"], blocks=n, bytes=n * bb,
        )

    def migrate_chain(
        self, keys_hex: Sequence[str], src: int, dst: int,
        request_id: Optional[str] = None,
    ) -> None:
        """Operator/bench entry point: schedule one chain migration
        src -> dst through the same bounded scheduler the spill path
        uses (dedup, bytes-in-flight cap, demote-after-export)."""
        self._schedule_handoff(
            {"src": int(src), "dst": int(dst),
             "keys_hex": list(keys_hex), "depth": len(keys_hex)},
            request_id,
        )

    def wait_handoffs(self, timeout_s: float = 10.0) -> bool:
        """Block until the handoff queue is drained and no job is in
        flight (tests / bench determinism); True when idle."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                idle = (
                    not self._handoff_chains
                    and self._handoff_q.empty()
                    and self._role_handoffs_pending == 0
                )
            if idle:
                return True
            time.sleep(0.01)
        return False

    # -- elastic fleet membership (FleetController's actuator surface) -------

    def attach_controller(self, controller: "FleetController") -> None:
        """Register the fleet controller (written once, before any
        scale action): /debug/fleet and /metrics render its state."""
        self.controller = controller

    def add_replica(self, replica: Any, role: Optional[str] = None) -> int:
        """Scale-up actuator: append one replica (a started in-process
        ``LLMServer`` or a ``"host:port"`` string) at the next index —
        never reusing a retired slot, so ``_replicas[i].index == i``
        stays structural.  Under role disaggregation the new replica
        must declare its role.  Returns the assigned index; the
        replica becomes routable at its first successful health
        scrape (``check_health_now`` in manual mode)."""
        if self.roles is not None:
            if role is None or role not in ROLES:
                raise ValueError(
                    "add_replica under role disaggregation needs "
                    f"role in {ROLES}, got {role!r}"
                )
        if isinstance(replica, str):
            h, p = _parse_address(replica)
            server = None
        else:
            h, p = _parse_address(replica.address)
            server = replica
        with self._lock:
            idx = len(self._replicas)
            rep = _Replica(index=idx, host=h, port=p, server=server)
            # Unscraped: not routable until the first health sweep
            # proves it answers (a half-started server must not eat
            # live traffic).
            rep.healthy = False
            self._replicas.append(rep)
            if self.roles is not None:
                self.roles = self.roles + (role,)
        self._log("router_replica_added", replica=idx,
                  address=f"{h}:{p}", role=role)
        return idx

    def swap_replica(self, index: int, replica: Any) -> None:
        """Rollout actuator: replace the INSTANCE in an existing slot
        (same index, new server — typically new weights/config).  The
        slot's sentinel state and global-index table are forgotten
        (the new instance starts from clean baselines and a full
        digest resync) and its retiring flag clears; like add_replica
        it becomes routable at the next health sweep.  The OLD
        server's shutdown stays with the caller — swap first, retire
        the old instance after, so the fleet never shrinks mid-rung."""
        if isinstance(replica, str):
            h, p = _parse_address(replica)
            server = None
        else:
            h, p = _parse_address(replica.address)
            server = replica
        with self._lock:
            rep = self._replicas[index]
            rep.host, rep.port, rep.server = h, p, server
            rep.healthy = False
            rep.retiring = False
            rep.retired = False
            rep.last_health = {}
            rep.last_health_t = 0.0
        self.sentinel.forget(index)
        self.index.drop_replica(index)
        self._log("router_replica_swapped", replica=index,
                  address=f"{h}:{p}")

    def set_retiring(self, index: int, retiring: bool = True) -> None:
        """Flip a replica's admission without touching its health: a
        retiring replica is excluded from every routing pick but stays
        scraped/canaried and its serving loop keeps running — exactly
        what drain migration needs (the source must still execute
        ``export_prefix`` control calls)."""
        with self._lock:
            self._replicas[index].retiring = bool(retiring)
        self._log("router_replica_retiring", replica=index,
                  retiring=bool(retiring))

    def retire_replica(self, index: int) -> None:
        """Take a replica out of the fleet permanently (scale-down
        completion): never picked, scraped or canaried again; its
        list slot survives (structural index invariant) but its
        sentinel state and index table are dropped so lookups stop
        seeing phantom holders.  Stopping the server stays with the
        caller (the controller stops instances it owns)."""
        with self._lock:
            rep = self._replicas[index]
            rep.retired = True
            rep.retiring = False
            rep.healthy = False
            # The slot keeps no reference to its instance: once its owner
            # stops it, its batcher's pool (gigabytes on the card) is
            # freed with it.
            rep.server = None
        self.sentinel.forget(index)
        self.index.drop_replica(index)
        self._log("router_replica_retired", replica=index)

    def repin_routes(self, src: int, dst: int) -> int:
        """Re-point every routing record and affinity pin from a
        drained replica to the survivor its sessions migrated to, so
        the very next turn of every session routes where its KV now
        lives (cache-aware routing would find it through the index
        anyway; affinity and /debug/requests need the explicit
        re-pin).  The affinity pin's digest version resets to None —
        backfilled at the destination's next scrape, same as a fresh
        pin.  Returns the number of records moved."""
        moved = 0
        with self._lock:
            for rid, idx in list(self._routes.items()):
                if idx == src:
                    self._routes[rid] = dst
                    moved += 1
            for key, ent in self._affinity.items():
                if ent[0] == src:
                    ent[0] = dst
                    ent[1] = None
                    moved += 1
        if moved:
            self._log("router_routes_repinned", src=src, dst=dst,
                      moved=moved)
        return moved

    # -- synthetic canary probes ---------------------------------------------

    def _canary_loop(self) -> None:
        """The canary prober thread (started when
        ``canary_interval_s > 0``): one probe per replica per
        interval.  ``<= 0`` is manual mode — deterministic
        drills/tests drive :meth:`run_canaries_now`."""
        while not self._closed.is_set():
            self.run_canaries_now()
            self._closed.wait(self.canary_interval_s)

    def run_canaries_now(self) -> List[Tuple[int, Dict[str, Any]]]:
        """One synchronous canary sweep over every NON-RETIRED replica
        — routable or not: an unhealthy replica's canary is exactly
        how its recovery (or continued sickness) is confirmed without
        risking real traffic (retired replicas have no server to
        probe).  Two phases: probe everyone FIRST, then resolve
        the token oracle against the whole sweep (majority rule — see
        ``_resolve_canary_oracle``) before any mismatch is judged, so
        a wrong-output replica that happens to be probed first cannot
        invert the fleet verdict.  Probes run CONCURRENTLY (one short
        thread per replica): a single hung replica costs its own
        probe timeout, never the whole fleet's sweep — otherwise one
        accept-but-never-answer replica would double every healthy
        replica's effective probe period.  Returns the oracle-resolved
        ``(replica_index, result)`` pairs — the fleet controller's
        rollout gate reads the restarted replica's entry directly."""
        with self._lock:
            reps = [r for r in self._replicas if not r.retired]
            if self._closed.is_set():
                return []
            seq0 = self._canary_seq
            self._canary_seq += len(reps)
        slots: List[Optional[Dict[str, Any]]] = [None] * len(reps)

        def probe(i: int, rep: _Replica) -> None:
            slots[i] = self._canary_probe(rep, seq0 + 1 + i)

        threads = [
            threading.Thread(
                target=probe, args=(i, rep), daemon=True,
                name=f"router-canary-probe-{rep.index}",
            )
            for i, rep in enumerate(reps)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.canary_timeout_s + 5.0)
        results: List[Tuple[_Replica, Dict[str, Any]]] = []
        for i, (rep, res) in enumerate(zip(reps, slots)):
            if res is None:
                # The probe thread outlived even the HTTP timeout (a
                # wedged resolver/socket): that IS a failed probe —
                # dropping it would hide exactly the hung replica.
                res = {
                    "ok": False,
                    "error": "canary probe did not complete "
                             "(probe thread hung past its timeout)",
                    "latency_ms": self.canary_timeout_s * 1000.0,
                    "request_id": f"canary-{rep.index}-{seq0 + 1 + i}",
                }
            results.append((rep, res))
        self._resolve_canary_oracle(results)
        for rep, res in results:
            self._ingest_canary(rep, res)
        return [(rep.index, res) for rep, res in results]

    def reset_canary_oracle(self) -> None:
        """Operator hook: forget the pinned oracle (the next sweep's
        majority re-establishes it).  Call on a KNOWN fleet-wide
        output change — a weight rollout, a tokenizer swap — so every
        replica does not read as mismatched against the old fleet's
        tokens."""
        with self._lock:
            self._canary_oracle = None
        self.decisions.record("canary_oracle_reset")
        self._log("router_canary_oracle_reset")

    def _resolve_canary_oracle(
        self, results: List[Tuple[_Replica, Dict[str, Any]]],
    ) -> None:
        """Resolve this sweep's token oracle and mark mismatches.

        The oracle is the plurality token sequence among the sweep's
        transport-successful probes (same weights + greedy decode ⇒
        replica-independent, so healthy fleets are unanimous).  An
        already-pinned oracle is RE-PINNED when a STRICT MAJORITY of
        this sweep's successful probes agree on a different sequence
        (counted ``canary_oracle_repins_total``): the pin was wrong —
        a corrupt replica happened to be probed first, or the whole
        fleet legitimately changed output (rollout) — and without the
        re-pin every HEALTHY replica would read as mismatched forever.
        A split with no majority (1-vs-1 on a 2-replica fleet) can
        never PIN or RE-PIN: with no pin yet the oracle stays unset
        (probe order must not crown a corrupt replica — the
        disagreement is recorded instead), and with a pin it is kept.
        Only after the oracle settles are individual probes marked
        ``mismatch`` (ok flips False); with no settled oracle nobody
        is mismatched — the sentinel cannot tell who is wrong, only
        that they disagree."""
        votes = [
            (rep.index, tuple(res.get("tokens") or ()))
            for rep, res in results
            if res.get("ok") and res.get("tokens")
        ]
        counts: Dict[Tuple[int, ...], int] = {}
        for _, t in votes:
            counts[t] = counts.get(t, 0) + 1
        repinned = None
        disagreement = False
        with self._lock:
            pinned = (
                tuple(self._canary_oracle)
                if self._canary_oracle is not None else None
            )
            if counts:
                best = max(counts, key=lambda t: counts[t])
                unanimous_or_majority = (
                    len(counts) == 1 or counts[best] > len(votes) / 2
                )
                if pinned is None:
                    if unanimous_or_majority:
                        self._canary_oracle = list(best)
                    else:
                        disagreement = True
                elif (
                    best != pinned
                    and counts[best] > len(votes) / 2
                    and counts.get(pinned, 0) < counts[best]
                ):
                    self._canary_oracle = list(best)
                    self.canary_oracle_repins_total += 1
                    repinned = list(best)
            oracle = (
                tuple(self._canary_oracle)
                if self._canary_oracle is not None else None
            )
        if repinned is not None:
            self.decisions.record(
                "canary_oracle_repin", oracle_tokens=repinned,
                votes=len(votes),
            )
            self._log(
                "router_canary_oracle_repin", votes=len(votes),
            )
        if disagreement:
            # No pin and no majority: crowning either side by probe
            # order would let a corrupt replica permanently invert
            # the verdict.  Record the split; the next sweep with a
            # majority (or an operator's eyes on this event) settles.
            self.decisions.record(
                "canary_oracle_disagreement", votes=len(votes),
                sequences=len(counts),
            )
            self._log(
                "router_canary_oracle_disagreement",
                votes=len(votes), sequences=len(counts),
            )
        if oracle is None:
            return
        for _, res in results:
            if res.get("ok") and tuple(res.get("tokens") or ()) != oracle:
                res["ok"] = False
                res["mismatch"] = True

    def _canary_payload(self) -> Dict[str, Any]:
        """The deterministic probe request: a tiny fixed token prompt,
        greedy (temperature 0), fixed seed, and the RESERVED canary
        priority class — the replica serves it normally but excludes
        it from SLO attainment, goodput, latency histograms and the
        brownout ladder's inputs (no self-triggered brownouts)."""
        return {
            "prompt": list(self.canary_prompt),
            "max_new_tokens": self.canary_max_new,
            "temperature": 0.0,
            "seed": 0,
            "priority": CANARY,
        }

    def _canary_probe(self, rep: _Replica, seq: int) -> Dict[str, Any]:
        """One TRANSPORT-level probe against one replica (direct POST
        — never through the routing path, so a probe can reach a
        replica the router has stopped routing to).  Returns the raw
        result (ok = HTTP 200 with a body; tokens; latency); token
        correctness is judged afterwards against the whole sweep by
        ``_resolve_canary_oracle``."""
        rid = f"canary-{rep.index}-{seq}"
        body = json.dumps(self._canary_payload()).encode()
        t0 = time.monotonic()
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.canary_timeout_s
            )
            try:
                conn.request(
                    "POST", "/generate", body=body,
                    headers={
                        "Content-Type": "application/json",
                        "X-Request-Id": rid,
                    },
                )
                resp = conn.getresponse()
                data = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException) as e:
            return {
                "ok": False, "error": repr(e),
                "latency_ms": (time.monotonic() - t0) * 1000.0,
                "request_id": rid,
            }
        lat = (time.monotonic() - t0) * 1000.0
        if resp.status != 200 or not isinstance(data, dict):
            return {
                "ok": False,
                "error": f"HTTP {resp.status}: "
                         f"{(data or {}).get('error')}",
                "latency_ms": lat, "request_id": rid,
                "status": resp.status,
            }
        tokens = [int(t) for t in (data.get("tokens") or [])]
        return {
            "ok": True, "latency_ms": lat, "tokens": tokens,
            "request_id": rid,
        }

    def _ingest_canary(self, rep: _Replica,
                       res: Dict[str, Any]) -> None:
        """Feed one oracle-resolved probe result everywhere it goes:
        the probe counters, the decision audit log, the structured log
        (failures only — a healthy fleet's probes are not log
        traffic), and the health sentinel (whose anomaly/verdict
        events land in the decision log via the ingest path)."""
        with self._lock:
            self.canary_probes_total += 1
            if res.get("mismatch"):
                self.canary_mismatches_total += 1
            elif not res["ok"]:
                self.canary_failures_total += 1
        self.decisions.record(
            "canary", request_id=res.get("request_id"),
            replica=rep.index, ok=res["ok"],
            latency_ms=round(res["latency_ms"], 3),
            mismatch=res.get("mismatch") or None,
            error=res.get("error"),
        )
        if not res["ok"]:
            self._log(
                "router_canary_failed", replica=rep.index,
                error=res.get("error"),
                mismatch=res.get("mismatch"),
            )
        events = self.sentinel.observe_canary(
            rep.index, ok=res["ok"],
            latency_ms=res.get("latency_ms"),
            mismatch=bool(res.get("mismatch")),
            error=res.get("error"),
        )
        self._ingest_sentinel_events(rep.index, events)

    # -- GET surface ---------------------------------------------------------

    def _handle_get(self, handler: BaseHTTPRequestHandler) -> None:
        parts = urlsplit(handler.path)
        route, query = parts.path, parse_qs(parts.query)
        if route == "/healthz":
            h = self.health()
            self._reply_json(handler, 200 if h["ok"] else 503, h)
        elif route == "/metrics":
            body = self.metrics_text().encode()
            handler.send_response(200)
            handler.send_header(
                "Content-Type", "text/plain; version=0.0.4"
            )
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif route == "/debug/trace":
            window_ms = None
            if "window_s" in query:
                try:
                    window_ms = float(query["window_s"][0]) * 1000.0
                except ValueError:
                    self._reply_json(
                        handler, 400, {"error": "bad window_s"}
                    )
                    return
            self._reply_json(
                handler, 200, self.fleet_trace_json(window_ms)
            )
        elif route == "/debug/kv/fleet":
            depth = None
            if "depth" in query:
                try:
                    depth = int(query["depth"][0])
                except ValueError:
                    self._reply_json(
                        handler, 400, {"error": "bad depth"}
                    )
                    return
            self._reply_json(handler, 200, self.fleet_kv_json(depth))
        elif route == "/debug/fleet":
            # The health-score/anomaly sentinel's fleet view — the
            # verdict surface the future autoscaler consumes.
            self._reply_json(handler, 200, self.fleet_health_json())
        elif route == "/debug/decisions":
            kind = (query.get("kind") or [None])[0]
            request_id = (query.get("request_id") or [None])[0]
            try:
                n = int((query.get("n") or [128])[0])
            except ValueError:
                n = 128
            self._reply_json(
                handler, 200,
                self.decisions.json(
                    n=n, kind=kind, request_id=request_id
                ),
            )
        elif route == "/debug/bundle":
            def qflag(name: str) -> bool:
                try:
                    return int((query.get(name) or [1])[0]) > 0
                except ValueError:
                    return True
            self._reply_json(
                handler, 200,
                self.bundle_json(
                    include_replicas=qflag("replicas"),
                    trace=qflag("trace"),
                ),
            )
        elif route == "/debug/requests":
            self._reply_json(
                handler, *self._fleet_requests_index(handler.path)
            )
        elif route.startswith("/debug/requests/"):
            rid = unquote(route[len("/debug/requests/"):])
            self._reply_json(
                handler, *self._fleet_request_lookup(rid, handler.path)
            )
        elif route.startswith("/debug/"):
            # Everything else (dispatch rings, profiler summaries...)
            # lives on whichever replica produced it: try each healthy
            # replica until one answers non-404.
            code, data = self._first_non_404(handler.path)
            self._reply_json(handler, code, data)
        else:
            self._reply_json(handler, 404, {"error": "not found"})

    def _get_replica_json(
        self, rep: _Replica, path: str, timeout: float = 2.0,
    ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """One replica GET; None on connection/parse failure.  The
        default timeout matches the health probe's: the fleet /debug
        endpoints fetch replicas SEQUENTIALLY, so each hung-but-
        marked-healthy replica costs at most one probe interval, not
        a proxy-class stall per replica."""
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=timeout
            )
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                data = json.loads(resp.read() or b"{}")
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException):
            return None
        if not isinstance(data, dict):
            return None
        return resp.status, data

    def _first_non_404(self, path: str) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            reps = [r for r in self._replicas if r.healthy]
        for rep in reps:
            got = self._get_replica_json(rep, path)
            if got is None:
                continue
            status, data = got
            if status != 404:
                data["replica"] = rep.index
                return status, data
        return 404, {"error": "not found on any replica"}

    def _fleet_requests_index(
        self, path: str,
    ) -> Tuple[int, Dict[str, Any]]:
        """GET /debug/requests aggregated across ALL healthy replicas
        (first-to-answer would show one replica's slice of the fleet
        and 404-hide the rest); every entry carries its replica id."""
        with self._lock:
            reps = [r for r in self._replicas if r.healthy]
        merged: List[Dict[str, Any]] = []
        replicas_answered: List[int] = []
        for rep in reps:
            got = self._get_replica_json(rep, path)
            if got is None or got[0] != 200:
                continue
            replicas_answered.append(rep.index)
            for entry in got[1].get("requests", []):
                if isinstance(entry, dict):
                    entry["replica"] = rep.index
                    merged.append(entry)
        return 200, {
            "requests": merged, "replicas": replicas_answered,
        }

    def _fleet_request_lookup(
        self, request_id: str, path: str,
    ) -> Tuple[int, Dict[str, Any]]:
        """GET /debug/requests/<id>: the ROUTING RECORD names the
        replica that served the id, so that replica answers first;
        healthy-replica fan-out only covers ids the bounded record has
        already evicted (or pre-router traffic)."""
        with self._lock:
            routed = self._routes.get(request_id)
            reps = list(self._replicas)
        ordered = (
            [r for r in reps if r.index == routed]
            + [r for r in reps if r.index != routed and r.healthy]
        )
        for rep in ordered:
            got = self._get_replica_json(rep, path)
            if got is None:
                continue
            status, data = got
            if status != 404:
                data["replica"] = rep.index
                data["routed_replica"] = routed
                # The decision join: every router decision carrying
                # this external id (route, reroute, handoff, canary)
                # rides the timeline reply, so "why did this request
                # land here" reads in one fetch.
                data["router_decisions"] = self.decisions.for_request(
                    request_id
                )
                return status, data
        return 404, {
            "error": f"request id {request_id!r} unknown fleet-wide",
            "routed_replica": routed,
            "router_decisions": self.decisions.for_request(request_id),
        }

    @staticmethod
    def _reply_json(
        handler: BaseHTTPRequestHandler, code: int,
        obj: Dict[str, Any], headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = json.dumps(obj).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(body)

    # -- observability -------------------------------------------------------

    def fleet_trace_json(
        self, window_ms: Optional[float] = None,
    ) -> Dict[str, Any]:
        """The fleet-merged Perfetto document (module docstring): the
        router's span track plus every healthy replica's
        ``/debug/trace`` export, replica timestamps shifted into the
        router's frame through the ``t0_unix_s`` anchors and re-tagged
        to per-replica pids.  Snapshot under the lock, fetch and build
        outside it — replica HTTP round-trips must never hold the
        routing lock."""
        with self._lock:
            reps = [
                (r.index, r.host, r.port)
                for r in self._replicas if r.healthy
            ]
            spans = list(self._trace)
            now = self._now_ms()
        horizon = None if window_ms is None else now - window_ms
        ev: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 0, "name": "process_name",
             "args": {"name": "router"}},
            {"ph": "M", "pid": 0, "tid": 1, "name": "thread_name",
             "args": {"name": "routing"}},
        ]
        for s in spans:
            if horizon is not None and s["t0_ms"] + s["dur_ms"] < horizon:
                continue
            ev.append({
                "name": s["name"], "cat": "router", "ph": "X",
                "pid": 0, "tid": 1,
                "ts": round(s["t0_ms"] * 1000.0, 1),
                "dur": max(1, round(s["dur_ms"] * 1000.0)),
                "args": dict(s["args"]),
            })
        suffix = (
            "" if window_ms is None
            else f"?window_s={window_ms / 1000.0:g}"
        )
        merged_replicas: List[int] = []
        for index, host, port in reps:
            got = self._get_replica_json(
                _Replica(index=index, host=host, port=port),
                "/debug/trace" + suffix,
            )
            if got is None or got[0] != 200:
                continue
            doc = got[1]
            merged_replicas.append(index)
            pid = 1 + index
            # Clock-offset normalization: replica ts are relative to
            # ITS Observability t0; the wall anchors captured at both
            # t0 instants give the shift into the router's frame.
            off_us = (
                float(doc.get("t0_unix_s", self.t0_unix))
                - self.t0_unix
            ) * 1e6
            ev.append({
                "ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": f"replica-{index}"},
            })
            for e in doc.get("traceEvents", []):
                if not isinstance(e, dict):
                    continue
                e = dict(e)
                e["pid"] = pid
                if "ts" in e:
                    e["ts"] = round(e["ts"] + off_us, 1)
                ev.append(e)
        return {
            "traceEvents": ev, "displayTimeUnit": "ms",
            "t0_unix_s": round(self.t0_unix, 6),
            "replicas": merged_replicas,
        }

    def fleet_kv_json(
        self, depth: Optional[int] = None,
    ) -> Dict[str, Any]:
        """``GET /debug/kv/fleet``: the router-side fleet cache view.

        Scrapes every healthy replica's ``/debug/kv`` digest
        (sequential, probe-class 2 s timeouts — on demand, never from
        the poller) and aggregates:

          * **fleet prefix-hit ratio** — sum of hit tokens over sum of
            admitted prompt tokens across the fleet;
          * **per-replica occupancy/watermarks** — nodes, HBM/host
            residency, idle (evictable) depth, digest version/age;
          * **cross-replica duplicate chains** — chain-prefix keys
            HBM-resident on >= 2 replicas, with the redundant blocks
            and BYTES (copies beyond the first, priced at each extra
            copy's own block_bytes): the HBM a cache-aware
            disaggregation scheduler would get back.

        The computed fleet aggregate is cached (``_fleet_kv``) for the
        ``llm_fleet_duplicate_kv_blocks`` /metrics gauges; truncated
        replica digests make the duplicate count a LOWER bound and are
        listed in ``truncated_replicas``."""
        with self._lock:
            reps = [
                (r.index, r.host, r.port)
                for r in self._replicas if r.healthy
            ]
        t0 = time.monotonic()
        suffix = f"?depth={depth}" if depth is not None else ""
        per: List[Dict[str, Any]] = []
        truncated: List[int] = []
        # chain key -> [(replica index, block_bytes), ...] HBM copies
        chains: Dict[str, List[Tuple[int, int]]] = {}
        hit_tokens = prompt_tokens = 0
        for index, host, port in reps:
            got = self._get_replica_json(
                _Replica(index=index, host=host, port=port),
                "/debug/kv" + suffix,
            )
            if got is None or got[0] != 200:
                continue
            doc = got[1]
            summ = doc.get("summary") or {}
            bb = int(summ.get("block_bytes") or 0)
            for node in doc.get("nodes", []):
                if (
                    isinstance(node, dict)
                    and node.get("tier") == "hbm"
                ):
                    chains.setdefault(str(node.get("key")), []).append(
                        (index, bb)
                    )
            if doc.get("truncated"):
                truncated.append(index)
            hit_tokens += int(summ.get("prefix_hit_tokens_total") or 0)
            prompt_tokens += int(summ.get("prompt_tokens_total") or 0)
            per.append({
                "replica": index,
                "summary": summ,
                "hit_ratio": round(
                    int(summ.get("prefix_hit_tokens_total") or 0)
                    / max(1, int(summ.get("prompt_tokens_total") or 0)),
                    6,
                ),
                "hbm_bytes": (
                    int(summ.get("hbm_blocks") or 0) * bb
                ),
            })
        dup_chains = dup_blocks = dup_bytes = 0
        for copies in chains.values():
            if len({i for i, _ in copies}) < 2:
                continue
            dup_chains += 1
            extra = sorted(copies)[1:]  # first copy is the keeper
            dup_blocks += len(extra)
            dup_bytes += sum(b for _, b in extra)
        scrape_ms = round((time.monotonic() - t0) * 1000.0, 3)
        fleet = {
            "prefix_hit_ratio": round(
                hit_tokens / max(1, prompt_tokens), 6
            ),
            "prefix_hit_tokens_total": hit_tokens,
            "prompt_tokens_total": prompt_tokens,
            "duplicate_chains": dup_chains,
            "duplicate_kv_blocks": dup_blocks,
            "duplicate_kv_bytes": dup_bytes,
            "replicas_scraped": [p["replica"] for p in per],
            "truncated_replicas": truncated,
            "scrape_ms": scrape_ms,
        }
        with self._lock:
            self._fleet_kv = dict(fleet, computed_unix_s=time.time())
        return {"fleet": fleet, "replicas": per}

    def fleet_health_json(self) -> Dict[str, Any]:
        """``GET /debug/fleet`` — the per-replica health-score /
        verdict view: the sentinel's scores, subscores, active
        anomalies and last canary result merged with the router's own
        routing facts (routable, inflight, scrape age), plus the
        fleet verdict (worst replica) and the edge-triggered anomaly
        counters.  THE surface the fleet controller's autoscaler consults
        before it is allowed to kill or drain a replica."""
        now = time.monotonic()
        with self._lock:
            snaps = {
                r.index: {
                    "replica": r.index,
                    "healthy": r.healthy,
                    "retiring": r.retiring,
                    "retired": r.retired,
                    "inflight": r.inflight,
                    "routed_total": r.routed_total,
                    "failures_total": r.failures_total,
                    "health_age_s": (
                        round(now - r.last_health_t, 3)
                        if r.last_health_t > 0 else None
                    ),
                }
                for r in self._replicas
            }
            canary = {
                "probes_total": self.canary_probes_total,
                "failures_total": self.canary_failures_total,
                "mismatches_total": self.canary_mismatches_total,
                "oracle_repins_total": self.canary_oracle_repins_total,
                "interval_s": self.canary_interval_s,
                "prompt": list(self.canary_prompt),
                "max_new": self.canary_max_new,
                "oracle_tokens": (
                    list(self._canary_oracle)
                    if self._canary_oracle is not None else None
                ),
            }
        fleet = self.sentinel.fleet_json()
        replicas: List[Dict[str, Any]] = []
        for idx in sorted(snaps):
            ent = dict(snaps[idx])
            sent = fleet["replicas"].get(idx)
            if sent is None:
                sent = {
                    "score": 1.0, "verdict": "healthy",
                    "signals": {}, "anomalous": [],
                    "last_canary": None,
                }
            ent.update(sent)
            replicas.append(ent)
        ctrl = self.controller
        return {
            "verdict": fleet["verdict"],
            "verdict_index": fleet["verdict_index"],
            "replicas": replicas,
            "anomalies_total": fleet["anomalies_total"],
            "canary": canary,
            # Elastic-fleet controller state (None until one attaches):
            # ladder/dwell state, last signals, counters, rollout rung.
            "controller": (
                ctrl.state_json() if ctrl is not None else None
            ),
        }

    def bundle_json(self, include_replicas: bool = True,
                    trace: bool = True) -> Dict[str, Any]:
        """``GET /debug/bundle[?replicas=0&trace=0]`` — the router's
        black-box flight-recorder artifact: config + aggregate health
        + the fleet health-score view + the last-N control-plane
        decisions + the structured-log tail + the fleet-merged
        Perfetto trace, and (by default) every healthy replica's own
        ``/debug/bundle`` inline — ONE pull for the whole incident.
        Replica fetches use bounded timeouts so a hung replica costs
        seconds, not the artifact.  Replica bundles are fetched with
        ``?trace=0`` ALWAYS: the fleet-merged trace above already
        carries every replica's tracks (re-tagged, clock-shifted), so
        shipping each replica's own trace again would double the
        heaviest section — and with ``trace=0`` the slimming would
        otherwise not slim the dominant payload at all."""
        out: Dict[str, Any] = {
            "kind": "router_bundle",
            "generated_unix_s": round(time.time(), 3),
            "config": {
                "policy": self.policy,
                "roles": list(self.roles) if self.roles else None,
                "health_interval_s": self.health_interval_s,
                "proxy_timeout_s": self.proxy_timeout_s,
                "spill_occupancy": self.spill_occupancy,
                "handoff_threshold": self.handoff_threshold,
                "handoff_min_depth": self.handoff_min_depth,
                "handoff_max_bytes": self.handoff_max_bytes,
                "handoff_max_bytes_inflight": (
                    self.handoff_max_bytes_inflight
                ),
                "handoff_timeout_s": self.handoff_timeout_s,
                "canary_interval_s": self.canary_interval_s,
                "canary_max_new": self.canary_max_new,
                "canary_timeout_s": self.canary_timeout_s,
            },
            "health": self.health(),
            "fleet": self.fleet_health_json(),
            "decisions": self.decisions.json(n=256),
            "log_tail": self.logger.tail(),
        }
        if trace:
            out["trace"] = self.fleet_trace_json()
        if include_replicas:
            with self._lock:
                reps = [
                    (r.index, r.host, r.port)
                    for r in self._replicas if r.healthy
                ]
            bundles: List[Dict[str, Any]] = []
            for index, host, port in reps:
                got = self._get_replica_json(
                    _Replica(index=index, host=host, port=port),
                    "/debug/bundle?trace=0", timeout=5.0,
                )
                if got is not None and got[0] == 200:
                    doc = got[1]
                    doc["replica"] = index
                    bundles.append(doc)
            out["replicas"] = bundles
        return out

    def health(self) -> Dict[str, Any]:
        """Aggregate /healthz: ok while ANY replica is routable, with
        the per-replica snapshots under ``replicas``."""
        with self._lock:
            snaps = [r.snapshot() for r in self._replicas]
            affinity_sessions = len(self._affinity)
            handoffs = self.kv_handoffs_total
            stale_routes = self.affinity_stale_routes_total
            fleet_kv = (
                dict(self._fleet_kv)
                if self._fleet_kv is not None else None
            )
            scheduler = {
                "scheduled_total": self.handoffs_scheduled_total,
                "completed_total": self.handoffs_completed_total,
                "aborted_total": self.handoffs_aborted_total,
                "skipped_total": self.handoffs_skipped_total,
                "empty_total": self.handoffs_empty_total,
                "blocks_total": self.handoff_blocks_total,
                "bytes_total": self.handoff_bytes_total,
                "bytes_inflight": self._handoff_bytes_inflight,
                "chains_inflight": len(self._handoff_chains),
                "role_pending": self._role_handoffs_pending,
            }
            cache = {
                "stale_routes_total": self.cache_stale_routes_total,
                "hit_depth_blocks_total": (
                    self.cache_hit_depth_blocks_total
                ),
            }
            canary = {
                "probes_total": self.canary_probes_total,
                "failures_total": self.canary_failures_total,
                "mismatches_total": self.canary_mismatches_total,
                "oracle_repins_total": self.canary_oracle_repins_total,
                "interval_s": self.canary_interval_s,
            }
        cache.update(self.index.stats())
        sent = self.sentinel.fleet_json()
        return {
            "ok": any(s["healthy"] for s in snaps),
            "policy": self.policy,
            "roles": list(self.roles) if self.roles else None,
            "replicas": snaps,
            "affinity_sessions": affinity_sessions,
            "kv_handoffs_total": handoffs,
            "affinity_stale_routes_total": stale_routes,
            # Cache-aware routing state: the global radix index's
            # sync/size counters + routing outcomes.
            "cache_index": cache,
            # Handoff scheduler ledger (bounds + outcomes).
            "handoff": scheduler,
            # Last computed fleet cache aggregate (None until the
            # first GET /debug/kv/fleet).
            "fleet_kv": fleet_kv,
            # Control-plane observability: canary prober counters, the
            # sentinel's fleet verdict + per-signal anomaly counters,
            # and the decision audit log's size (GET /debug/decisions
            # for the events, GET /debug/fleet for the full view).
            "canary": canary,
            "fleet_health": {
                "verdict": sent["verdict"],
                "verdict_index": sent["verdict_index"],
                "anomalies_total": sent["anomalies_total"],
            },
            "decisions_total": self.decisions.total(),
        }

    def metrics_text(self) -> str:
        """Router Prometheus exposition: aggregate counters plus
        per-replica labeled gauges (occupancy / inflight / routed /
        health / mesh shape / sentinel score).  Every family's
        HELP/TYPE comes from the :data:`ROUTER_METRICS` registry
        (``fam``); tests/test_torch_router.py holds the exposition's
        families to the registry."""
        with self._lock:
            snaps = [r.snapshot() for r in self._replicas]
            by_policy = dict(self.routed_by_policy)
            reroutes = self.reroutes_total
            failures = self.replica_failures_total
            handoffs = self.kv_handoffs_total
            affinity_sessions = len(self._affinity)
            stale_routes = self.affinity_stale_routes_total
            fleet_kv = (
                dict(self._fleet_kv)
                if self._fleet_kv is not None else None
            )
            ho = {
                "scheduled": self.handoffs_scheduled_total,
                "completed": self.handoffs_completed_total,
                "aborted": self.handoffs_aborted_total,
                "skipped": self.handoffs_skipped_total,
                "bytes_inflight": self._handoff_bytes_inflight,
                "bytes_total": self.handoff_bytes_total,
            }
            cache_stale = self.cache_stale_routes_total
            cache_depth = self.cache_hit_depth_blocks_total
            canary = {
                "probes": self.canary_probes_total,
                "failures": self.canary_failures_total,
                "mismatches": self.canary_mismatches_total,
                "repins": self.canary_oracle_repins_total,
            }
        idx = self.index.stats()
        decision_counts = self.decisions.counts_snapshot()
        sent = self.sentinel.fleet_json()
        lines: List[str] = []

        def fam(name: str) -> None:
            kind, help_text = ROUTER_METRICS[name]
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")

        fam("llm_router_replicas")
        # Retired slots survive in the table (index invariant) but are
        # no longer fleet members.
        lines.append(
            "llm_router_replicas "
            f"{sum(not s['retired'] for s in snaps)}"
        )
        fam("llm_router_replicas_healthy")
        lines.append(
            "llm_router_replicas_healthy "
            f"{sum(s['healthy'] for s in snaps)}"
        )
        fam("llm_router_routed_requests_total")
        for pol, n in sorted(by_policy.items()):
            lines.append(
                f'llm_router_routed_requests_total{{policy="{pol}"}} {n}'
            )
        fam("llm_router_reroutes_total")
        lines.append(f"llm_router_reroutes_total {reroutes}")
        fam("llm_router_replica_failures_total")
        lines.append(f"llm_router_replica_failures_total {failures}")
        fam("llm_router_kv_handoffs_total")
        lines.append(f"llm_router_kv_handoffs_total {handoffs}")
        fam("llm_router_affinity_sessions")
        lines.append(f"llm_router_affinity_sessions {affinity_sessions}")
        fam("llm_router_affinity_stale_routes_total")
        lines.append(
            f"llm_router_affinity_stale_routes_total {stale_routes}"
        )
        # Cache-aware routing: the global radix index + decision
        # outcome counters (policy="cache-aware" only; families are
        # always exposed for dashboard discovery).
        fam("llm_router_cache_index_nodes")
        lines.append(f"llm_router_cache_index_nodes {idx['nodes']}")
        fam("llm_router_cache_index_replicas_synced")
        lines.append(
            "llm_router_cache_index_replicas_synced "
            f"{idx['replicas_synced']}"
        )
        fam("llm_router_cache_index_syncs_total")
        lines.append(
            f"llm_router_cache_index_syncs_total {idx['syncs_total']}"
        )
        fam("llm_router_cache_index_resyncs_total")
        lines.append(
            "llm_router_cache_index_resyncs_total "
            f"{idx['resyncs_total']}"
        )
        fam("llm_router_cache_index_events_applied_total")
        lines.append(
            "llm_router_cache_index_events_applied_total "
            f"{idx['events_applied_total']}"
        )
        fam("llm_router_cache_stale_routes_total")
        lines.append(
            f"llm_router_cache_stale_routes_total {cache_stale}"
        )
        fam("llm_router_cache_hit_depth_blocks_total")
        lines.append(
            f"llm_router_cache_hit_depth_blocks_total {cache_depth}"
        )
        # Handoff scheduler ledger.
        fam("llm_router_handoffs_scheduled_total")
        lines.append(
            f"llm_router_handoffs_scheduled_total {ho['scheduled']}"
        )
        fam("llm_router_handoffs_completed_total")
        lines.append(
            f"llm_router_handoffs_completed_total {ho['completed']}"
        )
        fam("llm_router_handoffs_aborted_total")
        lines.append(
            f"llm_router_handoffs_aborted_total {ho['aborted']}"
        )
        fam("llm_router_handoffs_skipped_total")
        lines.append(
            f"llm_router_handoffs_skipped_total {ho['skipped']}"
        )
        fam("llm_router_handoff_bytes_inflight")
        lines.append(
            f"llm_router_handoff_bytes_inflight {ho['bytes_inflight']}"
        )
        fam("llm_router_handoff_bytes_total")
        lines.append(
            f"llm_router_handoff_bytes_total {ho['bytes_total']}"
        )
        # Control-plane observability: the decision audit log (one
        # labeled series per decision kind), the canary prober's
        # counters, the sentinel's edge-triggered anomaly counters
        # (one labeled series per signal) and the fleet verdict.
        fam("llm_router_decisions_total")
        for kname, n in sorted(decision_counts.items()):
            lines.append(
                f'llm_router_decisions_total{{kind="{kname}"}} {n}'
            )
        fam("llm_router_canary_probes_total")
        lines.append(
            f"llm_router_canary_probes_total {canary['probes']}"
        )
        fam("llm_router_canary_failures_total")
        lines.append(
            f"llm_router_canary_failures_total {canary['failures']}"
        )
        fam("llm_router_canary_mismatches_total")
        lines.append(
            f"llm_router_canary_mismatches_total {canary['mismatches']}"
        )
        fam("llm_router_canary_oracle_repins_total")
        lines.append(
            f"llm_router_canary_oracle_repins_total {canary['repins']}"
        )
        fam("llm_router_anomalies_total")
        for sig, n in sorted(sent["anomalies_total"].items()):
            lines.append(
                f'llm_router_anomalies_total{{signal="{sig}"}} {n}'
            )
        fam("llm_router_fleet_verdict")
        lines.append(
            f"llm_router_fleet_verdict {sent['verdict_index']}"
        )
        # Elastic-fleet controller (zeros / -1 until one attaches —
        # families always exposed for dashboard discovery).  Read via
        # the controller's own snapshot under ITS leaf lock, never
        # under the router lock.
        ctrl = self.controller
        cs = ctrl.metrics_snapshot() if ctrl is not None else None
        fam("llm_fleet_scale_events_total")
        for action in ("up", "down", "deferred", "aborted"):
            v = cs["scale_events"][action] if cs is not None else 0
            lines.append(
                f'llm_fleet_scale_events_total{{action="{action}"}} {v}'
            )
        fam("llm_sessions_migrated_total")
        lines.append(
            "llm_sessions_migrated_total "
            f"{cs['sessions_migrated'] if cs is not None else 0}"
        )
        fam("llm_rollout_rung")
        lines.append(
            "llm_rollout_rung "
            f"{cs['rollout_rung'] if cs is not None else -1}"
        )
        # Fleet cache aggregate (last GET /debug/kv/fleet computation;
        # headers always present for dashboard discovery, samples only
        # once a fleet view has been computed).
        fam("llm_fleet_duplicate_kv_blocks")
        fam("llm_fleet_duplicate_kv_bytes")
        fam("llm_fleet_prefix_hit_ratio")
        fam("llm_fleet_kv_age_s")
        if fleet_kv is not None:
            lines.append(
                "llm_fleet_duplicate_kv_blocks "
                f"{fleet_kv['duplicate_kv_blocks']}"
            )
            lines.append(
                "llm_fleet_duplicate_kv_bytes "
                f"{fleet_kv['duplicate_kv_bytes']}"
            )
            lines.append(
                "llm_fleet_prefix_hit_ratio "
                f"{fleet_kv['prefix_hit_ratio']}"
            )
            lines.append(
                "llm_fleet_kv_age_s "
                f"{round(time.time() - fleet_kv['computed_unix_s'], 3)}"
            )
        fam("llm_router_replica_healthy")
        fam("llm_router_replica_inflight")
        fam("llm_router_replica_routed_total")
        fam("llm_router_replica_active_slots")
        fam("llm_router_replica_mesh_devices")
        # Per-replica cache gauges (from the /healthz kv.digest
        # summary the poller already scrapes) + the staleness gauge
        # that qualifies EVERY per-replica labeled value here: a
        # replica that went unroutable keeps its last-scraped numbers,
        # so dashboards gate on the age instead of trusting them.
        fam("llm_replica_health_age_s")
        fam("llm_router_replica_kv_nodes")
        fam("llm_router_replica_kv_hbm_blocks")
        fam("llm_router_replica_kv_host_blocks")
        fam("llm_router_replica_kv_idle_blocks")
        fam("llm_router_replica_kv_digest_version")
        fam("llm_router_replica_kv_hit_ratio")
        # Per-replica sentinel gauges (health score / verdict / last
        # canary) — the labeled twins of the GET /debug/fleet view.
        fam("llm_router_replica_health_score")
        fam("llm_router_replica_verdict")
        fam("llm_router_replica_canary_latency_ms")
        fam("llm_router_replica_canary_ok")
        for s in snaps:
            lab = f'replica="{s["index"]}"'
            lines.append(
                f"llm_router_replica_healthy{{{lab}}} "
                f"{int(bool(s['healthy']))}"
            )
            lines.append(
                f"llm_router_replica_inflight{{{lab}}} {s['inflight']}"
            )
            lines.append(
                f"llm_router_replica_routed_total{{{lab}}} "
                f"{s['routed_total']}"
            )
            rep_info = s.get("replica") or {}
            lines.append(
                f"llm_router_replica_active_slots{{{lab}}} "
                f"{rep_info.get('active_slots', 0) or 0}"
            )
            mesh = rep_info.get("serve_mesh") or {}
            lines.append(
                f"llm_router_replica_mesh_devices{{{lab}}} "
                f"{mesh.get('devices', 1) or 1}"
            )
            age = s.get("health_age_s")
            lines.append(
                f"llm_replica_health_age_s{{{lab}}} "
                f"{age if age is not None else -1}"
            )
            kv = s.get("kv") or {}
            dig = kv.get("digest") or {}
            lines.append(
                f"llm_router_replica_kv_nodes{{{lab}}} "
                f"{dig.get('nodes', 0) or 0}"
            )
            lines.append(
                f"llm_router_replica_kv_hbm_blocks{{{lab}}} "
                f"{dig.get('hbm_blocks', 0) or 0}"
            )
            lines.append(
                f"llm_router_replica_kv_host_blocks{{{lab}}} "
                f"{dig.get('host_blocks', 0) or 0}"
            )
            lines.append(
                f"llm_router_replica_kv_idle_blocks{{{lab}}} "
                f"{dig.get('idle_blocks', 0) or 0}"
            )
            lines.append(
                f"llm_router_replica_kv_digest_version{{{lab}}} "
                f"{dig.get('version', 0) or 0}"
            )
            hit = int(kv.get("prefix_hit_tokens_total") or 0)
            prompt = int(kv.get("prompt_tokens_total") or 0)
            lines.append(
                f"llm_router_replica_kv_hit_ratio{{{lab}}} "
                f"{round(hit / max(1, prompt), 6)}"
            )
            st = sent["replicas"].get(s["index"]) or {}
            lines.append(
                f"llm_router_replica_health_score{{{lab}}} "
                f"{st.get('score', 1.0)}"
            )
            lines.append(
                f"llm_router_replica_verdict{{{lab}}} "
                f"{VERDICT_INDEX[st.get('verdict', 'healthy')]}"
            )
            lc = st.get("last_canary") or {}
            lat = lc.get("latency_ms")
            lines.append(
                f"llm_router_replica_canary_latency_ms{{{lab}}} "
                f"{lat if lat is not None else -1}"
            )
            ok = lc.get("ok") if lc else None
            lines.append(
                f"llm_router_replica_canary_ok{{{lab}}} "
                f"{int(ok) if ok is not None else -1}"
            )
        return "\n".join(lines) + "\n"

    def note_handoff(
        self, blocks: int, request_id: Optional[str] = None,
        src: Optional[int] = None, dst: Optional[int] = None,
    ) -> None:
        """Count a brokered prefix handoff and drop a ``handoff`` span
        on the router track carrying the external request id — the
        link that ties the source replica's ``prefix_export`` and the
        destination's ``prefix_import`` instants into one timeline in
        the merged trace.  When the destination is known the routing
        record re-pins the id there (route-follow: the session's next
        /debug lookup lands where its KV now lives)."""
        if blocks <= 0:
            return
        t = self._now_ms()
        with self._lock:
            self.kv_handoffs_total += 1
            self._trace.append({
                "name": "handoff", "t0_ms": round(t, 3),
                "dur_ms": 0.0,
                "args": {
                    k: v for k, v in (
                        ("request_id", request_id), ("src", src),
                        ("dst", dst), ("blocks", blocks),
                    ) if v is not None
                },
            })
        if dst is not None:
            self._note_route(request_id, dst)


class FleetController:
    """The elastic-fleet control loop: autoscaling, drain-by-migration
    and zero-downtime rollouts over one :class:`ReplicaRouter`.

    Three actuators, one invariant — **no session is dropped on any
    planned fleet event**:

    - :meth:`tick` (or the background loop when ``interval_s > 0``)
      scales the fleet against windowed interactive attainment and
      queue-wait pressure, with dwell/cooldown hysteresis exactly like
      the brownout ladder: pressure (attainment below
      ``attainment_floor`` or queue-wait p90 above
      ``queue_wait_high_ms``) sustained for ``dwell_s`` scales up;
      calm (no pressure, occupancy at or below ``occupancy_low``)
      sustained for ``dwell_s`` scales down; ``cooldown_s`` separates
      consecutive actions.  Every action lands in the decision log
      (``kind="scale"``) with the driving signals, and scale-down is
      gated on the health sentinel: a victim whose verdict is not
      ``"healthy"`` is never killed (the controller must not destroy
      the evidence of an anomaly it cannot explain) — the deferral is
      itself a recorded decision.

    - :meth:`drain_replica` is the drain primitive every removal goes
      through: stop admission (``retiring``), wait for in-flight
      streams and the serving loop to settle, enumerate every live
      session's chain (``resident_chain_keys``), and move each chain
      to a survivor through the same export→import→residency-proof
      path the handoff scheduler uses (``_execute_migration``, demote
      suppressed — the source's copies die with it).  Routing records
      re-pin to the receiving survivor so the next turn of every
      session lands where its KV now lives.  Any failure — injected
      fault at ``session_migrate``, export/import error, no surviving
      destination — resumes the source untouched and reports instead
      of dropping anyone.

    - :meth:`rollout` restarts the fleet replica-by-replica onto new
      weights: per rung, drain → swap the slot to the new instance →
      ``reset_canary_oracle()`` → full canary sweep, gated on the
      restarted replica's own probe matching the rollout oracle (the
      rung-0 probe pins it, or pass ``expect_tokens`` to pin it
      externally — mid-rollout the FLEET majority still runs old
      weights, so the fleet oracle would misjudge the new output).  A
      failed gate auto-rolls the rung back (``rollback_factory``) and
      aborts; after the last rung a final reset + sweep must be
      unanimously clean.

    Thread discipline: own leaf lock guarding only the controller's
    counters/hysteresis state — compute under it, act outside it.
    Controller methods take ``router._lock`` for snapshots and call
    router actuators (which take it internally), but NEVER while
    holding the controller lock, so the two locks never nest and no
    ordering constraint exists.  Fault sites: ``scale_event`` fires at
    the start of every scale-up/scale-down/rollout-rung (an injected
    fault aborts the whole action cleanly — fleet membership
    unchanged); ``session_migrate`` fires once per live session at the
    start of its drain migration (aborts that session's move only).
    """

    def __init__(
        self,
        router: ReplicaRouter,
        replica_factory: Optional[Any] = None,
        *,
        min_replicas: int = 1,
        max_replicas: int = 8,
        interval_s: float = 0.0,   # <= 0: manual (tests) — drive tick()
        attainment_floor: float = 0.9,
        queue_wait_high_ms: float = 500.0,
        occupancy_low: float = 0.25,
        dwell_s: float = 0.0,
        cooldown_s: float = 0.0,
        drain_timeout_s: float = 30.0,
        migrate_timeout_s: Optional[float] = None,
        fault_injector: Optional[FaultInjector] = None,
    ):
        self.router = router
        # ``replica_factory(index_hint)`` returns a started in-process
        # LLMServer (or a "host:port" string) for scale-up / rollouts.
        self.replica_factory = replica_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.attainment_floor = float(attainment_floor)
        self.queue_wait_high_ms = float(queue_wait_high_ms)
        self.occupancy_low = float(occupancy_low)
        self.dwell_s = float(dwell_s)
        self.cooldown_s = float(cooldown_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.migrate_timeout_s = migrate_timeout_s
        self.fault_injector = (
            fault_injector if fault_injector is not None
            else router.fault_injector
        )
        self._lock = threading.Lock()
        self._scale_events: Dict[str, int] = {
            "up": 0, "down": 0, "deferred": 0, "aborted": 0,
        }
        self.sessions_migrated_total = 0
        self.sessions_migrate_failed_total = 0
        self.drains_total = 0
        self.drains_failed_total = 0
        self.rollouts_total = 0
        self.rollbacks_total = 0
        self.rollout_rung = -1
        self._pressure_since: Optional[float] = None
        self._calm_since: Optional[float] = None
        self._last_action_t = float("-inf")
        self._busy = False
        self._last_signals: Optional[Dict[str, Any]] = None
        # In-process servers the controller created (scale-up /
        # rollout swaps): the controller stops these on removal; all
        # other instances' lifecycles stay with their creator.
        self._owned: Dict[int, Any] = {}
        self._rollout_oracle: Optional[List[int]] = None
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        router.attach_controller(self)
        if self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="fleet-controller",
            )
            self._thread.start()

    # -- lifecycle -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._closed.is_set():
            try:
                self.tick()
            except Exception as e:  # keep the loop alive; surface it
                self.router._log("fleet_tick_error", error=str(e))
            self._closed.wait(self.interval_s)

    def close(self, stop_owned: bool = False) -> None:
        """Stop the background loop; with ``stop_owned`` also stop
        every in-process server the controller created."""
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if stop_owned:
            with self._lock:
                owned = list(self._owned.values())
            for srv in owned:
                self._stop_server(srv)

    # -- signals + decision --------------------------------------------------

    def signals(self) -> Dict[str, Any]:
        """One snapshot of the scaling inputs, from the last health
        scrapes (no network): worst interactive attainment and worst
        queue-wait p90 across healthy active replicas, worst slot
        occupancy, and fleet-wide in-flight."""
        r = self.router
        with r._lock:
            active = [
                x for x in r._replicas
                if not x.retired and not x.retiring
            ]
            healthy = [x for x in active if x.healthy]
            att: List[float] = []
            qw: List[float] = []
            occ: List[float] = []
            for x in healthy:
                ov = (x.last_health or {}).get("overload") or {}
                a = ov.get("interactive_attainment")
                if a is not None:
                    att.append(float(a))
                q = ov.get("queue_wait_ms_p90")
                if q is not None:
                    qw.append(float(q))
                occ.append(r._occupancy_locked(x))
            inflight = sum(x.inflight for x in active)
        return {
            "replicas_active": len(active),
            "replicas_healthy": len(healthy),
            "inflight": inflight,
            "attainment_min": round(min(att), 4) if att else None,
            "queue_wait_ms_p90_max": round(max(qw), 3) if qw else None,
            "occupancy_max": round(max(occ), 4) if occ else None,
        }

    def _decide_locked(
        self, now: float, sig: Dict[str, Any],
    ) -> Tuple[str, str]:
        """Hysteresis state machine (holds ``self._lock``): returns
        ``("up"|"down"|"hold", reason)``.  Pressure and calm must each
        be SUSTAINED for ``dwell_s`` (a single hot scrape scales
        nothing), and ``cooldown_s`` must have passed since the last
        action — the same shape as the brownout ladder, so the two
        controllers don't fight over transients."""
        if self._busy:
            return "hold", "action-in-progress"
        att = sig.get("attainment_min")
        qw = sig.get("queue_wait_ms_p90_max")
        occ = sig.get("occupancy_max")
        pressure = (
            (att is not None and att < self.attainment_floor)
            or (qw is not None and qw > self.queue_wait_high_ms)
        )
        calm = (
            not pressure
            and occ is not None and occ <= self.occupancy_low
        )
        if pressure:
            self._calm_since = None
            if self._pressure_since is None:
                self._pressure_since = now
        else:
            self._pressure_since = None
            if calm:
                if self._calm_since is None:
                    self._calm_since = now
            else:
                self._calm_since = None
        if not pressure and not calm:
            return "hold", "steady"
        if now - self._last_action_t < self.cooldown_s:
            return "hold", "cooldown"
        if pressure:
            if now - self._pressure_since < self.dwell_s:
                return "hold", "dwell"
            if sig["replicas_active"] >= self.max_replicas:
                return "hold", "at-max-replicas"
            if self.replica_factory is None:
                return "hold", "no-replica-factory"
            return "up", "pressure"
        if now - self._calm_since < self.dwell_s:
            return "hold", "dwell"
        if sig["replicas_active"] <= self.min_replicas:
            return "hold", "at-min-replicas"
        return "down", "calm"

    def tick(self) -> Dict[str, Any]:
        """One control-loop step: snapshot signals, run the hysteresis
        decision, act.  Gated deferrals (at-max/at-min/no-factory) are
        recorded decisions; dwell/cooldown/steady holds are silent
        (their state is visible in /debug/fleet's ``last_signals``)."""
        now = time.monotonic()
        sig = self.signals()
        with self._lock:
            action, reason = self._decide_locked(now, sig)
            self._last_signals = dict(sig, action=action, reason=reason)
        if action == "up":
            return self.scale_up(signals=sig)
        if action == "down":
            return self.scale_down(signals=sig)
        if reason in (
            "at-max-replicas", "at-min-replicas", "no-replica-factory",
        ):
            with self._lock:
                self._scale_events["deferred"] += 1
            self.router.decisions.record(
                "scale", action="deferred", reason=reason, signals=sig,
            )
        return {"ok": True, "action": "hold", "reason": reason,
                "signals": sig}

    # -- shared plumbing -----------------------------------------------------

    def _fire(self, site: str) -> Optional[str]:
        """Fire a controller fault site; returns the injected-fault
        message (action must abort) or None (proceed)."""
        fi = self.fault_injector
        if fi is None:
            return None
        try:
            fi.fire(site)
        except InjectedFault as e:
            return str(e) or f"injected fault at {site}"
        return None

    def _begin_action(self) -> bool:
        with self._lock:
            if self._busy:
                return False
            self._busy = True
            return True

    def _end_action(self, acted: bool) -> None:
        with self._lock:
            self._busy = False
            if acted:
                self._last_action_t = time.monotonic()

    @staticmethod
    def _stop_server(server: Any) -> None:
        if server is None or isinstance(server, str):
            return
        try:
            server.shutdown_for_restart(grace_s=2.0)
        except Exception:
            pass

    def _pick_destination(self, src: int) -> Optional[int]:
        """Least-loaded active healthy survivor (never the source)."""
        r = self.router
        with r._lock:
            cands = [
                x for x in r._replicas
                if x.index != src and x.healthy
                and not x.retiring and not x.retired
            ]
            if not cands:
                return None
            best = min(
                cands,
                key=lambda x: (r._occupancy_locked(x), x.inflight,
                               x.index),
            )
            return best.index

    def _pick_victim(
        self, explicit: Optional[int] = None,
    ) -> Tuple[Optional[int], Dict[int, str]]:
        """Scale-down victim, sentinel-gated: only a replica whose
        health-sentinel verdict is ``"healthy"`` may be killed —
        never destroy the evidence of an anomaly the sentinel cannot
        explain.  Among eligible victims, least in-flight wins."""
        r = self.router
        with r._lock:
            cands = [
                (x.index, x.inflight, x.routed_total)
                for x in r._replicas
                if not x.retired and not x.retiring and x.healthy
            ]
        verdicts = {i: r.sentinel.verdict(i) for i, _, _ in cands}
        if explicit is not None:
            v = verdicts.get(explicit) or r.sentinel.verdict(explicit)
            verdicts[explicit] = v
            return (explicit if v == "healthy" else None), verdicts
        ok = [c for c in cands if verdicts[c[0]] == "healthy"]
        if not ok:
            return None, verdicts
        return min(ok, key=lambda c: (c[1], c[2]))[0], verdicts

    # -- actuators -----------------------------------------------------------

    def scale_up(
        self, signals: Optional[Dict[str, Any]] = None,
        role: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Add one replica through ``replica_factory``.  Fires
        ``scale_event`` first — an injected fault aborts with the
        fleet unchanged."""
        r = self.router
        sig = signals if signals is not None else self.signals()
        if not self._begin_action():
            return {"ok": False, "action": "up",
                    "reason": "action-in-progress"}
        acted = False
        try:
            err = self._fire("scale_event")
            if err is not None:
                with self._lock:
                    self._scale_events["aborted"] += 1
                r.decisions.record("scale", action="aborted", op="up",
                                   reason=err, signals=sig)
                return {"ok": False, "action": "up", "reason": err}
            if self.replica_factory is None:
                with self._lock:
                    self._scale_events["deferred"] += 1
                r.decisions.record(
                    "scale", action="deferred", op="up",
                    reason="no-replica-factory", signals=sig,
                )
                return {"ok": False, "action": "up",
                        "reason": "no-replica-factory"}
            with r._lock:
                hint = len(r._replicas)
            try:
                server = self.replica_factory(hint)
            except Exception as e:
                with self._lock:
                    self._scale_events["aborted"] += 1
                r.decisions.record(
                    "scale", action="aborted", op="up",
                    reason=f"replica-factory: {e}", signals=sig,
                )
                return {"ok": False, "action": "up",
                        "reason": f"replica-factory: {e}"}
            idx = r.add_replica(server, role=role)
            with self._lock:
                if not isinstance(server, str):
                    self._owned[idx] = server
                self._scale_events["up"] += 1
            if r.health_interval_s <= 0:
                r.check_health_now()
            r.decisions.record(
                "scale", action="up", replica=idx,
                sentinel=r.sentinel.verdict(idx), signals=sig,
            )
            acted = True
            return {"ok": True, "action": "up", "replica": idx,
                    "signals": sig}
        finally:
            self._end_action(acted)

    def scale_down(
        self, victim: Optional[int] = None,
        signals: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Remove one replica: sentinel-gated victim pick, drain (live
        sessions migrate to survivors), then retire.  Fires
        ``scale_event`` first; any failure aborts with the fleet
        unchanged and every session still served."""
        r = self.router
        sig = signals if signals is not None else self.signals()
        if not self._begin_action():
            return {"ok": False, "action": "down",
                    "reason": "action-in-progress"}
        acted = False
        try:
            err = self._fire("scale_event")
            if err is not None:
                with self._lock:
                    self._scale_events["aborted"] += 1
                r.decisions.record("scale", action="aborted", op="down",
                                   reason=err, signals=sig)
                return {"ok": False, "action": "down", "reason": err}
            pick, verdicts = self._pick_victim(victim)
            if pick is None:
                with self._lock:
                    self._scale_events["deferred"] += 1
                r.decisions.record(
                    "scale", action="deferred", op="down",
                    reason="sentinel-cannot-explain",
                    sentinel=verdicts, signals=sig,
                )
                return {"ok": False, "action": "down",
                        "reason": "sentinel-cannot-explain",
                        "sentinel": verdicts}
            report = self.drain_replica(pick)
            if not report.get("ok"):
                # drain_replica already resumed admission: abort with
                # the fleet exactly as it was.
                with self._lock:
                    self._scale_events["aborted"] += 1
                r.decisions.record(
                    "scale", action="aborted", op="down", replica=pick,
                    reason=f"drain: {report.get('reason')}",
                    signals=sig,
                )
                return {"ok": False, "action": "down", "replica": pick,
                        "reason": f"drain: {report.get('reason')}",
                        "drain": report}
            with r._lock:
                server = r._replicas[pick].server
            r.retire_replica(pick)
            with self._lock:
                owned = self._owned.pop(pick, None)
                self._scale_events["down"] += 1
            if owned is not None and owned is server:
                self._stop_server(server)
            r.decisions.record(
                "scale", action="down", replica=pick,
                sentinel=verdicts.get(pick),
                migrated=report.get("migrated"),
                blocks=report.get("blocks"), signals=sig,
            )
            acted = True
            return {"ok": True, "action": "down", "replica": pick,
                    "drain": report, "signals": sig}
        finally:
            self._end_action(acted)

    def drain_replica(
        self, index: int, timeout_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """THE drain primitive (also the operator entry): stop
        admission, wait for in-flight streams + the serving loop to
        settle, migrate every live session's chain to a survivor, and
        re-pin routing records.  On success the replica is left
        ``retiring`` (the caller retires/swaps it, or resumes with
        ``set_retiring(index, False)`` to cancel).  On ANY failure the
        replica RESUMES admission untouched — no session is ever
        stranded halfway."""
        r = self.router
        budget = (
            self.drain_timeout_s if timeout_s is None
            else float(timeout_s)
        )
        with r._lock:
            rep = r._replicas[index]
            already_retired = rep.retired
            server = rep.server
        if already_retired:
            return {"ok": False, "replica": index,
                    "reason": "already-retired"}
        if server is None:
            return {"ok": False, "replica": index,
                    "reason": "not-in-process"}
        t_wall = time.monotonic()
        r.set_retiring(index, True)
        deadline = t_wall + budget

        def _fail(reason: str, **extra: Any) -> Dict[str, Any]:
            r.set_retiring(index, False)
            with self._lock:
                self.drains_total += 1
                self.drains_failed_total += 1
            rec = {"ok": False, "replica": index, "reason": reason}
            rec.update(extra)
            r.decisions.record("drain", **rec)
            return rec

        # 1. In-flight streams finish on the source (admission is
        #    already off, so the count only falls).
        while True:
            with r._lock:
                infl = r._replicas[index].inflight
            if infl == 0:
                break
            if time.monotonic() >= deadline:
                return _fail("inflight-timeout", inflight=infl)
            time.sleep(0.01)
        # 2. The serving loop settles (work admitted before retiring).
        if not server.wait_idle(
            timeout_s=max(0.1, deadline - time.monotonic()),
        ):
            return _fail("serving-loop-busy")
        # 3. Enumerate every live session's chain.
        try:
            chains = server.call_on_loop(
                lambda b: b.resident_chain_keys(),
                timeout_s=max(0.1, deadline - time.monotonic()),
            )
        except (TimeoutError, RuntimeError, OSError) as e:
            return _fail(f"enumerate: {e}")
        # Deepest-first is deterministic and moves whole sessions
        # before their prefix-sharing shorter siblings.
        chains = sorted(chains, key=lambda c: (-len(c), c))
        mig_budget = (
            r.handoff_timeout_s if self.migrate_timeout_s is None
            else float(self.migrate_timeout_s)
        )
        migrated = skipped = failed = blocks = 0
        dst_counts: Dict[int, int] = {}
        failures: List[Dict[str, Any]] = []
        for i, chain in enumerate(chains):
            rid = f"drain-{index}-{i}"
            err = self._fire("session_migrate")
            if err is not None:
                # This session's move aborts; its copy stays on the
                # source, which resumes below — nobody is dropped.
                failed += 1
                failures.append(
                    {"chain": chain[0].hex()[:16], "reason": err},
                )
                continue
            dst = self._pick_destination(index)
            if dst is None:
                return _fail(
                    "no-survivor", sessions=len(chains),
                    migrated=migrated, failed=failed,
                )
            try:
                n, outcome = r._execute_migration(
                    index, dst, chain, request_id=rid,
                    timeout_s=mig_budget, demote=False,
                )
            except (TimeoutError, RuntimeError, OSError,
                    InjectedFault) as e:
                failed += 1
                failures.append({
                    "chain": chain[0].hex()[:16], "dst": dst,
                    "reason": str(e) or type(e).__name__,
                })
                continue
            if outcome == "completed":
                migrated += 1
                blocks += n
                dst_counts[dst] = dst_counts.get(dst, 0) + 1
            else:
                skipped += 1  # nothing-resident / already at dst
        with self._lock:
            self.sessions_migrated_total += migrated
            self.sessions_migrate_failed_total += failed
        if failed:
            return _fail(
                "migration-failures", sessions=len(chains),
                migrated=migrated, failed=failed, skipped=skipped,
                failures=failures[:8],
            )
        # 4. Re-pin routing records + affinity to the survivor that
        #    received the most sessions (cache-aware routing finds
        #    per-chain placements through the index regardless).
        repin_dst = (
            max(dst_counts, key=lambda k: dst_counts[k])
            if dst_counts else None
        )
        repinned = (
            r.repin_routes(index, repin_dst)
            if repin_dst is not None else 0
        )
        with self._lock:
            self.drains_total += 1
        rec = {
            "ok": True, "replica": index, "sessions": len(chains),
            "migrated": migrated, "skipped": skipped, "blocks": blocks,
            "destinations": {str(k): v for k, v in dst_counts.items()},
            "repinned": repinned,
            "dur_ms": round((time.monotonic() - t_wall) * 1000.0, 3),
        }
        r.decisions.record("drain", **rec)
        return rec

    def rollout(
        self, factory: Any, rollback_factory: Optional[Any] = None,
        expect_tokens: Optional[Sequence[int]] = None,
    ) -> Dict[str, Any]:
        """Zero-downtime rollout: replica-by-replica drain → swap to
        ``factory(index)``'s instance → canary gate.  Per rung the
        canary oracle is reset and a full sweep runs; the gate is the
        restarted replica's own probe — transport-clean AND its tokens
        matching the rollout oracle (pinned from the rung-0 probe, or
        from ``expect_tokens`` when the operator knows the new
        weights' expected canary output).  A failed gate auto-rolls
        the rung back through ``rollback_factory`` (without one the
        rung's replica is retired) and aborts the rollout.  After the
        last rung a final reset + sweep must be unanimously clean.
        Sessions are migrated off each rung before its restart, so no
        session is dropped even by a failed rung."""
        r = self.router
        if not self._begin_action():
            return {"ok": False, "reason": "action-in-progress"}
        with self._lock:
            self.rollouts_total += 1
            self._rollout_oracle = (
                list(expect_tokens) if expect_tokens is not None
                else None
            )
        with r._lock:
            plan = [x.index for x in r._replicas if not x.retired]
        results: List[Dict[str, Any]] = []
        ok_all = True
        reason: Optional[str] = None
        try:
            for rung, idx in enumerate(plan):
                with self._lock:
                    self.rollout_rung = rung
                err = self._fire("scale_event")
                if err is not None:
                    with self._lock:
                        self._scale_events["aborted"] += 1
                    r.decisions.record(
                        "rollout_rung", rung=rung, replica=idx,
                        ok=False, reason=err,
                    )
                    ok_all, reason = False, err
                    break
                report = self.drain_replica(idx)
                if not report.get("ok"):
                    r.decisions.record(
                        "rollout_rung", rung=rung, replica=idx,
                        ok=False,
                        reason=f"drain: {report.get('reason')}",
                    )
                    ok_all = False
                    reason = f"drain: {report.get('reason')}"
                    break
                with r._lock:
                    old = r._replicas[idx].server
                try:
                    fresh = factory(idx)
                except Exception as e:
                    r.set_retiring(idx, False)
                    r.decisions.record(
                        "rollout_rung", rung=rung, replica=idx,
                        ok=False, reason=f"factory: {e}",
                    )
                    ok_all, reason = False, f"factory: {e}"
                    break
                r.swap_replica(idx, fresh)
                with self._lock:
                    if not isinstance(fresh, str):
                        self._owned[idx] = fresh
                    else:
                        self._owned.pop(idx, None)
                self._stop_server(old)
                if r.health_interval_s <= 0:
                    r.check_health_now()
                gate_ok, why = self._rung_gate(idx)
                if gate_ok:
                    r.decisions.record(
                        "rollout_rung", rung=rung, replica=idx,
                        ok=True, gate=why,
                        migrated=report.get("migrated"),
                    )
                    results.append(
                        {"rung": rung, "replica": idx, "ok": True},
                    )
                    continue
                rb = self._rollback_rung(idx, fresh, rollback_factory)
                with self._lock:
                    self.rollbacks_total += 1
                r.decisions.record(
                    "rollout_rung", rung=rung, replica=idx, ok=False,
                    reason=f"canary-gate: {why}", rollback=rb,
                )
                results.append({
                    "rung": rung, "replica": idx, "ok": False,
                    "reason": why, "rollback": rb,
                })
                ok_all, reason = False, f"canary-gate: {why}"
                break
            if ok_all:
                r.reset_canary_oracle()
                sweep = r.run_canaries_now()
                bad = [i for i, res in sweep if not res.get("ok")]
                if bad:
                    ok_all = False
                    reason = f"final-sweep-unclean: {bad}"
            r.decisions.record(
                "rollout", ok=ok_all, rungs_done=len(results),
                planned=len(plan), reason=reason,
            )
            return {"ok": ok_all, "rungs": results,
                    "planned": len(plan), "reason": reason}
        finally:
            with self._lock:
                self.rollout_rung = -1
                self._rollout_oracle = None
            self._end_action(True)

    def _rung_gate(self, idx: int) -> Tuple[bool, str]:
        """One rung's canary gate: reset the fleet oracle, sweep, and
        judge the restarted replica by its OWN probe against the
        rollout oracle — mid-rollout the fleet majority still runs old
        weights, so the sweep's plurality oracle cannot be trusted to
        judge the new output."""
        r = self.router
        r.reset_canary_oracle()
        sweep = dict(r.run_canaries_now())
        res = sweep.get(idx)
        if res is None:
            return False, "no-canary-result"
        tokens = res.get("tokens")
        if res.get("error") is not None or not tokens:
            return False, (
                f"probe-failed: {res.get('error') or 'no-tokens'}"
            )
        with self._lock:
            oracle = self._rollout_oracle
            if oracle is None:
                self._rollout_oracle = list(tokens)
                return True, "oracle-pinned"
        if list(tokens) == list(oracle):
            return True, "oracle-match"
        return False, "oracle-mismatch"

    def _rollback_rung(
        self, idx: int, bad_server: Any, rollback_factory: Optional[Any],
    ) -> str:
        """Undo one failed rung: swap the slot back to a
        ``rollback_factory(index)`` instance (old weights) — or,
        without one, retire the slot (its sessions already live on
        survivors).  The bad instance is stopped either way."""
        r = self.router
        if rollback_factory is None:
            r.retire_replica(idx)
            with self._lock:
                self._owned.pop(idx, None)
            self._stop_server(bad_server)
            return "retired"
        try:
            prev = rollback_factory(idx)
        except Exception as e:
            r.retire_replica(idx)
            with self._lock:
                self._owned.pop(idx, None)
            self._stop_server(bad_server)
            return f"retired (rollback factory failed: {e})"
        r.swap_replica(idx, prev)
        with self._lock:
            if not isinstance(prev, str):
                self._owned[idx] = prev
            else:
                self._owned.pop(idx, None)
        self._stop_server(bad_server)
        if r.health_interval_s <= 0:
            r.check_health_now()
        return "rolled-back"

    # -- introspection -------------------------------------------------------

    def state_json(self) -> Dict[str, Any]:
        """/debug/fleet's ``controller`` block."""
        with self._lock:
            return {
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "interval_s": self.interval_s,
                "attainment_floor": self.attainment_floor,
                "queue_wait_high_ms": self.queue_wait_high_ms,
                "occupancy_low": self.occupancy_low,
                "dwell_s": self.dwell_s,
                "cooldown_s": self.cooldown_s,
                "busy": self._busy,
                "rollout_rung": self.rollout_rung,
                "scale_events": dict(self._scale_events),
                "sessions_migrated_total": self.sessions_migrated_total,
                "sessions_migrate_failed_total":
                    self.sessions_migrate_failed_total,
                "drains_total": self.drains_total,
                "drains_failed_total": self.drains_failed_total,
                "rollouts_total": self.rollouts_total,
                "rollbacks_total": self.rollbacks_total,
                "last_signals": (
                    dict(self._last_signals)
                    if self._last_signals else None
                ),
            }

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The /metrics families the router exposition renders."""
        with self._lock:
            return {
                "scale_events": dict(self._scale_events),
                "sessions_migrated": self.sessions_migrated_total,
                "rollout_rung": self.rollout_rung,
            }


def handoff_prefix(
    src_batcher, dst_batcher, tokens: Sequence[int],
    router: Optional[ReplicaRouter] = None,
    request_id: Optional[str] = None,
    src: Optional[int] = None,
    dst: Optional[int] = None,
) -> int:
    """Prefill/decode disaggregation handoff: move ``tokens``' cached
    prefix blocks from ``src_batcher`` (which prefilled them) into
    ``dst_batcher``'s pool + radix index, so the session's next
    admission on the destination replica is a plain prefix hit —
    ``export_prefix``'s D2H slab fetch feeding ``import_prefix``'s
    stage/adopt/publish, the exact path the host-DRAM tier restores
    through.  Both batcher calls MUST run on their owning serving-loop
    threads (the batchers are thread-confined).  ``request_id`` (the
    session's external id) threads through both batchers' trace
    annotations and the router's handoff span, so the fleet-merged
    trace shows the move as ONE linked timeline; ``src``/``dst`` are
    the replica indices when the caller knows them.  Returns the
    number of blocks landed on the destination."""
    keys, slabs = src_batcher.export_prefix(tokens, request_id=request_id)
    if not slabs:
        return 0
    n = dst_batcher.import_prefix(keys, slabs, request_id=request_id)
    if router is not None:
        router.note_handoff(n, request_id=request_id, src=src, dst=dst)
    return n
