"""Lock-discipline checker: guarded fields and thread confinement (port
of ``jax_llama_tpu/analysis/lockcheck.py``, the registry over the port's
classes).

The serving stack has exactly two concurrency disciplines:

  * **Lock-guarded classes** (``obs.Observability``,
    ``degrade.DegradeManager``, the ``LLMServer`` profiler state, the
    lockstep ``Leader``'s record counters) and **lock-guarded module
    state** (``utils/profiling.py``'s process-wide profiler claim):
    every access to the registered fields must happen inside a
    ``with self.<lock>:`` block, in a method whose name ends in
    ``_locked`` (the repo's existing convention for
    called-with-lock-held helpers), or on a line / ``def`` carrying an
    ``# audit: locked(<why the lock is held>)`` pragma.  A module guard
    (``cls=None``) names module-level globals and a module-level lock:
    every read or write of them in any function of the module must sit
    inside ``with <lock>:``.
  * **Owner-thread confinement** (``ContinuousBatcher``,
    ``LLMServer``): the batcher has NO lock by design -- one serving
    loop thread owns it, and every CUDA call of the dispatch path runs
    there lock-free (server.py module docstring).  The registry therefore declares the
    confined fields and the *foreign* methods (code that provably runs
    on HTTP-handler / watchdog threads); any access to a confined
    field from a foreign method — or through a holder attribute like
    ``server.batcher`` / the handler closure's ``server`` from another
    class — must carry ``# audit: racy-read(<why a stale/ torn view is
    acceptable>)`` or ``# audit: unguarded(<single-writer argument>)``.

The pragma is the point: every cross-thread touch of batcher state is
greppable, with its safety argument attached, and a new unannotated
one fails ``python -m jax_llama_tpu_torch.analysis`` (and tier-1)
instead of waiting for a race to reproduce.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .common import (
    Finding, Pragmas, def_line_span, iter_package_sources, node_span,
    parse_module,
)

CHECKER = "lock-discipline"


@dataclasses.dataclass(frozen=True)
class LockGuard:
    """Fields of ``cls`` that may only be touched under ``self.<lock>``;
    with ``cls=None``, module-level globals that may only be touched
    under the module-level ``<lock>``."""

    module: str                  # module basename, e.g. "obs"
    cls: Optional[str]
    lock: str                    # e.g. "_lock"
    fields: frozenset
    exempt_methods: frozenset = frozenset({"__init__"})


@dataclasses.dataclass(frozen=True)
class ThreadConfinement:
    """Fields of ``cls`` owned by one thread (the serving loop).

    ``fields``: reads AND writes are owner-only.
    ``write_fields``: only writes are owner-only (snapshot reads of
    single-writer counters/gauges are the /metrics contract).
    ``foreign_methods``: methods of ``cls`` that run on non-owner
    threads; confined-field accesses there need a pragma.
    ``holders``: expressions that alias the instance from OTHER
    classes/modules ("batcher" = ``<x>.batcher.<field>``, "server" =
    the handler closure's ``server.<field>``); accesses through them
    need a pragma anywhere they appear.
    """

    module: str
    cls: str
    owner: str                   # prose: who owns it
    fields: frozenset
    write_fields: frozenset = frozenset()
    foreign_methods: frozenset = frozenset()
    holders: frozenset = frozenset()
    exempt_methods: frozenset = frozenset({"__init__"})


# ---------------------------------------------------------------------------
# The serving stack's registry
# ---------------------------------------------------------------------------

LOCK_GUARDS: Tuple[LockGuard, ...] = (
    LockGuard(
        module="obs", cls="Observability", lock="_lock",
        fields=frozenset({
            "_seq", "dispatches", "events", "_timelines", "_by_rid",
            "hist", "hist_dispatch", "_slo_window", "_util",
            "compiles", "compiles_total", "compiles_by_program",
            "requests_finished_total", "requests_failed_total",
            "requests_cancelled_total", "requests_slo_ok_total",
            "goodput_tokens_total", "metric_snapshots",
        }),
    ),
    # Decision audit log (obs.py): serving-loop / poller / canary /
    # handler threads record while /debug/decisions snapshots — a
    # leaf lock never held while calling out.
    LockGuard(
        module="obs", cls="DecisionLog", lock="_lock",
        fields=frozenset({"_ring", "_seq", "counts"}),
    ),
    # Structured logger (obs.py): every thread that logs appends to
    # the flight-recorder tail ring; /debug/bundle snapshots it.
    LockGuard(
        module="obs", cls="StructuredLogger", lock="_lock",
        fields=frozenset({"_ring"}),
    ),
    LockGuard(
        module="degrade", cls="DegradeManager", lock="_lock",
        fields=frozenset({"_features"}),
    ),
    # The live profiler (server.py): handler threads start, stop and
    # read the session; the loop's way out closes it.
    LockGuard(
        module="server", cls="LLMServer", lock="_profiler_lock",
        fields=frozenset({
            "_profiler", "_profiler_dir", "_profiler_last_dir",
        }),
    ),
    # The process's one torch.profiler claim (utils/profiling.py): a
    # second session started on another thread while one ran crashed the
    # interpreter, so every server's sessions take the claim under it.
    LockGuard(
        module="profiling", cls=None, lock="_CLAIM_LOCK",
        fields=frozenset({"_CLAIMED_BY"}),
    ),
    # The lockstep log's leader (parallel/lockstep.py): every record runs
    # under its lock (``_run_locked``, from the serving loop, the
    # router's threads and the heartbeat thread); its counters are
    # written there and read by ``stats()``.
    LockGuard(
        module="lockstep", cls="Leader", lock="_lock",
        fields=frozenset({
            "index", "records", "publish_ms_total", "agree_ms_total",
        }),
    ),
    # Overload controller (overload.py): HTTP handler threads call
    # admit() while the serving loop pushes/pops/ticks — every access
    # to the queues, EWMAs, ladder state, and counters goes under the
    # one lock (its dispatch-record ingest is called OUTSIDE the obs
    # lock, so the two locks never nest in either order).
    LockGuard(
        module="overload", cls="OverloadController", lock="_lock",
        fields=frozenset({
            "_queues", "_queued_tokens", "_inflight_tokens",
            "_prefill_tps", "_decode_tps",
            "_rung", "_rung_since", "_pressure_since", "_calm_since",
            "_slo_windows", "_wait_window",
            "transitions_total", "sheds_total",
            "refused_backlog_total", "refused_deadline_total",
            "refused_batch_total", "ttft_estimate_last_ms",
        }),
    ),
    # Replica router (router.py): HTTP handler threads (forward /
    # metrics / healthz), the health-poller thread, and the handoff
    # worker share the replica table, sticky-session map, routing
    # counters, the router-local trace ring, the request-id routing
    # record, the handoff scheduler's dedup/bounds/outcome state, and
    # the cached fleet cache view — every access goes under the one
    # lock.  The router holds no jax state.
    LockGuard(
        module="router", cls="ReplicaRouter", lock="_lock",
        fields=frozenset({
            "_replicas", "_affinity", "routed_by_policy",
            "reroutes_total", "replica_failures_total",
            "kv_handoffs_total", "_trace", "_routes",
            "affinity_stale_routes_total", "_fleet_kv",
            "cache_stale_routes_total",
            "cache_hit_depth_blocks_total",
            "_handoff_chains", "_handoff_bytes_inflight",
            "handoffs_scheduled_total", "handoffs_completed_total",
            "handoffs_aborted_total", "handoffs_skipped_total",
            "handoffs_empty_total", "handoff_blocks_total",
            "handoff_bytes_total", "_role_handoffs_pending",
            "canary_probes_total", "canary_failures_total",
            "canary_mismatches_total", "canary_oracle_repins_total",
            "_canary_oracle", "_canary_seq",
        }),
    ),
    # Elastic-fleet controller (router.py): the background control
    # loop, operator HTTP handlers (drain/rollout entries), and the
    # /metrics + /debug/fleet renderers share the counters and
    # hysteresis state — all under the controller's own leaf lock
    # (compute under it, act outside it: never held while calling the
    # router or a replica, so it never nests with router._lock in
    # either order).
    LockGuard(
        module="router", cls="FleetController", lock="_lock",
        fields=frozenset({
            "_scale_events", "sessions_migrated_total",
            "sessions_migrate_failed_total",
            "drains_total", "drains_failed_total",
            "rollouts_total", "rollbacks_total", "rollout_rung",
            "_pressure_since", "_calm_since", "_last_action_t",
            "_busy", "_last_signals", "_owned", "_rollout_oracle",
        }),
    ),
    # Per-replica health sentinel (router.py): the canary prober and
    # the health poller feed observations while handler threads read
    # /debug/fleet and /metrics — all state under the sentinel's own
    # leaf lock (never held while calling out; the router lock is
    # never taken inside).
    LockGuard(
        module="router", cls="HealthSentinel", lock="_lock",
        fields=frozenset({"_states", "anomalies_total"}),
    ),
    # Router-side global radix index (router.py): the health poller
    # writes syncs, handler threads read lookups at pick time, the
    # handoff worker applies optimistic post-migration updates — all
    # under the index's own leaf lock (lock order router -> index,
    # never inverted: the sync/lookup paths take only this lock).
    LockGuard(
        module="router", cls="RouterRadixIndex", lock="_lock",
        fields=frozenset({
            "_by_replica", "_synced", "_epoch", "_block_bytes",
            "syncs_total", "resyncs_total", "events_applied_total",
        }),
    ),
    # KV chain digest (kvcache.py): the serving loop mutates it at
    # every prefix-store content mutation while HTTP handler threads
    # read /debug/kv, /healthz kv.digest, and the stats() gauges — the
    # ONE piece of KV-cache state that is legitimately cross-thread,
    # so every field lives under its own leaf lock (taken nowhere else
    # while another lock is held).
    LockGuard(
        module="kvcache", cls="KvDigest", lock="_lock",
        fields=frozenset({
            "_entries", "_seq", "_hash", "_hbm", "_host", "_idle",
            "version", "loss_version", "depth_max",
            "publishes_total", "evictions_total", "demotions_total",
            "restores_total", "host_evictions_total", "_journal",
        }),
    ),
)

CONFINEMENTS: Tuple[ThreadConfinement, ...] = (
    ThreadConfinement(
        module="serving", cls="ContinuousBatcher",
        owner="the serving-loop thread (single owner; no lock by "
              "design -- the dispatch path stays lock-free)",
        fields=frozenset({
            # block-table / per-slot decode state + their device twins
            "table", "fill", "pos", "active", "tau", "d_tau_lp",
            "generators", "remaining", "stop_tab", "pool", "draft_pool",
            "_dirty_rows", "_unsettled",
            # admission machinery
            "slots", "queue", "free_blocks", "_block_refs", "_store",
            "_pf", "_restoring", "_restored_ready", "failed",
            "_accept_window",
        }),
        # /metrics snapshot-reads single-writer counters; only WRITES
        # are confined for them.
        write_fields=frozenset({
            "host_syncs_total", "state_uploads_total", "emitted_total",
            "steps_total", "decode_dispatches_total",
        }),
        # Methods documented/observed to run on HTTP-handler threads.
        foreign_methods=frozenset({
            "stats", "_window_acceptance", "acceptance_rate",
            "kv_debug_json", "_kv_summary",
            # Ctor-stable config snapshot for /debug/bundle — touches
            # no confined field by construction.
            "describe",
        }),
        holders=frozenset({"batcher"}),
    ),
    ThreadConfinement(
        module="server", cls="LLMServer",
        owner="the serving-loop thread",
        fields=frozenset({
            "_active", "_pending_success", "_recovery_times",
        }),
        write_fields=frozenset({
            "batcher", "ttft_ms_ewma", "itl_ms_ewma",
            "recoveries_total",
            "quarantine_rebuilds_total", "probe_rebuilds_total",
            "nonfinite_failed_total", "watchdog_stalls_total",
            "_stalled", "_heartbeat", "canary_requests_total",
            "_last_flight_t",
        }),
        foreign_methods=frozenset({
            "_watchdog", "_health", "_metrics_text",
            "_metrics_scalars",
            "_handle_profiler", "_retry_after_s", "begin_drain",
            "wait_drained", "draining", "address", "stop", "start",
            # The handoff scheduler's control path: queues work for
            # the loop thread (thread-safe queue) and waits on the
            # call's own event — no confined field is touched.
            "call_on_loop",
            # Flight-recorder artifact assembly (handler threads):
            # snapshot reads through the same racy-read surfaces
            # /metrics and /healthz already use.
            "bundle_json", "_config_snapshot",
        }),
        holders=frozenset({"server"}),
    ),
)


# ---------------------------------------------------------------------------
# Checker
# ---------------------------------------------------------------------------

def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _WithLockTracker(ast.NodeVisitor):
    """Visit a method body tracking ``with self.<lock>:`` nesting and
    reporting guarded-field accesses outside it."""

    def __init__(self, guard: LockGuard, path: str, method: str,
                 fn: ast.FunctionDef, pragmas: Pragmas,
                 findings: List[Finding]):
        self.guard = guard
        self.path = path
        self.method = method
        self.fn = fn
        self.pragmas = pragmas
        self.findings = findings
        self.lock_depth = 0
        self._stmt_stack: List[ast.stmt] = []

    def visit(self, node: ast.AST):
        if isinstance(node, ast.stmt):
            self._stmt_stack.append(node)
            try:
                return super().visit(node)
            finally:
                self._stmt_stack.pop()
        return super().visit(node)

    def _holds_lock(self, item: ast.withitem) -> bool:
        return _self_attr(item.context_expr) == self.guard.lock

    def visit_With(self, node: ast.With):
        held = any(self._holds_lock(i) for i in node.items)
        if held:
            self.lock_depth += 1
        try:
            self.generic_visit(node)
        finally:
            if held:
                self.lock_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if node is self.fn:
            self.generic_visit(node)
        # nested defs inherit the surrounding analysis conservatively:
        # skip (they are closures invoked who-knows-where; accesses in
        # them would need their own pragma anyway)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute):
        attr = _self_attr(node)
        if (
            attr in self.guard.fields
            and self.lock_depth == 0
            and not self.method.endswith("_locked")
        ):
            spans = [node_span(node), def_line_span(self.fn)]
            if self._stmt_stack:
                spans.append(node_span(self._stmt_stack[-1]))
            if not (
                self.pragmas.allows("locked", *spans)
                or self.pragmas.allows("unguarded", *spans)
            ):
                self.findings.append(Finding(
                    checker=CHECKER, rule="unlocked-access",
                    sanctionable=True,
                    path=self.path, line=node.lineno,
                    message=(
                        f"{self.guard.cls}.{self.method} touches "
                        f"self.{attr} outside `with self."
                        f"{self.guard.lock}` (annotate with # audit: "
                        "locked(...) if the caller holds it, or "
                        "rename the method *_locked)"
                    ),
                ))
        self.generic_visit(node)


class _ModuleLockTracker(ast.NodeVisitor):
    """One function's accesses to a module guard's globals, tracking
    ``with <lock>:`` nesting (nested defs are walked on their own)."""

    def __init__(self, guard: LockGuard, path: str, fn: ast.AST,
                 pragmas: Pragmas, findings: List[Finding]):
        self.guard = guard
        self.path = path
        self.fn = fn
        self.pragmas = pragmas
        self.findings = findings
        self.lock_depth = 0
        self._stmt_stack: List[ast.stmt] = []

    def visit(self, node: ast.AST):
        if isinstance(node, ast.stmt):
            self._stmt_stack.append(node)
            try:
                return super().visit(node)
            finally:
                self._stmt_stack.pop()
        return super().visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        if node is self.fn:
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node: ast.With):
        held = any(
            isinstance(i.context_expr, ast.Name)
            and i.context_expr.id == self.guard.lock for i in node.items
        )
        self.lock_depth += held
        try:
            self.generic_visit(node)
        finally:
            self.lock_depth -= held

    def visit_Name(self, node: ast.Name):
        if (node.id in self.guard.fields and self.lock_depth == 0
                and not self.fn.name.endswith("_locked")):
            spans = [node_span(node), def_line_span(self.fn)]
            if self._stmt_stack:
                spans.append(node_span(self._stmt_stack[-1]))
            if not (self.pragmas.allows("locked", *spans)
                    or self.pragmas.allows("unguarded", *spans)):
                self.findings.append(Finding(
                    checker=CHECKER, rule="unlocked-access",
                    sanctionable=True, path=self.path, line=node.lineno,
                    message=(
                        f"{self.fn.name} touches the module state "
                        f"{node.id} outside `with {self.guard.lock}` "
                        "(annotate with # audit: locked(...) if the "
                        "caller holds it)"
                    ),
                ))


class LockDisciplineChecker:
    """Registry-driven lock/confinement audit (module docstring)."""

    def __init__(
        self,
        lock_guards: Sequence[LockGuard] = LOCK_GUARDS,
        confinements: Sequence[ThreadConfinement] = CONFINEMENTS,
    ):
        self.lock_guards = tuple(lock_guards)
        self.confinements = tuple(confinements)

    # -- per-source ----------------------------------------------------------

    def check_source(self, path: str, source: str,
                     module: Optional[str] = None) -> List[Finding]:
        module = module or path.rsplit("/", 1)[-1].replace(".py", "")
        tree, findings = parse_module(path, source, CHECKER)
        if tree is None:
            return findings
        pragmas = Pragmas.scan(source)

        classes: Dict[str, ast.ClassDef] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node

        for guard in self.lock_guards:
            if guard.module != module:
                continue
            if guard.cls is None:
                self._check_module_guard(guard, path, tree, pragmas,
                                         findings)
            elif guard.cls in classes:
                self._check_lock_guard(
                    guard, path, classes[guard.cls], pragmas, findings
                )
        for conf in self.confinements:
            if conf.module == module and conf.cls in classes:
                self._check_confinement_intra(
                    conf, path, classes[conf.cls], pragmas, findings
                )
        # Holder accesses apply to EVERY audited module (the handler
        # closure's ``server`` lives inside server.py itself; the
        # batcher holder is reached from server.py).
        self._check_holders(path, tree, pragmas, findings, module)
        return findings

    def _check_lock_guard(self, guard: LockGuard, path: str,
                          cls: ast.ClassDef, pragmas: Pragmas,
                          findings: List[Finding]) -> None:
        for node in cls.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            if node.name in guard.exempt_methods:
                continue
            _WithLockTracker(
                guard, path, node.name, node, pragmas, findings
            ).visit(node)

    def _check_module_guard(self, guard: LockGuard, path: str,
                            tree: ast.Module, pragmas: Pragmas,
                            findings: List[Finding]) -> None:
        """Every function of the module (methods included) touches the
        guarded globals only inside ``with <lock>:``."""
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            _ModuleLockTracker(guard, path, fn, pragmas, findings).visit(fn)

    def _check_confinement_intra(
        self, conf: ThreadConfinement, path: str, cls: ast.ClassDef,
        pragmas: Pragmas, findings: List[Finding],
    ) -> None:
        declared_missing = conf.foreign_methods - {
            n.name for n in cls.body if isinstance(n, ast.FunctionDef)
        }
        for name in sorted(declared_missing):
            findings.append(Finding(
                checker=CHECKER, rule="stale-registry", path=path,
                line=cls.lineno,
                message=(
                    f"{conf.cls} registry lists foreign method "
                    f"{name!r} which no longer exists"
                ),
            ))
        for node in cls.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            foreign = node.name in conf.foreign_methods
            if not foreign:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Attribute):
                    continue
                attr = _self_attr(sub)
                if attr is None:
                    continue
                is_write = isinstance(sub.ctx, (ast.Store, ast.Del))
                relevant = attr in conf.fields or (
                    attr in conf.write_fields and is_write
                )
                if not relevant:
                    continue
                spans = (node_span(sub), def_line_span(node),
                         self._stmt_span(node, sub))
                if pragmas.allows("racy-read", *spans) or \
                        pragmas.allows("unguarded", *spans):
                    continue
                findings.append(Finding(
                    checker=CHECKER, rule="foreign-thread-access",
                    sanctionable=True,
                    path=path, line=sub.lineno,
                    message=(
                        f"{conf.cls}.{node.name} (runs off the owner "
                        f"thread) {'writes' if is_write else 'reads'} "
                        f"self.{attr}, which is confined to "
                        f"{conf.owner} (annotate # audit: "
                        "racy-read(...) / unguarded(...) with the "
                        "safety argument, or move it onto the loop)"
                    ),
                ))

    def _check_holders(self, path: str, tree: ast.Module,
                       pragmas: Pragmas, findings: List[Finding],
                       module: str) -> None:
        # find the enclosing statement for span-level pragmas
        parents: Dict[ast.AST, ast.stmt] = {}

        def index(node: ast.AST, stmt: Optional[ast.stmt]):
            if isinstance(node, ast.stmt):
                stmt = node
            for child in ast.iter_child_nodes(node):
                if stmt is not None:
                    parents[child] = stmt
                index(child, stmt)

        index(tree, None)

        for conf in self.confinements:
            if not conf.holders:
                continue
            confined = conf.fields | conf.write_fields
            for node in ast.walk(tree):
                if not isinstance(node, ast.Attribute):
                    continue
                if node.attr not in confined:
                    continue
                base = node.value
                via_holder = (
                    isinstance(base, ast.Name)
                    and base.id in conf.holders
                ) or (
                    isinstance(base, ast.Attribute)
                    and base.attr in conf.holders
                )
                if not via_holder:
                    continue
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
                if node.attr in conf.write_fields and not is_write:
                    continue
                stmt = parents.get(node)
                spans = [node_span(node)]
                if stmt is not None:
                    spans.append(node_span(stmt))
                if pragmas.allows("racy-read", *spans) or \
                        pragmas.allows("unguarded", *spans):
                    continue
                holder_name = (
                    base.id if isinstance(base, ast.Name) else base.attr
                )
                findings.append(Finding(
                    checker=CHECKER, rule="foreign-thread-access",
                    sanctionable=True,
                    path=path, line=node.lineno,
                    message=(
                        f"access to {conf.cls} state "
                        f"`{holder_name}.{node.attr}`: the field is "
                        f"confined to {conf.owner} (annotate "
                        "# audit: racy-read(...) or route through "
                        "the owner)"
                    ),
                ))

    @staticmethod
    def _stmt_span(fn: ast.FunctionDef, node: ast.AST) -> Tuple[int, int]:
        """Span of the smallest simple statement in ``fn`` containing
        ``node`` — the unit one pragma comment covers."""
        target = getattr(node, "lineno", 0)
        best = node_span(node)
        best_width = None
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.stmt) or isinstance(
                stmt, (ast.If, ast.For, ast.While, ast.With, ast.Try,
                       ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef)
            ):
                continue
            lo, hi = node_span(stmt)
            if lo <= target <= hi and (
                best_width is None or hi - lo < best_width
            ):
                best, best_width = (lo, hi), hi - lo
        return best

    # -- package -------------------------------------------------------------

    def check_package(self) -> List[Finding]:
        modules = sorted({
            g.module for g in self.lock_guards
        } | {c.module for c in self.confinements})
        out: List[Finding] = []
        for path, source in iter_package_sources(only=modules):
            out.extend(self.check_source(path, source))
        return out
