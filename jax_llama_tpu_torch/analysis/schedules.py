"""Schedule explorer: checked models for every cross-thread pragma (port
of ``jax_llama_tpu/analysis/schedules.py``; the models run the port's
real classes).

The lock-discipline checker (lockcheck.py) lets a cross-thread access
through on the strength of an ``# audit: racy-read(<argument>)`` /
``# audit: unguarded(<argument>)`` pragma -- trusted PROSE.  This pass
elevates each such pragma to a CHECKED claim: a small deterministic
model that drives the declared thread pair through instrumented
schedules over the real classes (the real ``ContinuousBatcher.stats``
/ ``LLMServer._health`` methods run against stub instances built from
real stores, deques and events) under a virtual clock, asserting the
annotated access really is snapshot-safe / single-writer under
exhaustive interleavings of the declared critical regions.  A pragma
with no model -- or a model whose exploration finds a counterexample --
fails ``python -m jax_llama_tpu_torch.analysis``.

Two explorers, matched to the two claim shapes:

  * **Preemption explorer** (``snapshot`` claims, real reader
    methods): the reader runs in its own thread under a
    ``sys.settrace`` line hook; for every line boundary ``cut`` and
    every split of the writer's atomic ops, the schedule pauses the
    reader at ``cut``, runs the op prefix, resumes the reader to
    completion, then runs the suffix.  That explores every placement
    of the writer's critical regions against every intra-reader
    preemption point -- exactly the TOCTOU class of a ``stats()`` that
    read ``self._pf`` twice: a reader that dereferences
    loop-owned state twice fails the schedule where the writer's
    nulling op lands between the two lines.
  * **Atomic explorer** (``single-writer`` / ``happens-before``
    claims): threads are lists of named atomic ops with declared
    write-sets; every interleaving (honoring declared happens-before
    edges) runs against fresh state, and the write-sets are checked
    structurally -- a field written by two threads voids a
    single-writer claim no schedule needs to find.

``owner-thread`` claims (loop-thread code reading through its own
holder alias) run their accesses sequentially on one thread -- the
model documents WHY there is no concurrency to explore, and keeps the
pragma's claim in a place the checker can fail when the claim rots
(e.g. the method disappears).

Models register in :data:`MODELS`, keyed by the pragma's enclosing
``(module, function)``.  The site scan finds every ``racy-read`` /
``unguarded`` pragma in the package; a site without a model is an
``unmodeled-pragma`` finding, a model without a site is
``stale-model``.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .common import Finding, Pragmas, iter_package_sources, parse_module

CHECKER = "schedules"

_MAX_SCHEDULES = 20000
_MAX_CUTS = 160


@dataclasses.dataclass(frozen=True)
class Op:
    """One atomic step of a modeled thread (a declared critical
    region: everything inside runs without preemption, matching the
    GIL-atomicity the pragmas' arguments lean on)."""

    name: str
    fn: Callable[[Any, int], None]       # (state, virtual clock)
    writes: frozenset = frozenset()      # state fields this op writes


@dataclasses.dataclass(frozen=True)
class ScheduleModel:
    """A checked safety argument for one pragma site."""

    name: str
    module: str                           # pragma site: module basename
    func: str                             # pragma site: enclosing def
    claim: str                            # snapshot | single-writer |
                                          # happens-before | owner-thread
    make: Callable[[], Any]               # fresh shared state
    writers: Dict[str, Tuple[Op, ...]]    # thread -> atomic ops
    reader: Optional[Callable[[Any], Any]] = None   # preemptible
    check: Optional[Callable[[Any, Any], None]] = None
    # Name of the function whose LINES are the preemption points
    # (default: the site function).  Only that frame is traced -- a
    # pause inside a nested call could sit on a C-level mutex (e.g.
    # queue.qsize) and deadlock the writer instead of racing it; the
    # annotated code's own lines are the TOCTOU surface under audit.
    trace_fn: Optional[str] = None
    # happens-before edges: thread -> (other thread, op name) that
    # must complete before the keyed thread's first op may run.
    after: Dict[str, Tuple[str, str]] = dataclasses.field(
        default_factory=dict
    )


# ---------------------------------------------------------------------------
# Explorers
# ---------------------------------------------------------------------------

def _make_tracer(model: ScheduleModel, on_line: Callable[[], None]):
    """A settrace handler firing ``on_line`` only inside the frame(s)
    of the model's traced function (see ScheduleModel.trace_fn)."""
    name = model.trace_fn or model.func

    def line_tracer(frame, event, arg):
        if event == "line":
            on_line()
        return line_tracer

    def global_tracer(frame, event, arg):
        if event == "call" and frame.f_code.co_name == name:
            return line_tracer
        return None

    return global_tracer


def _reader_line_count(model: ScheduleModel) -> int:
    """Dry-run the reader counting line events (the preemption points)."""
    state = model.make()
    count = [0]

    def bump():
        count[0] += 1

    tracer = _make_tracer(model, bump)

    def run():
        sys.settrace(tracer)
        try:
            model.reader(state)
        except BaseException:  # noqa: BLE001 - schedules judge errors
            pass  # the cut=0 schedule reports it with context
        finally:
            sys.settrace(None)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=10)
    return count[0]


def _preempt_once(
    model: ScheduleModel, ops: Sequence[Op], cut: int, split: int,
) -> Optional[str]:
    """One schedule: reader runs to line ``cut``, pauses; ops[:split]
    run; reader resumes to completion; ops[split:] run.  Returns a
    failure description or None."""
    state = model.make()
    paused = threading.Event()
    resume = threading.Event()
    err: Dict[str, BaseException] = {}
    out: Dict[str, Any] = {}
    count = [0]

    def on_line():
        count[0] += 1
        if count[0] == cut:
            paused.set()
            resume.wait(timeout=5)

    tracer = _make_tracer(model, on_line)

    def run():
        sys.settrace(tracer)
        try:
            out["v"] = model.reader(state)
        except BaseException as e:  # noqa: BLE001 - the verdict itself
            err["e"] = e
        finally:
            sys.settrace(None)
            paused.set()

    t = threading.Thread(target=run, daemon=True)
    if cut == 0:
        # writer prefix strictly before the reader starts
        for clock, op in enumerate(ops[:split]):
            op.fn(state, clock)
        t.start()
    else:
        t.start()
        if not paused.wait(timeout=5):
            return f"reader hung before line {cut}"
        for clock, op in enumerate(ops[:split]):
            op.fn(state, cut + clock)
        resume.set()
    t.join(timeout=10)
    if t.is_alive():
        return f"reader hung (cut={cut}, split={split})"
    for clock, op in enumerate(ops[split:]):
        op.fn(state, cut + split + clock)
    schedule = (
        f"cut@line{cut} after "
        f"[{', '.join(o.name for o in ops[:split])}]"
    )
    if "e" in err:
        e = err["e"]
        return (
            f"reader raised {type(e).__name__}: {e} under schedule "
            f"{schedule}"
        )
    if model.check is not None:
        try:
            model.check(state, out.get("v"))
        except AssertionError as e:
            return f"check failed ({e}) under schedule {schedule}"
    return None


def _explore_preempt(model: ScheduleModel) -> List[str]:
    failures: List[str] = []
    lines = min(_reader_line_count(model), _MAX_CUTS)
    for thread, ops in sorted(model.writers.items()):
        for cut in range(0, lines + 1):
            for split in range(0, len(ops) + 1):
                fail = _preempt_once(model, ops, cut, split)
                if fail:
                    failures.append(f"[{thread}] {fail}")
                    if len(failures) >= 3:
                        return failures
    return failures


def _explore_atomic(model: ScheduleModel) -> List[str]:
    """Exhaustive interleavings of the threads' atomic op lists,
    honoring happens-before edges."""
    threads = sorted(model.writers.items())
    failures: List[str] = []
    counted = [0]

    def run_schedule(order: List[Tuple[str, Op]]) -> Optional[str]:
        state = model.make()
        try:
            for clock, (tname, op) in enumerate(order):
                op.fn(state, clock)
        except BaseException as e:  # noqa: BLE001 - the verdict
            return (
                f"{type(e).__name__}: {e} under schedule "
                f"[{', '.join(t + ':' + o.name for t, o in order)}]"
            )
        if model.check is not None:
            try:
                model.check(state, None)
            except AssertionError as e:
                return (
                    f"check failed ({e}) under schedule "
                    f"[{', '.join(t + ':' + o.name for t, o in order)}]"
                )
        return None

    def gen(pos: Dict[str, int], order: List[Tuple[str, Op]],
            done: Dict[str, set]):
        if counted[0] > _MAX_SCHEDULES or len(failures) >= 3:
            return
        complete = True
        for tname, ops in threads:
            i = pos[tname]
            if i >= len(ops):
                continue
            complete = False
            edge = model.after.get(tname)
            if edge is not None and i == 0:
                other, opname = edge
                if opname not in done.get(other, set()):
                    continue  # not enabled yet
            pos[tname] += 1
            order.append((tname, ops[i]))
            done.setdefault(tname, set()).add(ops[i].name)
            gen(pos, order, done)
            done[tname].discard(ops[i].name) if ops[i].name not in [
                o.name for o in ops[:i]
            ] else None
            order.pop()
            pos[tname] -= 1
        if complete:
            counted[0] += 1
            fail = run_schedule(order)
            if fail:
                failures.append(fail)

    gen({t: 0 for t, _ in threads}, [], {})
    if counted[0] == 0 and not failures:
        # An unsatisfiable after-edge (typo'd op/thread name, or a
        # renamed op) would otherwise make the claim pass VACUOUSLY.
        failures.append(
            "no complete schedule could be generated -- an `after` "
            "happens-before edge names a thread/op that never runs "
            "(typo or renamed op?)"
        )
    return failures


def _single_writer_violations(model: ScheduleModel) -> List[str]:
    owners: Dict[str, set] = {}
    for tname, ops in model.writers.items():
        for op in ops:
            for field in op.writes:
                owners.setdefault(field, set()).add(tname)
    return [
        f"field {field!r} is written by threads {sorted(ts)} -- the "
        "single-writer claim is structurally void"
        for field, ts in sorted(owners.items()) if len(ts) > 1
    ]


def explore(model: ScheduleModel) -> List[str]:
    """Run a model's exploration; [] means the claim held."""
    failures: List[str] = []
    if model.claim in ("single-writer", "snapshot"):
        failures.extend(_single_writer_violations(model))
    if model.claim == "owner-thread":
        # no concurrency by claim: one thread, program order
        state = model.make()
        clock = 0
        try:
            for _, ops in sorted(model.writers.items()):
                for op in ops:
                    op.fn(state, clock)
                    clock += 1
            if model.reader is not None:
                result = model.reader(state)
                if model.check is not None:
                    model.check(state, result)
        except BaseException as e:  # noqa: BLE001 - the verdict
            failures.append(f"owner-thread run raised {e}")
        return failures
    if model.reader is not None:
        failures.extend(_explore_preempt(model))
    else:
        failures.extend(_explore_atomic(model))
    return failures


# ---------------------------------------------------------------------------
# Pragma-site scan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Site:
    module: str
    func: str
    path: str
    line: int
    kind: str


def pragma_sites(
    sources: Optional[Sequence[Tuple[str, str]]] = None,
) -> List[Site]:
    """Every ``racy-read`` / ``unguarded`` pragma in the package,
    resolved to its innermost enclosing function."""
    out: List[Site] = []
    if sources is None:
        sources = list(iter_package_sources())
    for path, source in sources:
        pragmas = Pragmas.scan(source)
        hits = [
            (line, kind) for line, kind, _ in pragmas.records
            if kind in ("racy-read", "unguarded")
        ]
        if not hits:
            continue
        tree, _ = parse_module(path, source, CHECKER)
        if tree is None:
            continue
        fns = [
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        modname = path.rsplit("/", 1)[-1][:-3]
        for line, kind in hits:
            best = None
            for fn in fns:
                hi = fn.end_lineno or fn.lineno
                # a pragma on its own comment line annotates the
                # STATEMENT BELOW it, so let the span reach one past
                if fn.lineno <= line <= hi + 1:
                    if best is None or hi - fn.lineno < (
                        best.end_lineno or best.lineno
                    ) - best.lineno:
                        best = fn
            out.append(Site(
                module=modname,
                func=best.name if best is not None else "<module>",
                path=path, line=line, kind=kind,
            ))
    return out


# ---------------------------------------------------------------------------
# The serving stack's models
# ---------------------------------------------------------------------------

def _make_batcher_stub():
    """A ContinuousBatcher stand-in carrying every field ``stats()`` /
    ``_window_acceptance()`` reads, with the REAL methods resolved
    from the real class (so the model exercises the code under audit,
    not a copy) over real container/store instances."""
    import collections

    from ..kvcache import RadixPrefixStore
    from ..serving import ContinuousBatcher

    class _StubBatcher:
        stats = ContinuousBatcher.stats
        _window_acceptance = ContinuousBatcher._window_acceptance
        acceptance_rate = ContinuousBatcher.acceptance_rate
        kv_debug_json = ContinuousBatcher.kv_debug_json
        _kv_summary = ContinuousBatcher._kv_summary

    s = _StubBatcher()
    s.fault_injector = None
    s.emitted_total = 0
    s.steps_total = 0
    s.slots = {0: None, 1: None}
    s.queue = []
    s.free_blocks = list(range(8))
    s.n_blocks = 8
    s.drafts_proposed = 0
    s.drafts_accepted = 0
    s._store = RadixPrefixStore(host_blocks=0)
    s.prefix_requests_hit = 0
    s.prefix_blocks_reused = 0
    s.prefix_hit_tokens_total = 0
    s.prompt_tokens_total = 0
    s.host_kv_blocks = 0
    s._restoring = []
    s._restored_ready = []
    s.swap_ins_total = 0
    s.swap_in_blocks_total = 0
    s.swap_out_blocks_total = 0
    s.swap_in_ms_total = 0.0
    s.swap_failures_total = 0
    s.kv_export_blocks_total = 0
    s.kv_import_blocks_total = 0
    s.mesh = None
    s.nonfinite_rows_total = 0
    s.decode_chunk_last = 1
    s.decode_dispatches_total = 0
    s.host_syncs_total = 0
    s.state_uploads_total = 0
    s.spec_rounds_last = 0
    s.spec_dispatches_total = 0
    s.spec_host_syncs_total = 0
    s.spec_emitted_total = 0
    s._accept_window = collections.deque(maxlen=64)
    s.prefill_budget = 16
    s._pf = None
    s.prefill_chunks_total = 0
    s.fused_admissions_total = 0
    s.decode_stall_ms_total = 0.0
    s.prefix_index = "radix"
    s.n_slots = 2
    # KV chain-digest surface: the REAL store's real digest
    # (its own leaf lock), plus the ctor-stable geometry scalars
    # stats()/kv_debug_json read.
    s.kv_digest = s._store.digest
    s.block_bytes = 4096
    s.block_size = 16
    s.kv_export_events_total = 0
    s.kv_import_events_total = 0
    # Handoff hardening: the abort/demote ledger stats() reads.
    s.kv_handoff_aborted_total = 0
    s.kv_export_demoted_blocks_total = 0
    # The port's own counter stats() reads (insert dispatches).
    s._admit_dispatches = 0
    return s


def _make_prefill():
    from ..serving import _Prefill

    return _Prefill(
        slot=0, req=None, chain=[], n_share=0, base=0, suffix_len=8,
        chunk=4,
    )


def _loop_admit(s, clock):
    s.slots[0] = object()
    s.queue.append(object())
    s.free_blocks.pop()
    s._pf = _make_prefill()
    s._restoring.append(object())


def _loop_dispatch(s, clock):
    s.emitted_total += 1
    s.steps_total += 1
    s.host_syncs_total += 1
    s.decode_dispatches_total += 1
    s._accept_window.append((4, 3))
    if s._pf is not None:
        s._pf.off += s._pf.chunk


def _loop_finish(s, clock):
    s._pf = None
    s.slots[0] = None
    s.queue.clear()
    s.free_blocks.append(9)
    s._restoring.clear()
    s._accept_window.append((4, 0))


_LOOP_OPS = (
    Op("admit", _loop_admit, frozenset({
        "slots", "queue", "free_blocks", "_pf", "_restoring",
    })),
    Op("dispatch", _loop_dispatch, frozenset({
        "emitted_total", "steps_total", "host_syncs_total",
        "decode_dispatches_total", "_accept_window", "_pf",
    })),
    Op("finish", _loop_finish, frozenset({
        "_pf", "slots", "queue", "free_blocks", "_restoring",
        "_accept_window",
    })),
)


def _check_stats(state, result):
    assert isinstance(result, dict) and result, "stats() returned junk"
    for k, v in result.items():
        assert isinstance(v, (int, float)), f"non-scalar stat {k!r}"


def _model_stats() -> ScheduleModel:
    return ScheduleModel(
        name="batcher-stats-snapshot",
        module="serving", func="stats", claim="snapshot",
        make=_make_batcher_stub,
        writers={"loop": _LOOP_OPS},
        reader=lambda s: s.stats(),
        check=_check_stats,
    )


def _model_window_acceptance() -> ScheduleModel:
    def check(state, result):
        assert 0.0 <= result <= 1.0, f"acceptance {result} out of range"

    return ScheduleModel(
        name="spec-window-snapshot",
        module="serving", func="_window_acceptance", claim="snapshot",
        make=_make_batcher_stub,
        writers={"loop": (
            Op("append", lambda s, c: s._accept_window.append((4, 2)),
               frozenset({"_accept_window"})),
            Op("append2", lambda s, c: s._accept_window.append((4, 4)),
               frozenset({"_accept_window"})),
        )},
        reader=lambda s: s._window_acceptance(),
        check=check,
    )


def _model_kv_debug() -> ScheduleModel:
    """``kv_debug_json``'s racy-read (the /debug/kv endpoint, handler
    threads): the digest reads go through KvDigest's own leaf lock and
    the two hit-token counters are single-writer point-in-time reads.
    The writer ops drive the REAL RadixPrefixStore (publish / retain /
    evict), so every digest mutation hook runs under preemption."""
    def loop_publish(s, clock):
        key = (b"chain-%d" % clock) * 2
        s._store.publish([key], [clock % 8])
        s.prefix_hit_tokens_total += 16
        s.prompt_tokens_total += 32

    def loop_retain_evict(s, clock):
        blk = clock % 8
        if s._store.is_keyed(blk):
            s._store.retain([blk])
        s._store.pop_evictable()

    def check(state, result):
        assert isinstance(result, dict), "kv_debug_json returned junk"
        assert "summary" in result and "nodes" in result
        for node in result["nodes"]:
            assert {"key", "depth", "tier", "refcount", "seq"} <= set(
                node
            ), f"malformed digest node {node!r}"
        assert result["summary"]["nodes"] >= 0

    return ScheduleModel(
        name="kv-debug-digest-snapshot",
        # The pragma site lives in _kv_summary (the factored summary
        # helper kv_debug_json and the incremental ?since= reply both
        # call); the reader still drives the full public entry point.
        module="serving", func="_kv_summary", claim="snapshot",
        make=_make_batcher_stub,
        writers={"loop": (
            Op("publish", loop_publish, frozenset({
                "_store", "kv_digest", "prefix_hit_tokens_total",
                "prompt_tokens_total",
            })),
            Op("retain_evict", loop_retain_evict, frozenset({
                "_store", "kv_digest",
            })),
        )},
        reader=lambda s: s.kv_debug_json(),
        check=check,
    )


def _make_server_stub():
    """An LLMServer stand-in for the ``_health`` snapshot model: the
    REAL ``_health`` runs against real Events/threads/containers, a
    real DegradeManager and a real OverloadController, with the
    batcher stub above behind the holder alias."""
    import queue
    import time

    from ..degrade import DegradeManager
    from ..overload import OverloadController
    from ..server import LLMServer

    class _StubServer:
        _health = LLMServer._health

    s = _StubServer()
    s._loop_thread = threading.Thread(target=lambda: None)
    s._closed = threading.Event()
    s._draining = threading.Event()
    s._drain_deadline = None
    s.degrade = DegradeManager()
    s._stalled = False
    s._heartbeat = time.monotonic()
    s.recoveries_total = 0
    s.watchdog_stalls_total = 0
    s.batcher = _make_batcher_stub()
    s._inbox = queue.Queue()
    s._active = {}
    s.overload = OverloadController(enabled=False)
    s.replica_id = None
    # Control-plane observability: _health's replica section
    # reports the ITL EWMA the router's sentinel z-scores.
    s.itl_ms_ewma = None
    return s


def _model_health() -> ScheduleModel:
    def loop_mutate(s, clock):
        s.batcher._restoring.append(object())
        s.batcher._restored_ready.append(object())
        s.batcher.slots[0] = object()
        s._heartbeat = clock * 0.001
        s._active[clock] = object()

    def loop_settle(s, clock):
        s.batcher._restoring.clear()
        s.batcher._restored_ready.clear()
        s.batcher.slots[0] = None
        s._active.clear()

    def watchdog_trip(s, clock):
        s._stalled = True

    def check(state, result):
        assert isinstance(result, dict) and "ok" in result, (
            "_health returned junk"
        )

    return ScheduleModel(
        name="healthz-snapshot",
        module="server", func="_health", claim="snapshot",
        make=_make_server_stub,
        writers={
            "loop": (
                Op("mutate", loop_mutate, frozenset({
                    "batcher._restoring", "batcher._restored_ready",
                    "batcher.slots", "_heartbeat", "_active",
                })),
                Op("settle", loop_settle, frozenset({
                    "batcher._restoring", "batcher._restored_ready",
                    "batcher.slots", "_active",
                })),
            ),
            "watchdog": (
                Op("trip", watchdog_trip, frozenset({"_stalled"})),
            ),
        },
        reader=lambda s: s._health(),
        check=check,
    )


def _model_do_post_depth() -> ScheduleModel:
    """do_POST's admission-depth estimate (the ``# audit: racy-read``
    at the overload gate): ``_inbox.qsize() + len(_active) +
    overload.queued_total()`` over loop-mutated state.  The model
    mirrors the handler expression over the real container types; the
    claim is that an off-by-a-few depth is the worst outcome."""
    def reader(s):
        return (
            s._inbox.qsize() + len(s._active)
            + s.overload.queued_total()
        )

    def check(state, result):
        assert 0 <= result <= 6, f"depth estimate {result} impossible"

    return ScheduleModel(
        name="admission-depth-snapshot",
        module="server", func="do_POST", claim="snapshot",
        make=_make_server_stub,
        writers={"loop": (
            Op("take", lambda s, c: (
                s._inbox.put(object()), s._active.update({c: object()}),
            ), frozenset({"_inbox", "_active"})),
            Op("drain", lambda s, c: (
                s._inbox.get_nowait() if not s._inbox.empty() else None,
                s._active.clear(),
            ), frozenset({"_inbox", "_active"})),
        )},
        reader=reader,
        check=check,
        trace_fn="reader",
    )


def _model_start_happens_before() -> ScheduleModel:
    """LLMServer.start's heartbeat write precedes every thread start --
    the loop/watchdog can never read an unset heartbeat."""
    def make():
        class _S:
            pass

        s = _S()
        s.heartbeat = None
        s.started = False
        return s

    def set_heartbeat(s, clock):
        s.heartbeat = float(clock)

    def start_threads(s, clock):
        s.started = True

    def loop_read(s, clock):
        assert s.heartbeat is not None, (
            "loop read the heartbeat before start() wrote it"
        )

    return ScheduleModel(
        name="start-heartbeat-happens-before",
        module="server", func="start", claim="happens-before",
        make=make,
        writers={
            "main": (
                Op("set_heartbeat", set_heartbeat,
                   frozenset({"heartbeat"})),
                Op("start_threads", start_threads,
                   frozenset({"started"})),
            ),
            "loop": (Op("read_heartbeat", loop_read),),
        },
        after={"loop": ("main", "start_threads")},
    )


def _model_watchdog_single_writer() -> ScheduleModel:
    """_watchdog's ``_stalled`` / ``watchdog_stalls_total`` writes:
    single-writer (only the watchdog thread mutates them); /healthz
    and /metrics readers see GIL-atomic bool/int snapshots."""
    def make():
        class _S:
            pass

        s = _S()
        s._stalled = False
        s.watchdog_stalls_total = 0
        s._heartbeat = 0.0
        return s

    def trip(s, clock):
        if not s._stalled:
            s._stalled = True
            s.watchdog_stalls_total += 1

    def clear(s, clock):
        s._stalled = False

    def read(s, clock):
        assert isinstance(s._stalled, bool)
        assert s.watchdog_stalls_total in (0, 1)

    return ScheduleModel(
        name="watchdog-single-writer",
        module="server", func="_watchdog", claim="single-writer",
        make=make,
        writers={
            "watchdog": (
                Op("trip", trip, frozenset({
                    "_stalled", "watchdog_stalls_total",
                })),
                Op("clear", clear, frozenset({"_stalled"})),
            ),
            "health-reader": (Op("read", read), Op("read2", read)),
        },
    )


def _model_loop_owner() -> ScheduleModel:
    """_loop's reads through its own holder alias (``self.batcher.
    slots`` / ``.queue`` at the interactive-first submit gate): the
    loop thread OWNS the batcher, so there is no concurrency -- the
    model runs the exact access shapes in program order and exists so
    the pragma's claim fails loudly if the loop stops being the
    owner-thread home of this code."""
    def submit_gate(s, clock):
        free = sum(v is None for v in s.slots.values())
        while len(s.queue) < free:
            s.queue.append(object())

    return ScheduleModel(
        name="loop-owner-submit-gate",
        module="server", func="_loop", claim="owner-thread",
        make=_make_batcher_stub,
        writers={"loop": (
            Op("admit", _loop_admit, frozenset({
                "slots", "queue", "free_blocks", "_pf", "_restoring",
            })),
            Op("gate", submit_gate, frozenset({"queue"})),
            Op("finish", _loop_finish, frozenset({
                "_pf", "slots", "queue", "free_blocks", "_restoring",
                "_accept_window",
            })),
        )},
    )


def _model_leader_stats() -> ScheduleModel:
    """The lockstep leader's ``stats()`` (the ``# audit: unguarded``
    there): the REAL method over the real Counter while a record, the
    only writer, runs under the lock (``_run_locked``'s counter
    updates)."""
    import collections

    from ..parallel.lockstep import Leader

    def make():
        class _StubLeader:
            stats = Leader.stats

        s = _StubLeader()
        s.index = 0
        s.records = collections.Counter()
        s.publish_ms_total = 0.0
        s.agree_ms_total = 0.0
        return s

    def publish(s, clock):
        s.publish_ms_total += 0.5
        s.index += 1
        s.records["step"] += 1

    def agree(s, clock):
        s.agree_ms_total += 0.25

    def check(state, result):
        assert set(result) == {"records", "records_total",
                               "publish_ms_total", "agree_ms_total"}
        assert 0 <= sum(result["records"].values()) <= 2
        assert 0 <= result["records_total"] <= 2

    return ScheduleModel(
        name="leader-stats-snapshot",
        module="lockstep", func="stats", claim="snapshot",
        make=make,
        writers={"record": (
            Op("publish", publish, frozenset({
                "index", "records", "publish_ms_total"})),
            Op("agree", agree, frozenset({"agree_ms_total"})),
            Op("publish2", publish, frozenset({
                "index", "records", "publish_ms_total"})),
        )},
        reader=lambda s: s.stats(),
        check=check,
    )


MODELS: Tuple[Callable[[], ScheduleModel], ...] = (
    _model_stats,
    _model_window_acceptance,
    _model_kv_debug,
    _model_health,
    _model_do_post_depth,
    _model_start_happens_before,
    _model_watchdog_single_writer,
    _model_loop_owner,
    _model_leader_stats,
)


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def check_package(
    models: Optional[Sequence[ScheduleModel]] = None,
    sources: Optional[Sequence[Tuple[str, str]]] = None,
) -> List[Finding]:
    """Match every racy-read/unguarded pragma to a model and run every
    model's exploration."""
    findings: List[Finding] = []
    if models is None:
        models = [m() for m in MODELS]
    sites = pragma_sites(sources)
    by_key: Dict[Tuple[str, str], List[ScheduleModel]] = {}
    for m in models:
        by_key.setdefault((m.module, m.func), []).append(m)

    covered: set = set()
    for site in sites:
        key = (site.module, site.func)
        if key in by_key:
            covered.add(key)
            continue
        findings.append(Finding(
            checker=CHECKER, rule="unmodeled-pragma",
            path=site.path, line=site.line,
            message=(
                f"# audit: {site.kind}(...) in {site.module}."
                f"{site.func} has no schedule model -- register a "
                "ScheduleModel in analysis/schedules.py MODELS (the "
                "safety argument must be checked, not trusted prose)"
            ),
        ))
    for m in models:
        if sources is None and (m.module, m.func) not in {
            (s.module, s.func) for s in sites
        }:
            findings.append(Finding(
                checker=CHECKER, rule="stale-model",
                path=f"jax_llama_tpu_torch/{m.module}.py", line=0,
                message=(
                    f"schedule model {m.name!r} targets {m.module}."
                    f"{m.func} but no racy-read/unguarded pragma "
                    "lives there anymore -- delete or retarget it"
                ),
            ))
            continue
        for fail in explore(m):
            findings.append(Finding(
                checker=CHECKER, rule="schedule-model-failed",
                path=f"jax_llama_tpu_torch/{m.module}.py", line=0,
                message=(
                    f"model {m.name!r} ({m.claim}) found a "
                    f"counterexample: {fail} -- the pragma's safety "
                    "argument does not hold; fix the code or the model"
                ),
            ))
    return findings
