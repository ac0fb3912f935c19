"""One ordered command log that keeps the batchers of a serving mesh in
lockstep across its ranks (the HTTP server and the replica router over a
mesh of more than one rank).

No module of the JAX package corresponds to this one.  There one
controller drives every device of the mesh, so ``LLMServer`` and
``ReplicaRouter`` need nothing to run on it.  The port runs one process
per rank, and a batcher on a mesh stays in lockstep only while every rank
makes the same calls in the same order (``serving.py``'s serving-mesh
note): a collective that one rank skips leaves the others waiting in it.
The server decides those calls from clocks and sockets (admission,
deadlines, the degrade ladders, recovery), which no two processes read
alike, so the ranks do not each decide them.  Instead:

* **One leader.**  Global rank 0 runs the HTTP front end, the server's
  loop, its overload and degrade state machines and watchdog, the router
  and the fleet controller: every decision that reads a clock or a
  socket.  Each of its batchers is a :class:`LockstepBatcher`, which
  publishes every call that changes host state or issues a collective as
  a record, through the mesh's CPU group, **before** it runs the call.
* **Followers.**  Every other rank builds the same batchers over its own
  weight shard, serves no socket, and applies the records in order on one
  thread (:func:`follow`).
* **One log for all replicas.**  Replicas that time-share the mesh put
  their records into the one log, each tagged with the batcher it names
  (its log id ``lid``).  The leader runs each logged call under one lock,
  so two replica loops never interleave collectives on a process group
  and a follower replays the calls in exactly the leader's order.
* **Outcomes.**  After each record every rank runs it, then the ranks
  exchange how it ended (returned, with a digest of the result, or raised,
  with the exception's type).  If they disagree every rank raises
  :class:`LockstepDivergence`, naming the record's index and method; a
  rank lost before the exchange raises :class:`LockstepError` once the
  mesh's timeouts expire (``make_mesh(timeout_s=, control_timeout_s=)``).
  Either error breaks the log: later records raise at once, so no rank
  hangs.
* **Handoffs.**  On each rank ``export_prefix`` returns that rank's own
  head slice.  The leader's export result remembers its record
  (:class:`Exported`); an ``import_prefix`` record names that record, and
  a follower lands its OWN slabs of it.  A follower drops an export's
  slabs once the leader has dropped its result.

What is logged: ``submit``, ``cancel``, ``step`` (a follower drains
``pop_failed`` after it, as the server does on the leader), attribute
writes (the degrade ladder's ``prefill_budget``), ``demote_idle``,
``rebuild``, ``_quiesce_restores``, ``export_prefix``, ``import_prefix``,
``demote_exported`` and ``run_to_completion``, and ``host_state``, which
every rank computes at the same point of the log so that the outcome
exchange compares the ranks' block tables, free lists and prefix digests
(a follower keeps what it computed, in the summary ``follow`` returns);
a new batcher (``make``,
through the factory both sides hold; ``build``, a quarantine rebuild's
keyword overrides over the first construction) and its release
(``drop``).  Read-only calls (``READ_ONLY``) stay on the leader; any
other method is refused by the proxy rather than run on one rank.
When nothing was published for ``HEARTBEAT_S`` (at most a quarter of
the CPU group's timeout) the leader publishes an empty record, so an idle follower's wait never reaches the CPU group's
timeout.  The fault injector is armed on every rank with the same spec
and seed: a batcher site then fires at the same call everywhere.  The
router's and the controller's sites fire on the leader only, from an
injector of their own, so that their draws never move the random stream
the batchers' sites share (run.py's ``_serve_router``).

Usage, the same program on every rank::

    mesh = build_serve_mesh(spec, control_timeout_s=300)
    if mesh.rank == 0:
        leader = leader_for(mesh)
        cb = leader.make(0, lambda: ContinuousBatcher(..., mesh=mesh))
        with LLMServer(cb, ...) as srv:
            ...
        leader.stop()
    else:
        follow(mesh, lambda i: ContinuousBatcher(..., mesh=mesh))

``LLMServer`` refuses a plain batcher on a mesh of more than one rank:
nothing would replay its calls on the other ranks.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

# The calls a proxy publishes before it runs them.
LOGGED = frozenset({
    "submit", "cancel", "step", "demote_idle", "rebuild",
    "_quiesce_restores", "export_prefix", "import_prefix",
    "demote_exported", "run_to_completion", "host_state",
})
# The calls that read host state only, run on the leader alone.
# ``pop_failed`` clears the leader's list; a follower drains its own after
# each ``step`` record.
READ_ONLY = frozenset({
    "pending", "stats", "describe", "kv_debug_json", "default_seed",
    "resident_chain_keys", "_match_prefix", "acceptance_rate",
    "_window_acceptance", "_kv_summary", "pop_failed", "construction",
})
# The leader publishes an empty record after this long without one.
HEARTBEAT_S = 10.0
# The bounds run.py gives an HTTP server's mesh (make_mesh's timeout_s and
# control_timeout_s).  The CPU group waits longer than the axis groups:
# a rank left in a collective that another rank skipped times out first,
# then joins the outcome exchange, so both ranks name the divergence.
MESH_TIMEOUT_S = 300.0
CONTROL_TIMEOUT_S = 2 * MESH_TIMEOUT_S


class LockstepError(RuntimeError):
    """The ranks of a serving mesh can no longer agree (a rank was lost,
    or the log was stopped); every rank stops serving."""


class LockstepDivergence(LockstepError):
    """The ranks ran the same record to different outcomes."""


def _digest(method: str, result: Any) -> Any:
    """A small, picklable summary of a call's result that every rank must
    share (the tokens a step emitted, a request id, a block count)."""
    if method in ("step", "run_to_completion"):
        items = (sorted(result.items()) if isinstance(result, dict)
                 else [tuple(ev[:3]) for ev in result])
        return zlib.crc32(repr(items).encode())
    if method == "export_prefix":
        return (len(result[0]), len(result[1]))
    if method == "host_state":
        return zlib.crc32(repr(sorted(result.items())).encode())
    if result is None or isinstance(result, (bool, int, str)):
        return result
    return type(result).__name__


class Exported(list):
    """An ``export_prefix`` result's slabs on the leader: a list that
    remembers the record that made it and which of that record's slabs it
    holds (``picks``), so that an import or a demotion of any slice of it
    names, to a follower, that follower's own slabs."""

    def __init__(self, items, record: int, picks: Sequence[int],
                 root: Optional["Exported"] = None):
        super().__init__(items)
        self.record = record
        self.picks = list(picks)
        # A slice keeps its root alive: the follower holds the record's
        # slabs until the root is collected.
        self._root = root

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Exported(list.__getitem__(self, i), self.record,
                            self.picks[i],
                            self if self._root is None else self._root)
        return list.__getitem__(self, i)

    def ref(self):
        return ("exported", self.record, self.picks)


def _encode_slabs(slabs):
    if slabs is None:
        return None
    if not isinstance(slabs, Exported):
        raise ValueError(
            "on a serving mesh the slabs of an import or a demotion must be "
            "an export_prefix result of the same job: a follower lands its "
            "own head slice of that export")
    return slabs.ref()


class Leader:
    """The log on rank 0 of ``mesh``: publishes records, runs each under
    one lock, and agrees its outcome with the followers (module
    docstring)."""

    def __init__(self, mesh):
        if mesh.rank != 0:
            raise ValueError(
                f"rank {mesh.rank} follows the log (lockstep.follow); only "
                "rank 0 leads it")
        self.mesh = mesh
        self.heartbeat_s = HEARTBEAT_S
        if mesh.control_timeout_s is not None:
            self.heartbeat_s = min(HEARTBEAT_S, mesh.control_timeout_s / 4)
        self._lock = threading.Lock()
        self._holder: Optional[int] = None
        self.index = 0
        self.broken: Optional[LockstepError] = None
        self.stopped = False
        self._next_lid = 0
        self._gens: Dict[int, int] = {}
        # Export records whose leader-side result was collected (appended
        # by finalizers, shipped with the next record).
        self._forget: List[int] = []
        self.records = collections.Counter()
        self.publish_ms_total = 0.0
        self.agree_ms_total = 0.0
        self._last = time.monotonic()
        self._halt = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat,
                                      name="lockstep-heartbeat", daemon=True)
        self._beat.start()

    # -- the log ------------------------------------------------------------

    @contextlib.contextmanager
    def _held(self):
        me = threading.get_ident()
        if self._holder == me:
            raise RuntimeError(
                "lockstep: a logged call inside another one cannot be "
                "replayed in order")
        with self._lock:
            self._holder = me
            try:
                yield
            finally:
                self._holder = None

    def _check(self) -> None:
        if self.broken is not None:
            raise self.broken
        if self.stopped:
            raise LockstepError("lockstep: the log was stopped")

    def run(self, rec: Dict[str, Any], fn: Callable[[], Any],
            method: Optional[str] = None) -> Any:
        """Publish ``rec``, run ``fn()`` on this rank, agree its outcome
        with every rank; return its result or raise its exception."""
        with self._held():
            self._check()
            return self._run_locked(rec, fn, method)

    def _run_locked(self, rec, fn, method):
        n = self.index
        name = method or rec["op"]
        rec = dict(rec, n=n, forget=self._take_forget())
        t = time.perf_counter()
        try:
            self.mesh.broadcast_object(rec, src=0)
        except Exception as e:
            self._break(LockstepError(
                f"lockstep record {n} ({name}): a rank was lost while it "
                f"was published: {e}"))
        self.publish_ms_total += (time.perf_counter() - t) * 1e3
        self.index += 1
        self._last = time.monotonic()
        self.records[rec["op"] if rec["op"] != "call" else name] += 1
        error = None
        try:
            result = fn()
            outcome = ("returned", _digest(name, result))
        except BaseException as e:
            error, result = e, None
            outcome = ("raised", type(e).__name__)
        t = time.perf_counter()
        agree(self.mesh, n, name, outcome, self._break)
        self.agree_ms_total += (time.perf_counter() - t) * 1e3
        if error is not None:
            raise error
        return result

    def _break(self, err: LockstepError):
        self.broken = err
        self._halt.set()
        raise err

    def _take_forget(self) -> List[int]:
        out = []
        while self._forget:
            out.append(self._forget.pop())
        return out

    def _heartbeat(self) -> None:
        while not self._halt.wait(self.heartbeat_s / 4):
            if time.monotonic() - self._last < self.heartbeat_s:
                continue
            if not self._lock.acquire(blocking=False):
                continue  # a record is running: the follower is busy too
            try:
                if self.broken is None and not self.stopped:
                    self._run_locked({"op": "noop"}, lambda: None, None)
            except LockstepError:
                return
            finally:
                self._lock.release()

    # -- batchers -----------------------------------------------------------

    def make(self, arg: Any, build: Callable[[], Any]) -> "LockstepBatcher":
        """A new batcher on every rank: publish ``("make", arg)``, run
        ``build()`` here; each follower calls its factory with ``arg``."""
        lid = self._next_lid
        self._next_lid += 1
        batcher = self.run({"op": "make", "lid": lid, "arg": arg}, build)
        self._gens[lid] = 0
        return LockstepBatcher(self, lid, 0, batcher,
                               batcher.construction())

    def stop(self) -> None:
        """The last record: every follower returns from ``follow``.  Call
        once no server of this log runs."""
        self._halt.set()
        self._beat.join(timeout=30)
        if self.broken is not None or self.stopped:
            return
        self.run({"op": "stop"}, lambda: None)
        self.stopped = True

    def stats(self) -> Dict[str, Any]:
        """Records published by kind (a call by its method), and the
        leader's milliseconds spent publishing and agreeing."""
        # audit: unguarded(single-writer: only the record running under
        # the lock writes these; dict() copies the Counter atomically, so
        # a read may miss the record in flight, never crash)
        return dict(records=dict(self.records), records_total=self.index,
                    publish_ms_total=self.publish_ms_total,
                    agree_ms_total=self.agree_ms_total)


def agree(mesh, n: int, name: str, outcome, on_error) -> None:
    """Every rank's outcome of record ``n``; ``on_error`` (which raises)
    gets a LockstepDivergence when they differ, a LockstepError when a
    rank was lost."""
    try:
        outs = mesh.gather_object(outcome)
    except Exception as e:
        on_error(LockstepError(
            f"lockstep record {n} ({name}): a rank was lost while the ranks "
            f"agreed on its outcome: {e}"))
    if any(o != outs[0] for o in outs[1:]):
        on_error(LockstepDivergence(
            f"lockstep record {n} ({name}): the ranks diverged: " + ", ".join(
                f"rank {r} {o[0]} {o[1]!r}" for r, o in enumerate(outs))))


class LockstepBatcher:
    """A batcher on the leader, seen through its log: logged calls and
    attribute writes are published before they run (module docstring);
    read-only calls and attribute reads reach the batcher directly."""

    def __init__(self, leader: Leader, lid: int, gen: int, batcher,
                 base):
        for k, v in (("_leader", leader), ("_lid", lid), ("_gen", gen),
                     ("_b", batcher), ("_base", base)):
            object.__setattr__(self, k, v)

    def _rec(self, **kw) -> Dict[str, Any]:
        if self._leader._gens.get(self._lid) != self._gen:
            raise ValueError(
                f"lockstep: batcher {self._lid} was replaced (generation "
                f"{self._gen} is stale)")
        return dict(kw, lid=self._lid, gen=self._gen)

    def __getattr__(self, name):
        if name in LOGGED:
            return lambda *a, **kw: self._call(name, *a, **kw)
        value = getattr(self._b, name)
        if (callable(value) and getattr(value, "__self__", None) is self._b
                and name not in READ_ONLY):
            raise AttributeError(
                f"lockstep: {name} is neither logged nor read-only "
                "(parallel.lockstep.LOGGED / READ_ONLY)")
        return value

    def __setattr__(self, name, value):
        self._leader.run(self._rec(op="set", name=name, value=value),
                         lambda: setattr(self._b, name, value),
                         f"set {name}")

    def _call(self, method, *args, **kwargs):
        wire_args, wire_kw = list(args), dict(kwargs)
        if method == "import_prefix":
            if len(wire_args) > 1:
                wire_args[1] = _encode_slabs(wire_args[1])
            else:
                wire_kw["slabs"] = _encode_slabs(wire_kw["slabs"])
        elif method == "demote_exported":
            if len(wire_args) > 1:
                wire_args[1] = _encode_slabs(wire_args[1])
            elif "slabs" in wire_kw:
                wire_kw["slabs"] = _encode_slabs(wire_kw["slabs"])
        leader = self._leader
        rec = self._rec(op="call", method=method, args=wire_args,
                        kwargs=wire_kw)
        at = []

        def call():
            at.append(leader.index - 1)  # this record's, under the lock
            return getattr(self._b, method)(*args, **kwargs)

        result = leader.run(rec, call, method)
        if method == "export_prefix":
            n = at[0]
            keys, slabs = result
            slabs = Exported(slabs, n, range(len(slabs)))
            weakref.finalize(slabs, leader._forget.append, n)
            return keys, slabs
        if method == "rebuild":
            return self._replace(result)
        return result

    def build(self, overrides: Dict[str, Any]) -> "LockstepBatcher":
        """A batcher of the first construction with keyword ``overrides``
        (``serving.build_batcher``), on every rank: a quarantine's or a
        probe's rebuild."""
        from ..serving import build_batcher

        batcher = self._leader.run(
            self._rec(op="build", overrides=dict(overrides)),
            lambda: build_batcher(self._base, overrides))
        return self._replace(batcher)

    def _replace(self, batcher) -> "LockstepBatcher":
        gen = self._gen + 1
        self._leader._gens[self._lid] = gen
        return LockstepBatcher(self._leader, self._lid, gen, batcher,
                               self._base)

    def release(self) -> None:
        """Drop this batcher on every rank (its server has stopped)."""
        leader = self._leader
        if (leader.broken is not None or leader.stopped
                or leader._gens.get(self._lid) != self._gen):
            return
        leader.run(self._rec(op="drop"), lambda: None)
        leader._gens.pop(self._lid, None)


def leader_for(mesh) -> Leader:
    """The one log of ``mesh`` on rank 0, made at first use."""
    leader = getattr(mesh, "_lockstep_leader", None)
    if leader is None or leader.stopped or leader.broken is not None:
        leader = Leader(mesh)
        mesh._lockstep_leader = leader
    return leader


class _Follower:
    def __init__(self, mesh, factory):
        self.mesh = mesh
        self.factory = factory
        self.batchers: Dict[int, Any] = {}
        self.bases: Dict[int, Any] = {}
        self.gens: Dict[int, int] = {}
        self.exports: Dict[int, List[Any]] = {}
        self.states: List[Dict[str, Any]] = []
        self.records = collections.Counter()

    def _target(self, rec):
        lid = rec["lid"]
        if self.gens.get(lid) != rec["gen"]:
            raise LockstepError(
                f"batcher {lid} is at generation {self.gens.get(lid)} here, "
                f"{rec['gen']} on the leader")
        return self.batchers[lid]

    def _slabs(self, ref):
        if ref is None:
            return None
        _, record, picks = ref
        slabs = self.exports[record]
        return [slabs[j] for j in picks]

    def apply(self, rec) -> Any:
        from ..serving import build_batcher

        op = rec["op"]
        if op in ("noop", "stop"):
            return None
        lid = rec.get("lid")
        if op == "make":
            batcher = self.batchers[lid] = self.factory(rec["arg"])
            self.bases[lid] = batcher.construction()
            self.gens[lid] = 0
            return batcher
        b = self._target(rec)
        if op == "build":
            self.batchers[lid] = build_batcher(self.bases[lid],
                                               rec["overrides"])
            self.gens[lid] += 1
            return self.batchers[lid]
        if op == "drop":
            del self.batchers[lid], self.bases[lid], self.gens[lid]
            return None
        if op == "set":
            setattr(b, rec["name"], rec["value"])
            return None
        method = rec["method"]
        args, kwargs = list(rec["args"]), dict(rec["kwargs"])
        if method in ("import_prefix", "demote_exported"):
            if len(args) > 1:
                args[1] = self._slabs(args[1])
            elif "slabs" in kwargs:
                kwargs["slabs"] = self._slabs(kwargs["slabs"])
        result = getattr(b, method)(*args, **kwargs)
        if method == "step":
            b.pop_failed()
        elif method == "export_prefix":
            self.exports[rec["n"]] = result[1]
        elif method == "rebuild":
            self.batchers[lid] = result
            self.gens[lid] += 1
        elif method == "host_state":
            self.states.append(result)
        return result

    def run(self) -> Dict[str, Any]:
        last = None

        def fail(err):
            raise err

        while True:
            try:
                rec = self.mesh.broadcast_object(None, src=0)
            except Exception as e:
                raise LockstepError(
                    f"lockstep: the leader was lost after record {last}: "
                    f"{e}") from e
            last = rec["n"]
            for n in rec["forget"]:
                self.exports.pop(n, None)
            name = rec.get("method") or rec["op"]
            if rec["op"] == "set":
                name = f"set {rec['name']}"
            self.records[rec["op"] if rec["op"] != "call" else name] += 1
            try:
                result = self.apply(rec)
                outcome = ("returned", _digest(name, result))
            except BaseException as e:
                outcome = ("raised", type(e).__name__)
            agree(self.mesh, rec["n"], name, outcome, fail)
            if rec["op"] == "stop":
                return dict(records=dict(self.records),
                            records_total=last + 1, states=self.states)


def follow(mesh, factory: Callable[[Any], Any]) -> Dict[str, Any]:
    """A follower rank's loop: apply the leader's records in order until
    its stop record, then return the records applied by kind and the
    ``host_state`` results this rank computed.  ``factory(arg)`` builds
    the batcher a ``make`` record names.  Raises
    :class:`LockstepDivergence` or :class:`LockstepError` when the ranks
    can no longer agree."""
    if mesh.rank == 0:
        raise ValueError("rank 0 leads the log (lockstep.leader_for)")
    return _Follower(mesh, factory).run()


__all__ = [
    "CONTROL_TIMEOUT_S", "HEARTBEAT_S", "MESH_TIMEOUT_S", "LOGGED",
    "READ_ONLY", "Exported", "Leader", "LockstepBatcher",
    "LockstepDivergence", "LockstepError", "follow", "leader_for",
]
