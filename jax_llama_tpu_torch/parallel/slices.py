"""Sliced replicas: each replica of ``run.py --http --replicas N
--serve-mesh dp,tp`` on ranks of its own (the device slicing of JAX's
``run._serve_router``, ``jax_llama_tpu/run.py:834-884``, with "devices"
read as "ranks").

Geometry.  A job of ``world`` ranks holds ``world / (dp x tp)`` slices
(``slice_count``; a world that is not a whole number of slices is
refused).  Replica i runs on slice i while the job has one for it and
time-shares slice 0 otherwise, seed replicas and the ones the fleet
controller grows alike (``replica_slice``, JAX's ``_geometry``).  Slice s
is a serving mesh of its own over global ranks ``[s * per, (s + 1) *
per)`` (``make_mesh(slices=)``): its own process groups and its own
lockstep log (``parallel.lockstep``), led by its first rank, the slice
head.

Roles.

* Global rank 0, slice 0's head, runs the router, the fleet controller
  and every replica on slice 0 in process, as over one mesh.  It holds a
  :class:`Channel` to each other slice's head (a gloo group of the two
  ranks) and stands for a replica on slice s > 0 with a
  :class:`RemoteReplica`: what the router and the controller use of an
  ``LLMServer`` (``address``, ``call_on_loop``, ``wait_idle``, the drain
  and stop calls), each call sent over the channel.
* The head of slice s > 0 runs :func:`serve_slice`: a start message
  builds the replica's batcher through its slice's log and its
  ``LLMServer`` (HTTP on port 0) in its own process, so the server's obs
  sink, traces and degrade state stay beside the batcher; it then
  answers rank 0's calls on that server, on the replica's own serving
  loop, until the exit message.
* Every other rank follows its slice's log (``lockstep.follow``).

``call_on_loop`` on a :class:`RemoteReplica` runs its function on rank 0
against a stand-in batcher whose methods are the named calls the router
makes (``NAMED``): each call, never the function, crosses to the slice
head, which runs it on its server's loop.

Handoffs between slices.  A slice's log gathers every export's KV heads
on its head inside the export record (``Exported.full``,
``serve_mesh.gather_slab_heads``; the draft's ``d_`` twins and int8
scale planes ride along).  Rank 0 carries those slabs of every head from
the source slice to the destination, whose import record carries them
inline to its followers; each rank lands its own head slice
(``serve_mesh.slab_head_slice``).  Exports and imports between replicas
of one slice keep the log's per-rank path (``lockstep.Exported``).  A
demotion after a handoff names, back to the source head, the export it
kept.

Bounds.  Every channel message waits at most the channel's timeout (the
job's ``CONTROL_TIMEOUT_S``); rank 0 sends an empty message to an idle
channel every ``heartbeat_s``.  A channel that fails is broken for good:
its replica's calls raise at once (the router counts them as failed
handoffs or drains), and the router's health scrapes, which go over
HTTP, find the replica unhealthy; rank 0 never waits on a lost slice
past the timeout.

Faults.  Every rank arms the same ``--inject-faults`` spec and seed, so
a ``site@N`` rule counts the dispatches of the replicas on the rank's
own slice, where JAX's one injector counts every replica's (ROADMAP
Queue C, a known difference).
"""

from __future__ import annotations

import datetime
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch.distributed as dist

from . import lockstep

# The batcher calls a RemoteReplica's call_on_loop sends to its slice:
# the router's handoff and drain calls, and the reads that tests and
# operators take through call_on_loop.
NAMED = frozenset({
    "export_prefix", "import_prefix", "demote_exported", "_match_prefix",
    "resident_chain_keys", "host_state", "stats", "pending",
})
# The server calls a RemoteReplica forwards.
SERVER_CALLS = frozenset({
    "wait_idle", "shutdown_for_restart", "begin_drain", "wait_drained",
    "stop",
})
_ERRORS = {e.__name__: e for e in (
    TimeoutError, ValueError, KeyError, RuntimeError, OSError,
    lockstep.LockstepError, lockstep.LockstepDivergence)}


def slice_count(world: int, per: int) -> int:
    """The slices a job of ``world`` ranks holds at ``per`` ranks a
    slice; ValueError unless it is a whole number of them."""
    if per < 1 or world < per or world % per:
        raise ValueError(
            f"{world} ranks are not a whole number of slices of {per}")
    return world // per


def replica_slice(i: int, n_slices: int) -> int:
    """The slice replica ``i`` runs on (JAX's ``_geometry``): its own
    while the job has slice ``i``, slice 0 (time-shared) after."""
    return i if 0 <= i < n_slices else 0


class Match(NamedTuple):
    """A ``_match_prefix`` result sent back from a slice: the resident
    hit blocks (the radix nodes stay on the slice)."""

    blocks: List[int]


class SliceLost(RuntimeError):
    """A slice's channel failed: its head was lost or timed out."""


def _delta(seconds: Optional[float]):
    return None if seconds is None else datetime.timedelta(seconds=seconds)


class Channel:
    """The control channel between global rank 0 and the head of slice
    ``index`` (a gloo group of the two).  Rank 0 sends a message and waits
    for the head's reply (:meth:`ask`, one at a time); the head receives
    (:meth:`recv`) and replies (:meth:`reply`)."""

    def __init__(self, group, index: int, head: int,
                 timeout_s: Optional[float] = None):
        self.group = group
        self.index = index
        self.head = head
        self.timeout_s = timeout_s
        self.heartbeat_s = lockstep.HEARTBEAT_S
        if timeout_s is not None:
            self.heartbeat_s = min(self.heartbeat_s, timeout_s / 4)
        self.broken: Optional[SliceLost] = None
        self.messages = 0
        self.ms_total = 0.0
        self._lock = threading.Lock()
        self._forget: List[int] = []
        self._last = time.monotonic()
        self._halt = threading.Event()
        self._beat: Optional[threading.Thread] = None

    def _bcast(self, obj, src: int):
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    # -- rank 0 -------------------------------------------------------------

    def start_heartbeat(self) -> None:
        self._beat = threading.Thread(target=self._heartbeat, daemon=True,
                                      name=f"slice-{self.index}-heartbeat")
        self._beat.start()

    def forget(self, eid: int) -> None:
        """Drop the head's copy of export ``eid`` with the next message
        (a finalizer's call: it only appends)."""
        self._forget.append(eid)

    def ask(self, msg: Dict[str, Any]) -> Any:
        """Send ``msg`` to the head and return its reply's value, or raise
        the error the head's call raised (its type where the type is a
        common one, else RuntimeError)."""
        with self._lock:
            return self._ask_locked(msg)

    def _ask_locked(self, msg):
        if self.broken is not None:
            raise self.broken
        forget = []
        while self._forget:
            forget.append(self._forget.pop())
        t = time.perf_counter()
        try:
            self._bcast(dict(msg, forget=forget), src=0)
            status, value = self._bcast(None, src=self.head)
        except Exception as e:
            self.broken = SliceLost(
                f"slice {self.index} (head rank {self.head}) was lost "
                f"during {msg.get('method') or msg['op']}: {e}")
            raise self.broken from e
        self.messages += 1
        self.ms_total += (time.perf_counter() - t) * 1e3
        self._last = time.monotonic()
        if status == "raised":
            kind, text = value
            raise _ERRORS.get(kind, RuntimeError)(text)
        return value

    def _heartbeat(self) -> None:
        while not self._halt.wait(self.heartbeat_s / 4):
            if time.monotonic() - self._last < self.heartbeat_s:
                continue
            if not self._lock.acquire(blocking=False):
                continue  # a call is running: the head is busy too
            try:
                if self.broken is None:
                    self._ask_locked({"op": "noop"})
            except Exception:
                return
            finally:
                self._lock.release()

    def close(self) -> None:
        """The last message: the head stops its servers and its log and
        returns.  Best effort on a broken channel."""
        self._halt.set()
        if self._beat is not None:
            self._beat.join(timeout=30)
        try:
            self.ask({"op": "exit"})
        except Exception:
            pass
        self.broken = self.broken or SliceLost(
            f"slice {self.index}: the channel was closed")

    # -- the slice head -----------------------------------------------------

    def recv(self) -> Dict[str, Any]:
        return self._bcast(None, src=0)

    def reply(self, status: str, value: Any) -> None:
        self._bcast((status, value), src=self.head)


def open_channels(mesh, timeout_s: Optional[float] = None
                  ) -> Dict[int, Channel]:
    """One channel per slice s > 0 of ``mesh``'s job (``mesh.slices``
    slices of ``mesh.size`` ranks).  Every rank calls this, in the same
    order, for the groups it is not in too; rank 0 gets every channel
    (its heartbeat started), slice s's head its own, the others none."""
    out: Dict[int, Channel] = {}
    me = mesh.global_rank
    for s in range(1, mesh.slices):
        head = s * mesh.size
        g = dist.new_group([0, head], backend="gloo",
                           timeout=_delta(timeout_s))
        if me in (0, head):
            out[s] = Channel(g, s, head, timeout_s)
    if me == 0:
        for ch in out.values():
            ch.start_heartbeat()
    return out


class _Calls:
    """The batcher a RemoteReplica's ``call_on_loop`` function sees: each
    named method sends that one call to the slice."""

    def __init__(self, replica: "RemoteReplica", timeout_s: float):
        self._replica = replica
        self._timeout_s = timeout_s

    def __getattr__(self, name):
        if name not in NAMED:
            raise AttributeError(
                f"{name} is not a named call a replica on another slice "
                f"takes (parallel.slices.NAMED)")
        return lambda *a, **kw: self._replica._call(name, a, kw,
                                                    self._timeout_s)


class RemoteReplica:
    """Rank 0's stand-in for the ``LLMServer`` of replica ``replica_id`` on
    the slice behind ``channel`` (module docstring)."""

    def __init__(self, channel: Channel, replica_id: int):
        self.channel = channel
        self.replica_id = replica_id
        self.sid: Optional[int] = None
        self.block_size: Optional[int] = None
        self._address: Optional[str] = None
        self._stopped = False

    @property
    def address(self) -> str:
        return self._address

    @property
    def slice(self) -> int:
        return self.channel.index

    def start(self) -> "RemoteReplica":
        """Build the replica on its slice; its server's address and block
        size come back."""
        info = self.channel.ask({"op": "start",
                                 "replica": self.replica_id})
        self.sid = info["sid"]
        self._address = info["address"]
        self.block_size = info["block_size"]
        return self

    def _call(self, method, args, kwargs, timeout_s):
        args, kwargs = list(args), dict(kwargs)
        if method in ("import_prefix", "demote_exported"):
            # Slabs cross as slabs of every head (an import) or as the
            # head's export they came from (a demotion).
            at_arg = len(args) > 1
            slabs = args[1] if at_arg else kwargs.get("slabs")
            if slabs is not None:
                slabs = (lockstep.full_slabs(slabs)
                         if method == "import_prefix" else self._ref(slabs))
                if at_arg:
                    args[1] = slabs
                else:
                    kwargs["slabs"] = slabs
        value = self.channel.ask({
            "op": "call", "sid": self.sid, "method": method, "args": args,
            "kwargs": kwargs, "timeout_s": timeout_s})
        if method == "export_prefix":
            keys, full, eid = value
            # The head keeps the export as ``eid`` until these slabs (and
            # every slice of them) are collected.
            slabs = lockstep.Exported(full, eid, range(len(full)),
                                      owner=self.channel, full=full)
            weakref.finalize(slabs, self.channel.forget, eid)
            return keys, slabs
        return value

    def _ref(self, slabs):
        if not (isinstance(slabs, lockstep.Exported)
                and slabs.owner is self.channel):
            raise ValueError(
                "a replica on another slice demotes only an export it made")
        return ("remote", slabs.record, slabs.picks)

    def call_on_loop(self, fn: Callable[[Any], Any],
                     timeout_s: float = 30.0):
        """``fn(batcher)`` with the replica's named calls (``NAMED``), each
        run on its serving loop on the slice, ``timeout_s`` bounding each
        (TimeoutError past it, as ``LLMServer.call_on_loop``)."""
        return fn(_Calls(self, timeout_s))

    def _server(self, method, **kwargs):
        return self.channel.ask({"op": "server", "sid": self.sid,
                                 "method": method, "kwargs": kwargs})

    def wait_idle(self, timeout_s: float = 30.0,
                  poll_s: float = 0.05) -> bool:
        return self._server("wait_idle", timeout_s=timeout_s, poll_s=poll_s)

    def begin_drain(self, timeout_s: Optional[float] = None) -> None:
        self._server("begin_drain", timeout_s=timeout_s)

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        try:
            return self._server("wait_drained", timeout=timeout)
        except SliceLost:
            return False

    def shutdown_for_restart(self, grace_s: float = 5.0) -> bool:
        self._stopped = True
        return self._server("shutdown_for_restart", grace_s=grace_s)

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        try:
            self._server("stop")
        except SliceLost:
            pass


def _take(slabs, picks):
    """The export's slabs at ``picks`` (an ``Exported`` keeps its
    reference for the log, so they must be a contiguous run)."""
    if isinstance(slabs, lockstep.Exported):
        lo = picks[0] if picks else 0
        if picks != list(range(lo, lo + len(picks))):
            raise ValueError("a demotion names a contiguous run of an "
                             "export")
        return slabs[lo:lo + len(picks)]
    return [slabs[j] for j in picks]


def serve_slice(mesh, channel: Channel, make: Callable[[int], Any],
                serve: Callable[[Any, int], Any]) -> Dict[str, Any]:
    """The head of a slice s > 0: answer rank 0's messages on ``channel``
    until its exit message.  A start message builds replica i's batcher
    (``make(i)``, through the slice's lockstep log where the slice has
    more than one rank) and its started server (``serve(batcher, i)``);
    call messages run on a server's loop (``call_on_loop``), server
    messages are its drain and stop calls.  On the way out every server
    stops and the log's stop record returns the followers.  Returns the
    log's figures and the channel's."""
    leader = None
    if mesh.size > 1:
        leader = lockstep.leader_for(mesh)
    servers: Dict[int, Any] = {}
    exports: Dict[int, Any] = {}
    counter = {"eid": 0, "sid": 0}

    def start(i):
        cb = (leader.make(i, lambda: make(i)) if leader is not None
              else make(i))
        sid = counter["sid"]
        counter["sid"] += 1
        servers[sid] = serve(cb, i)
        return dict(sid=sid, address=servers[sid].address,
                    block_size=cb.block_size)

    def call(msg):
        srv = servers[msg["sid"]]
        method = msg["method"]
        if method not in NAMED:
            raise AttributeError(f"{method} is not a named call")
        args, kwargs = list(msg["args"]), dict(msg["kwargs"])
        if method == "demote_exported":
            at_arg = len(args) > 1
            ref = args[1] if at_arg else kwargs.get("slabs")
            if ref is not None:
                slabs = _take(exports[ref[1]], ref[2])
                if at_arg:
                    args[1] = slabs
                else:
                    kwargs["slabs"] = slabs
        value = srv.call_on_loop(
            lambda b: getattr(b, method)(*args, **kwargs),
            timeout_s=msg["timeout_s"])
        if method == "export_prefix":
            keys, slabs = value
            eid = counter["eid"]
            counter["eid"] += 1
            exports[eid] = slabs
            return keys, lockstep.full_slabs(slabs), eid
        if method == "_match_prefix":
            return Match(list(value.blocks))
        return value

    def server(msg):
        method = msg["method"]
        if method not in SERVER_CALLS:
            raise AttributeError(f"{method} is not a server call")
        srv = servers[msg["sid"]]
        if method in ("stop", "shutdown_for_restart"):
            del servers[msg["sid"]]
        return getattr(srv, method)(**msg["kwargs"])

    handlers = {"noop": lambda msg: None,
                "start": lambda msg: start(msg["replica"]),
                "call": call, "server": server}
    try:
        while True:
            msg = channel.recv()
            for eid in msg["forget"]:
                exports.pop(eid, None)
            if msg["op"] == "exit":
                channel.reply("returned", None)
                break
            try:
                value = handlers[msg["op"]](msg)
            except Exception as e:
                channel.reply("raised", (type(e).__name__, str(e)))
                continue
            channel.reply("returned", value)
    finally:
        for srv in servers.values():
            srv.stop()
        if leader is not None:
            leader.stop()
    return dict(lockstep=None if leader is None else leader.stats(),
                replicas=counter["sid"], exports=counter["eid"])


__all__ = [
    "NAMED", "SERVER_CALLS", "Channel", "Match", "RemoteReplica", "SliceLost", "open_channels", "replica_slice",
    "serve_slice", "slice_count",
]
