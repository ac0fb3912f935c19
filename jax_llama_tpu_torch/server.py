"""HTTP serving front-end over ``ContinuousBatcher`` (port of
``jax_llama_tpu/server.py``; the wire format is the JAX package's: the
same JSON fields, status codes, NDJSON framing and ``/metrics`` series
names).

Design constraints, in order:

  * **One device thread.**  The batcher, and with it every CUDA call, is
    driven by a single serving-loop thread, which makes the batcher's
    device current before its first step; HTTP handler threads only
    enqueue work and wait.  Cancellation follows the same rule: a handler
    thread never touches the batcher — it only flips the request's
    ``disconnected`` flag (or the deadline expires), and the loop's
    ``_reap`` scan calls ``batcher.cancel`` at the next step boundary.
    ``/metrics``, ``/healthz`` and ``/debug/*`` read host counters only
    (``stats()``, ``describe()``, the obs rings): no handler reads a CUDA
    tensor or synchronises the device.
  * **Stdlib only.**  ``http.server.ThreadingHTTPServer`` + ``json``.
  * **Chunked decode is transparent here.**  ``step()`` may return up to
    K tokens per slot per call; the loop iterates per-token events, so
    streaming clients receive one NDJSON line per token and the
    delivered-token record (what crash recovery replays from) stays
    token-exact.
  * **Degrade before dying.**  A feature that keeps failing is
    QUARANTINED onto its fallback (``degrade.py``) instead of burning
    the crash-recovery budget: after ``quarantine_threshold``
    attributable failures inside ``quarantine_window_s`` the batcher is
    rebuilt with the feature disabled, in-flight requests replay exactly
    as in crash recovery, and after ``quarantine_cooldown_s`` the
    feature is re-probed (one trial: success re-enables it, failure
    re-quarantines).  Each quarantine is logged, written to the decision
    log, counted in ``/metrics`` and shown in ``/healthz``.  The rungs
    on the card lead from one hand-written kernel to another (splash ->
    the flash kernel, stock-paged -> the paged kernel:
    ``ops.kernels.KernelSpec.fallback``) or drop the draft model
    (speculative -> plain decode, still on the paged kernel).  The
    baseline kernels' rungs onto plain PyTorch (flash attention -> plain
    attention, the paged kernel -> the gathered view) are taken only by
    a batcher on the CPU: on the card a flash or paged kernel failure is
    not attributed, so it goes to the crash-recovery budget and, past
    it, to the breaker that 503s every client.  A non-finite guard fails
    just the request whose logits came back NaN/Inf (HTTP 500 with a
    clean error).
  * **Attributing a real kernel error.**  An injected fault carries its
    site; a real one is recognised by the text the kernel wrappers raise
    (``"<entry> launch failed: cudaError_t <rc>"``) or a failed ``nvcc``
    build, together with the batcher's ``last_dispatch_features``.  A
    sticky CUDA error (``cudaErrorIllegalAddress`` and its kin) poisons
    the context: the rebuild that recovery attempts then fails too, the
    loop dies, and every client gets 503 — the right outcome for a card
    that can no longer run anything.

/healthz (200 when ``ok``, 503 otherwise) carries the JAX package's keys:
``ok``, ``stalled``, ``loop_alive``, ``last_step_age_s``,
``recoveries_total``, ``watchdog_stalls_total``, ``draining``,
``drain_remaining_s``, ``degraded``, ``quarantined``, ``kv`` (the prefix
store, its host tier and the compact summary of its chain digest,
``kvcache.KvDigest``), ``overload`` (``overload.py``),
``replica`` (``serve_mesh``, 1 x 1 off-mesh) and ``features`` (one
entry per degradable feature).

Over a serving mesh of more than one rank (``parallel.serve_mesh``) the
server runs on rank 0 only, and its batcher is seen through the mesh's
lockstep log (``parallel.lockstep``): ``LLMServer(batcher)`` takes the
``LockstepBatcher`` that ``Leader.make`` built (and refuses a plain
batcher on such a mesh), and every call that changes the batcher's host
state or issues a collective (admission, cancels, steps, the degrade
ladder's writes, recovery and quarantine rebuilds, the router's handoff
calls) is published to the follower ranks before it runs, so they apply
it in the same order.  A rank that diverges or is lost stops the loop
(``LockstepError``), which no recovery retries.

Endpoints:
  POST /generate   {"prompt": [ids]} or {"text": "..."} (needs a
                   tokenizer), optional max_new_tokens / temperature /
                   top_p / top_k / seed / stop_tokens / timeout_s /
                   stream / priority ("interactive" default | "batch").
                   Default: blocks until the request finishes; returns
                   {"request_id", "tokens", "text"?}.  "stream": true
                   streams NDJSON, one {"token", "request_id", "text"?}
                   line per token, then a final {"done": true, "tokens":
                   [...]} line.  A client disconnect cancels the request.
                   "timeout_s" bounds the generation (504, or a stream
                   finished with "timeout": true).
  POST /chat       {"messages": [{"role", "content"}, ...]} (needs a
                   server-side chat_format, llama3 ChatFormat).
  GET  /metrics    Prometheus text: ``ContinuousBatcher.stats()`` +
                   degradation / server / SLO / overload scalars (# HELP /
                   # TYPE from ``obs.METRICS``) + the latency histograms
                   + the labeled utilization, build and library families.
  GET  /healthz    schema above.
  GET  /debug/requests[/<id>]   request-timeline JSON.
  GET  /debug/dispatches        recent dispatch-span ring.
  GET  /debug/trace             Chrome/Perfetto trace_event JSON.
  GET  /debug/decisions         control-plane decision audit log.
  GET  /debug/bundle            flight-recorder postmortem artifact.
  GET  /debug/kv[?depth=&n=&since=]   the prefix store's chain digest
                                (``ContinuousBatcher.kv_debug_json``):
                                the bounded node walk, or with
                                ``since`` the journaled events past
                                that version.
  POST /debug/profiler          ``{"action": "start", "log_dir": D}`` /
                                ``{"action": "stop"}``: a torch.profiler
                                session over live traffic, started and
                                stopped on the serving loop, its Chrome
                                trace written under D (one session per
                                process: a second start answers 500).
  GET  /debug/profile/summary   the last completed session's time by
                                serving program
                                (``utils.profiling.summarize_trace``:
                                device and host ms per dispatch label).

Every reply carries the end-to-end request id (the client's
``X-Request-Id`` or a generated one) in its body and an ``X-Request-Id``
header.  Overload control (``overload.py``): per-class pre-admission
queues, cost-based deadline refusals and the brownout ladder, every
refusal a 503 with a load-derived ``Retry-After``.  ``begin_drain()``
finishes in-flight requests and refuses new ones with 503 + Retry-After.
Request bodies are capped at ``max_body_bytes`` (413 past it, or without
a Content-Length).
"""

from __future__ import annotations

import inspect
import json
import math
import queue
import select
import socket
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, unquote, urlsplit

import torch

from .degrade import FEATURES, DegradeManager
from .obs import Observability, StructuredLogger, metric_meta
from .ops.kernels import kernel_specs
from .overload import CANARY, PRIORITIES, RUNG_INDEX, OverloadController
from .parallel import lockstep
from .parallel.serve_mesh import mesh_shape
from .serving import (
    ContinuousBatcher, _round_up, build_batcher, jit_cache_entries,
)
from .utils.profiling import ProfilerSession, summarize_trace

# Injection-site -> degradable-feature attribution for dispatch
# exceptions that carry a site name (InjectedFault.site; the generic
# step/insert/alloc sites stay unattributed and use the crash-recovery
# budget).  The kernel sites are the KernelSpec table's.  Real device
# errors carry no site — they attribute through _KERNEL_ERROR_MARKERS +
# the batcher's last-dispatch record instead.
_SITE_FEATURES = {
    **{s.fault_site: s.feature for s in kernel_specs()},
    "spec_decode": "spec_decode",
    "suffix_insert": "prefix_cache",
}
# The rungs from a baseline kernel onto plain PyTorch, as the ctor
# argument each quarantine rebuild overrides.  Only a batcher on the CPU
# takes them; on the card these features are never attributed.
_PLAIN_RUNGS = {
    "paged_kernel": ("use_pallas_kernel", False),
    "flash_attention": ("attn_impl", "xla"),
}
# Substrings that mark a real (non-injected) dispatch error as coming
# out of a hand-written kernel, matched case-insensitively against the
# exception text: every kernel wrapper raises "<entry> launch failed:
# cudaError_t <rc>" (ops/flash_attention.py, ops/paged_attention.py,
# ops/kernels.py), and a failed build names nvcc (ops/_build.py).
_KERNEL_ERROR_MARKERS = ("launch failed: cudaerror_t", "nvcc")

_DONE = object()  # stream sentinel

# The batcher's own default generation budget — read from the signature
# so the recovery snapshot can never drift from what submit() reserved.
_SUBMIT_DEFAULT_MAX_NEW = inspect.signature(
    ContinuousBatcher.submit
).parameters["max_new_tokens"].default


class _ControlCall:
    """One unit of batcher work scheduled onto the serving-loop thread
    by a foreign thread (``LLMServer.call_on_loop``): the batcher is
    thread-confined, so the router's handoff scheduler drives
    ``export_prefix`` / ``import_prefix`` through this control path
    instead of touching the batcher directly.  ``cancelled`` makes the
    caller's timeout safe: a call abandoned before the loop picked it
    up never runs; one abandoned mid-run completes harmlessly (its
    result is simply dropped)."""

    __slots__ = ("fn", "done", "cancelled", "result", "error")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.cancelled = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


@dataclass
class _Pending:
    payload: Dict[str, Any]
    done: threading.Event = field(default_factory=threading.Event)
    tokens: List[int] = field(default_factory=list)
    error: Optional[str] = None
    error_code: int = 400  # 400 = rejected payload, 503 = server-side
    request_id: Optional[int] = None
    # Streaming: the loop feeds token ids (then _DONE) into ``chunks``;
    # the handler thread drains it onto the socket.
    stream: bool = False
    chunks: "queue.Queue[Any]" = field(default_factory=queue.Queue)
    # Absolute deadline (time.monotonic()); enforced by the loop.
    deadline: Optional[float] = None
    timed_out: bool = False
    # Set by the handler when the client socket dies mid-stream; the loop
    # cancels the request at the next step boundary.
    disconnected: bool = False
    # /chat request: dialog framing on submit, stop ids stripped from the
    # decoded text fields.
    chat: bool = False
    # Client sent its own "stop_tokens": the tokenizer's stop set is no
    # longer protocol framing for this request, so _visible must not
    # strip it from decoded text (it may legitimately appear mid-stream).
    stops_overridden: bool = False
    # "logprobs": true — per-token model logprobs in the response
    # (requires the batcher to be constructed with logprobs=True).
    want_lp: bool = False
    lps: List[float] = field(default_factory=list)
    # Crash-recovery snapshot, recorded at submit time: the CPU-side
    # state a replay needs.  ``tokens`` above is the DELIVERED record —
    # authoritative over the batcher's slot.emitted, which may include
    # tokens an aborted step() never returned; replaying from prompt +
    # delivered regenerates those, so clients neither miss nor repeat
    # tokens.
    prompt_tokens: List[int] = field(default_factory=list)
    submit_kwargs: Dict[str, Any] = field(default_factory=dict)
    max_new: int = _SUBMIT_DEFAULT_MAX_NEW
    replay_seed: Optional[int] = None
    # Recovery clamped this request's continuation budget (the replayed
    # prompt's block padding ate capacity): the reply is shorter than a
    # fault-free run's and says so.
    truncated: bool = False
    # Submit-time monotonic stamp: TTFT = first delivered token minus
    # this (survives crash-recovery resubmits, so the gauge reflects
    # what the CLIENT waited, recovery included).
    submitted_at: Optional[float] = None
    # ReplicaRouter decision (the X-Routed-By request header, e.g.
    # "replica-1/least-loaded"): recorded on the request's timeline at
    # submit so /debug/requests/<id> shows which replica served it.
    route: Optional[str] = None
    # End-to-end request id: the client's X-Request-Id header when
    # supplied, a generated hex id otherwise.  Echoed in every reply
    # (blocking body, each stream line, error bodies) and the key of
    # the request's /debug/requests/<id> timeline — stable across
    # crash-recovery replays, unlike the batcher rid.
    ext_id: str = ""
    # Client-observed latency record for the SLO accounting: TTFT, the
    # worst inter-token gap, and whether this request was already
    # scored (each request is scored exactly once, at its terminal
    # transition).
    ttft_ms: Optional[float] = None
    last_tok_t: Optional[float] = None
    itl_max_ms: Optional[float] = None
    slo_accounted: bool = False
    # Overload control (overload.py): the request's priority class
    # ("interactive" | "batch"; validated in do_POST), its admission
    # cost estimate in prompt tokens (exact for token prompts, a
    # chars/4 heuristic for text/chat — it only feeds the TTFT lower
    # bound and Retry-After, nothing token-exact), and the POST-arrival
    # stamp the pre-admission queue wait is measured from.
    priority: str = "interactive"
    cost_tokens: int = 0
    received_at: Optional[float] = None
    # Retry-After (seconds) for a 503 delivered through fail() — set by
    # the shed path so the reply carries the load-derived header even
    # though the refusal happens long after do_POST returned.
    retry_after_s: Optional[int] = None

    def fail(self, message: str, code: int) -> None:
        self.error = message
        self.error_code = code
        self.done.set()
        self.chunks.put(_DONE)

    def finish(self) -> None:
        self.done.set()
        self.chunks.put(_DONE)


class LLMServer:
    """HTTP wrapper: handler threads enqueue; one loop thread owns the
    batcher and the device."""

    def __init__(
        self,
        batcher: ContinuousBatcher,
        tokenizer: Any = None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_queue: int = 256,
        chat_format: Any = None,
        max_recoveries: int = 3,
        recovery_window_s: float = 60.0,
        watchdog_deadline_s: Optional[float] = 60.0,
        watchdog_interval_s: float = 1.0,
        degrade: Optional[DegradeManager] = None,
        quarantine_threshold: int = 3,
        quarantine_window_s: float = 60.0,
        quarantine_cooldown_s: float = 30.0,
        drain_timeout_s: float = 30.0,
        max_body_bytes: int = 8 << 20,
        logger: Optional[StructuredLogger] = None,
        priority_classes: bool = True,
        overload: Optional[OverloadController] = None,
        brownout_enter_attainment: float = 0.85,
        brownout_exit_attainment: float = 0.95,
        brownout_queue_wait_ms: Optional[float] = None,
        brownout_dwell_s: float = 2.0,
        brownout_cooldown_s: float = 10.0,
        brownout_batch_max_new: int = 64,
        brownout_demote_blocks: int = 32,
        replica_id: Optional[int] = None,
        flight_interval_s: float = 5.0,
    ):
        mesh = getattr(batcher, "mesh", None)
        if (mesh is not None and mesh.size > 1
                and not isinstance(batcher, lockstep.LockstepBatcher)):
            # No other rank would replay what this server does to it.
            raise ValueError(
                f"a batcher on a mesh of {mesh.size} ranks must be built "
                "through lockstep.Leader.make on rank 0 (and "
                "lockstep.follow on the others)")
        self.batcher = batcher
        # Replica index behind a ReplicaRouter (router.py); None when
        # standalone.  Purely observational: /healthz gains a
        # ``replica`` section and /metrics a ``replica_id`` gauge so a
        # fleet scrape can tell the instances apart.
        self.replica_id = replica_id
        # Structured logging (obs.StructuredLogger; run.py --log-json):
        # lifecycle events — recoveries, quarantines, per-request
        # failures — go through one formatter carrying request_id /
        # feature fields.  With no logger supplied a QUIET one is
        # created: stdout stays as silent as the old print-free
        # server, but the flight recorder's /debug/bundle log tail
        # still records every lifecycle line.
        self.logger = (
            logger if logger is not None
            else StructuredLogger(quiet=True)
        )
        self.tokenizer = tokenizer
        self.chat_format = chat_format
        self.max_queue = max_queue
        self.max_body_bytes = int(max_body_bytes)
        # Crash-recovery circuit breaker: at most ``max_recoveries``
        # batcher rebuilds per sliding ``recovery_window_s`` window; one
        # more failure hard-drains (every client 503s) instead of
        # crash-looping a persistently broken device.
        self.max_recoveries = max_recoveries
        self.recovery_window_s = recovery_window_s
        self.recoveries_total = 0
        # Monotonic times of UNATTRIBUTABLE recoveries only — failures
        # attributed to a degradable feature are budgeted by the
        # quarantine threshold/window instead (see _recover).
        self._recovery_times: List[float] = []
        # Degradation layer: failures attributable to a quarantinable
        # feature feed this state machine; a quarantine rebuilds the
        # batcher onto the feature's fallback path instead of tripping
        # the breaker.  The ORIGINAL construction is captured here so a
        # later probe can rebuild with the feature restored (a rebuilt
        # batcher only remembers its own, possibly-degraded, ctor args).
        self.degrade = degrade if degrade is not None else DegradeManager(
            threshold=quarantine_threshold,
            window_s=quarantine_window_s,
            cooldown_s=quarantine_cooldown_s,
        )
        # Quarantine state EDGES land in the serving trace next to the
        # dispatches that caused them (degrade.py only counts totals).
        if self.degrade.on_transition is None:
            self.degrade.on_transition = self.batcher.obs.annotate
        # Overload controller (overload.py): per-class admission
        # queues, the cost-based deadline refusal, and the brownout
        # ladder.  Server-owned like the DegradeManager, so it survives
        # batcher rebuilds; the dispatch sink feeds its throughput
        # EWMAs from the obs records the loop already produces.
        # ``priority_classes=False`` keeps the controller as a plain
        # FIFO with only the depth backstop (the pre-PR-9 behavior,
        # plus the Retry-After header the bare 503 lacked).
        self.overload = overload if overload is not None else (
            OverloadController(
                enabled=priority_classes,
                max_queue=max_queue,
                enter_attainment=brownout_enter_attainment,
                exit_attainment=brownout_exit_attainment,
                queue_wait_ms=brownout_queue_wait_ms,
                slo_ttft_ms=self.batcher.obs.slo_ttft_ms,
                dwell_s=brownout_dwell_s,
                cooldown_s=brownout_cooldown_s,
                batch_max_new=brownout_batch_max_new,
                demote_blocks=brownout_demote_blocks,
            )
        )
        # The depth backstop now lives in the controller; an
        # explicitly-injected controller brings its OWN max_queue, so
        # mirror it back — ``server.max_queue`` must never disagree
        # with the bound actually enforced.
        self.max_queue = self.overload.max_queue
        if self.batcher.obs.on_dispatch is None:
            self.batcher.obs.on_dispatch = self.overload.on_dispatch
        self._base_ctor = batcher.construction()
        # The degrade state the current batcher was built for.
        self._built_disabled: frozenset = frozenset()
        self.quarantine_rebuilds_total = 0
        self.probe_rebuilds_total = 0
        self.nonfinite_failed_total = 0
        # Time-to-first-token EWMA (ms, alpha 0.2) over delivered
        # requests — the latency the fused prefill-decode scheduler
        # (serving.py, run.py --prefill-budget) exists to bound; None
        # until the first request delivers.
        self.ttft_ms_ewma: Optional[float] = None
        # Inter-token-latency EWMA (ms, alpha 0.2) — the per-replica
        # degradation signal the router's health sentinel z-scores off
        # the /healthz scrape.  Canary probes are excluded (a tiny
        # probe's gaps would drag the signal the probe exists to
        # watch).
        self.itl_ms_ewma: Optional[float] = None
        # Synthetic canary probes served (the reserved "canary"
        # request class — router.py sends them; excluded from SLO /
        # goodput / ladder inputs, counted here so a replica can
        # prove its probes are arriving).
        self.canary_requests_total = 0
        # Flight recorder: the serving loop appends a compact metric
        # snapshot to obs.metric_snapshots every flight_interval_s
        # (<= 0 disables), so /debug/bundle carries the trend into an
        # incident, not just the final values.
        self.flight_interval_s = float(flight_interval_s)
        self._last_flight_t = 0.0
        # Features whose LAST completed step's success is still
        # unconfirmed by a host sync (see the probe-success note in
        # _loop); cleared on every rebuild.
        self._pending_success: tuple = ()
        # Drain-on-signal: once set, new POSTs 503 with Retry-After,
        # in-flight requests run to completion (bounded by the deadline)
        # and the loop exits cleanly.
        self.drain_timeout_s = float(drain_timeout_s)
        self._draining = threading.Event()
        self._drain_deadline: Optional[float] = None
        # Step watchdog: the loop heartbeats every iteration; a monitor
        # thread flips /healthz to a degraded payload when the heartbeat
        # goes stale past the deadline (a wedged dispatch, not a crash —
        # crashes drain loudly).  None disables the monitor thread.
        self.watchdog_deadline_s = watchdog_deadline_s
        self.watchdog_interval_s = watchdog_interval_s
        self.watchdog_stalls_total = 0
        self._heartbeat = time.monotonic()
        self._stalled = False
        self._inbox: "queue.Queue[_Pending]" = queue.Queue()
        # Control path (thread-safe queue): foreign threads schedule
        # batcher work (handoff export/import) the loop executes
        # between steps — see call_on_loop.
        self._control: "queue.Queue[_ControlCall]" = queue.Queue()
        # On-demand profiler session (POST /debug/profiler): the active
        # session's log_dir (None when idle) and the session itself,
        # started and stopped on the serving loop (torch.profiler records
        # the ranges of the thread that starts it); _profiler_last_dir
        # remembers the most recently COMPLETED session so GET
        # /debug/profile/summary can attribute it without a log_dir.
        self._profiler_dir: Optional[str] = None
        self._profiler: Optional[ProfilerSession] = None
        self._profiler_last_dir: Optional[str] = None
        self._profiler_lock = threading.Lock()
        self._active: Dict[int, _Pending] = {}
        self._stop = threading.Event()
        self._closed = threading.Event()  # set once the loop has drained
        self._loop_thread = threading.Thread(
            target=self._loop, name="llm-serving-loop", daemon=True
        )
        self._watchdog_thread = (
            threading.Thread(
                target=self._watchdog, name="llm-watchdog", daemon=True
            )
            if watchdog_deadline_s is not None else None
        )

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet test output
                pass

            def _reply(self, code: int, body: bytes, ctype: str,
                       headers: Optional[Dict[str, str]] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, obj: Dict[str, Any],
                            headers: Optional[Dict[str, str]] = None):
                self._reply(
                    code, json.dumps(obj).encode(), "application/json",
                    headers,
                )

            def do_GET(self):
                parts = urlsplit(self.path)
                route, query = parts.path, parse_qs(parts.query)

                def qint(name: str, default: int) -> int:
                    try:
                        return int(query.get(name, [default])[0])
                    except ValueError:
                        return default

                if route == "/healthz":
                    h = server._health()
                    self._reply_json(200 if h["ok"] else 503, h)
                elif route == "/metrics":
                    self._reply(
                        200, server._metrics_text().encode(),
                        "text/plain; version=0.0.4",
                    )
                elif route == "/debug/requests":
                    self._reply_json(
                        200, server.obs.requests_json(qint("n", 64))
                    )
                elif route.startswith("/debug/requests/"):
                    rid = unquote(route[len("/debug/requests/"):])
                    tl = server.obs.timeline_json(rid)
                    if tl is None:
                        self._reply_json(
                            404,
                            {"error": f"unknown request id {rid!r} "
                                      "(timeline evicted or never seen)"},
                        )
                    else:
                        self._reply_json(200, tl)
                elif route == "/debug/dispatches":
                    self._reply_json(
                        200, server.obs.dispatches_json(qint("n", 128))
                    )
                elif route == "/debug/decisions":
                    # Decision audit log: ?kind= filters one decision
                    # class, ?request_id= joins to a request timeline.
                    self._reply_json(
                        200,
                        server.obs.decisions.json(
                            n=qint("n", 128),
                            kind=(query.get("kind") or [None])[0],
                            request_id=(
                                query.get("request_id") or [None]
                            )[0],
                        ),
                    )
                elif route == "/debug/bundle":
                    # Flight-recorder postmortem artifact (?trace=0
                    # drops the Perfetto doc for a lighter pull).
                    self._reply_json(
                        200,
                        server.bundle_json(trace=qint("trace", 1) > 0),
                    )
                elif route == "/debug/kv":
                    # The chain digest's walk (depth-capped, node-
                    # bounded), or with ?since=V its journaled events:
                    # reads only the lock-guarded digest, never the
                    # loop-owned store.
                    depth = qint("depth", 0)
                    since = qint("since", -1)
                    self._reply_json(200, server.batcher.kv_debug_json(
                        depth=depth if depth > 0 else None,
                        max_nodes=qint("n", 2048),
                        since=since if since >= 0 else None))
                elif route == "/debug/trace":
                    window_ms = None
                    if "window_s" in query:
                        try:
                            window_ms = (
                                float(query["window_s"][0]) * 1000.0
                            )
                        except ValueError:
                            self._reply_json(
                                400, {"error": "bad window_s"}
                            )
                            return
                    self._reply_json(
                        200, server.obs.trace_json(window_ms)
                    )
                elif route == "/debug/profile/summary":
                    self._reply_json(*server._profile_summary(query))
                else:
                    self._reply_json(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in (
                    "/generate", "/chat", "/debug/profiler"
                ):
                    self._reply_json(404, {"error": "not found"})
                    return
                # End-to-end request id: honor the client's
                # X-Request-Id (so a failure is traceable from THEIR
                # logs), otherwise mint one; echoed in every reply from
                # here on — including the refusals below.
                ext_id = (
                    self.headers.get("X-Request-Id") or ""
                ).strip()[:128] or uuid.uuid4().hex[:16]
                # Every refusal below carries the id as a header too —
                # proxies correlate on headers, not 4xx/5xx bodies.
                rid_hdr = {"X-Request-Id": ext_id}
                is_debug = self.path == "/debug/profiler"
                if not is_debug and (
                    server._draining.is_set() or server._closed.is_set()
                ):
                    # Drain mode / shutdown: refuse BEFORE reading the
                    # body, with Retry-After so well-behaved clients back
                    # off until a replacement instance is routable.
                    self._reply_json(
                        503,
                        {"error": (
                            "server draining; retry later"
                            if server._draining.is_set()
                            and not server._closed.is_set()
                            else "server shutting down"
                        ), "request_id": ext_id},
                        headers={
                            "Retry-After": str(server._retry_after_s()),
                            **rid_hdr,
                        },
                    )
                    return
                # Body-size cap: the client-supplied Content-Length used
                # to be trusted unboundedly — a hostile length could pin
                # max_queue * max_body bytes of handler-thread memory.
                # Oversized or missing lengths are refused before any
                # read.
                cl = self.headers.get("Content-Length")
                if cl is None:
                    self._reply_json(
                        413, {"error": "Content-Length required",
                              "request_id": ext_id},
                        headers=rid_hdr,
                    )
                    return
                try:
                    n = int(cl)
                    if n < 0:
                        raise ValueError(cl)
                except ValueError:
                    self._reply_json(
                        400, {"error": f"bad Content-Length: {cl!r}",
                              "request_id": ext_id},
                        headers=rid_hdr,
                    )
                    return
                if n > server.max_body_bytes:
                    self._reply_json(
                        413,
                        {"error": (
                            f"request body too large ({n} bytes > "
                            f"{server.max_body_bytes} allowed)"
                        ), "request_id": ext_id},
                        headers=rid_hdr,
                    )
                    return
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply_json(
                        400, {"error": f"bad request: {e}",
                              "request_id": ext_id},
                        headers=rid_hdr,
                    )
                    return
                if not isinstance(payload, dict):
                    # A JSON list/string/number parses fine but every
                    # consumer downstream calls payload.get — refuse
                    # here, not via an AttributeError traceback that
                    # closes the socket with no HTTP response.
                    self._reply_json(
                        400, {"error": "request body must be a JSON "
                                       "object", "request_id": ext_id},
                        headers=rid_hdr,
                    )
                    return
                if is_debug:
                    self._reply_json(*server._handle_profiler(payload))
                    return
                # Priority class (overload.py): optional "priority"
                # field, strictly validated — junk is the client's
                # defect (400), not a silent default that would let a
                # typo'd "interactiv" jump the batch queue.
                priority = payload.get("priority", "interactive")
                if priority not in PRIORITIES and priority != CANARY:
                    # CANARY is the router's reserved probe class:
                    # accepted (it rides the interactive queue) but
                    # excluded from SLO/goodput/ladder accounting.
                    self._reply_json(
                        400,
                        {"error": (
                            f'"priority" must be one of '
                            f'{list(PRIORITIES)}, got {priority!r}'
                        ), "request_id": ext_id},
                        headers=rid_hdr,
                    )
                    return
                # timeout_s parses BEFORE admission: the deadline-aware
                # refusal needs it, and a malformed value must 400, not
                # feed the cost model garbage.  NaN would make every
                # deadline comparison False and silently disable the
                # bound; inf is equally useless.
                timeout_s = payload.get("timeout_s")
                t = None
                if timeout_s is not None:
                    try:
                        t = float(timeout_s)
                        if not math.isfinite(t):
                            raise ValueError(timeout_s)
                    except (TypeError, ValueError):
                        self._reply_json(
                            400,
                            {"error": "timeout_s must be a finite number",
                             "request_id": ext_id},
                            headers=rid_hdr,
                        )
                        return
                # Admission control (overload.py): the queue-depth
                # backstop (each blocked POST holds an OS thread for
                # the full generation, so an unbounded inbox is an
                # unbounded thread/memory leak under flood), the
                # brownout ladder's batch-class gate, and the
                # cost-based deadline proof.  Every refusal is a 503
                # with a load-derived Retry-After.
                # audit: racy-read(admission-bound estimate: _active
                # is mutated by the loop thread; an off-by-a-few depth
                # only shifts when the 503 overload refusal fires)
                depth = (
                    server._inbox.qsize() + len(server._active)
                    + server.overload.queued_total()
                )
                cost = server._cost_estimate(payload)
                refusal = server.overload.admit(priority, cost, t, depth)
                if refusal is not None:
                    self._reply_json(
                        503,
                        {"error": refusal.reason, "request_id": ext_id},
                        headers={
                            "Retry-After": str(refusal.retry_after_s),
                            **rid_hdr,
                        },
                    )
                    return
                now = time.monotonic()
                pending = _Pending(
                    payload=payload, stream=bool(payload.get("stream")),
                    chat=self.path == "/chat",
                    want_lp=bool(payload.get("logprobs")),
                    ext_id=ext_id,
                    priority=priority, cost_tokens=cost,
                    # TTFT counts from POST arrival: with per-class
                    # queues a request can wait pre-admission far
                    # longer than the old always-drained inbox, and
                    # the client's clock started here.
                    received_at=now, submitted_at=now,
                    route=(
                        self.headers.get("X-Routed-By") or ""
                    ).strip()[:64] or None,
                )
                if t is not None:
                    pending.deadline = now + t
                server._inbox.put(pending)
                if pending.stream:
                    self._stream_reply(pending)
                else:
                    self._blocking_reply(pending)

            def _client_gone(self) -> bool:
                # Readable-EOF probe: a closed client socket selects
                # readable and MSG_PEEK returns b"".  Without this, a
                # client that disconnects while its request is QUEUED or
                # mid-generation (no tokens flowing to a blocking caller,
                # so no write ever fails) would keep its slot, blocks,
                # and decode work until natural completion.
                # Known trade-off: a client that half-closes
                # (shutdown(SHUT_WR)) after POSTing and then waits to
                # read is indistinguishable from a vanished one at this
                # layer and gets cancelled; HTTP/1.1 clients that
                # half-close are rare and widely treated as aborts
                # (nginx/gunicorn behave the same way).
                try:
                    r, _, _ = select.select([self.connection], [], [], 0)
                    if not r:
                        return False
                    return (
                        self.connection.recv(1, socket.MSG_PEEK) == b""
                    )
                except (OSError, ValueError):
                    return True

            def _blocking_reply(self, pending: "_Pending"):
                # Poll _closed so a request enqueued just as the loop dies
                # (put racing the final drain) still unblocks.
                while not pending.done.wait(timeout=1.0):
                    if server._closed.is_set() and not pending.done.is_set():
                        pending.fail("server shutting down", 503)
                        break
                    if self._client_gone():
                        pending.disconnected = True
                        return  # the loop reaps the request
                rid_hdr = {"X-Request-Id": pending.ext_id}
                if pending.timed_out:
                    body: Dict[str, Any] = {
                        "error": "generation timed out",
                        "request_id": pending.ext_id,
                        "tokens": pending.tokens,
                    }
                    if pending.want_lp:
                        # Partial results keep their logprobs — the
                        # streaming timeout final line already does.
                        body["logprobs"] = pending.lps
                    self._reply_json(504, body, headers=rid_hdr)
                    return
                if pending.error is not None:
                    if pending.retry_after_s is not None:
                        # Shed under overload: the 503 carries the
                        # load-derived Retry-After like every other
                        # refusal path.
                        rid_hdr = {
                            "Retry-After": str(pending.retry_after_s),
                            **rid_hdr,
                        }
                    self._reply_json(
                        pending.error_code,
                        {"error": pending.error,
                         "request_id": pending.ext_id},
                        headers=rid_hdr,
                    )
                    return
                out: Dict[str, Any] = {
                    "request_id": pending.ext_id,
                    "tokens": pending.tokens,
                }
                if pending.truncated:
                    out["truncated"] = True
                if pending.want_lp:
                    out["logprobs"] = pending.lps
                if server.tokenizer is not None:
                    out["text"] = server.tokenizer.decode(
                        server._visible(pending.tokens, pending)
                    )
                self._reply_json(200, out, headers=rid_hdr)

            def _stream_reply(self, pending: "_Pending"):
                """NDJSON token stream; body is close-delimited (no
                Content-Length).  Response headers are DEFERRED until
                the first event: a stream request that terminates
                before emitting any token (shed under overload, queued
                past its deadline, server drain) gets a REAL HTTP
                error status — 503s with the load-derived Retry-After
                — instead of a 200 stream whose only line is an error
                (load balancers and retry layers act on status codes,
                not NDJSON bodies).  A failed socket write marks the
                request disconnected; the loop cancels it at the next
                step."""
                started = False

                def start_stream() -> None:
                    nonlocal started
                    if started:
                        return
                    started = True
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "application/x-ndjson"
                    )
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.send_header("X-Request-Id", pending.ext_id)
                    self.end_headers()

                def emit(obj: Dict[str, Any]) -> bool:
                    try:
                        start_stream()
                        self.wfile.write(json.dumps(obj).encode() + b"\n")
                        self.wfile.flush()
                        return True
                    except OSError:
                        pending.disconnected = True
                        return False

                while True:
                    try:
                        ev = pending.chunks.get(timeout=1.0)
                    except queue.Empty:
                        if server._closed.is_set():
                            pending.fail("server shutting down", 503)
                            ev = _DONE
                        elif self._client_gone():
                            pending.disconnected = True
                            return  # the loop reaps the request
                        else:
                            continue
                    if ev is _DONE:
                        break
                    tok, lp = ev
                    # Every stream event carries the end-to-end id, so a
                    # line-oriented log pipeline can attribute a
                    # mid-stream failure without joining on the socket.
                    line: Dict[str, Any] = {
                        "token": tok, "request_id": pending.ext_id,
                    }
                    if lp is not None:
                        line["logprob"] = lp
                    if server.tokenizer is not None:
                        line["text"] = server.tokenizer.decode(
                            server._visible([tok], pending)
                        )
                    if not emit(line):
                        return  # client gone; the loop reaps the request
                if not started and not pending.tokens and (
                    pending.error is not None or pending.timed_out
                ):
                    # Terminal before any token flowed: reply with the
                    # real status (the stream never started, so the
                    # status line is still ours to send).
                    code = (
                        504 if pending.timed_out else pending.error_code
                    )
                    headers = {"X-Request-Id": pending.ext_id}
                    if pending.retry_after_s is not None:
                        headers["Retry-After"] = str(
                            pending.retry_after_s
                        )
                    self._reply_json(
                        code,
                        {"error": (
                            pending.error or "generation timed out"
                        ), "request_id": pending.ext_id},
                        headers=headers,
                    )
                    return
                final: Dict[str, Any] = {
                    "done": True,
                    "request_id": pending.ext_id,
                    "tokens": pending.tokens,
                }
                if pending.truncated:
                    final["truncated"] = True
                if pending.want_lp:
                    final["logprobs"] = pending.lps
                if pending.timed_out:
                    final["timeout"] = True
                if pending.error is not None:
                    final["error"] = pending.error
                emit(final)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, name="llm-http", daemon=True
        )

    # -- lifecycle ----------------------------------------------------------

    @property
    def obs(self) -> Observability:
        """The shared observability sink (rides the batcher so it
        survives quarantine/recovery rebuilds — same lifetime rule as
        the fault injector)."""
        return self.batcher.obs

    def _log(self, event: str, message: str = "", **fields) -> None:
        # self.logger is never None (the ctor substitutes a quiet
        # ring-only logger), so every event reaches the bundle tail.
        self.logger.log(event, message, **fields)

    def _slo_finalize(self, p: "_Pending", completed: bool) -> None:
        """Score one request against the configured SLOs, exactly once,
        at its terminal transition (finish / fail / timeout).  Client
        disconnects are NOT scored — the latency a vanished client
        would have observed is unattributable, and counting aborts as
        misses would let a flaky client poison the attainment gauges."""
        if p.slo_accounted:
            return
        p.slo_accounted = True
        if p.priority == CANARY:
            # Reserved probe class (overload.CANARY): a canary is the
            # ROUTER measuring this replica, never workload — scoring
            # it would let the probe distort the attainment gauges
            # and (worse) feed the brownout ladder its own probes.
            return
        self.obs.slo_account(
            p.ttft_ms, p.itl_max_ms, len(p.tokens), completed=completed
        )
        # Per-class window for the brownout ladder (overload.py) —
        # the same pass/fail math as slo_account (an unset dimension
        # always passes); the ladder reads the interactive window.
        o = self.obs
        ttft_ok = completed and (
            o.slo_ttft_ms is None
            or (p.ttft_ms is not None and p.ttft_ms <= o.slo_ttft_ms)
        )
        itl_ok = completed and (
            o.slo_itl_ms is None
            or p.itl_max_ms is None or p.itl_max_ms <= o.slo_itl_ms
        )
        self.overload.note_slo(
            p.priority, ttft_ok, itl_ok, completed and ttft_ok and itl_ok
        )

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "LLMServer":
        # audit: unguarded(happens-before: the loop/watchdog threads
        # start below, after this write)
        self._heartbeat = time.monotonic()
        self._loop_thread.start()
        if self._watchdog_thread is not None:
            self._watchdog_thread.start()
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._loop_thread.join(timeout=30)
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=10)
        if (isinstance(self.batcher, lockstep.LockstepBatcher)
                and not self._loop_thread.is_alive()):
            # The follower ranks drop their copy of this batcher too.
            self.batcher.release()

    def call_on_loop(self, fn, timeout_s: float = 30.0):
        """Run ``fn(batcher)`` on the serving-loop thread (the
        batcher's single owner) and return its result — the control
        path the router's cache-aware handoff scheduler uses to drive
        ``export_prefix`` / ``import_prefix`` without violating thread
        confinement.  Blocks the CALLING thread up to ``timeout_s``;
        past it the call is cancelled (never runs if the loop had not
        picked it up; a call already mid-run completes and its result
        drops) and :class:`TimeoutError` raises — so a wedged or
        heavily loaded loop bounds the scheduler instead of hanging
        it.  Raises ``TimeoutError`` immediately when the loop is not
        running (stopped / crashed / never started)."""
        if self._closed.is_set() or not self._loop_thread.is_alive():
            raise TimeoutError("serving loop is not running")
        call = _ControlCall(fn)
        self._control.put(call)
        if not call.done.wait(timeout_s):
            call.cancelled.set()
            raise TimeoutError(
                f"control call did not complete within {timeout_s}s"
            )
        if call.error is not None:
            raise call.error
        return call.result

    def _drain_control(self) -> None:
        """Execute queued control calls (loop thread only).  Errors
        are CAPTURED into the call — a failed handoff export must
        never take down the device-owning thread — except a lockstep
        error, which the caller gets and the loop dies of."""
        while True:
            try:
                call = self._control.get_nowait()
            except queue.Empty:
                return
            if call.cancelled.is_set():
                continue
            try:
                call.result = call.fn(self.batcher)
            except BaseException as e:
                call.error = e
            call.done.set()
            if isinstance(call.error, lockstep.LockstepError):
                raise call.error

    def begin_drain(self, timeout_s: Optional[float] = None) -> None:
        """Flip the server into drain mode (the SIGTERM/SIGINT path):
        in-flight requests run to completion, new POSTs get 503 +
        Retry-After, and the serving loop exits once idle — or once
        ``timeout_s`` (default ``drain_timeout_s``) elapses, at which
        point stragglers are failed with 503.  Idempotent: the first
        call pins the deadline.  HTTP listeners stay up through the
        drain (clients must be able to read their streams and /healthz
        must report the drain); call ``stop()`` after ``wait_drained``
        to close the sockets."""
        if self._draining.is_set():
            return
        t = self.drain_timeout_s if timeout_s is None else float(timeout_s)
        self._drain_deadline = time.monotonic() + max(0.0, t)
        self._draining.set()
        self.obs.decisions.record("drain", timeout_s=round(t, 3))

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until the serving loop has exited (drain complete or
        hard stop); returns False on timeout."""
        return self._closed.wait(timeout)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def wait_idle(
        self, timeout_s: float = 30.0, poll_s: float = 0.05,
    ) -> bool:
        """Fleet-controller drain hook: block until the serving loop is
        idle (no admitted work) WITHOUT tearing it down — unlike
        ``begin_drain``, the loop stays alive afterwards so control
        calls (the session-migration ``export_prefix`` path) still run.
        The controller stops routing to this replica first, then waits
        here for stragglers to finish; returns False on timeout (the
        drain aborts and the replica resumes).  Each probe runs on the
        loop thread between steps, so a True result is an exact
        no-admitted-work snapshot, not a racy guess."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while True:
            try:
                if self.call_on_loop(
                    lambda b: not b.pending(), timeout_s=timeout_s,
                ):
                    return True
            except TimeoutError:
                return False
            if time.monotonic() >= deadline:
                return False
            time.sleep(poll_s)

    def shutdown_for_restart(self, grace_s: float = 5.0) -> bool:
        """Rollout restart hook: bounded drain + full stop in one call.
        The controller swaps a freshly built replacement into the
        router FIRST (sessions already migrated off), then retires this
        instance — any straggler past ``grace_s`` fails with 503 rather
        than wedging the rung.  Returns True when the loop exited
        within the grace window."""
        self.begin_drain(timeout_s=grace_s)
        ok = self.wait_drained(grace_s + 10.0)
        self.stop()
        return ok

    def _retry_after_s(self) -> int:
        """Retry-After value for drain-mode 503s: the remaining drain
        budget, rounded up — after that a replacement instance should be
        routable."""
        dl = self._drain_deadline
        if dl is None:
            return max(1, int(math.ceil(self.drain_timeout_s)))
        return max(1, int(math.ceil(dl - time.monotonic())))

    @staticmethod
    def _cost_estimate(payload: Dict[str, Any]) -> int:
        """Admission-cost estimate in prompt tokens: exact for token
        prompts, a chars/4 heuristic for text and chat dialogs (BPE
        averages ~4 chars/token on English text).  Feeds only the
        overload controller's TTFT lower bound and Retry-After — an
        estimate by design, never token accounting."""
        p = payload.get("prompt")
        if isinstance(p, (list, tuple)):
            return len(p)
        text = payload.get("text")
        if isinstance(text, str):
            return max(1, len(text) // 4)
        msgs = payload.get("messages")
        if isinstance(msgs, list):
            n = sum(
                len(m["content"]) // 4
                for m in msgs
                if isinstance(m, dict)
                and isinstance(m.get("content"), str)
            )
            # + a few framing tokens per message (role headers).
            return max(1, n + 4 * len(msgs))
        return 1

    def _apply_overload_knobs(self, entering: bool = False) -> None:
        """Apply the current brownout rung's knobs to the batcher
        (loop thread only — the batcher has a single owner).  Called
        on every ladder transition AND after every batcher rebuild: a
        rebuilt batcher starts from the base ctor's prefill budget, so
        the rung's shrink must be re-applied or a crash recovery would
        silently reset the brownout.  ``entering=True`` additionally
        fires the rung's one-shot host-tier demotion sweep (an
        operational HBM-pressure release, not a steady-state drain).
        The batch-class max_new cap is NOT applied here — it clamps at
        ``_submit`` time, so it follows the ladder dynamically."""
        kn = self.overload.knobs()
        base = int(self._base_ctor[2].get("prefill_budget", 0) or 0)
        if base > 0 and not self.batcher.spec:
            # Shrink, never zero: prefill_budget=0 would flip the
            # batcher to classic whole-prompt admission — the opposite
            # of protecting ITL.
            self.batcher.prefill_budget = max(
                1, int(base * kn.prefill_budget_scale)
            )
        if entering and kn.demote_blocks > 0:
            self.batcher.demote_idle(kn.demote_blocks)

    def __enter__(self) -> "LLMServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- serving loop (sole owner of the batcher) ---------------------------

    def _visible(self, tokens: List[int], p: "_Pending") -> List[int]:
        """Tokens to DECODE for a reply: /chat strips the tokenizer's stop
        ids (the eot/eos framing is protocol, not assistant text);
        /generate returns everything verbatim.  A /chat request that sent
        its own "stop_tokens" is also verbatim — the tokenizer's stop set
        is not framing for it, and a mid-stream eot the client asked to
        generate past must survive into "text"."""
        if not p.chat or p.stops_overridden:
            return list(tokens)
        stops = set(getattr(self.tokenizer, "stop_tokens", None) or ())
        return [t for t in tokens if t not in stops]

    def _submit(self, p: _Pending) -> None:
        payload = p.payload
        if p.want_lp and not getattr(self.batcher, "logprobs", False):
            raise ValueError(
                '"logprobs" needs a batcher constructed with '
                "logprobs=True (run.py: --logprobs)"
            )
        if p.chat:
            if self.chat_format is None:
                raise ValueError(
                    "/chat needs a server-side chat_format "
                    "(e.g. tokenizers.llama3.ChatFormat)"
                )
            messages = payload.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ValueError(
                    'missing "messages" (non-empty list of '
                    '{"role", "content"})'
                )
            for m in messages:
                # Type-check the values too: ChatFormat calls .strip() /
                # encode() on them, and an AttributeError from a payload
                # is not in the loop's caught-error set — one malformed
                # request must never kill the device-owning thread.
                if (
                    not isinstance(m, dict)
                    or not isinstance(m.get("role"), str)
                    or not isinstance(m.get("content"), str)
                ):
                    raise ValueError(
                        'each message needs string "role" and "content"'
                    )
            tokens = self.chat_format.encode_dialog_prompt(messages)
        elif "prompt" in payload:
            tokens = [int(t) for t in payload["prompt"]]
        elif "text" in payload:
            if self.tokenizer is None:
                raise ValueError(
                    '"text" prompts need a server-side tokenizer; send '
                    'token ids as "prompt"'
                )
            tokens = self.tokenizer.encode(
                payload["text"], bos=True, eos=False
            )
        else:
            raise ValueError('missing "prompt" (token ids) or "text"')
        kwargs: Dict[str, Any] = {}
        for k in ("max_new_tokens", "top_k", "seed"):
            if payload.get(k) is not None:
                kwargs[k] = int(payload[k])
        # Brownout cap (overload.py): at brownout-1 and deeper the
        # ladder caps batch-class generation budgets so each batch
        # admission returns its slot and blocks sooner; interactive
        # budgets are never touched.
        cap = self.overload.knobs().batch_max_new_cap
        if cap > 0 and p.priority == "batch":
            kwargs["max_new_tokens"] = min(
                int(kwargs.get("max_new_tokens", _SUBMIT_DEFAULT_MAX_NEW)),
                cap,
            )
        for k in ("temperature", "top_p"):
            if payload.get(k) is not None:
                kwargs[k] = float(payload[k])
        if payload.get("stop_tokens") is not None:
            kwargs["stop_tokens"] = tuple(
                int(t) for t in payload["stop_tokens"]
            )
            p.stops_overridden = True
        elif p.chat:
            # Dialog completions stop at the tokenizer's stop set
            # (llama3: end_of_text + eot_id) unless overridden.
            stops = getattr(self.tokenizer, "stop_tokens", None)
            if stops:
                kwargs["stop_tokens"] = tuple(int(t) for t in stops)
        rid = self.batcher.submit(tokens, **kwargs)
        p.request_id = rid
        if p.priority == CANARY:
            self.canary_requests_total += 1
        # The batcher opened the timeline under a provisional r<rid>
        # key; attach the END-TO-END id so /debug/requests/<ext_id>
        # resolves (replays re-bind their fresh rid into the same
        # timeline — see _rebuild_and_replay).
        self.obs.bind(rid, p.ext_id)
        if p.route is not None:
            # Router decision onto the timeline + annotation ring —
            # /debug/requests/<id> shows which replica served it.
            self.obs.set_route(p.ext_id, p.route)
        if p.submitted_at is None:  # replays keep the original stamp
            p.submitted_at = time.monotonic()
        # Snapshot the replay state (crash recovery resubmits from it):
        # original prompt, resolved sampling kwargs, and the seed pinned
        # to its resolved value — a replayed request gets a new id, so
        # leaving the seed implicit would silently fork its chain.
        p.prompt_tokens = list(tokens)
        p.submit_kwargs = dict(kwargs)
        p.max_new = int(kwargs.get("max_new_tokens", _SUBMIT_DEFAULT_MAX_NEW))
        p.replay_seed = (
            int(kwargs["seed"]) if kwargs.get("seed") is not None
            else self.batcher.default_seed(rid)
        )
        self._active[rid] = p

    def _reap(self) -> None:
        """Cancel expired and disconnected requests (loop thread only —
        the batcher has a single owner)."""
        now = time.monotonic()
        for rid, p in list(self._active.items()):
            expired = p.deadline is not None and now >= p.deadline
            if not (expired or p.disconnected):
                continue
            # Timeouts record as FAILED (the registry counts timeouts
            # under requests_failed_total); only disconnects and
            # explicit cancels are "cancelled".
            self.batcher.cancel(
                rid,
                outcome="cancelled" if p.disconnected else "failed",
                error=None if p.disconnected else "generation timed out",
            )
            del self._active[rid]
            if p.disconnected:
                self._log(
                    "request_disconnected", request_id=p.ext_id, rid=rid
                )
                p.finish()  # nobody is reading; just release state
            elif p.stream:
                p.timed_out = True
                self._slo_finalize(p, completed=False)
                self._log(
                    "request_timeout", request_id=p.ext_id, rid=rid,
                    tokens=len(p.tokens),
                )
                p.finish()
            else:
                p.timed_out = True
                self._slo_finalize(p, completed=False)
                self._log(
                    "request_timeout", request_id=p.ext_id, rid=rid,
                    tokens=len(p.tokens),
                )
                p.fail("generation timed out", 504)

    def _reap_preadmission(self) -> None:
        """Deadline/disconnect reaping for requests still waiting in
        the overload controller's class queues — the pre-admission arm
        of ``_reap``.  These checks used to happen at inbox pop, but
        the per-class queues can hold an entry much longer (a batch
        request behind a brownout, anything behind a backlog)."""
        expired, gone = self.overload.reap(time.monotonic())
        for p in gone:
            self._log("request_disconnected", request_id=p.ext_id)
            p.finish()  # client vanished before admission
        for p in expired:
            # Expired while queued — the overload signature.  These
            # worst-latency requests MUST hit the SLO window, or
            # attainment reads healthy exactly when the server is
            # drowning; and they get a terminal timeline + failed
            # count even though no batcher rid ever existed, so
            # /debug/requests/<id> explains the 504.
            p.timed_out = True
            self._slo_finalize(p, completed=False)
            self.obs.request_rejected(
                p.ext_id,
                "generation timed out before admission "
                "(server overloaded)",
            )
            self._log(
                "request_timeout", "expired pre-admission",
                request_id=p.ext_id,
            )
            p.fail("generation timed out", 504)

    def _attribute(self, exc: BaseException) -> Optional[str]:
        """Map a dispatch exception to the degradable feature that
        caused it, or None (generic failure -> crash-recovery budget).
        Injected faults from the kernel/spec/suffix sites carry their
        site name; real device errors are recognized by the kernel
        wrappers' launch-failure text (or a failed build) plus the
        batcher's last-dispatch record.  On the card a feature whose
        only fallback is plain PyTorch (``_PLAIN_RUNGS``) is never
        returned: its failure is a crash, not a quarantine."""
        site = getattr(exc, "site", None)
        feature = _SITE_FEATURES.get(site)
        text = f"{type(exc).__name__}: {exc}".lower()
        if feature is None and any(m in text for m in _KERNEL_ERROR_MARKERS):
            feats = getattr(self.batcher, "last_dispatch_features", ())
            # Opt-in kernels first (kernel_specs' order): when a
            # dispatch ran the splash or stock kernel it ALSO exercised
            # the baseline kernel's path (both feature names are in
            # feats), and quarantining the opt-in rung first keeps the
            # fallback ladder one step at a time (splash -> flash,
            # stock-paged -> paged).
            feature = next((s.feature for s in kernel_specs()
                            if s.feature in feats), None)
        if feature in _PLAIN_RUNGS and self.batcher.device.type == "cuda":
            return None
        return feature

    def _disabled_features(self) -> frozenset:
        """The features a batcher built now runs without (probing
        features count as enabled — that is what a probe rebuild is)."""
        return frozenset(f for f in FEATURES if not self.degrade.enabled(f))

    def _build_batcher(self) -> ContinuousBatcher:
        """A fresh batcher for the current degrade state.  When that is
        the state the current batcher was built for (a crash recovery),
        ``ContinuousBatcher.rebuild()`` reproduces it; otherwise the
        ORIGINAL construction is rebuilt with every quarantined feature
        swapped for its fallback (on a serving mesh, on every rank: the
        overrides are plain values a follower applies to its own
        construction)."""
        disabled = self._disabled_features()
        if disabled == self._built_disabled:
            return self.batcher.rebuild()
        # The batcher this one replaces is dropped: its swap-in copies
        # must land before their staging memory goes.
        self.batcher._quiesce_restores()
        kw: Dict[str, Any] = {}
        # Kernel-selection rungs: each falls back to another custom
        # kernel (ctor kwargs override the config fields, so this wins
        # over a baked-in "splash"/"stock-paged"/"auto").
        for spec in kernel_specs():
            if spec.fallback and spec.feature in disabled:
                kw[f"{spec.role}_kernel"] = spec.fallback
        if "spec_decode" in disabled:
            kw["draft_params"] = None
            kw["draft_config"] = None
        if "prefix_cache" in disabled:
            kw["prefix_cache"] = False
        for feature, (arg, value) in _PLAIN_RUNGS.items():
            if feature in disabled:
                kw[arg] = value
        if isinstance(self.batcher, lockstep.LockstepBatcher):
            batcher = self.batcher.build(kw)
        else:
            batcher = build_batcher(self._base_ctor, kw)
        self._built_disabled = disabled
        return batcher

    def _recover(self, exc: BaseException) -> bool:
        """Crash recovery: rebuild the batcher (fresh pool + host state
        from the still-held params) and resubmit every live request from
        the CPU-side snapshot each ``_Pending`` carries — original
        prompt + DELIVERED tokens as the replay prompt, remaining token
        budget, same sampling params/stops, seed pinned to its resolved
        value.  Greedy requests continue token-identically (teacher-
        forced prefix); streaming clients see only fresh continuation
        tokens, never a repeat, because the replay prompt already
        contains everything they received.

        Failures attributable to a degradable feature are budgeted by
        the QUARANTINE state machine instead of the breaker: each one
        rebuilds and replays like any recovery, but the bound on them is
        the feature's threshold/window (past it the feature falls back
        and the failures stop), not ``max_recoveries`` — so quarantine
        is reachable for ANY threshold, including thresholds above the
        breaker budget.  Once a feature is on its fallback, continuing
        crashes are unattributable and fill the breaker window normally,
        which keeps the hard-drain backstop for wrong attributions.

        Returns False when the circuit breaker trips (``max_recoveries``
        unattributable rebuilds inside ``recovery_window_s``): the
        caller re-raises and the finally-drain 503s every client
        instead of crash-looping."""
        if isinstance(exc, lockstep.LockstepError):
            # The ranks can no longer agree: nothing a rebuild can mend.
            return False
        feature = self._attribute(exc)
        if feature is not None:
            if self.degrade.record_failure(feature):
                self.quarantine_rebuilds_total += 1
                self._log(
                    "quarantine", f"{feature} quarantined: {exc!r}",
                    feature=feature,
                )
                self.obs.decisions.record(
                    "quarantine", feature=feature, error=repr(exc),
                )
            self.recoveries_total += 1
            self._log(
                "crash_recovery", repr(exc), feature=feature,
                recoveries_total=self.recoveries_total,
            )
            self.obs.decisions.record(
                "recovery", feature=feature, error=repr(exc),
                recoveries_total=self.recoveries_total,
            )
            self._rebuild_and_replay()
            return True
        now = time.monotonic()
        self._recovery_times = [
            t for t in self._recovery_times
            if now - t < self.recovery_window_s
        ]
        if len(self._recovery_times) >= self.max_recoveries:
            self.obs.decisions.record(
                "recovery_breaker_tripped", error=repr(exc),
                recoveries_in_window=len(self._recovery_times),
            )
            return False
        self._recovery_times.append(now)
        self.recoveries_total += 1
        self._log(
            "crash_recovery", repr(exc),
            recoveries_total=self.recoveries_total,
        )
        self.obs.decisions.record(
            "recovery", error=repr(exc),
            recoveries_total=self.recoveries_total,
        )
        self._rebuild_and_replay()
        return True

    def _rebuild_and_replay(self) -> None:
        """The recovery primitive shared by crash recovery, quarantine
        fallbacks, and probe re-enables: fresh batcher (base ctor +
        current feature overrides), then resubmit every live request
        from its CPU-side snapshot."""
        # Rebuild BEFORE detaching _active: if the rebuild itself dies
        # (e.g. a real OOM re-allocating the pool), the exception must
        # propagate with _active intact so the finally-drain still
        # delivers the crash reason to every in-flight client.
        new_batcher = self._build_batcher()
        old_active, self._active = self._active, {}
        self.batcher = new_batcher
        # Any un-credited step success died with the old batcher: the
        # exception that brought us here may have been its async work.
        self._pending_success = ()
        # The brownout ladder's knobs survive the rebuild: a fresh
        # batcher carries the BASE prefill budget, so re-apply the
        # rung's shrink (controller state itself is server-owned and
        # untouched by rebuilds, like the DegradeManager).
        self._apply_overload_knobs()
        bs = self.batcher.block_size
        for p in old_active.values():
            prompt = list(p.prompt_tokens) + list(p.tokens)
            remaining = p.max_new - len(p.tokens)
            # Replay headroom: prompt + delivered pads to a block
            # multiple, which can exceed the original prompt's padding
            # by up to a block — a request admitted within a block of
            # capacity can lose up to block_size-1 tokens of budget.
            # Clamp rather than reject, but SAY SO: a shortened reply
            # carries "truncated": true instead of silently posing as
            # the full fault-free completion.
            # _round_up is submit()'s own padding helper — the headroom
            # math must stay in lockstep with its admission check.
            room = self.batcher.max_len - _round_up(len(prompt), bs)
            if room < remaining:
                remaining = room
                p.truncated = True
            if remaining <= 0:
                # The client receives a (truncated) completion: a
                # TERMINAL delivery — close the timeline and score it,
                # or the finished counter and /debug disagree with the
                # 200 the client saw.
                self.obs.request_end(p.request_id, "finished")
                self._slo_finalize(p, completed=True)
                p.finish()  # deliver what the client already has
                continue
            kwargs = dict(p.submit_kwargs)
            kwargs["max_new_tokens"] = remaining
            kwargs["seed"] = p.replay_seed
            try:
                rid = self.batcher.submit(prompt, **kwargs)
            except (ValueError, TypeError) as e:
                msg = f"lost in crash recovery: {e}"
                self.obs.request_end(p.request_id, "failed", msg)
                p.fail(msg, 503)
                self._slo_finalize(p, completed=False)
                continue
            p.request_id = rid
            # Fold the replay's fresh rid (and its new queued span) into
            # the original external-id timeline, so /debug/requests/<id>
            # shows the whole story across batcher incarnations.
            self.obs.bind(rid, p.ext_id, replay=True)
            self._active[rid] = p

    def _watchdog(self) -> None:
        """Monitor thread: flag a stall when the serving loop's heartbeat
        goes stale past the deadline (the loop beats every iteration,
        idle included, so only a wedged dispatch — or a dead loop —
        stalls).  Passive by design: it flips /healthz degraded for the
        fleet's load balancer; it never touches the batcher."""
        while not self._stop.wait(self.watchdog_interval_s):
            if self._closed.is_set():
                break
            age = time.monotonic() - self._heartbeat
            if age > self.watchdog_deadline_s:
                if not self._stalled:
                    # audit: unguarded(single-writer: only the watchdog
                    # thread mutates _stalled / its counter; readers
                    # see a GIL-atomic bool/int snapshot)
                    self._stalled = True
                    # audit: unguarded(single-writer: watchdog thread
                    # only; readers snapshot a GIL-atomic int)
                    self.watchdog_stalls_total += 1
                    self._log(
                        "watchdog_stall", last_step_age_s=round(age, 3)
                    )
            else:
                # audit: unguarded(single-writer: watchdog thread only)
                self._stalled = False

    def _health(self) -> Dict[str, Any]:
        """The /healthz payload (schema in the module docstring):
        liveness + watchdog/recovery state + the full degraded state.
        ``ok`` is False (HTTP 503) when the loop is dead, stalled, or
        draining — load balancers must stop routing here in all three.
        A merely DEGRADED server (features quarantined, fallbacks
        serving) stays ``ok``: staying routable on the slow path is the
        whole point of quarantine."""
        alive = self._loop_thread.is_alive() and not self._closed.is_set()
        draining = self._draining.is_set()
        features = self.degrade.snapshot()
        remaining = None
        if draining and self._drain_deadline is not None:
            remaining = round(
                max(0.0, self._drain_deadline - time.monotonic()), 3
            )
        return {
            "ok": alive and not self._stalled and not draining,
            "stalled": self._stalled,
            "loop_alive": alive,
            "last_step_age_s": round(
                time.monotonic() - self._heartbeat, 3
            ),
            "recoveries_total": self.recoveries_total,
            "watchdog_stalls_total": self.watchdog_stalls_total,
            "draining": draining,
            "drain_remaining_s": remaining,
            "degraded": self.degrade.degraded(),
            "quarantined": list(self.degrade.quarantined()),
            "kv": {
                # audit: racy-read(point-in-time /healthz snapshot of
                # loop-owned batcher state: len()/count reads; a scrape
                # may be one step stale)
                "prefix_index": self.batcher.prefix_index,
                "host_kv_blocks": self.batcher.host_kv_blocks,
                "host_tier_blocks": self.batcher._store.host_blocks(),
                "swap_queue_depth": len(self.batcher._restoring),
                "restored_waiting": len(self.batcher._restored_ready),
                # The chain digest's summary, under its own lock.
                "digest": self.batcher.kv_digest.summary(),
                "block_bytes": self.batcher.block_bytes,
                "total_blocks": self.batcher.n_blocks,
                "prefix_hit_tokens_total": (
                    self.batcher.prefix_hit_tokens_total),
                "prompt_tokens_total": self.batcher.prompt_tokens_total,
            },
            "overload": self.overload.health(),
            # The replica's occupancy (what router.ReplicaRouter reads)
            # and its serving mesh (1 x 1 for an unsharded batcher).
            "replica": {
                "id": self.replica_id,
                # audit: racy-read(point-in-time /healthz snapshot of
                # loop-owned batcher occupancy; len()/sum reads are
                # GIL-atomic, a scrape may be one step stale)
                "serve_mesh": mesh_shape(getattr(self.batcher, "mesh",
                                                 None)),
                "serve_mesh_placed": bool(getattr(
                    self.batcher, "_mesh_placed", False)),
                "active_slots": sum(
                    s is not None for s in self.batcher.slots.values()
                ),
                "n_slots": self.batcher.n_slots,
                # Per-replica ITL degradation signal for the router's
                # health sentinel (None until two non-canary tokens
                # have been delivered).
                "itl_ms_ewma": (
                    round(self.itl_ms_ewma, 3)
                    if self.itl_ms_ewma is not None else None
                ),
                "queued": (
                    self._inbox.qsize() + len(self._active)
                    + self.overload.queued_total()
                ),
                "kv_handoff_blocks": (
                    getattr(self.batcher, "kv_export_blocks_total", 0)
                    + getattr(self.batcher, "kv_import_blocks_total", 0)
                ),
            },
            "features": features,
        }

    def _handle_profiler(self, payload: Dict[str, Any]):
        """POST /debug/profiler: an on-demand ``torch.profiler`` session
        (``utils.profiling.trace`` unrolled into two HTTP calls so it can
        bracket LIVE traffic, JAX :1971): ``{"action": "start",
        "log_dir": DIR}`` begins a capture, ``{"action": "stop"}`` ends it
        and writes a Chrome trace under DIR.  The session starts and
        stops on the serving loop (``call_on_loop``), whose thread is the
        one whose dispatch ranges it must record; the trace file is
        written here on the handler thread, so the loop never waits for
        it.  One session per process (CUPTI's rule): a start while
        another server of the process traces answers 500.  Returns
        ``(status_code, body)`` for the handler's ``_reply_json``."""
        action = payload.get("action")
        if action == "start":
            log_dir = payload.get("log_dir")
            if not isinstance(log_dir, str) or not log_dir:
                return 400, {"error": 'start needs a "log_dir" string'}
            # Serialized: two concurrent starts racing the None check
            # would both reach the profiler (handler threads).
            with self._profiler_lock:
                if self._profiler_dir is not None:
                    return 409, {"error": (
                        f"profiler already tracing into "
                        f"{self._profiler_dir!r}; stop it first"
                    )}
                session = ProfilerSession(
                    owner=f"server {self.address}, log_dir {log_dir!r}")
                try:
                    self.call_on_loop(lambda b: session.start())
                except Exception as e:  # surface, never crash the server
                    return 500, {"error": f"profiler start failed: {e}"}
                self._profiler_dir = log_dir
                self._profiler = session
            self.obs.annotate("profiler_start", log_dir=log_dir)
            self._log("profiler_start", log_dir=log_dir)
            return 200, {"ok": True, "log_dir": log_dir}
        if action == "stop":
            with self._profiler_lock:
                if self._profiler_dir is None:
                    return 409, {"error": "no profiler session active"}
                log_dir = self._profiler_dir
                session = self._profiler
                try:
                    self.call_on_loop(lambda b: session.stop())
                    session.export(log_dir)
                except Exception as e:
                    # The session stays recorded: a stop that did not
                    # reach the loop can be retried (stop and export are
                    # idempotent), as JAX keeps its session for a retry.
                    return 500, {"error": f"profiler stop failed: {e}"}
                self._profiler_dir = None
                self._profiler = None
                self._profiler_last_dir = log_dir
            self.obs.annotate("profiler_stop", log_dir=log_dir)
            self._log("profiler_stop", log_dir=log_dir)
            return 200, {"ok": True, "log_dir": log_dir}
        return 400, {"error": 'action must be "start" or "stop"'}

    def _close_profiler_on_loop(self) -> None:
        """Loop thread, on its way out: a session still open is stopped
        here (the thread that started it) and its trace written, so that
        the process's one profiler claim is freed for other servers."""
        with self._profiler_lock:
            session, log_dir = self._profiler, self._profiler_dir
            if session is None:
                return
            try:
                session.stop()
                session.export(log_dir)
                self._profiler_last_dir = log_dir
            except Exception as e:
                self._log("profiler_stop_failed", error=str(e))
            self._profiler_dir = None
            self._profiler = None

    def _profile_summary(self, query: Dict[str, List[str]]):
        """GET /debug/profile/summary[?log_dir=DIR]: the most recently
        completed session's capture split by serving program
        (``utils.profiling.summarize_trace``; JAX :2028).  Pure file
        parsing on the handler thread: no device work, and the serving
        loop is never touched.  Returns ``(status_code, body)``."""
        log_dir = (query.get("log_dir") or [None])[0]
        with self._profiler_lock:
            active = self._profiler_dir
            if log_dir is None:
                log_dir = self._profiler_last_dir
        if log_dir is None:
            return 404, {"error": (
                "no completed profiler session; bracket traffic with "
                'POST /debug/profiler {"action": "start"/"stop"} '
                "first, or pass ?log_dir="
            )}
        if active is not None and log_dir == active:
            return 409, {"error": (
                f"profiler session into {log_dir!r} still active; "
                "stop it before summarizing"
            )}
        try:
            summary = summarize_trace(log_dir)
        except FileNotFoundError as e:
            return 404, {"error": str(e)}
        except Exception as e:  # surface a parse failure, never crash
            return 500, {"error": f"trace parse failed: {e}"}
        summary["log_dir"] = log_dir
        return 200, summary

    def _loop(self) -> None:
        # The finally-drain guarantees no client blocks forever: whether
        # the loop exits via stop() or an unexpected device/runtime error,
        # every in-flight and queued request gets its done event set.
        reason, code = "server shutting down", 503
        try:
            if self.batcher.device.type == "cuda":
                # Every CUDA call of the server runs on this thread, on
                # the batcher's card.
                torch.cuda.set_device(self.batcher.device)
            while not self._stop.is_set():
                self._heartbeat = time.monotonic()
                # Flight recorder: one compact metric snapshot per
                # flight_interval_s (host-side dict building only) —
                # the /debug/bundle trend ring.
                if (
                    self.flight_interval_s > 0
                    and self._heartbeat - self._last_flight_t
                    >= self.flight_interval_s
                ):
                    self._last_flight_t = self._heartbeat
                    self.obs.record_metrics_snapshot(
                        self._flight_snapshot()
                    )
                # Control path: scheduled batcher work (handoff
                # export/import) runs HERE, between steps, on the
                # batcher's owning thread.
                self._drain_control()
                if self._draining.is_set():
                    # Drain mode: finish in-flight work, then exit
                    # cleanly; past the deadline fail the stragglers
                    # (the finally-drain delivers the 503s).
                    idle = (
                        not self._active
                        and self._inbox.empty()
                        and self.overload.queued_total() == 0
                        and not self.batcher.pending()
                    )
                    if idle:
                        break
                    if (
                        self._drain_deadline is not None
                        and time.monotonic() >= self._drain_deadline
                    ):
                        reason = (
                            "drain timeout: server shutting down before "
                            "this request finished"
                        )
                        break
                # Quarantined features whose cooldown expired get ONE
                # probe re-trial: rebuild with the feature re-enabled
                # (live requests replay, exactly as in crash recovery).
                # Success on the next exercising dispatch restores it;
                # failure re-quarantines via the normal recovery path.
                # Not while draining — a probe rebuild would discard the
                # very device state the drain is trying to finish.
                due = (
                    [] if self._draining.is_set()
                    else self.degrade.due_probes()
                )
                if due:
                    for f in due:
                        self.degrade.start_probe(f)
                    self._log("probe_rebuild", features=",".join(due))
                    self.obs.decisions.record(
                        "probe", features=",".join(due)
                    )
                    self._rebuild_and_replay()
                    # Counted once the probed batcher is in place: a
                    # reader that sees the count sees that batcher.
                    self.probe_rebuilds_total += 1
                # Drain the inbox into the controller's per-class
                # queues (strict interactive-first ordering lives
                # there); block briefly when fully idle so shutdown
                # and new work are both responsive.
                try:
                    block = (
                        not self.batcher.pending()
                        and self.overload.queued_total() == 0
                    )
                    while True:
                        p = self._inbox.get(block=block, timeout=0.05)
                        block = False
                        self.overload.push(p)
                except queue.Empty:
                    pass
                self._reap_preadmission()
                # Brownout ladder (overload.py): evaluate the rung,
                # apply its knobs on a transition, shed queued batch
                # entries at the top rung.
                tr = self.overload.tick()
                if tr is not None:
                    old, new = tr
                    self._log(
                        "overload_transition", f"{old} -> {new}",
                        rung=new,
                    )
                    self.obs.annotate(
                        "overload_transition", old=old, state=new
                    )
                    # Decision log: the rung move WITH the signals
                    # that drove it, so /debug/decisions explains a
                    # brownout the way it explains a route.
                    ov = self.overload.health()
                    self.obs.decisions.record(
                        "brownout", old=old, rung=new,
                        rung_index=RUNG_INDEX[new],
                        interactive_attainment=(
                            ov["interactive_attainment"]
                        ),
                        queue_wait_ms_p90=ov["queue_wait_ms_p90"],
                        queued=ov["queued"],
                    )
                    # The one-shot demotion sweep is an ESCALATION
                    # pressure release only — re-firing it on recovery
                    # steps would evict warm prefix KV exactly as
                    # traffic returns.
                    self._apply_overload_knobs(
                        entering=RUNG_INDEX[new] > RUNG_INDEX[old]
                    )
                for p in self.overload.shed_batch():
                    msg = (
                        "shed under overload (brownout rung 'shed'); "
                        "retry later"
                    )
                    p.retry_after_s = self.overload.retry_after_s()
                    self.obs.request_rejected(p.ext_id, msg)
                    self._log(
                        "request_shed", request_id=p.ext_id,
                        priority=p.priority,
                    )
                    self.obs.decisions.record(
                        "shed", request_id=p.ext_id,
                        priority=p.priority,
                        retry_after_s=p.retry_after_s,
                    )
                    # Deliberately NOT SLO-scored: a shed is the
                    # controller protecting attainment — counting it
                    # as a miss would wedge the ladder at 'shed'.
                    p.fail(msg, 503)
                # Submit interactive-first while free slots can take
                # them; the rest wait ORDERED in the controller (the
                # batcher's own queue is FIFO, so keeping it shallow
                # is what makes interactive-first stick — at most
                # ``free`` entries are committed to FIFO order ahead
                # of a later interactive arrival).
                # audit: unguarded(serving-loop thread — the batcher's
                # owner — reading through its own holder alias)
                free = sum(
                    s is None for s in self.batcher.slots.values()
                )
                # audit: unguarded(owner-thread read, as above)
                while len(self.batcher.queue) < free:
                    p = self.overload.pop()
                    if p is None:
                        break
                    if p.received_at is not None and p.priority != CANARY:
                        # Canary waits are excluded: queue-wait p90 is
                        # a brownout-ladder pressure signal, and the
                        # probes must never trigger the ladder.
                        self.overload.observe_queue_wait(
                            (time.monotonic() - p.received_at) * 1000.0
                        )
                    try:
                        self._submit(p)
                    except (ValueError, TypeError, KeyError) as e:
                        # Malformed payloads must never kill the
                        # device-owning thread.  Deliberately NOT
                        # SLO-scored: a 400 is the client's defect,
                        # and letting bad payloads drag attainment
                        # would let one misconfigured client page
                        # the on-call for a healthy server.
                        p.fail(str(e), 400)
                self._reap()
                if not self.batcher.pending():
                    continue
                try:
                    events = self.batcher.step()
                except Exception as e:
                    # A step/insert dispatch died (device error, injected
                    # fault, allocation failure).  Rebuild + replay —
                    # onto a fallback path when the failure quarantined
                    # a feature; past the retry budget, re-raise into
                    # the hard drain.
                    if self._recover(e):
                        continue
                    raise
                # Probe-success recording runs ONE STEP BEHIND, as in the
                # JAX package: kernel launches are asynchronous, so a
                # step's device work is proven good by a later host sync.
                # The port's step ends in its own packed fetch, which
                # already proves it; the lag only keeps the two
                # packages' probe timing the same.
                for f in self._pending_success:
                    self.degrade.record_success(f)
                self._pending_success = tuple(
                    getattr(self.batcher, "last_step_features", ())
                )
                # Non-finite guard: fail just the poisoned requests (the
                # batcher already freed their slots and blocks).
                for rid, msg in self.batcher.pop_failed():
                    p = self._active.pop(rid, None)
                    if p is not None:
                        self.nonfinite_failed_total += 1
                        self._slo_finalize(p, completed=False)
                        self._log(
                            "request_failed", msg,
                            request_id=p.ext_id, rid=rid,
                        )
                        p.fail(msg, 500)
                now = time.monotonic()
                for ev in events:
                    rid, tok, done = ev[0], ev[1], ev[2]
                    lp = ev[3] if len(ev) > 3 else None
                    p = self._active.get(rid)
                    if p is None:
                        continue
                    p.tokens.append(tok)
                    # Canary probes keep their per-request stamps (the
                    # router reads its own probe latency) but never
                    # feed the shared histograms/EWMAs — a stream of
                    # tiny fast probes would skew the very latency
                    # signals they exist to watch.
                    canary = p.priority == CANARY
                    if len(p.tokens) == 1:
                        if p.submitted_at is not None:
                            ttft_ms = (now - p.submitted_at) * 1000.0
                            p.ttft_ms = ttft_ms
                            if not canary:
                                self.obs.observe_ttft(ttft_ms)
                                self.ttft_ms_ewma = (
                                    ttft_ms if self.ttft_ms_ewma is None
                                    else 0.8 * self.ttft_ms_ewma
                                    + 0.2 * ttft_ms
                                )
                    elif p.last_tok_t is not None:
                        # Tokens inside one fused chunk arrive together
                        # (gap ~0); the chunk-period gap lands on the
                        # chunk's first token.  Both are real client-
                        # observed inter-token latencies.
                        itl_ms = (now - p.last_tok_t) * 1000.0
                        if not canary:
                            self.obs.observe_itl(itl_ms)
                            self.itl_ms_ewma = (
                                itl_ms if self.itl_ms_ewma is None
                                else 0.8 * self.itl_ms_ewma
                                + 0.2 * itl_ms
                            )
                        if p.itl_max_ms is None or itl_ms > p.itl_max_ms:
                            p.itl_max_ms = itl_ms
                    p.last_tok_t = now
                    if p.want_lp and lp is not None:
                        p.lps.append(lp)
                    if p.stream:
                        p.chunks.put((tok, lp if p.want_lp else None))
                    if done:
                        del self._active[rid]
                        self._slo_finalize(p, completed=True)
                        p.finish()
        except Exception as e:  # device/runtime failure: fail loudly
            reason = f"serving loop crashed: {e!r}"
            raise
        finally:
            self._closed.set()
            for p in list(self._active.values()):
                self._slo_finalize(p, completed=False)
                p.fail(reason, code)
            self._active.clear()
            # Pre-admission entries in the controller's class queues
            # must drain too — a shed-proof client is one that never
            # hangs, whatever queue it was waiting in.
            for p in self.overload.drain_all():
                p.fail(reason, code)
            while not self._inbox.empty():
                p = self._inbox.get_nowait()
                p.fail(reason, code)
            # Pending control calls fail too (their callers' own
            # timeouts bound them anyway, but an immediate error beats
            # a silent timeout).
            while True:
                try:
                    call = self._control.get_nowait()
                except queue.Empty:
                    break
                call.error = RuntimeError(reason)
                call.done.set()
            # Last: a profiler stop waiting on the control path above has
            # been answered, so it no longer holds the profiler lock.
            self._close_profiler_on_loop()

    # -- flight recorder / decision audit (GET /debug/bundle, /debug/decisions)

    def _flight_snapshot(self) -> Dict[str, Any]:
        """One compact flight-recorder metric snapshot (loop thread —
        the batcher's owner): the handful of scalars whose trend a
        postmortem actually reads, not the full exposition (the ring
        holds ~100 of these)."""
        st = self.batcher.stats()
        om = self.obs.metrics()
        return {
            "emitted_tokens_total": st["emitted_tokens_total"],
            "active_slots": st["active_slots"],
            "queued_requests": st["queued_requests"],
            "free_blocks": st["free_blocks"],
            "host_syncs_total": st["host_syncs_total"],
            "decode_dispatches_total": st["decode_dispatches_total"],
            "swap_queue_depth": st["swap_queue_depth"],
            "prefill_tokens_inflight": st["prefill_tokens_inflight"],
            "requests_finished_total": om["requests_finished_total"],
            "requests_failed_total": om["requests_failed_total"],
            "goodput_tokens_total": om["goodput_tokens_total"],
            "slo_attainment": om["slo_attainment"],
            "overload_rung": self.overload.rung,
            "queued_preadmission": self.overload.queued_total(),
            "recoveries_total": self.recoveries_total,
            "canary_requests_total": self.canary_requests_total,
            "draining": self._draining.is_set(),
        }

    def _config_snapshot(self) -> Dict[str, Any]:
        """The bundle's ``config`` section: ctor-stable server knobs +
        the batcher geometry (``ContinuousBatcher.describe``)."""
        return {
            "batcher": self.batcher.describe(),
            "replica_id": self.replica_id,
            "max_queue": self.max_queue,
            "max_body_bytes": self.max_body_bytes,
            "max_recoveries": self.max_recoveries,
            "recovery_window_s": self.recovery_window_s,
            "drain_timeout_s": self.drain_timeout_s,
            "watchdog_deadline_s": self.watchdog_deadline_s,
            "flight_interval_s": self.flight_interval_s,
            "slo_ttft_ms": self.obs.slo_ttft_ms,
            "slo_itl_ms": self.obs.slo_itl_ms,
        }

    def bundle_json(self, trace: bool = True) -> Dict[str, Any]:
        """``GET /debug/bundle[?trace=0]`` — the black-box flight
        recorder's one-shot postmortem artifact: config + current
        health/metrics + the metric-snapshot trend ring + the last-N
        control-plane decisions + the annotation (state-transition)
        ring + the structured-log tail + the request index + the
        Perfetto trace.  Pure host-side snapshot assembly on the
        handler thread; the serving loop is never touched beyond the
        same racy-read surfaces /metrics and /healthz already read."""
        obs = self.obs
        out: Dict[str, Any] = {
            "kind": "replica_bundle",
            "generated_unix_s": round(time.time(), 3),
            "replica_id": self.replica_id,
            "config": self._config_snapshot(),
            "health": self._health(),
            "metrics": self._metrics_scalars(),
            "metric_snapshots": obs.metric_snapshots_json(),
            "decisions": obs.decisions.json(n=256),
            "annotations": obs.events_json(),
            "log_tail": self.logger.tail(),
            "requests": obs.requests_json(64),
        }
        if trace:
            out["trace"] = obs.trace_json()
        return out

    # -- metrics ------------------------------------------------------------

    def _metrics_scalars(self) -> Dict[str, Any]:
        """Every scalar the /metrics exposition renders (batcher +
        degrade + obs + overload + server-level), as one dict — shared
        by ``_metrics_text`` and the /debug/bundle artifact."""
        stats = dict(self.batcher.stats())
        stats.update(self.degrade.stats())
        stats.update(self.obs.metrics())
        stats.update(self.overload.stats())
        stats.update({
            # Server-level fault tolerance (batcher counters above carry
            # the injection-site totals when an injector is attached).
            "server_recoveries_total": self.recoveries_total,
            "watchdog_stalls_total": self.watchdog_stalls_total,
            "watchdog_stalled": int(self._stalled),
            "watchdog_last_step_age_seconds": round(
                time.monotonic() - self._heartbeat, 3
            ),
            # Degradation / drain / non-finite-guard state.
            "quarantine_rebuilds_total": self.quarantine_rebuilds_total,
            "probe_rebuilds_total": self.probe_rebuilds_total,
            "nonfinite_requests_failed_total": self.nonfinite_failed_total,
            "draining": int(self._draining.is_set()),
            "ttft_ms_ewma": (
                round(self.ttft_ms_ewma, 3)
                if self.ttft_ms_ewma is not None else 0.0
            ),
            "itl_ms_ewma": (
                round(self.itl_ms_ewma, 3)
                if self.itl_ms_ewma is not None else 0.0
            ),
            # Control-plane observability: synthetic canary probes
            # served (the reserved class the router sends).
            "canary_requests_total": self.canary_requests_total,
            # Scale-out serving: which replica this is (-1 standalone);
            # the serve_mesh_* shape gauges ride batcher.stats().
            "replica_id": (
                self.replica_id if self.replica_id is not None else -1
            ),
        })
        return stats

    def _metrics_text(self) -> str:
        stats = self._metrics_scalars()
        lines = []
        for k, v in stats.items():
            name = f"llm_{k}"
            meta = metric_meta(k)
            if meta is None:
                # Legacy fallback for a scalar nobody registered: the
                # old "_total names a counter" convention, with a HELP
                # line that SAYS the registration is missing — the
                # /metrics parse test (tests/test_server.py) fails on
                # it, so an unregistered metric cannot ship silently.
                kind = "gauge" if "total" not in k else "counter"
                help_text = "UNREGISTERED metric (add to obs.METRICS)"
            else:
                kind, help_text = meta
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {v}")
        # Histogram families (ttft/itl/queue-wait/prefill/swap/dispatch)
        # render their own HELP/TYPE + _bucket/_sum/_count series.
        lines.extend(self.obs.expose_histograms("llm_"))
        # Labeled families: per-kind device-time attribution gauges and
        # per-program build counters (obs.utilization_metrics), plus
        # each serving program's cache keys (serving.jit_cache_entries,
        # JAX :2491).  One HELP/TYPE header per family, even while a
        # family has no samples yet, so dashboards can discover them
        # before traffic.
        labeled = list(self.obs.utilization_metrics())
        for prog, n in sorted(jit_cache_entries().items()):
            labeled.append(("jit_cache_entries", {"program": prog}, n))
        for family in ("mxu_utilization", "hbm_utilization",
                       "host_overhead_ratio", "program_compiles_total",
                       "jit_cache_entries"):
            kind, help_text = metric_meta(family)
            lines.append(f"# HELP llm_{family} {help_text}")
            lines.append(f"# TYPE llm_{family} {kind}")
            for fam, labels, v in labeled:
                if fam != family:
                    continue
                lab = ",".join(
                    f'{k}="{val}"' for k, val in sorted(labels.items())
                )
                lines.append(f"llm_{family}{{{lab}}} {v}")
        return "\n".join(lines) + "\n"
