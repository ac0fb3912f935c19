"""Tracing, profiling and throughput accounting (port of
``jax_llama_tpu/utils/profiling.py``).

``Timer`` and ``DecodeStats`` are JAX's (``run.py`` prints them).  The
profiler wrappers are built on ``torch.profiler`` where JAX's use
``jax.profiler``:

* :func:`trace` captures a session into a directory as a Chrome-trace
  JSON (``*.pt.trace.json``), where JAX writes an xplane.
* :func:`device_op_times` runs a thunk under a capture and returns the
  device time of each kernel, in picoseconds as JAX's does.
* :func:`program_range` opens the ``record_function`` range that labels
  one host dispatch of the serving batcher with its JAX program name
  (:data:`PROGRAMS`); :func:`normalize_program_name` maps such a label
  (and JAX's own xplane spellings) back to the program.
* :func:`summarize_trace`, the counterpart of JAX's
  ``summarize_xplane``, splits the newest capture's time by program:
  host ms are the label ranges' own durations, device ms the kernels
  whose launch lies inside a range (the trace's correlation ids link a
  launch to its kernel).

torch.profiler records CPU-side ranges only on the thread that started
the session, so a capture that brackets a serving loop starts and stops
on that loop's thread (``server.LLMServer`` does so through its control
path).  CUPTI allows one session per process: :class:`ProfilerSession`
holds a process-wide claim from its start until its trace is written, and
a second start while it is held raises ``RuntimeError``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import glob
import json
import os
import re
import shutil
import socket
import tempfile
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

# The serving programs the batcher labels its dispatches with: the JAX
# package's program names (jax_llama_tpu/serving.py ``_programs``).
PROGRAMS = (
    "_paged_decode_step", "_paged_decode_chunk", "_fused_chunk",
    "_spec_round", "_spec_rounds_chunk", "_paged_insert",
    "_paged_suffix_insert", "_scatter_rows", "_release_blocks",
    "_adopt_jit",
)
TRACE_SUFFIX = ".pt.trace.json"

_CLAIM_LOCK = threading.Lock()
_CLAIMED_BY: Optional[str] = None


def program_range(name: str):
    """The profiler range of one dispatch of program ``name`` (one of
    :data:`PROGRAMS`): a ``torch.profiler.record_function`` context,
    which records nothing while no session runs on this thread."""
    if name not in PROGRAMS:
        raise ValueError(f"{name!r} is not a serving program {PROGRAMS}")
    return torch.profiler.record_function(name)


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class ProfilerSession:
    """One ``torch.profiler`` session, started and stopped on the thread
    whose ranges it must see, its trace written on any thread after the
    stop.  ``owner`` names the holder in the error a second start raises
    while this session holds the process's claim (from :meth:`start`
    until :meth:`export`)."""

    def __init__(self, owner: str = "trace"):
        self.owner = owner
        self._prof = None
        self._claimed = False
        self._stopped = False

    def start(self) -> None:
        global _CLAIMED_BY
        with _CLAIM_LOCK:
            if _CLAIMED_BY is not None:
                raise RuntimeError(
                    f"a profiler session is already active in this "
                    f"process ({_CLAIMED_BY})")
            _CLAIMED_BY = self.owner
            self._claimed = True
        try:
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
        except BaseException:
            self._prof = None
            self._release()
            raise

    def stop(self) -> None:
        """End the capture (on the starting thread; a second call does
        nothing); queued kernels are waited for first, so that the trace
        holds them."""
        if self._stopped:
            return
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._prof.stop()
        self._stopped = True

    def export(self, log_dir: str) -> str:
        """Write the stopped capture into ``log_dir`` as a Chrome trace
        and release the claim; returns the file's path."""
        try:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, (
                f"{socket.gethostname()}.{os.getpid()}."
                f"{time.time_ns()}{TRACE_SUFFIX}"))
            self._prof.export_chrome_trace(path)
            return path
        finally:
            self._release()

    def _release(self) -> None:
        global _CLAIMED_BY
        with _CLAIM_LOCK:
            if self._claimed:
                _CLAIMED_BY = None
                self._claimed = False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` session (CPU activity, and CUDA when a
    GPU is present) into ``log_dir`` as a Chrome-trace JSON; the profiler
    stops and the trace is written even when the body raises.  Include
    one warm-up call outside the context so that a kernel build does not
    fill the trace."""
    session = ProfilerSession()
    session.start()
    try:
        yield
    finally:
        try:
            session.stop()
        finally:
            session.export(log_dir)


@dataclasses.dataclass
class Timer:
    """Wall-clock timer that waits for queued GPU work on both edges, so
    the measured window covers exactly the enclosed computation."""

    elapsed_s: float = 0.0

    def __enter__(self) -> "Timer":
        _block_on_pending()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _block_on_pending()
        self.elapsed_s = time.perf_counter() - self._t0


def _block_on_pending() -> None:
    # Only a process that has touched the card has work queued on it.
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_op_times(
    thunk: Callable[[], None],
    *,
    by: str = "op",
) -> Dict[str, int]:
    """Run ``thunk`` under a capture and return device time in
    PICOSECONDS by kernel name (``by="op"``, JAX's default; JAX's
    ``"source"``, the Python file XLA attributes an op to, has no
    counterpart in a torch trace).  Warm the thunk first (kernel builds,
    allocator).  A capture with no GPU has no kernels and returns an empty
    map."""
    if by != "op":
        raise ValueError(f"by={by!r}: only 'op' is supported")
    tmpdir = tempfile.mkdtemp(prefix="ptl_trace_")
    try:
        with trace(tmpdir):
            thunk()
        events = _load_events(_newest_trace(tmpdir))
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    agg: Dict[str, int] = collections.Counter()
    for e in _kernels(events):
        agg[e.get("name", "")] += int(round(float(e.get("dur", 0.0)) * 1e6))
    return agg


# Event-name spellings that carry a program identity in JAX's xplane
# captures (host ``PjitFunction(<name>)`` frames, device ``jit_<name>``
# modules), kept so that one name maps the same way in both packages.
_PJIT_RE = re.compile(r"^PjitFunction\((.+)\)$")
_JIT_MODULE_RE = re.compile(r"^jit_(.+?)(?:\.\d+)?$")


def normalize_program_name(event_name: str):
    """The serving program behind a trace event name: a dispatch label
    (:data:`PROGRAMS`) is its own program, JAX's xplane spellings map as
    JAX maps them, and anything else (an aten op, a kernel, host noise)
    is None."""
    if event_name in PROGRAMS:
        return event_name
    m = _PJIT_RE.match(event_name)
    if m:
        return m.group(1)
    m = _JIT_MODULE_RE.match(event_name)
    if m:
        return m.group(1)
    return None


def _newest_trace(log_dir: str) -> str:
    paths = sorted(
        glob.glob(os.path.join(glob.escape(log_dir), "**", "*" + TRACE_SUFFIX),
                  recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(
            f"no {TRACE_SUFFIX} capture under {log_dir!r}")
    return paths[-1]


def _load_events(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _kernels(events: List[dict]) -> List[dict]:
    """The capture's kernel events (device time; copies and memsets are
    not kernels)."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "kernel"]


def _label_ranges(events: List[dict]):
    """Each thread's program ranges, sorted by start:
    ``{(pid, tid): (starts, [(start, end, program)])}``."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "user_annotation":
            continue
        prog = normalize_program_name(e.get("name", ""))
        if prog is None:
            continue
        t0 = float(e["ts"])
        by_thread[(e.get("pid"), e.get("tid"))].append(
            (t0, t0 + float(e.get("dur", 0.0)), prog))
    out = {}
    for key, rs in by_thread.items():
        rs.sort()
        out[key] = ([r[0] for r in rs], rs)
    return out


def _kernel_programs(events: List[dict]) -> Dict[int, str]:
    """Index in ``_kernels(events)`` -> the program whose innermost range
    on the launching thread holds the kernel's launch (the runtime call
    with the kernel's correlation id)."""
    launches = {}
    for e in events:
        # Runtime and low-level API calls ("cuda_runtime", ...) carry
        # the correlation id of the kernel they launch.
        if e.get("ph") == "X" and str(e.get("cat", "")).startswith("cuda_"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ((e.get("pid"), e.get("tid")),
                                  float(e["ts"]))
    ranges = _label_ranges(events)
    owner = {}
    for i, k in enumerate(_kernels(events)):
        hit = launches.get((k.get("args") or {}).get("correlation"))
        if hit is None or hit[0] not in ranges:
            continue
        starts, rs = ranges[hit[0]]
        t = hit[1]
        j = bisect.bisect_right(starts, t) - 1
        # Ranges nest only by containment: walk back from the latest one
        # that starts before the launch to the innermost that holds it.
        while j >= 0:
            t0, t1, prog = rs[j]
            if t0 <= t <= t1:
                owner[i] = prog
                break
            j -= 1
    return owner


def summarize_trace(log_dir: str) -> Dict[str, object]:
    """Split the newest capture under ``log_dir`` by serving program
    (JAX's ``summarize_xplane``; pure file parsing, no device work):
    ``programs`` -> ``{device_ms, host_ms}``, with ``total_device_ms`` and
    ``total_host_ms`` their sums and ``trace`` the capture's path (JAX's
    key is ``xplane``).  A program's host ms are its ranges' durations on
    the launching thread; its device ms the kernels launched inside them.
    A CPU capture has host time only.  Raises FileNotFoundError when
    ``log_dir`` holds no capture."""
    path = _newest_trace(log_dir)
    events = _load_events(path)
    device_ms: Dict[str, float] = collections.defaultdict(float)
    host_ms: Dict[str, float] = collections.defaultdict(float)
    for _, rs in _label_ranges(events).values():
        for t0, t1, prog in rs:
            host_ms[prog] += (t1 - t0) / 1e3
    kernels = _kernels(events)
    for i, prog in _kernel_programs(events).items():
        device_ms[prog] += float(kernels[i].get("dur", 0.0)) / 1e3
    programs = sorted(set(device_ms) | set(host_ms))
    return {
        "trace": path,
        "programs": {
            p: {
                "device_ms": round(device_ms.get(p, 0.0), 3),
                "host_ms": round(host_ms.get(p, 0.0), 3),
            }
            for p in programs
        },
        "total_device_ms": round(sum(device_ms.values()), 3),
        "total_host_ms": round(sum(host_ms.values()), 3),
    }


@dataclasses.dataclass
class DecodeStats:
    """Throughput accounting for one generation call.

    tokens/sec figures are per device: divided by ``n_devices``."""

    batch: int
    prompt_len: int
    new_tokens: int
    prefill_s: float
    decode_s: float
    n_devices: int = 1

    @property
    def decode_tokens_per_s(self) -> float:
        return self.batch * self.new_tokens / max(self.decode_s, 1e-9)

    @property
    def decode_tokens_per_s_per_chip(self) -> float:
        return self.decode_tokens_per_s / self.n_devices

    @property
    def prefill_tokens_per_s(self) -> float:
        return self.batch * self.prompt_len / max(self.prefill_s, 1e-9)

    @property
    def per_token_latency_ms(self) -> float:
        return 1e3 * self.decode_s / max(self.new_tokens, 1)

    def summary(self) -> str:
        prefill = (
            f"prefill {self.prefill_tokens_per_s:,.0f} tok/s | "
            if self.prefill_s > 0
            else ""
        )
        return (
            f"{prefill}decode "
            f"{self.decode_tokens_per_s_per_chip:,.1f} tok/s/chip "
            f"({self.per_token_latency_ms:.2f} ms/tok, batch {self.batch})"
        )
