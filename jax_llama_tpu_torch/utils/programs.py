"""The batcher's compiled programs: the port's counterpart of ``jax.jit``
over the serving programs (``jax_llama_tpu/serving.py`` :552-1433,
``kvcache._adopt_jit``, the two jitted wrappers of ``ops/kernels.py``).

``@program(name, static=(...), donate=(...), returns=(...))`` wraps a
module-level function under its JAX program name:

* **Keys.**  A call is keyed as ``jax.jit`` keys its cache: the
  ``static`` arguments by value, every tensor leaf of the other
  arguments (through dicts, lists, tuples and dataclasses) by shape,
  dtype and device, and each generator slot by its place in the
  arguments (a slot's generator is the counterpart of a row of JAX's
  ``keys`` array, traced, so the key does not hold which slots are
  set).  A Python ``int``, ``float``, ``bool`` or ``str`` in an
  argument that is not declared static raises ``TypeError``: a key never
  depends silently on a host value.  :meth:`Program.cache_size` is the
  number of keys seen in this process, as JAX's per-function cache
  counts its entries (``serving.jit_cache_entries``).
* **Donation.**  A ``donate`` argument named in ``returns`` is updated in
  place and returned as the same tensor (JAX's input/output aliasing:
  the function computes the new value, the wrapper copies it into the
  argument unless the function already returned the argument itself); a
  donated argument not in ``returns`` (a pool) is one the function
  writes in place.  The analysis pass ``lowering`` checks both.
* **Graphs.**  Under :func:`use_graphs` with a :class:`GraphStore` (a
  batcher's, or one ``engine.generate``/``score`` call's, on CUDA), a
  ``graph=True`` program runs its first call for a key eagerly (the warm
  run, whose results the call returns), then captures one
  ``torch.cuda.CUDAGraph`` for that key into the store's memory pool, on
  the process's capture thread and stream; every later call for the key
  replays it.  A store made with ``capture_first=True`` (a call's own,
  which a warm run would not pay back) captures a key this process has
  already run once and replays the capture at once, so the call's first
  run is a replay; a key new to the process still runs warm first (it
  loads kernels and fills caches, which a capture may not do).  A graph
  is one per key and per address of each donated or large tensor input
  (the weights, a pool, the state twins): the same key called on
  another pool (a draft model's) captures its own.  Other tensor inputs
  at the captured address are used in place; a small one elsewhere (at
  most :data:`SMALL_INPUT_BYTES`), or one of the program's ``copied``
  arguments (a swap-in's staged planes), is copied into the captured one
  first.  Outputs that are not donated belong to the graph and stay
  valid until that key's next replay (copy them to keep them).
  Generators in the arguments are registered with the graph, so a
  replay draws from their current seed and offset and advances them.
  The kernel wrappers count launches in Python, which a replay does not
  run: a capture records each wrapper's counts
  (``ops._build.record_counts``) and every replay adds them.  A failed
  capture raises, naming the program and the key.  All graphs of a store
  share its one memory pool: a replay's temporaries reuse the space of
  every other graph's, so the pool holds about the largest graph's
  working set, not their sum.
* **Everything else runs eagerly**: outside a store (the CPU, a caller
  on a mesh whose collectives go through the host, a direct call), for
  ``graph=False`` programs (the kernel wrappers of ``ops.kernels``), and
  for a program called inside another program's call, which runs inline
  and is keyed by the outer call alone.

:func:`clear_caches` forgets every program's keys (``jax.clear_caches()``'s
counterpart for the key counts); it closes no store's graphs.

A dispatch of a program listed in ``utils.profiling.PROGRAMS`` runs
inside its ``program_range``, so each name has one source.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import inspect
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .profiling import PROGRAMS, program_range

# The largest input a replay copies into the captured one when the caller
# passes it at another address (a per-round upload, a re-made pending-
# token vector); weights, pools and activations are larger and raise.
SMALL_INPUT_BYTES = 1 << 20

# Every program by its JAX name, in definition order.
REGISTRY: Dict[str, "Program"] = {}
# Every Program object, registered or not (``clear_caches``).
_ALL: "weakref.WeakSet[Program]" = weakref.WeakSet()

_TLS = threading.local()
# Every capture runs on one thread of the process, on one capture stream
# per device (both made when the device's first graph store is): one
# capture at a time (PyTorch's graph capture rule; replicas in one process
# dispatch from their own serving threads), and cuBLAS allocates its
# workspace for that (thread, stream) pair once, when the stream is made,
# outside any graph's pool: a workspace made inside a capture would pin
# that graph's pool, one per serving thread would stay allocated after its
# replica retires, and one made at a later store's first capture would
# read as that store's memory.
_CAPTURER: List[Any] = []
_CAPTURER_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[Any, Any] = {}
# Graph stores dropped, and the count at the last return of their pools
# (``_capture_graph``).
_DROPPED = [0, 0]


def _capturer():
    with _CAPTURER_LOCK:
        if not _CAPTURER:
            _CAPTURER.append(concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="program-capture"))
        return _CAPTURER[0]


def program(name: str, *, static: Sequence[str] = (),
            donate: Sequence[str] = (), returns: Sequence[str] = (),
            graph: bool = False, copied: Sequence[str] = ()):
    """Decorate a module-level function as the program ``name`` (JAX's
    name).  ``static``, ``donate``: JAX's ``static_argnames`` and
    ``donate_argnames``; ``returns`` names the outputs (a donated
    argument named there is returned aliased); ``graph``: captured as a
    CUDA graph under a :class:`GraphStore`; ``copied``: arguments a
    replay copies into the captured tensors whatever their size (they
    are new tensors at every call)."""

    def deco(fn):
        if name in REGISTRY:
            raise ValueError(f"program {name!r} is already registered")
        prog = Program(fn, name, static, donate, returns, graph, copied)
        REGISTRY[name] = prog
        return prog

    return deco


def clear_caches() -> None:
    """Forget every program's keys, as ``jax.clear_caches()`` empties
    JAX's jit caches: each ``cache_size()`` starts again from 0.  No
    store's graphs are closed (their owners close them)."""
    for prog in list(_ALL):
        with prog._lock:
            prog._keys.clear()


def registry() -> Dict[str, "Program"]:
    """The registered programs by name (importing the modules that
    define them first)."""
    from .. import engine, kvcache, serving  # noqa: F401
    from ..ops import kernels  # noqa: F401

    return dict(REGISTRY)


class Program:
    """One serving program: the function, its key domain and its cache
    count (see the module docstring)."""

    def __init__(self, fn, name: str, static: Sequence[str],
                 donate: Sequence[str], returns: Sequence[str],
                 graph: bool, copied: Sequence[str] = ()):
        functools.update_wrapper(self, fn)
        self.name = name
        self.static = tuple(static)
        self.donate = tuple(donate)
        self.returns = tuple(returns)
        self.graph = bool(graph)
        self.copied = tuple(copied)
        self._sig = inspect.signature(fn)
        params = self._sig.parameters
        for arg in (*self.static, *self.donate, *self.copied):
            if arg not in params:
                raise TypeError(f"program {name}: no argument {arg!r}")
        for arg in self.donate:
            if arg in self.static:
                raise TypeError(f"program {name}: {arg!r} is both static "
                                "and donated")
        self._keys: set = set()
        self._lock = threading.Lock()
        _ALL.add(self)

    def cache_size(self) -> int:
        """Keys seen by this program in this process (JAX's
        ``_cache_size()``)."""
        with self._lock:
            return len(self._keys)

    def key(self, *args, **kwargs):
        """The cache key of a call with these arguments (raises
        ``TypeError`` on an undeclared host scalar)."""
        return self._bind(args, kwargs)[1]

    def _bind(self, args, kwargs):
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        statics, traced, leaves = [], [], []
        for arg, value in bound.arguments.items():
            if arg in self.static:
                try:
                    hash(value)
                except TypeError:
                    raise TypeError(
                        f"program {self.name}: static argument {arg!r} is "
                        f"not hashable ({type(value).__name__})") from None
                statics.append((arg, value))
            else:
                traced.append((arg, _spec(self.name, arg, value, arg,
                                          leaves)))
        return bound, (tuple(statics), tuple(traced)), leaves

    def __call__(self, *args, **kwargs):
        if getattr(_TLS, "depth", 0):
            # Inside another program's call: inline, keyed by the outer.
            return self.__wrapped__(*args, **kwargs)
        bound, key, leaves = self._bind(args, kwargs)
        with self._lock:
            seen = key in self._keys
            self._keys.add(key)
        store = getattr(_TLS, "store", None) if self.graph else None
        ctx = (program_range(self.name) if self.name in PROGRAMS
               else contextlib.nullcontext())
        with ctx:
            _TLS.depth = 1
            try:
                if store is None:
                    return self._run(bound)
                return store.call(self, key, bound, leaves, seen)
            finally:
                _TLS.depth = 0

    def _run(self, bound):
        """One eager run with the donated outputs aliased onto their
        arguments."""
        return self._alias(bound, self.__wrapped__(*bound.args,
                                                   **bound.kwargs))

    def _alias(self, bound, out):
        if not self.returns:
            return out
        single = not isinstance(out, tuple)
        outs = [out] if single else list(out)
        if len(outs) != len(self.returns):
            raise TypeError(f"program {self.name} returned {len(outs)} "
                            f"outputs, names {len(self.returns)}")
        for i, name in enumerate(self.returns):
            if name not in self.donate:
                continue
            arg = bound.arguments[name]
            if outs[i] is not arg:
                arg.copy_(outs[i])
                outs[i] = arg
        return outs[0] if single else tuple(outs)


def _spec(prog: str, arg: str, value, path: str, leaves: List[tuple]):
    """The key of one traced argument; its tensor and generator leaves
    (path, object) are appended to ``leaves`` in a fixed order."""
    if isinstance(value, torch.Tensor):
        leaves.append((path, value))
        return ("tensor", tuple(value.shape), value.dtype, value.device)
    if value is None or isinstance(value, torch.Generator):
        # A generator slot, set or not, or an absent optional tensor (see
        # the module docstring): one key either way.
        leaves.append((path, value))
        return "slot"
    if isinstance(value, (bool, int, float, str)):
        raise TypeError(
            f"program {prog}: {path} is a Python {type(value).__name__} "
            f"({value!r}) in argument {arg!r}, which is not static; "
            "declare it static or pass a tensor")
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__qualname__, tuple(
            (f.name, _spec(prog, arg, getattr(value, f.name),
                           f"{path}.{f.name}", leaves))
            for f in dataclasses.fields(value)))
    if isinstance(value, dict):
        return ("dict", tuple(
            (k, _spec(prog, arg, value[k], f"{path}[{k!r}]", leaves))
            for k in sorted(value)))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(
            _spec(prog, arg, v, f"{path}[{i}]", leaves)
            for i, v in enumerate(value)))
    raise TypeError(f"program {prog}: {path} holds a "
                    f"{type(value).__qualname__}, which a program key "
                    "cannot hold")


# ---------------------------------------------------------------------------
# CUDA graphs
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def use_graphs(store: Optional["GraphStore"]):
    """Dispatch this thread's ``graph=True`` programs through ``store``
    (None: eagerly) for the duration."""
    prev = getattr(_TLS, "store", None)
    _TLS.store = store
    try:
        yield store
    finally:
        _TLS.store = prev


@dataclasses.dataclass
class CapturedGraph:
    """One captured key: the graph, the inputs it reads (path, tensor or
    generator, donated, copied), its outputs, and the launch counts each
    replay adds."""

    program: str
    key: Any
    graph: Any
    inputs: List[Tuple[str, Any, bool, bool]]
    outputs: Any
    counts: List[Any]               # ops._build.CountRecord
    replays: int = 0

    @property
    def custom_kernels(self) -> int:
        """Hand-written kernels the capture recorded (the wrappers'
        counts): the graph holds at least as many kernel nodes."""
        return sum(rec.kernels for rec in self.counts)


class GraphStore:
    """The CUDA graphs of one owner (a batcher on one card, or one
    ``engine.generate``/``score`` call): graphs by (program, key, pinned
    input addresses) and one memory pool shared by all of them.
    ``capture_first``: a key this process has run before is captured
    and replayed at its first call here (see the module docstring).
    :meth:`close` frees them (a retired replica, a dropped batcher, the
    end of a call)."""

    def __init__(self, device, capture_first: bool = False):
        device = torch.device(device)
        if device.index is None:   # "cuda": the current card
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        if device not in _CAPTURE_STREAMS:
            _capturer().submit(_capture_stream, device).result()
        self.capture_first = bool(capture_first)
        self.graphs: Dict[Tuple[str, Any, Any], CapturedGraph] = {}
        self._pool = torch.cuda.graph_pool_handle()
        self.captures = 0
        self.replays = 0

    def close(self) -> None:
        """Free every graph and, with them, the store's pool."""
        for g in self.graphs.values():
            g.graph.reset()
        self.graphs.clear()
        self._pool = None
        _DROPPED[0] += 1

    def __del__(self):
        if self.graphs:
            _DROPPED[0] += 1

    def call(self, prog: Program, key, bound, leaves, seen: bool = False):
        gid = (prog.name, key, _pins(prog, leaves))
        entry = self.graphs.get(gid)
        if entry is not None:
            return self._replay(prog, entry, bound, leaves)
        if self.capture_first and seen:
            self._capture(prog, key, gid, bound, leaves)
            return self._replay(prog, self.graphs[gid], bound, leaves)
        warm = prog._run(bound)
        self._capture(prog, key, gid, bound, leaves)
        return warm

    def _capture(self, prog: Program, key, gid, bound, leaves):
        """Capture ``gid`` on the capture thread, in this thread's grad
        and inference modes and mesh; this thread waits for it."""
        from ..parallel.mesh import current_mesh, use_mesh

        main = torch.cuda.current_stream(self.device)
        grad, mesh = torch.is_grad_enabled(), current_mesh()
        inference = torch.is_inference_mode_enabled()

        def job():
            with torch.cuda.device(self.device), \
                    torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad), use_mesh(mesh):
                _TLS.depth = 1
                try:
                    self._capture_graph(prog, key, gid, bound, leaves,
                                        main)
                finally:
                    _TLS.depth = 0

        _capturer().submit(job).result()

    def _capture_graph(self, prog: Program, key, gid, bound, leaves, main):
        from ..ops import _build  # the ops package imports this module

        if self._pool is None:
            raise RuntimeError(f"program {prog.name}: the graph store was "
                               "closed")
        inputs = []
        for path, obj in leaves:
            if isinstance(obj, torch.Tensor) and obj.device != self.device:
                raise RuntimeError(
                    f"program {prog.name}: {path} lies on {obj.device}, "
                    f"the graph store on {self.device}")
            inputs.append((path, obj, _in_args(path, prog.donate),
                           _in_args(path, prog.copied)))
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        seen = set()
        for _, obj, _, _ in inputs:
            if isinstance(obj, torch.Generator) and id(obj) not in seen:
                seen.add(id(obj))
                graph.register_generator_state(obj)
        # Return the memory pools of graphs freed since (a dropped
        # batcher's, an ended call's) and the cache's idle blocks to the
        # device before the new graph allocates its own
        # (torch.cuda.graph empties the cache before every capture):
        # memory a dead graph's pool holds serves no other allocation,
        # and the graph's instantiation allocates outside the cache.
        if _DROPPED[0] != _DROPPED[1]:
            _DROPPED[1] = _DROPPED[0]
            torch.cuda.empty_cache()
        side = _capture_stream(self.device)
        side.wait_stream(main)
        # No cyclic collection during the capture: a dropped batcher's
        # graphs destroyed by one on this thread is an operation a capture
        # does not permit, and it would invalidate this one.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.record_counts() as record, torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = prog._run(bound)
                finally:
                    graph.capture_end()
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(
                f"program {prog.name}: CUDA graph capture failed for key "
                f"{_key_label(key)}: {type(e).__name__}: {e}") from e
        finally:
            if collecting:
                gc.enable()
            main.wait_stream(side)
        self.captures += 1
        self.graphs[gid] = CapturedGraph(
            prog.name, key, graph, inputs, outputs, list(record.values()))

    def _replay(self, prog: Program, entry: CapturedGraph, bound, leaves):
        from ..ops import _build

        back = []
        for (path, cap, donated, copied), (_, cur) in zip(entry.inputs,
                                                          leaves):
            if cur is cap:
                continue
            if not isinstance(cap, torch.Tensor):
                raise RuntimeError(
                    f"program {prog.name}: {path} is not the generator "
                    "the graph captured (each caller keeps its own)")
            if (cur.data_ptr() == cap.data_ptr()
                    and cur.stride() == cap.stride()):
                continue
            nbytes = cur.numel() * cur.element_size()
            if nbytes > SMALL_INPUT_BYTES and not copied:
                raise RuntimeError(
                    f"program {prog.name}: {path} ({nbytes} bytes) is not "
                    "at the address the graph captured")
            cap.copy_(cur)
            if donated:
                back.append((cur, cap))
        entry.graph.replay()
        for cur, cap in back:
            cur.copy_(cap)
        _build.add_counts(entry.counts)
        entry.replays += 1
        self.replays += 1
        out = entry.outputs
        if not prog.returns:
            return out
        single = not isinstance(out, tuple)
        outs = [out] if single else list(out)
        for i, name in enumerate(prog.returns):
            if name in prog.donate:
                outs[i] = bound.arguments[name]
        return outs[0] if single else tuple(outs)


def _pins(prog: Program, leaves) -> Tuple[Tuple[str, int], ...]:
    """The addresses that pick a call's graph besides its key: those of
    its donated and its large tensor inputs (weights, pools, the state
    twins), outside the ``copied`` arguments.  Another address there is
    another graph, so a captured input the caller still owns is never
    overwritten by a copy-in."""
    out = []
    for path, obj in leaves:
        if not isinstance(obj, torch.Tensor) or _in_args(path, prog.copied):
            continue
        if (_in_args(path, prog.donate)
                or obj.numel() * obj.element_size() > SMALL_INPUT_BYTES):
            out.append((path, obj.data_ptr()))
    return tuple(out)


def _capture_stream(device):
    """The capture stream for ``device`` (on the capture thread only),
    made on first use with cuBLAS's workspaces for it and this thread by a
    few products (plain and with a bias, in bf16 and float32) run on it
    before any capture."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device=device)
            with torch.cuda.stream(stream):
                for dtype in (torch.bfloat16, torch.float32):
                    a = torch.ones((64, 64), dtype=dtype, device=device)
                    torch.mm(a, a)
                    torch.addmm(a[0], a, a)
        _CAPTURE_STREAMS[device] = stream
    return stream


def _key_label(key) -> str:
    """A key's static values (a config by its class) and its number of
    traced leaves: what names a key in an error."""
    statics, traced = key
    shown = ", ".join(
        f"{k}={type(v).__name__ if dataclasses.is_dataclass(v) else v!r}"
        for k, v in statics)
    return f"({shown}; {len(traced)} traced arguments)"


def _in_args(path: str, names: Sequence[str]) -> bool:
    """Whether a leaf path (``fill``, ``pool.k``, ``generators[3]``)
    lies in one of the arguments ``names``."""
    head = path.split(".", 1)[0].split("[", 1)[0]
    return head in names


def jit_cache_entries() -> Dict[str, int]:
    """{program: keys seen in this process} for every registered
    program."""
    return {n: p.cache_size() for n, p in registry().items()}


__all__ = [
    "CapturedGraph", "GraphStore", "Program", "REGISTRY",
    "SMALL_INPUT_BYTES", "clear_caches", "jit_cache_entries", "program",
    "registry", "use_graphs",
]
