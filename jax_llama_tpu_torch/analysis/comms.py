"""Comms-budget contracts: the collectives each serving program issues on
a serving mesh (port of ``jax_llama_tpu/analysis/comms.py``).

The JAX package counts the collectives GSPMD inserts into each program's
compiled, sharded lowering.  The port compiles nothing: every collective
is an explicit, counted ``parallel.mesh.Mesh`` call (``mesh.collectives``,
PERF.md section 2's "collectives a token").  So this pass runs the
serving programs on a tiny serving mesh -- tensor = 2, two gloo ranks on
the CPU (:func:`run_example`) -- with every collective of rank 0 recorded
(:class:`Recorder`): its counted kind (the ``Mesh`` counter's, route
included), its result's shape and bytes, and the serving program it ran
in (``serving._chunk_scan``, ``_paged_insert`` ...; ``"host"`` for a host
decision agreed between dispatches).  Each program's calls are held to
its :class:`CommsBudget`, declared at that example geometry:

  * ``pool-collective``: a collective whose RESULT has the shape of the
    pool or of one layer's plane of it (a K/V plane, the positions) is a
    hard finding -- never budgetable: a slice of the pool moved whole.
  * ``comms-bytes``: the largest single collective result must fit
    ``max_bytes`` (the per-layer reductions are activation-sized).
  * ``comms-count``: per-kind counts within ``max_count`` per call (a
    kind absent from the budget allows zero).
  * ``no-comms-budget``: a program that issued collectives without a
    declared budget.

The example needs two processes, so the pass runs only with ``trace``
(``run_all(trace=True)``, or the CLI without ``--no-trace``), as the JAX
package's compiled layer does.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .common import Finding

CHECKER = "comms"
PATH = "jax_llama_tpu_torch/serving.py"

# The serving programs whose dispatches carry collectives (module-level
# functions of serving.py, called through the module's globals).
PROGRAMS = (
    "_chunk_scan", "_fused_chunk", "_paged_insert", "_paged_suffix_insert",
    "_spec_rounds_chunk",
)

# The Mesh methods that issue (and count) a collective.
_MESH_METHODS = (
    "all_reduce", "all_gather", "reduce_scatter", "_ppermute",
    "broadcast_object", "gather_object", "agree",
)

# The example: the tests' tiny model, two slots, tensor = 2.
EXAMPLE_CONFIG = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, multiple_of=32, max_seq_len=64,
                      dtype="float32", param_dtype="float32",
                      attn_impl="auto")
EXAMPLE_BATCHER = dict(n_slots=2, max_len=64, block_size=16,
                       decode_chunk=4)
EXAMPLE_AXES = dict(tensor=2)
EXAMPLE_PROMPTS = ((12, 6), (20, 6))   # (prompt tokens, new tokens)


@dataclasses.dataclass(frozen=True)
class CommsBudget:
    """Per-program collective budget, declared at the example geometry
    (tensor = 2 over two ranks, EXAMPLE_CONFIG) and checked per call of
    the program against the collectives rank 0 issued in it.

      * ``max_count``: counted kind (``Mesh.collectives``' first key:
        ``all_reduce``, ``all_gather``, ``agree`` ...) -> the most one
        call may issue (a kind absent from the dict allows ZERO).  A
        program's per-layer collectives scale with the layers and the
        chunk's iterations, which the example fixes.
      * ``max_bytes``: result bytes of the largest single collective.
        The per-layer tensor-axis reductions are activation-sized; a
        pool-sized one is orders larger at any geometry.

    Full-pool / one-plane shaped collective RESULTS are a hard finding
    whatever the budget (not declarable here on purpose)."""

    max_count: Dict[str, int]
    max_bytes: int


# Measured at the example (2 layers, decode_chunk 4, tensor = 2): a
# decode iteration reduces the embedding, each layer's o and down
# products (row-parallel) and gathers the vocab-sharded logits, so a
# 4-iteration chunk issues 4 x (1 + 2 x 2) all-reduces and 4 gathers; an
# insert is one such forward.  The host decisions between dispatches
# agree nothing on a one-replica serving mesh.
BUDGETS: Dict[str, CommsBudget] = {
    "_chunk_scan": CommsBudget(
        max_count={"all_reduce": 20, "all_gather": 4}, max_bytes=4096),
    "_paged_insert": CommsBudget(
        max_count={"all_reduce": 5, "all_gather": 1}, max_bytes=16384),
}

Record = Tuple[str, Tuple[int, ...], int]       # (kind, shape, bytes)


class Recorder:
    """Every collective one rank's ``mesh`` issues while active, by the
    serving program it ran in: wraps the mesh's collective methods (an
    instance attribute shadows the class's) and the serving programs of
    ``serving`` (its module globals).  ``calls`` lists one (program,
    [records]) per program call, and one ("host", [records]) per
    :meth:`between_dispatches` window that issued any."""

    def __init__(self, mesh, serving_module):
        self.mesh = mesh
        self.serving = serving_module
        self.calls: List[Tuple[str, List[Record]]] = []
        self._current: Optional[List[Record]] = None
        self._host: List[Record] = []
        self._saved: Dict[str, Any] = {}

    def _record(self, kind_delta, result) -> None:
        if hasattr(result, "shape"):
            shape = tuple(int(s) for s in result.shape)
            nbytes = int(result.numel()) * int(result.element_size())
        else:
            shape, nbytes = (), 0
        target = self._current if self._current is not None else self._host
        for kind in kind_delta.elements():
            target.append((kind, shape, nbytes))

    def __enter__(self) -> "Recorder":
        mesh = self.mesh
        for name in _MESH_METHODS:
            orig = getattr(mesh, name)

            def wrapped(*args, _orig=orig, **kwargs):
                before = collections.Counter(
                    {k[0]: v for k, v in mesh.collectives.items()})
                out = _orig(*args, **kwargs)
                after = collections.Counter(
                    {k[0]: v for k, v in mesh.collectives.items()})
                self._record(after - before, out)
                return out

            setattr(mesh, name, wrapped)
        for name in PROGRAMS:
            orig = getattr(self.serving, name)
            self._saved[name] = orig

            def program(*args, _orig=orig, _name=name, **kwargs):
                self.between_dispatches()
                self._current = []
                try:
                    return _orig(*args, **kwargs)
                finally:
                    self.calls.append((_name, self._current))
                    self._current = None

            setattr(self.serving, name, program)
        return self

    def between_dispatches(self) -> None:
        """Close the host window: its collectives become one "host"
        call."""
        if self._host:
            self.calls.append(("host", self._host))
            self._host = []

    def __exit__(self, *exc) -> None:
        self.between_dispatches()
        for name in _MESH_METHODS:
            self.mesh.__dict__.pop(name, None)
        for name, orig in self._saved.items():
            setattr(self.serving, name, orig)


def pool_shapes(pool) -> Set[Tuple[int, ...]]:
    """The shapes no collective may produce: each plane of the pool
    (``BlockPool``: k, v, pos and the int8 scales) and one layer's
    plane, on this rank and whole over the tensor axis."""
    out: Set[Tuple[int, ...]] = set()
    for name in ("k", "v", "pos", "k_scale", "v_scale"):
        t = getattr(pool, name, None)
        if t is None:
            continue
        shape = tuple(int(s) for s in t.shape)
        out.add(shape)
        if len(shape) >= 4:             # [L, KVH, NB, BLK, ...]
            out.add(shape[1:])
            whole = (shape[0], shape[1] * EXAMPLE_AXES["tensor"]) + shape[2:]
            out.add(whole)
            out.add(whole[1:])
    return out


def check_records(
    calls: Sequence[Tuple[str, List[Record]]],
    forbidden: Set[Tuple[int, ...]],
    budgets: Dict[str, CommsBudget] = BUDGETS,
    path: str = PATH,
) -> List[Finding]:
    """Hold each recorded call to its program's budget (module
    docstring); one finding per rule and program, with the worst call."""
    findings: List[Finding] = []
    flagged: Set[Tuple[str, str]] = set()

    def once(rule: str, program: str, message: str) -> None:
        if (rule, program) in flagged:
            return
        flagged.add((rule, program))
        findings.append(Finding(checker=CHECKER, rule=rule, path=path,
                                line=0, message=message))

    for program, records in calls:
        if not records:
            continue
        budget = budgets.get(program)
        for kind, shape, nbytes in records:
            if shape in forbidden:
                once("pool-collective", program, (
                    f"{program} [mesh]: {kind} produces the pool shape "
                    f"{shape} -- a slice of the pool moved whole (hard "
                    "finding; never budgetable)"))
        if budget is None:
            once("no-comms-budget", program, (
                f"{program}: issued {len(records)} collectives on the "
                "serving mesh but declares no CommsBudget (analysis/"
                "comms.py BUDGETS)"))
            continue
        worst = max(records, key=lambda r: r[2])
        if worst[2] > budget.max_bytes:
            once("comms-bytes", program, (
                f"{program} [mesh]: {worst[0]} of {worst[1]} moves "
                f"{worst[2]} B (budget: {budget.max_bytes} B per "
                "collective) -- bigger than any per-layer reduction the "
                "matmul sharding implies"))
        counts = collections.Counter(kind for kind, _, _ in records)
        for kind, n in sorted(counts.items()):
            allowed = budget.max_count.get(kind, 0)
            if n > allowed:
                once("comms-count", program, (
                    f"{program} [mesh]: {n} {kind} in one call (budget: "
                    f"{allowed}) -- the dispatch grew collectives beyond "
                    "the per-layer set the budget sanctions"))
    return findings


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, out) -> None:
    """One rank of the example: the tiny model's shard on the CPU, a
    batcher on the serving mesh, the prompts served to the end with
    rank 0's collectives recorded; rank 0 puts (calls, forbidden shapes)
    on ``out`` (or the error)."""
    import traceback

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from .. import serving
    from ..config import get_config
    from ..models import init_params
    from ..parallel import distributed, make_mesh

    try:
        distributed.initialize(f"localhost:{port}", world, rank,
                               backend="gloo")
        mesh = make_mesh(**EXAMPLE_AXES, devices=["cpu"] * world)
        config = get_config("tiny", **EXAMPLE_CONFIG)
        params = init_params(config, seed=0, device="cpu", mesh=mesh)
        cb = serving.ContinuousBatcher(params, config, mesh=mesh,
                                       device="cpu", **EXAMPLE_BATCHER)
        rng = np.random.RandomState(0)
        with Recorder(mesh, serving) as rec:
            for n, new in EXAMPLE_PROMPTS:
                cb.submit(rng.randint(1, config.vocab_size, n).tolist(),
                          max_new_tokens=new)
            steps = 0
            while cb.pending():
                steps += 1
                if steps > 100:
                    raise RuntimeError("the example did not drain")
                cb.step()
                rec.between_dispatches()
        if rank == 0:
            out.put(("ok", rec.calls, sorted(pool_shapes(cb.pool))))
    except BaseException:
        out.put(("error", f"rank {rank}:\n{traceback.format_exc()}", None))
    finally:
        distributed.shutdown()


def run_example(timeout_s: float = 300.0):
    """(calls, forbidden shapes) of the example, run on two spawned
    gloo ranks (module docstring)."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, 2, port, out),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    try:
        status, calls, forbidden = out.get(timeout=timeout_s)
    except queue.Empty:
        raise RuntimeError("the comms example timed out") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if status != "ok":
        raise RuntimeError(f"the comms example failed: {calls}")
    return calls, {tuple(s) for s in forbidden}


def check_package(
    budgets: Dict[str, CommsBudget] = BUDGETS,
) -> List[Finding]:
    calls, forbidden = run_example()
    return check_records(calls, forbidden, budgets)


def summarize(calls: Sequence[Tuple[str, List[Record]]]) -> Dict[str, Any]:
    """Per program: calls, the most of each kind in one call, and the
    largest result bytes (the figures a budget is set from)."""
    out: Dict[str, Any] = {}
    for program, records in calls:
        s = out.setdefault(program, dict(calls=0, max_count={},
                                         max_bytes=0))
        s["calls"] += 1
        counts = collections.Counter(k for k, _, _ in records)
        for k, n in counts.items():
            s["max_count"][k] = max(s["max_count"].get(k, 0), n)
        s["max_bytes"] = max([s["max_bytes"]] + [b for _, _, b in records])
    return out

