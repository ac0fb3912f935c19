"""Lowering auditor: contract checks for the serving programs (port of
``jax_llama_tpu/analysis/lowering.py``).

JAX lowers each jitted program and reads its jaxpr and StableHLO.  The
port's programs are eager PyTorch under ``utils.programs.program`` (CUDA
graphs on the card), so the auditor runs each one on the CPU at its
contract's tiny example under a recording ``TorchDispatchMode``: every
aten op with the shapes it produced and the storages it wrote is the
port's counterpart of the jaxpr.  Three layers, cheapest first
(contracts.py holds the registry):

  1. **Coverage + decorator audit (static, AST).**  Every
     ``program(...)``-decorated module-level function in serving.py /
     kvcache.py / ops/kernels.py must have a registered
     :class:`~.contracts.ProgramContract` under the decorator's name, the
     registry must not hold stale names, and each decorator's ``donate``
     must match its contract exactly, both ways.
  2. **Donation (recorded run).**  The program's declared donations must
     equal the contract's (JAX's ``leaf.donated`` check), every tensor
     leaf of a donated argument must be written in place during the call,
     and a donated argument the program returns must come back as the
     same storage (``donation-unresolved`` otherwise: the counterpart of
     an alias that does not resolve).  An argument written in place that
     the contract does not donate is a finding too.
  3. **Host-fetch surface + forbidden copies (recorded run).**  Outputs
     that share no storage with a donated input are what the host can
     fetch: their count must not exceed ``max_live_outputs`` and their
     bytes per batch row must fit ``max_fetch_bytes_per_row``.  No
     copy-class aten op (:data:`FORBIDDEN_OPS`) may produce a
     full-pool-sized or one-plane-sized tensor.  In-place writes
     (``index_put_``, ``copy_``) are the sanctioned ones, as JAX's
     scatter and dynamic-update-slice are.
"""

from __future__ import annotations

import ast
import importlib
import math
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .common import (
    Finding, iter_package_sources, parse_module, program_decorations,
)
from .contracts import (
    CONTRACT_MODULES, NON_DISPATCHED, REGISTRY, ProgramContract,
    pool_shapes,
)

CHECKER = "lowering"

# Copy-class aten ops (JAX's FORBIDDEN_PRIMITIVES, :52-58, in aten):
# producing a pool-sized result through any of these materializes a
# full-pool copy.  ``expand`` is a view; it counts when it broadcasts a
# smaller tensor to the pool's shape (the op that materializes it is then
# elementwise: JAX's ``broadcast_in_dim``).  In-place writes are not
# listed.
FORBIDDEN_OPS = frozenset({
    "expand", "index", "gather", "index_select", "take", "cat", "stack",
    "permute_copy", "clone", "copy", "_to_copy", "flip", "where",
    "constant_pad_nd", "pad", "arange", "full", "full_like", "repeat",
    "index_put", "scatter", "masked_fill", "slice_scatter",
    "select_scatter",
})


# ---------------------------------------------------------------------------
# Static layer
# ---------------------------------------------------------------------------

def _decorator_donations(dec: Optional[ast.Call], tree: ast.Module
                         ) -> Tuple[str, ...]:
    """The ``donate`` names a ``program(...)`` decorator declares: the
    keyword's expression evaluated over the module's literal constants
    (``donate=_CHUNK_DONATED + ("pf_off",)``)."""
    if dec is None:
        return ()
    consts: Dict[str, Any] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                continue
    for kw in dec.keywords:
        if kw.arg != "donate":
            continue
        try:
            value = eval(compile(ast.Expression(kw.value), "<donate>",
                                 "eval"), {"__builtins__": {}}, consts)
        except Exception:  # noqa: BLE001 - not a literal declaration
            return ("<not a literal tuple>",)
        return tuple(value)
    return ()


def check_static(
    registry: Dict[str, ProgramContract] = REGISTRY,
    modules: Sequence[str] = CONTRACT_MODULES,
    non_dispatched: frozenset = NON_DISPATCHED,
) -> List[Finding]:
    """Coverage + decorator audit over the contract modules' sources."""
    findings: List[Finding] = []
    seen: Dict[str, Tuple[str, ast.FunctionDef, Optional[ast.Call],
                          ast.Module]] = {}
    for path, source in iter_package_sources(only=modules):
        tree, errs = parse_module(path, source, CHECKER)
        findings.extend(errs)
        if tree is None:
            continue
        for name, (fn, dec) in program_decorations(tree).items():
            seen[name] = (path, fn, dec, tree)

    for name, (path, fn, dec, tree) in sorted(seen.items()):
        if name in non_dispatched:
            continue
        contract = registry.get(name)
        if contract is None:
            findings.append(Finding(
                checker=CHECKER, rule="unregistered-program",
                path=path, line=fn.lineno,
                message=(
                    f"program {name!r} ({fn.name}) has no lowering "
                    "contract -- register it in analysis/contracts.py "
                    "(donated args, fetch budget, forbidden shapes) "
                    "before the batcher may dispatch it"
                ),
            ))
            continue
        declared = _decorator_donations(dec, tree)
        if tuple(sorted(declared)) != tuple(sorted(contract.donated)):
            findings.append(Finding(
                checker=CHECKER, rule="donation-mismatch",
                path=path, line=fn.lineno,
                message=(
                    f"{name}: decorator donates {sorted(declared)} but "
                    f"the contract declares {sorted(contract.donated)} "
                    "-- update whichever is wrong (both are load-bearing: "
                    "a dropped donation copies the carry)"
                ),
            ))
    for name, contract in sorted(registry.items()):
        if name not in seen:
            findings.append(Finding(
                checker=CHECKER, rule="stale-contract",
                path=contract.module.replace(".", "/") + ".py", line=0,
                message=(
                    f"contract {name!r} names a program that no longer "
                    "exists in its module"
                ),
            ))
    return findings


# ---------------------------------------------------------------------------
# Recorded-run layer
# ---------------------------------------------------------------------------

def _tensors(x) -> List[Any]:
    """Tensor leaves of ``x`` (through dicts, lists, tuples and
    dataclasses), in a fixed order."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


class Recording:
    """Every aten op one call dispatched: (op name, output shapes, input
    shapes, storages written in place)."""

    def __init__(self):
        self.ops: List[Tuple[str, List[Tuple[int, ...]],
                             List[Tuple[int, ...]], Set[int]]] = []

    @property
    def written(self) -> Set[int]:
        out: Set[int] = set()
        for _, _, _, w in self.ops:
            out |= w
        return out


def record(fn, *args, **kwargs):
    """Run ``fn`` under a recording dispatch mode; (its result, the
    :class:`Recording`)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    rec = Recording()

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            written: Set[int] = set()
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in _tensors(v):
                    written.add(_storage(t))
            out = func(*args, **kwargs)
            ins = [tuple(t.shape) for t in _tensors(list(args))
                   if isinstance(t, torch.Tensor)]
            outs = [tuple(t.shape) for t in _tensors(out)]
            rec.ops.append((func.overloadpacket.__name__, outs, ins,
                            written))
            return out

    with torch.no_grad(), _Mode():
        result = fn(*args, **kwargs)
    return result, rec


def _resolve_program(contract: ProgramContract):
    mod = importlib.import_module(contract.module)
    return getattr(mod, contract.function or contract.name)


def _batch_rows(args: tuple, argnames: Tuple[str, ...]) -> int:
    """Example batch size: rows of the first per-row state tensor."""
    for name, arg in zip(argnames, args):
        if name in ("tau", "fill", "active", "prompt_tokens",
                    "suffix_tokens", "tokens"):
            return int(arg.shape[0])
    return 1


def _nbytes(t) -> int:
    return int(math.prod(t.shape)) * t.element_size()


def check_lowering(
    contract: ProgramContract,
    path_hint: Optional[str] = None,
) -> List[Finding]:
    """Run ``contract``'s program at its example under a recording
    dispatch mode and audit its donations, host-fetch surface and
    copy-class ops."""
    findings: List[Finding] = []
    path = path_hint or contract.module.replace(".", "/") + ".py"
    if contract.build is None:
        return findings
    program = _resolve_program(contract)
    argnames, args, kwargs = contract.build()
    by_name = dict(zip(argnames, args))
    declared = set(getattr(program, "donate", ()))
    returns = tuple(getattr(program, "returns", ()))
    out, rec = record(program, *args, **kwargs)
    outs = list(out) if isinstance(out, tuple) else [out]
    # A donated carry the call returns unchanged is aliased as it is
    # (JAX's pass-through output): written or returned, it is the carry.
    written = rec.written | {
        _storage(t) for i, name in enumerate(returns)
        if i < len(outs) and name in contract.donated
        for t in _tensors(outs[i])}

    # -- donation ------------------------------------------------------------
    for name, arg in zip(argnames, args):
        want = name in contract.donated
        leaves = _tensors(arg)
        if want and name not in declared:
            findings.append(Finding(
                checker=CHECKER, rule="donation-not-applied",
                path=path, line=0,
                message=(
                    f"{contract.name}: contract donates {name!r} but the "
                    "program does not declare it donated -- its new value "
                    "is returned in a fresh buffer, not written in place"
                ),
            ))
        elif not want and name in declared:
            findings.append(Finding(
                checker=CHECKER, rule="donation-not-applied",
                path=path, line=0,
                message=(
                    f"{contract.name}: argument {name!r} is donated by "
                    "the program but the contract does not declare it"
                ),
            ))
        if want and name in declared:
            cold = [t for t in leaves if _storage(t) not in written]
            if cold:
                findings.append(Finding(
                    checker=CHECKER, rule="donation-unresolved",
                    path=path, line=0,
                    message=(
                        f"{contract.name}: {len(cold)}/{len(leaves)} "
                        f"tensor leaves of donated {name!r} are neither "
                        "written in place nor returned by the call -- a "
                        "donated buffer that is never updated in place is "
                        "a copy"
                    ),
                ))
        elif not want and any(_storage(t) in written for t in leaves):
            findings.append(Finding(
                checker=CHECKER, rule="donation-not-applied",
                path=path, line=0,
                message=(
                    f"{contract.name}: argument {name!r} is written in "
                    "place but the contract does not donate it"
                ),
            ))
    donated_storage = {_storage(t) for n in contract.donated
                       if n in by_name for t in _tensors(by_name[n])}
    for i, name in enumerate(returns):
        if i < len(outs) and name in contract.donated and name in by_name:
            got = [_storage(t) for t in _tensors(outs[i])]
            want = [_storage(t) for t in _tensors(by_name[name])]
            if got != want:
                findings.append(Finding(
                    checker=CHECKER, rule="donation-unresolved",
                    path=path, line=0,
                    message=(
                        f"{contract.name}: donated {name!r} comes back in "
                        "another buffer than it went in -- the carry is "
                        "not aliased"
                    ),
                ))

    # -- host-fetch surface --------------------------------------------------
    live = [t for t in _tensors(outs) if _storage(t) not in donated_storage]
    if len(live) > contract.max_live_outputs:
        findings.append(Finding(
            checker=CHECKER, rule="fetch-count",
            path=path, line=0,
            message=(
                f"{contract.name}: {len(live)} outputs are not aliased "
                f"onto donated inputs (contract allows "
                f"{contract.max_live_outputs}) -- every live output is "
                "host-fetchable surface; pack or donate it"
            ),
        ))
    rows = _batch_rows(args, argnames)
    live_bytes = sum(_nbytes(t) for t in live)
    budget = contract.max_fetch_bytes_per_row * rows
    if live_bytes > budget:
        findings.append(Finding(
            checker=CHECKER, rule="fetch-bytes",
            path=path, line=0,
            message=(
                f"{contract.name}: live outputs total {live_bytes} B "
                f"for {rows} rows (contract: "
                f"{contract.max_fetch_bytes_per_row} B/row = {budget} "
                "B) -- something vocab-sized or per-position is escaping "
                "to the host"
            ),
        ))

    # -- forbidden pool-shaped copies ----------------------------------------
    if contract.forbid_pool_shapes:
        shapes: Set[Tuple[int, ...]] = set()
        if contract.forbidden_shapes is not None:
            shapes.update(tuple(s) for s in contract.forbidden_shapes(args))
        else:
            for arg in args:
                for obj in _pool_carriers(arg):
                    shapes.update(pool_shapes(obj))
        if not shapes:
            # An empty forbidden set would make the full-pool-copy check
            # pass vacuously.
            findings.append(Finding(
                checker=CHECKER, rule="no-forbidden-shapes",
                path=path, line=0,
                message=(
                    f"{contract.name}: forbid_pool_shapes is set but no "
                    "pool shapes are derivable from the example args -- "
                    "give the contract a forbidden_shapes callable (or "
                    "set forbid_pool_shapes=False with a reason)"
                ),
            ))
        hits: List[str] = []
        for op, out_shapes, in_shapes, _ in rec.ops:
            if op not in FORBIDDEN_OPS:
                continue
            for shape in out_shapes:
                if shape not in shapes:
                    continue
                if op == "expand" and in_shapes and in_shapes[0] == shape:
                    continue  # a no-op expand of the pool itself
                hits.append(f"{op} -> {shape}")
        for hit in hits[:8]:
            findings.append(Finding(
                checker=CHECKER, rule="full-pool-copy",
                path=path, line=0,
                message=(
                    f"{contract.name}: copy-class op {hit} materializes "
                    "a pool-sized tensor -- the no-full-pool-copy "
                    "invariant (doubles KV memory, a ms-class "
                    "per-dispatch regression)"
                ),
            ))
    return findings


def _pool_carriers(x) -> List[Any]:
    """Objects in ``x`` shaped like a ``BlockPool`` (k and block_size)."""
    if hasattr(x, "k") and hasattr(x, "block_size"):
        return [x]
    if isinstance(x, dict):
        return [p for v in x.values() for p in _pool_carriers(v)]
    if isinstance(x, (list, tuple)):
        return [p for v in x for p in _pool_carriers(v)]
    return []


def check_traces(
    registry: Dict[str, ProgramContract] = REGISTRY,
) -> List[Finding]:
    findings: List[Finding] = []
    for name in sorted(registry):
        findings.extend(check_lowering(registry[name]))
    return findings


class LoweringAuditor:
    """Facade bundling the static and the recorded-run layers."""

    def __init__(self, registry: Dict[str, ProgramContract] = REGISTRY):
        self.registry = registry

    def check_package(self, trace: bool = True) -> List[Finding]:
        findings = check_static(self.registry)
        if trace and not any(
            f.rule in ("unregistered-program", "stale-contract",
                       "syntax-error")
            for f in findings
        ):
            findings.extend(check_traces(self.registry))
        return findings
