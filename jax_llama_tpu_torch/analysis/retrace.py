"""Retrace auditor: bounded cache-key domains for every program (port of
``jax_llama_tpu/analysis/retrace.py``).

A program's cache (``utils.programs``: on the card, one CUDA graph per
key) is keyed by its static arguments and the shapes and dtypes of its
tensor arguments.  The serving stack's latency story assumes each program
holds O(log) keys -- pow2 buckets for chunk sizes, row counts and padded
widths; bools and ctor-stable objects for everything else.  One
un-bucketed width at one call site re-captures a program per request.

Two layers, as JAX's:

  1. **Static layer** (:func:`check_static`): for every registered
     :class:`~.contracts.ProgramContract`, find each dispatch call site of
     its function in its module and prove every value that enters the key
     flows through a *bounded-domain constructor*:

       * the program's ``static`` keyword values, and
       * the dims of every locally-constructed array argument (the
         admission-path uploads whose shapes key the program), and
       * the registered :data:`SHAPE_SOURCES` -- host buffers built
         elsewhere whose shapes reach a dispatch through attributes.

     Bounded means: literals and bools; ``self.<attr>`` assigned only in
     ``__init__`` (ctor-stable); calls to :data:`BOUNDED_CALLS` /
     :data:`BOUNDED_METHODS`; ``min(...)`` clamps against a bounded bound;
     boolean expressions; and compositions thereof.  Anything else is an
     ``unbounded-trace-domain`` finding, sanctionable with
     ``# audit: trace-domain(<why the domain is bounded anyway>)``.  A
     registered program without ``max_cache_keys`` is a finding too.

  2. **Runtime drill** (:func:`check_runtime`): real batchers on the CPU
     at the contracts' tiny geometry sweep the admission surface (prompt
     lengths across block buckets, greedy + sampled, stop sets, fused +
     classic + speculative lanes) and the DELTA in
     ``serving.jit_cache_entries()`` per program must stay within each
     contract's ``max_cache_keys``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import (
    Finding, Pragmas, def_line_span, iter_package_sources, node_span,
    parse_module, program_decorations,
)
from .contracts import REGISTRY, ProgramContract

CHECKER = "retrace"

# Free functions whose RESULT has a bounded domain by documented
# contract.  ``pow2_bucket`` is THE bucketing primitive.
BOUNDED_CALLS = frozenset({
    "pow2_bucket", "bool", "frozenset",
})

# Methods of the serving classes with the same property: each returns a
# pow2-bucketed / flag-clamped value (``_pick_chunk``, ``_suffix_pad``,
# ``_pf_chunk``, ``_row_bucket``) or a bool (``_spec_kernel_ok``,
# ``_fused_scheduling``; any method annotated ``-> bool`` too).
BOUNDED_METHODS = frozenset({
    "_pick_chunk", "_suffix_pad", "_pf_chunk", "_row_bucket",
    "_spec_kernel_ok", "_fused_scheduling",
})

# Attribute names that carry bounded values ACROSS object boundaries:
# ``chunk`` is ``_Prefill.chunk`` = ``_pf_chunk``'s pow2 result.
BOUNDED_ATTRS = frozenset({"chunk"})

# Array constructors whose first argument is the shape to audit.
_SHAPE_CTORS = frozenset({"zeros", "ones", "full", "empty"})
# Calls to look through when resolving an array argument to its
# constructor: uploads (their first argument) and tensor methods (their
# receiver).
_PASSTHROUGH = frozenset({"asarray", "array", "from_numpy", "as_tensor",
                          "tensor", "concatenate", "stack"})
_METHOD_PASSTHROUGH = frozenset({"to", "bool", "long", "int", "float",
                                 "view", "contiguous"})

# Host buffers whose SHAPES reach a dispatch indirectly (an attribute or
# a device twin): per program, the (defining function, local variable)
# pairs whose constructor dims the static layer must prove bounded.
SHAPE_SOURCES: Dict[str, List[Tuple[str, str]]] = {
    # the fused-prefill token buffer: pow2(n_chunks) * C (_pf_chunk)
    "_fused_chunk": [("_setup_fused_prefill", "toks")],
    # the per-slot stop table: width pow2-bucketed on regrowth; its shape
    # keys every chunk/spec-chunk/scatter program
    "_paged_decode_chunk": [("_set_stop_row", "tab")],
    "_spec_rounds_chunk": [("_set_stop_row", "tab")],
    "_scatter_rows": [("_set_stop_row", "tab")],
}


def _static_argnames(dec: Optional[ast.Call]) -> Set[str]:
    if dec is None:
        return set()
    out: Set[str] = set()
    for kw in dec.keywords:
        if kw.arg == "static":
            for elt in ast.walk(kw.value):
                if isinstance(elt, ast.Constant) and isinstance(
                        elt.value, str):
                    out.add(elt.value)
    return out


def _ctor_stable_attrs(cls: ast.ClassDef) -> Set[str]:
    """self-attributes assigned ONLY inside ``__init__``: one value per
    instance lifetime, so they contribute exactly one key."""
    init_writes: Set[str] = set()
    other_writes: Set[str] = set()
    for node in cls.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        sink = init_writes if node.name == "__init__" else other_writes
        for sub in ast.walk(node):
            targets: List[ast.AST] = []
            if isinstance(sub, ast.Assign):
                targets = list(sub.targets)
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                targets = [sub.target]
            for t in targets:
                for leaf in ast.walk(t):
                    if (
                        isinstance(leaf, ast.Attribute)
                        and isinstance(leaf.ctx, (ast.Store, ast.Del))
                        and isinstance(leaf.value, ast.Name)
                        and leaf.value.id == "self"
                    ):
                        sink.add(leaf.attr)
    return init_writes - other_writes


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class _BoundedProver:
    """Backward boundedness proof for expressions inside one function
    (single-function dataflow: a Name is bounded iff every assignment to
    it in the function is bounded)."""

    def __init__(self, fn: ast.FunctionDef, cls: Optional[ast.ClassDef],
                 ctor_stable: Set[str]):
        self.fn = fn
        self.cls = cls
        self.ctor_stable = ctor_stable
        self._assigns: Dict[str, List[ast.AST]] = {}
        self._bool_methods: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    self._index_target(t, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._index_target(node.target, node.value)
        if cls is not None:
            for node in cls.body:
                if isinstance(node, ast.FunctionDef) and isinstance(
                    node.returns, ast.Name
                ) and node.returns.id == "bool":
                    self._bool_methods.add(node.name)

    def _index_target(self, target: ast.AST, value: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self._assigns.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            # tuple unpack: each element inherits the RHS's boundedness.
            for elt in target.elts:
                if isinstance(elt, ast.Name):
                    self._assigns.setdefault(elt.id, []).append(value)

    def why_unbounded(self, node: ast.AST,
                      seen: Optional[Set[str]] = None) -> Optional[str]:
        """None if ``node`` provably has a bounded domain, else a short
        reason naming the unprovable leaf."""
        seen = seen if seen is not None else set()
        if isinstance(node, ast.Constant):
            return None
        if isinstance(node, (ast.Compare, ast.BoolOp)):
            return None  # bool domain
        if isinstance(node, ast.UnaryOp):
            return self.why_unbounded(node.operand, seen)
        if isinstance(node, ast.BinOp):
            return (self.why_unbounded(node.left, seen)
                    or self.why_unbounded(node.right, seen))
        if isinstance(node, ast.IfExp):
            return (self.why_unbounded(node.body, seen)
                    or self.why_unbounded(node.orelse, seen))
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                why = self.why_unbounded(elt, seen)
                if why:
                    return why
            return None
        if isinstance(node, ast.Starred):
            return self.why_unbounded(node.value, seen)
        if isinstance(node, ast.Subscript):
            return self.why_unbounded(node.value, seen)
        if isinstance(node, ast.Attribute):
            dotted = _dotted(node)
            if node.attr == "shape":
                # Shapes of INSTANCE state are stable-or-bucketed where
                # built; a bare parameter's .shape is request-shaped.
                base = node.value
                while isinstance(base, ast.Attribute):
                    base = base.value
                if isinstance(base, ast.Name) and base.id == "self":
                    return None
                return (
                    f"{dotted!r}: .shape of a non-instance value is "
                    "request-shaped unless its constructor is checked"
                )
            if node.attr in BOUNDED_ATTRS:
                return None
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                if node.attr in self.ctor_stable:
                    return None
                return (
                    f"self.{node.attr} is not ctor-stable (assigned "
                    "outside __init__)"
                )
            return f"attribute {dotted!r} has no bounded-domain proof"
        if isinstance(node, ast.Name):
            if node.id in seen:
                return None  # cycle: judged by the other assignments
            if node.id not in self._assigns:
                return (
                    f"name {node.id!r} is not assigned in this "
                    "function (parameter or outer binding)"
                )
            seen = seen | {node.id}
            for value in self._assigns[node.id]:
                why = self.why_unbounded(value, seen)
                if why:
                    return why
            return None
        if isinstance(node, ast.Call):
            fname = _dotted(node.func)
            leaf = fname.rsplit(".", 1)[-1]
            if leaf in BOUNDED_CALLS:
                return None
            if fname.startswith("self.") and (
                leaf in BOUNDED_METHODS or leaf in self._bool_methods
            ):
                return None
            if leaf == "min":
                # a clamp: bounded if ANY operand is bounded above
                for a in node.args:
                    if self.why_unbounded(a, seen) is None:
                        return None
                return "min() with no bounded operand"
            if leaf == "max":
                for a in node.args:
                    why = self.why_unbounded(a, seen)
                    if why:
                        return why
                if not node.args:
                    return "max() over a generator is unbounded"
                return None
            if leaf == "len":
                return (
                    "len(...) is request-shaped -- bucket it "
                    "(pow2_bucket / a declared clamp)"
                )
            return f"call to {fname!r} is not a bounded-domain constructor"
        return f"expression {type(node).__name__} has no boundedness rule"


def _resolve_array_ctor(
    expr: ast.AST, prover: _BoundedProver,
) -> Optional[ast.Call]:
    """The ``np.zeros``-class constructor an argument expression resolves
    to (through uploads, tensor methods, slices and local names), or None
    when the argument is not locally constructed (attribute loads and
    device twins: shape-stable, audited where built)."""
    for _ in range(8):
        if isinstance(expr, ast.Call):
            leaf = _dotted(expr.func).rsplit(".", 1)[-1]
            if leaf in _SHAPE_CTORS:
                return expr
            if leaf in _PASSTHROUGH and expr.args:
                expr = expr.args[0]
                if isinstance(expr, (ast.List, ast.Tuple)) and expr.elts:
                    expr = expr.elts[0]   # np.concatenate([first, ...])
                continue
            if (leaf in _METHOD_PASSTHROUGH
                    and isinstance(expr.func, ast.Attribute)):
                expr = expr.func.value
                continue
            return None
        if isinstance(expr, ast.Subscript):
            expr = expr.value
            continue
        if isinstance(expr, ast.Name):
            assigns = prover._assigns.get(expr.id)
            if not assigns or len(assigns) != 1:
                return None
            expr = assigns[0]
            continue
        return None
    return None


def _call_sites(
    tree: ast.Module, name: str,
) -> List[Tuple[ast.Call, ast.FunctionDef, Optional[ast.ClassDef]]]:
    out = []

    def walk(node, fn, cls):
        for child in ast.iter_child_nodes(node):
            f, c = fn, cls
            if isinstance(child, ast.ClassDef):
                c = child
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                f = child
            if (
                isinstance(child, ast.Call)
                and _dotted(child.func).rsplit(".", 1)[-1] == name
                and fn is not None
                and fn.name != name
            ):
                out.append((child, fn, cls))
            walk(child, f, c)

    walk(tree, None, None)
    return out


def check_module_source(
    path: str,
    source: str,
    registry: Dict[str, ProgramContract] = REGISTRY,
    module: Optional[str] = None,
) -> List[Finding]:
    """Static retrace audit of one module's dispatch call sites."""
    modname = module or path.rsplit("/", 1)[-1][:-3]
    tree, findings = parse_module(path, source, CHECKER)
    if tree is None:
        return findings
    pragmas = Pragmas.scan(source)
    programs = program_decorations(tree)
    inline = {fn.name for fn, _ in programs.values()}
    classes = {
        n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
    }
    stable_by_class = {
        name: _ctor_stable_attrs(cls) for name, cls in classes.items()
    }

    def sanctioned(node: ast.AST, fn: ast.FunctionDef) -> bool:
        return pragmas.allows(
            "trace-domain", node_span(node), def_line_span(fn)
        )

    def report(node, fn, program, what, why):
        findings.append(Finding(
            checker=CHECKER, rule="unbounded-trace-domain",
            path=path, line=getattr(node, "lineno", fn.lineno),
            message=(
                f"{program}: {what} is not provably bounded -- {why}. "
                "Every cache-key value must pass through a bounded-domain "
                "constructor (pow2_bucket, a clamp against a flag, a "
                "bool, a ctor-stable attribute); sanction a "
                "provably-bounded-anyway case with "
                "# audit: trace-domain(<argument>)"
            ),
            sanctionable=True,
        ))

    for name, contract in sorted(registry.items()):
        if contract.module.rsplit(".", 1)[-1] != modname:
            continue
        dec = programs.get(name)
        fn_name = dec[0].name if dec else (contract.function or name)
        statics = _static_argnames(dec[1]) if dec else set()
        for call, fn, cls in _call_sites(tree, fn_name):
            if cls is None and fn.name in inline:
                continue  # a call inside a program runs inline, keyless
            stable = stable_by_class.get(cls.name, set()) if cls else set()
            prover = _BoundedProver(fn, cls, stable)
            if sanctioned(call, fn):
                continue
            for kw in call.keywords:
                if kw.arg not in statics:
                    continue
                why = prover.why_unbounded(kw.value)
                if why and not sanctioned(kw.value, fn):
                    report(kw.value, fn, name,
                           f"static arg {kw.arg!r} at {fn.name}", why)
            for arg in list(call.args) + [
                kw.value for kw in call.keywords if kw.arg not in statics
            ]:
                ctor = _resolve_array_ctor(arg, prover)
                if ctor is None or not ctor.args:
                    continue
                why = prover.why_unbounded(ctor.args[0])
                if why and not sanctioned(ctor, fn) and not sanctioned(
                    arg, fn
                ):
                    report(
                        ctor, fn, name,
                        f"shape of a constructed array argument at "
                        f"{fn.name}", why,
                    )
    # -- registered shape sources -------------------------------------------
    fns_by_name: Dict[str, List[Tuple[ast.FunctionDef,
                                      Optional[ast.ClassDef]]]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    fns_by_name.setdefault(sub.name, []).append(
                        (sub, node)
                    )
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            fns_by_name.setdefault(node.name, []).append((node, None))

    for name, contract in sorted(registry.items()):
        if contract.module.rsplit(".", 1)[-1] != modname:
            continue
        for fn_name, var in SHAPE_SOURCES.get(name, ()):
            hits = fns_by_name.get(fn_name)
            if not hits:
                findings.append(Finding(
                    checker=CHECKER, rule="stale-registry", path=path,
                    line=0,
                    message=(
                        f"retrace SHAPE_SOURCES names "
                        f"{fn_name!r}/{var!r} for {name} but the "
                        "function no longer exists"
                    ),
                ))
                continue
            for fn, cls in hits:
                stable = (
                    stable_by_class.get(cls.name, set()) if cls else set()
                )
                prover = _BoundedProver(fn, cls, stable)
                assigns = prover._assigns.get(var, [])
                if not assigns:
                    findings.append(Finding(
                        checker=CHECKER, rule="stale-registry",
                        path=path, line=fn.lineno,
                        message=(
                            f"retrace SHAPE_SOURCES names local "
                            f"{var!r} in {fn_name} (for {name}) but no "
                            "such assignment exists"
                        ),
                    ))
                for value in assigns:
                    ctor = (
                        value if isinstance(value, ast.Call)
                        and _dotted(value.func).rsplit(".", 1)[-1]
                        in _SHAPE_CTORS else None
                    )
                    target = (
                        ctor.args[0] if ctor is not None and ctor.args
                        else value
                    )
                    why = prover.why_unbounded(target)
                    if why and not sanctioned(value, fn):
                        report(
                            value, fn, name,
                            f"shape source {fn_name}.{var}", why,
                        )
    return findings


def check_static(
    registry: Dict[str, ProgramContract] = REGISTRY,
) -> List[Finding]:
    """Static retrace audit over every contract module, plus the
    budget-coverage gate (every program declares ``max_cache_keys``)."""
    findings: List[Finding] = []
    for name, contract in sorted(registry.items()):
        if contract.max_cache_keys is None:
            findings.append(Finding(
                checker=CHECKER, rule="no-cache-key-budget",
                path=contract.module.replace(".", "/") + ".py", line=0,
                message=(
                    f"{name}: contract declares no max_cache_keys -- "
                    "every registered program must bound its key domain "
                    "(see ProgramContract.max_cache_keys)"
                ),
            ))
    modules = sorted({
        c.module.rsplit(".", 1)[-1] for c in registry.values()
    })
    for path, source in iter_package_sources(only=modules):
        findings.extend(
            check_module_source(path, source, registry=registry)
        )
    return findings


# ---------------------------------------------------------------------------
# Runtime drill
# ---------------------------------------------------------------------------

def _sweep_batcher(cb, lengths: Sequence[int], vocab: int) -> None:
    import numpy as np

    rng = np.random.RandomState(7)
    for i, n in enumerate(lengths):
        toks = list(rng.randint(1, vocab, n))
        sampled = i % 2 == 1
        cb.submit(
            toks,
            max_new_tokens=3 + (i % 3),
            temperature=0.8 if sampled else 0.0,
            seed=17 + i if sampled else None,
            stop_tokens=(
                tuple(int(t) for t in rng.randint(1, vocab,
                                                  1 + 2 * (i % 2)))
                if i % 2 else None
            ),
        )
    for _ in range(200):
        if not cb.step() and not cb.pending():
            break
    cb.run_to_completion()


def sweep(device: str = "cpu", params=None, config=None) -> None:
    """JAX's admission sweep (four batchers at the contracts' geometry:
    fused + chunked, classic without the prefix cache, speculative, and
    classic prefix-cache hits) over ``params``/``config`` (default: the
    contracts' tiny model) on ``device``."""
    from ..serving import ContinuousBatcher
    from .contracts import _BLOCK, _MAXLEN, _VOCAB, _tiny_config_params

    if params is None:
        config, params = _tiny_config_params()
    geo = dict(n_slots=2, max_len=_MAXLEN, block_size=_BLOCK,
               device=device)
    # One fused+chunked batcher takes the classic, suffix/prefix,
    # fused-prefill, scatter and release programs across prompt lengths
    # spanning several block buckets...
    cb = ContinuousBatcher(params, config, decode_chunk=4,
                           prefill_budget=_BLOCK, **geo)
    _sweep_batcher(cb, [3, 9, 17, 21, 33, 40, 18, 5], _VOCAB)
    # ...a classic-admission batcher widens the _paged_insert sweep...
    cb2 = ContinuousBatcher(params, config, decode_chunk=2,
                            prefix_cache=False, **geo)
    _sweep_batcher(cb2, [4, 12, 20, 35, 44], _VOCAB)
    # ...a speculative batcher drives the spec programs...
    cb3 = ContinuousBatcher(params, config, spec_rounds=2,
                            draft_params=params, draft_config=config,
                            n_draft=2, **geo)
    _sweep_batcher(cb3, [6, 14, 26], _VOCAB)
    # ...and a classic prefix-cache batcher replays shared prefixes so the
    # grouped suffix-insert path keys its buckets too.
    cb4 = ContinuousBatcher(params, config, decode_chunk=2, **geo)
    base = list(range(1, 37))  # two full blocks + a suffix
    for tail in ([40, 41], list(range(50, 60)), [70]):
        cb4.submit(base + tail, max_new_tokens=2)
        cb4.run_to_completion()
    for b in (cb, cb2, cb3, cb4):
        b.close()


def check_deltas(before: Dict[str, int], after: Dict[str, int],
                 registry: Dict[str, ProgramContract] = REGISTRY
                 ) -> List[Finding]:
    """Each program's key-count growth from ``before`` to ``after``
    against its contract's ``max_cache_keys``."""
    findings: List[Finding] = []
    for name, contract in sorted(registry.items()):
        if contract.max_cache_keys is None or name not in after:
            continue  # check_static reports a missing budget
        delta = after[name] - before.get(name, 0)
        if delta > contract.max_cache_keys:
            findings.append(Finding(
                checker=CHECKER, rule="cache-key-overrun",
                path=contract.module.replace(".", "/") + ".py", line=0,
                message=(
                    f"{name}: the admission sweep created {delta} cache "
                    f"keys (contract: {contract.max_cache_keys}) -- a "
                    "key value is escaping its bucket; see "
                    "llm_jit_cache_entries and the retrace static findings"
                ),
            ))
    return findings


def check_runtime(
    registry: Dict[str, ProgramContract] = REGISTRY,
) -> List[Finding]:
    """The cache drill: sweep the admission surface on real batchers and
    hold each program's key-count DELTA (the cache counts keys per
    process; only this sweep's growth is this configuration's footprint)
    within its contract's ``max_cache_keys``."""
    from .. import serving

    before = serving.jit_cache_entries()
    sweep()
    return check_deltas(before, serving.jit_cache_entries(), registry)
