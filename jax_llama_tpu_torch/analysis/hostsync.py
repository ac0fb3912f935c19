"""Host-boundary lint: device->host syncs, uploads-in-loops, device flow
(port of ``jax_llama_tpu/analysis/hostsync.py``, the rules translated to
torch, the rule names unchanged).

The serving stack's host budget is a boundary budget -- ONE packed fetch
and no steady-state upload per chunk dispatch (serving.py module
docstring; ``host_syncs_total`` counts the fetches).  A stray
``.item()`` on a device tensor, a ``float()`` of one, or a tensor built
on the card inside a per-token loop each adds a wait for the device (or
a copy) that chunked decode exists to amortise -- and nothing fails until
a measurement notices.

This checker makes every crossing explicit.  It walks each audited
module's AST with a simple per-function taint analysis:

  * **taint sources** -- ``self.<attr>`` for attributes in the module's
    device-state registry (:data:`DEVICE_SELF_ATTRS`) or with the ``d_``
    device-twin prefix (any base object: ``pf.d_toks``), results of
    ``torch.*`` calls (a tensor op or a constructor, unless it names the
    CPU: ``device="cpu"``, ``pin_memory=``, ``torch.from_numpy``) and of
    the serving programs (:data:`DEVICE_RETURNING`), and parameters with
    conventional device names (:data:`DEVICE_PARAM_NAMES`); taint
    propagates through assignment (tuple unpacks taint every target),
    subscripts, attribute chains, method chains and arithmetic;
  * **sinks** (rule ``host-fetch``) -- ``.item()``, ``.tolist()``,
    ``.numpy()`` and ``.cpu()`` of a tainted value, ``float()`` /
    ``int()`` / ``bool()`` of one, ``np.asarray`` / ``np.array`` of one,
    and unconditionally ``torch.cuda.synchronize()`` and any
    ``<event or stream>.synchronize()``; ``if`` / ``while`` tests on a
    tainted value (rule ``device-flow`` -- Python truthiness of a device
    tensor is a sync); a tensor built on the device inside a host
    ``for`` / ``while`` loop (rule ``host-upload``): a ``torch.*``
    constructor that does not name the CPU, ``.cuda()``, or ``.to()`` of
    a host value towards a device.

Each sanctioned crossing carries an ``# audit: <kind>(<reason>)``
pragma (common.py) -- the allowlist IS the documentation: grep for
``audit: host-fetch`` and you have every device->host sync the serving
stack performs, with its reason.

Functions that run only inside a compiled graph (``torch.compile`` /
``torch.jit.script``, and module-level helpers reachable ONLY from them)
skip the ``host-upload`` rule: a constructor in a Python loop there is a
constant captured into one graph, not a runtime upload.  The port's
serving programs are eager today (ROADMAP A4), so none is exempt.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import (
    Finding, Pragmas, compiled_decorations, def_line_span,
    dotted_name as _dotted, iter_package_sources, node_span, parse_module,
    pragma_findings,
)

CHECKER = "host-boundary"

# Modules under audit: the serving stack, where the host-boundary budget
# is load-bearing (the JAX package's list; model, ops and engine code
# launch the device work and are audited by the card's phases).
AUDITED_MODULES = (
    "serving", "kvcache", "server", "obs", "degrade", "faults",
)

# Per-module device-state registry: ``self.<attr>`` names that hold
# device tensors without the ``d_`` prefix.  The host mirrors (``table``,
# ``fill``, ``pos``, ``active``, ``stop_tab``: numpy) are deliberately
# absent.
DEVICE_SELF_ATTRS: Dict[str, Set[str]] = {
    "serving": {"pool", "draft_pool", "tau", "params", "draft_params"},
    "kvcache": set(),
    "server": set(),
    "obs": set(),
    "degrade": set(),
    "faults": set(),
}

# Attribute names that hold device values on ANY base object (carriers
# like serving._Prefill / _Restore).
DEVICE_ANY_ATTRS = frozenset({"staged", "pool", "draft_pool"})

# Parameters with these names seed taint (module-level device helpers:
# kvcache.fetch_slab(pool, ...), adopt_into_pool(pool, staged), ...).
DEVICE_PARAM_NAMES = frozenset({
    "pool", "draft_pool", "t_pool", "d_pool", "params", "draft_params",
    "t_params", "d_params", "staged", "pool_arrays",
})

# Module-level callables whose results live on the device: the serving
# programs and the device-returning kvcache helpers.
DEVICE_RETURNING = frozenset({
    "_decode_step_core", "_chunk_scan", "_fused_chunk", "_paged_insert",
    "_paged_suffix_insert", "_spec_round_core", "_spec_rounds_chunk",
    "_gather_cache", "_scatter_back", "_warp_rows", "warped_probs_rows",
    "sample_rows", "_finite_rows", "_token_logprob", "_pack_logprobs",
    "init_pool", "adopt_into_pool", "stage_restore", "fetch_slab",
    "paged_forward", "forward",
})

# Metadata attributes of device tensors -- host-resident, never a sync.
_METADATA_ATTRS = frozenset({
    "shape", "dtype", "ndim", "device", "is_cuda", "block_size",
    "n_blocks", "quantized", "data_ptr", "numel", "dim", "size",
    "element_size", "nbytes", "layout",
})

# torch.* calls whose result is not a device tensor.
_HOST_TORCH = frozenset({
    "from_numpy", "device", "Generator", "dtype", "Size", "finfo",
    "iinfo", "is_tensor", "is_grad_enabled", "no_grad", "inference_mode",
    "get_default_dtype", "manual_seed", "set_grad_enabled", "enable_grad",
    "is_floating_point",
})

_FETCH_NP_FUNCS = frozenset({"asarray", "array"})
_FETCH_BUILTINS = frozenset({"float", "int", "bool"})
_FETCH_METHODS = frozenset({"item", "tolist", "numpy", "cpu"})
_UPLOAD_TORCH_FUNCS = frozenset({
    "tensor", "as_tensor", "asarray", "zeros", "ones", "full", "arange",
    "eye", "empty", "zeros_like", "ones_like", "full_like", "empty_like",
})


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _names_cpu(call: ast.Call) -> bool:
    """Does a ``torch.*`` call place its result on the host?"""
    if _kw(call, "pin_memory") is not None:
        return True
    dev = _kw(call, "device")
    if isinstance(dev, ast.Constant) and dev.value == "cpu":
        return True
    if isinstance(dev, ast.Call) and (_dotted(dev.func) or "").endswith(
        "device"
    ) and dev.args and isinstance(dev.args[0], ast.Constant):
        return dev.args[0].value == "cpu"
    return False


def _is_device_arg(node: ast.AST) -> bool:
    """A ``.to()`` argument that names a device (``device``, ``dev``,
    ``self.device``, ``x.device``, ``"cuda"``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    name = _dotted(node) or ""
    leaf = name.rsplit(".", 1)[-1]
    return leaf in ("device", "dev") or leaf.endswith("_device")


def _trace_time_functions(tree: ast.Module, compiled: Set[str]) -> Set[str]:
    """Module-level functions whose EVERY intra-module caller runs only
    inside a compiled graph -- their constructors in a loop are constants
    of one graph, not runtime uploads.

    Fixpoint over the caller relation: a function is graph-time iff it
    is compiled, or it has at least one caller and all of them are
    graph-time.  Calls from class methods / nested defs count as HOST
    callers, and an uncalled function is host by default (it may be an
    external entry point)."""
    funcs: Dict[str, ast.FunctionDef] = {
        n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
    }
    callers: Dict[str, Set[Optional[str]]] = {n: set() for n in funcs}

    def record(caller: Optional[str], fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name in callers:
                    callers[name].add(caller)

    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            record(node.name, node)
        elif isinstance(node, ast.ClassDef):
            record(None, node)

    graph_time = set(compiled)
    changed = True
    while changed:
        changed = False
        for name in funcs:
            if name in graph_time:
                continue
            cs = callers[name]
            if cs and all(c is not None and c in graph_time for c in cs):
                graph_time.add(name)
                changed = True
    return graph_time


class _FunctionLint(ast.NodeVisitor):
    """Taint + sink walk of one function body."""

    def __init__(self, module: str, path: str, fn: ast.FunctionDef,
                 pragmas: Pragmas, trace_time: bool):
        self.module = module
        self.path = path
        self.fn = fn
        self.pragmas = pragmas
        self.trace_time = trace_time
        self.findings: List[Finding] = []
        self.tainted: Set[str] = {
            a.arg for a in (
                list(fn.args.posonlyargs) + list(fn.args.args)
                + list(fn.args.kwonlyargs)
            )
            if a.arg in DEVICE_PARAM_NAMES
        }
        self.loop_depth = 0
        self._stmt_stack: List[ast.stmt] = []

    # -- taint ---------------------------------------------------------------

    def _is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _METADATA_ATTRS:
                return False
            if node.attr.startswith("d_") or node.attr in DEVICE_ANY_ATTRS:
                return True
            base = _dotted(node.value)
            if base == "self":
                return node.attr in DEVICE_SELF_ATTRS.get(
                    self.module, set()
                )
            return self._is_tainted(node.value)
        if isinstance(node, ast.Call):
            return self._call_returns_device(node)
        if isinstance(node, ast.Subscript):
            return self._is_tainted(node.value)
        if self._identity_test(node):
            return False    # ``x is None``: a host bool
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare,
                             ast.UnaryOp, ast.IfExp, ast.Starred,
                             ast.Tuple, ast.List)):
            return any(
                self._is_tainted(c) for c in ast.iter_child_nodes(node)
                if isinstance(c, ast.expr)
            )
        return False

    def _call_returns_device(self, call: ast.Call) -> bool:
        name = _dotted(call.func) or ""
        head, _, rest = name.partition(".")
        leaf = name.rsplit(".", 1)[-1]
        if name == "getattr" and call.args and self._is_tainted(
            call.args[0]
        ):
            return True
        if head == "torch":
            if rest.startswith(("cuda.", "distributed.", "backends.",
                                "profiler.", "utils.", "testing.")):
                return False
            return leaf not in _HOST_TORCH and not _names_cpu(call)
        if head == "F":    # torch.nn.functional on device inputs
            return any(self._is_tainted(a) for a in call.args)
        if leaf in DEVICE_RETURNING:
            return True
        if isinstance(call.func, ast.Attribute):
            if call.func.attr in _FETCH_METHODS | _METADATA_ATTRS:
                return False    # host data: a fetch's result, metadata
            # method chains on device values (x.float(), x[i].clone())
            return self._is_tainted(call.func.value)
        return False

    # -- findings ------------------------------------------------------------

    def _spans(self, node: ast.AST) -> Tuple[Tuple[int, int], ...]:
        spans = [node_span(node), def_line_span(self.fn)]
        if self._stmt_stack:
            spans.append(node_span(self._stmt_stack[-1]))
        return tuple(spans)

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        if self.pragmas.allows(rule, *self._spans(node)):
            return
        self.findings.append(Finding(
            checker=CHECKER, rule=rule, path=self.path,
            line=getattr(node, "lineno", 0), message=message,
            sanctionable=True,
        ))

    # -- visitors ------------------------------------------------------------

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
        # nested defs are linted separately (fresh scope)

    visit_AsyncFunctionDef = visit_FunctionDef

    @staticmethod
    def _target_names(target: ast.AST) -> List[str]:
        """Plain-Name assignment targets only: ``pf.d_off = ...`` must
        not taint ``pf`` itself."""
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, (ast.Tuple, ast.List)):
            out: List[str] = []
            for elt in target.elts:
                out.extend(_FunctionLint._target_names(elt))
            return out
        if isinstance(target, ast.Starred):
            return _FunctionLint._target_names(target.value)
        return []

    def visit_Assign(self, node: ast.Assign):
        self.generic_visit(node)
        tainted = self._is_tainted(node.value)
        for target in node.targets:
            for name in self._target_names(target):
                if tainted:
                    self.tainted.add(name)
                else:
                    self.tainted.discard(name)

    def visit_AugAssign(self, node: ast.AugAssign):
        self.generic_visit(node)
        if isinstance(node.target, ast.Name) and self._is_tainted(
            node.value
        ):
            self.tainted.add(node.target.id)

    def visit_For(self, node: ast.For):
        self.loop_depth += 1
        try:
            self.generic_visit(node)
        finally:
            self.loop_depth -= 1

    @staticmethod
    def _identity_test(test: ast.AST) -> bool:
        """``x is None`` / ``x is not None`` never call ``__bool__`` on
        the operand -- host-safe even on a device value."""
        return isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        )

    def visit_While(self, node: ast.While):
        if not self._identity_test(node.test) and self._is_tainted(
            node.test
        ):
            self._flag(
                node.test, "device-flow",
                "while-loop condition evaluates a device tensor on the "
                "host (an implicit sync)",
            )
        self.loop_depth += 1
        try:
            self.generic_visit(node)
        finally:
            self.loop_depth -= 1

    def visit_If(self, node: ast.If):
        if not self._identity_test(node.test) and self._is_tainted(
            node.test
        ):
            self._flag(
                node.test, "device-flow",
                "branch condition evaluates a device tensor on the host "
                "(an implicit sync)",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        name = _dotted(node.func) or ""
        head, _, rest = name.partition(".")
        method = (node.func.attr if isinstance(node.func, ast.Attribute)
                  else None)

        # Unconditional syncs: the device, an event or a stream.
        if name == "torch.cuda.synchronize" or (
            method == "synchronize" and name != "torch.cuda.synchronize"
        ):
            self._flag(
                node, "host-fetch",
                f"{name or 'synchronize'}() is an unconditional device "
                "sync",
            )
            return
        # np.asarray / np.array of a device tensor.
        if head in ("np", "numpy") and rest in _FETCH_NP_FUNCS:
            if any(self._is_tainted(a) for a in node.args):
                self._flag(
                    node, "host-fetch",
                    f"np.{rest}() of a device tensor is a blocking "
                    "device->host fetch",
                )
            return
        # float()/int()/bool() of a device tensor.
        if name in _FETCH_BUILTINS and node.args and self._is_tainted(
            node.args[0]
        ):
            self._flag(
                node, "host-fetch",
                f"{name}() of a device tensor is a blocking scalar "
                "device->host fetch",
            )
            return
        # .item() / .tolist() / .numpy() / .cpu() of a device tensor.
        if method in _FETCH_METHODS and self._is_tainted(node.func.value):
            self._flag(
                node, "host-fetch",
                f".{method}() of a device tensor is a blocking "
                "device->host fetch",
            )
            return
        # A tensor built on the device inside a host loop.
        if self.loop_depth == 0 or self.trace_time:
            return
        upload = (
            (head == "torch" and rest in _UPLOAD_TORCH_FUNCS
             and not _names_cpu(node))
            or method == "cuda"
            or (method == "to" and not self._is_tainted(node.func.value)
                and (any(_is_device_arg(a) for a in node.args)
                     or _kw(node, "device") is not None))
        )
        if upload:
            self._flag(
                node, "host-upload",
                f"{name or method}() inside a loop is a per-iteration "
                "host->device upload",
            )


class HostBoundaryChecker:
    """Run the lint over source text / the audited package modules."""

    def check_source(self, path: str, source: str,
                     module: Optional[str] = None) -> List[Finding]:
        module = module or path.rsplit("/", 1)[-1].replace(".py", "")
        tree, findings = parse_module(path, source, CHECKER)
        if tree is None:
            return findings
        pragmas = Pragmas.scan(source)
        findings.extend(pragma_findings(path, pragmas, CHECKER))
        trace_time = _trace_time_functions(
            tree, set(compiled_decorations(tree)))

        def lint_fn(fn: ast.FunctionDef, in_class: bool) -> None:
            is_trace = (not in_class) and fn.name in trace_time
            # Pass 1 computes the function's final taint set (so taint
            # assigned late in a loop body still covers early sinks on
            # the next iteration); pass 2 reports with it pre-seeded.
            seed = _FunctionLint(
                module, path, fn, pragmas, trace_time=is_trace
            )
            seed.visit(fn)
            walker = _FunctionLint(
                module, path, fn, pragmas, trace_time=is_trace
            )
            walker.tainted |= seed.tainted
            walker.visit(fn)
            findings.extend(walker.findings)

        def lint_tree(fn: ast.FunctionDef, in_class: bool) -> None:
            lint_fn(fn, in_class)
            # Nested defs (closures, handler classes defined inside
            # methods) get their own fresh scope -- host-side always.
            for sub in ast.walk(fn):
                if sub is not fn and isinstance(sub, ast.FunctionDef):
                    lint_fn(sub, in_class=True)

        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                lint_tree(node, in_class=False)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        lint_tree(sub, in_class=True)
        return findings

    def check_package(
        self, modules: Sequence[str] = AUDITED_MODULES
    ) -> List[Finding]:
        out: List[Finding] = []
        for path, source in iter_package_sources(only=modules):
            out.extend(self.check_source(path, source))
        return out
