"""Metrics-registry lint: obs.METRICS <-> emission sites, both ways
(port of ``jax_llama_tpu/analysis/metricscheck.py`` over the port's
registries).

``obs.METRICS`` is the explicit registry, and the exposition prints a
loud UNREGISTERED help line for names that show up at scrape time
without a registration -- a RUNTIME check that only fires for metrics
the exercised configuration actually emits.  This pass closes the loop
statically:

  * **unemitted-metric**: every name registered in ``obs.METRICS``
    must be emitted somewhere in the package -- as an exact string
    constant, or via an f-string whose constant parts match (the
    generated per-site/per-feature families).  A registered name with
    no emission site is dashboard rot: the family renders HELP/TYPE
    never followed by a sample, or nothing at all.
  * **unregistered-metric**: every scalar key the metric PROVIDERS
    build (``ContinuousBatcher.stats``, ``DegradeManager.stats``,
    ``Observability.metrics``, ``OverloadController.stats``,
    ``FaultInjector.stats``, ``LLMServer._metrics_text``'s update
    dict) must be registered -- statically, for every configuration,
    not just the ones the /metrics parse test happens to serve.

String constants inside statements that ASSIGN into ``METRICS`` are
registration, not emission, and are excluded from the evidence.

The ROUTER's exposition (router.py renders ``llm_router_*`` /
``llm_fleet_*`` / ``llm_replica_*`` families itself, outside the
obs.METRICS pipeline, off its own ``ROUTER_METRICS`` registry) gets
the same two-way audit via :func:`check_router_registry` --
``router-unemitted-metric`` / ``router-unregistered-metric`` findings,
run as part of the package pass.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .common import Finding, iter_package_sources, parse_module

CHECKER = "metrics"

# (module basename, class or None, function) whose built dicts are
# rendered into /metrics verbatim -- their keys ARE metric names.
PROVIDERS: Tuple[Tuple[str, Optional[str], str], ...] = (
    ("serving", "ContinuousBatcher", "stats"),
    ("degrade", "DegradeManager", "stats"),
    ("obs", "Observability", "metrics"),
    ("overload", "OverloadController", "stats"),
    ("faults", "FaultInjector", "stats"),
    ("server", "LLMServer", "_metrics_scalars"),
)

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Family names the ROUTER's own exposition mints (full names -- the
# router renders outside the obs.METRICS pipeline, with its own
# ``ROUTER_METRICS`` registry in router.py).
_ROUTER_FAMILY_RE = re.compile(
    r"llm_(?:router|fleet|replica)_[a-z0-9_]+"
)


def _is_metrics_assign(stmt: ast.stmt) -> bool:
    """Does ``stmt`` assign into the METRICS registry?"""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    for t in targets:
        for leaf in ast.walk(t):
            if isinstance(leaf, ast.Name) and leaf.id == "METRICS":
                return True
    return False


def _joined_pattern(node: ast.JoinedStr) -> Optional[re.Pattern]:
    """Regex matching the f-string's constant skeleton, or None when
    the constant parts are too thin to mean anything (< 4 chars)."""
    parts: List[str] = []
    const_len = 0
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(re.escape(v.value))
            const_len += len(v.value)
        else:
            parts.append("[a-z0-9_]+")
    if const_len < 4:
        return None
    return re.compile("^" + "".join(parts) + "$")


def _collect_evidence(
    sources: Sequence[Tuple[str, str]],
) -> Tuple[Set[str], List[re.Pattern]]:
    """(exact string constants, f-string patterns) outside METRICS
    registration statements, package-wide."""
    exact: Set[str] = set()
    patterns: List[re.Pattern] = []
    for path, source in sources:
        tree, _ = parse_module(path, source, CHECKER)
        if tree is None:
            continue
        skip_spans: List[Tuple[int, int]] = []
        for stmt in ast.walk(tree):
            if isinstance(stmt, ast.stmt) and _is_metrics_assign(stmt):
                skip_spans.append(
                    (stmt.lineno, stmt.end_lineno or stmt.lineno)
                )
            # Docstrings DOCUMENT metrics by name (the /metrics schema
            # tables) -- they are not emission evidence; counting them
            # would let a deleted emission hide behind its own docs.
            if isinstance(stmt, (ast.Module, ast.ClassDef,
                                 ast.FunctionDef, ast.AsyncFunctionDef)):
                body = getattr(stmt, "body", [])
                if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant
                ) and isinstance(body[0].value.value, str):
                    doc = body[0]
                    skip_spans.append(
                        (doc.lineno, doc.end_lineno or doc.lineno)
                    )

        def skipped(node: ast.AST) -> bool:
            line = getattr(node, "lineno", 0)
            return any(lo <= line <= hi for lo, hi in skip_spans)

        for node in ast.walk(tree):
            if skipped(node):
                continue
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                exact.add(node.value)
            elif isinstance(node, ast.JoinedStr):
                pat = _joined_pattern(node)
                if pat is not None:
                    patterns.append(pat)
    return exact, patterns


def _provider_keys(
    tree: ast.Module, cls: Optional[str], func: str,
) -> List[Tuple[str, int, bool]]:
    """(key, line, is_template) for every metric-name key the provider
    function builds: dict-literal keys, ``out[...] =`` string
    subscripts, and f-string keys (templates)."""
    fn: Optional[ast.FunctionDef] = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and (
            cls is None or node.name == cls
        ):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and sub.name == func:
                    fn = sub
        elif (
            cls is None and isinstance(node, ast.FunctionDef)
            and node.name == func
        ):
            fn = node
    if fn is None:
        return []
    # Dicts that are elements of a tuple literal are LABEL dicts
    # (("family", {label: value}, v) rows), not metric-name dicts.
    label_dicts: Set[ast.Dict] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Tuple):
            for elt in node.elts:
                if isinstance(elt, ast.Dict):
                    label_dicts.add(elt)
    out: List[Tuple[str, int, bool]] = []
    for node in ast.walk(fn):
        keys: Iterable[ast.AST] = ()
        if isinstance(node, ast.Dict) and node not in label_dicts:
            keys = [k for k in node.keys if k is not None]
        elif isinstance(node, ast.Assign):
            keys = [
                t.slice for t in node.targets
                if isinstance(t, ast.Subscript)
            ]
        for key in keys:
            if isinstance(key, ast.Constant) and isinstance(
                key.value, str
            ):
                if _NAME_RE.match(key.value):
                    out.append((key.value, key.lineno, False))
            elif isinstance(key, ast.JoinedStr):
                pat = _joined_pattern(key)
                if pat is not None:
                    out.append((pat.pattern, key.lineno, True))
    return out


def _is_named_assign(stmt: ast.stmt, name: str) -> bool:
    """Does ``stmt`` assign into the variable ``name``?"""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    for t in targets:
        for leaf in ast.walk(t):
            if isinstance(leaf, ast.Name) and leaf.id == name:
                return True
    return False


def check_router_registry(
    registry: Optional[Dict[str, Tuple[str, str]]] = None,
    source: Optional[str] = None,
    path: str = "jax_llama_tpu_torch/router.py",
) -> List[Finding]:
    """Router-exposition audit: the ReplicaRouter renders its own
    Prometheus text (``llm_router_*`` / ``llm_fleet_*`` /
    ``llm_replica_*`` families) outside the obs.METRICS pipeline,
    driven by the ``ROUTER_METRICS`` registry in router.py -- so it
    gets the same two-way contract:

      * **router-unemitted-metric**: every registered family must be
        emitted in router.py -- a ``fam("name")`` header call or a
        sample-line string mentioning the full name (registry
        assignment and docstrings are not evidence).
      * **router-unregistered-metric**: every family router.py emits
        -- a ``fam()`` first argument, or any family-shaped token
        inside a non-docstring string constant / f-string constant
        part -- must be registered.
    """
    findings: List[Finding] = []
    if registry is None:
        from .. import router

        registry = router.ROUTER_METRICS
    if source is None:
        for p, src in iter_package_sources():
            if p.replace("\\", "/").endswith("/router.py"):
                path, source = p, src
                break
    if source is None:
        return [Finding(
            checker=CHECKER, rule="stale-registry", path=path, line=0,
            message="router.py not found in the audited package",
        )]
    tree, errs = parse_module(path, source, CHECKER)
    findings.extend(errs)
    if tree is None:
        return findings
    skip_spans: List[Tuple[int, int]] = []
    for stmt in ast.walk(tree):
        if isinstance(stmt, ast.stmt) and _is_named_assign(
            stmt, "ROUTER_METRICS"
        ):
            skip_spans.append(
                (stmt.lineno, stmt.end_lineno or stmt.lineno)
            )
        if isinstance(stmt, (ast.Module, ast.ClassDef,
                             ast.FunctionDef, ast.AsyncFunctionDef)):
            body = getattr(stmt, "body", [])
            if body and isinstance(body[0], ast.Expr) and isinstance(
                body[0].value, ast.Constant
            ) and isinstance(body[0].value.value, str):
                doc = body[0]
                skip_spans.append(
                    (doc.lineno, doc.end_lineno or doc.lineno)
                )

    def skipped(node: ast.AST) -> bool:
        line = getattr(node, "lineno", 0)
        return any(lo <= line <= hi for lo, hi in skip_spans)

    emitted: Dict[str, int] = {}  # family -> first evidence line
    fam_args: List[Tuple[str, int]] = []
    for node in ast.walk(tree):
        if skipped(node):
            continue
        texts: List[str] = []
        if isinstance(node, ast.Constant) and isinstance(
            node.value, str
        ):
            texts.append(node.value)
        elif isinstance(node, ast.JoinedStr):
            texts.extend(
                v.value for v in node.values
                if isinstance(v, ast.Constant)
                and isinstance(v.value, str)
            )
        for text in texts:
            for name in _ROUTER_FAMILY_RE.findall(text):
                emitted.setdefault(name, getattr(node, "lineno", 0))
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "fam"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            fam_args.append((node.args[0].value, node.lineno))
            emitted.setdefault(node.args[0].value, node.lineno)
    for name in sorted(registry):
        if name not in emitted:
            findings.append(Finding(
                checker=CHECKER, rule="router-unemitted-metric",
                path=path, line=0,
                message=(
                    f"ROUTER_METRICS registers {name!r} but router.py "
                    "never emits it (no fam() header, no sample line) "
                    "-- dead registration; emit it or delete it"
                ),
            ))
    flagged: set = set()
    for name, line in fam_args:
        if name not in registry and name not in flagged:
            flagged.add(name)
            findings.append(Finding(
                checker=CHECKER, rule="router-unregistered-metric",
                path=path, line=line,
                message=(
                    f"router.py declares family {name!r} via fam() "
                    "but ROUTER_METRICS has no entry -- register "
                    "type + help or the exposition KeyErrors"
                ),
            ))
    for name, line in sorted(emitted.items()):
        if name not in registry and name not in flagged:
            flagged.add(name)
            findings.append(Finding(
                checker=CHECKER, rule="router-unregistered-metric",
                path=path, line=line,
                message=(
                    f"router.py emits family {name!r} (sample-line "
                    "string) with no ROUTER_METRICS entry -- it "
                    "renders without HELP/TYPE; register it"
                ),
            ))
    return findings


def check_package(
    registry: Optional[Dict[str, Tuple[str, str]]] = None,
    sources: Optional[Sequence[Tuple[str, str]]] = None,
    providers: Tuple[Tuple[str, Optional[str], str], ...] = PROVIDERS,
) -> List[Finding]:
    # Package mode (no fixture registry/sources): the router's own
    # registry is audited alongside obs.METRICS.
    package_mode = registry is None and sources is None
    findings: List[Finding] = []
    if registry is None:
        from .. import obs

        registry = obs.METRICS
    if sources is None:
        sources = list(iter_package_sources())
    exact, patterns = _collect_evidence(sources)

    # -- registered -> emitted ----------------------------------------------
    for name in sorted(registry):
        if name in exact:
            continue
        if any(p.match(name) for p in patterns):
            continue
        findings.append(Finding(
            checker=CHECKER, rule="unemitted-metric",
            path="jax_llama_tpu_torch/obs.py", line=0,
            message=(
                f"obs.METRICS registers {name!r} but nothing in the "
                "package emits it (no exact string constant, no "
                "matching f-string) -- dead registration; emit it or "
                "delete it"
            ),
        ))

    # -- emitted -> registered ----------------------------------------------
    by_module: Dict[str, Tuple[str, ast.Module]] = {}
    for path, source in sources:
        modname = path.rsplit("/", 1)[-1][:-3]
        tree, errs = parse_module(path, source, CHECKER)
        findings.extend(errs)
        if tree is not None:
            by_module[modname] = (path, tree)
    registered = set(registry)
    for modname, cls, func in providers:
        if modname not in by_module:
            findings.append(Finding(
                checker=CHECKER, rule="stale-registry",
                path=f"jax_llama_tpu_torch/{modname}.py", line=0,
                message=(
                    f"metrics PROVIDERS names module {modname!r} which "
                    "is not in the audited package"
                ),
            ))
            continue
        path, tree = by_module[modname]
        keys = _provider_keys(tree, cls, func)
        if not keys:
            findings.append(Finding(
                checker=CHECKER, rule="stale-registry",
                path=path, line=0,
                message=(
                    f"metrics PROVIDERS names {cls or modname}.{func} "
                    "but no dict keys were found there -- provider "
                    "moved or renamed; update PROVIDERS"
                ),
            ))
            continue
        for key, line, is_template in keys:
            if is_template:
                pat = re.compile(key)
                if any(pat.match(r) for r in registered):
                    continue
                findings.append(Finding(
                    checker=CHECKER, rule="unregistered-metric",
                    path=path, line=line,
                    message=(
                        f"{cls or modname}.{func} emits templated "
                        f"metric {key!r} matching no registered name "
                        "-- add the family to obs.METRICS"
                    ),
                ))
            elif key not in registered:
                findings.append(Finding(
                    checker=CHECKER, rule="unregistered-metric",
                    path=path, line=line,
                    message=(
                        f"{cls or modname}.{func} emits {key!r} which "
                        "is not registered in obs.METRICS -- the "
                        "exposition will render the loud UNREGISTERED "
                        "help line; register type + help"
                    ),
                ))

    # -- router exposition (its own registry, both directions) ---------------
    if package_mode:
        findings.extend(check_router_registry())
    return findings
