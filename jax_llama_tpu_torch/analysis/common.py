"""Shared core of the invariant auditor (port of
``jax_llama_tpu/analysis/common.py``): findings, pragmas, sources.

Every checker reports :class:`Finding` records and honors ``# audit:``
pragmas -- the explicit, greppable allowlist that turns a sanctioned
violation into documentation instead of noise:

    # audit: host-fetch(the one packed fetch per chunk)
    # audit: host-upload(admission-time prompt upload, not per-token)
    # audit: device-flow(static eligibility flag, not a device value)
    # audit: locked(called under self._lock by every public method)
    # audit: racy-read(snapshot gauge; single-writer loop, GIL-atomic)
    # audit: unguarded(single-writer: watchdog thread only)

A pragma suppresses findings of its kind on the STATEMENT it annotates
(any line of a multi-line statement works) -- or on the whole function
when placed on its ``def`` line.  The reason is mandatory: a bare
``# audit: host-fetch`` does not parse and the crossing stays flagged.
An unknown pragma kind is itself a finding (typo defense -- a
misspelled allowlist entry must not silently sanction anything).  The
grammar is the JAX package's, unchanged.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# Pragma kinds, by checker:
#   host-fetch / host-upload / device-flow  -> hostsync.py
#   locked / racy-read / unguarded          -> lockcheck.py
#   trace-domain                            -> retrace.py
PRAGMA_KINDS = frozenset({
    "host-fetch", "host-upload", "device-flow",
    "locked", "racy-read", "unguarded",
    "trace-domain",
})

_PRAGMA_OPEN_RE = re.compile(r"#\s*audit:\s*([A-Za-z-]+)\s*\((.*)$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation (or registry inconsistency)."""

    checker: str    # "host-boundary" | "lock-discipline" | "comms"
                    # | "schedules" | "metrics"
    rule: str       # short kebab-case rule id, e.g. "host-fetch"
    path: str       # repo-relative or synthetic module path
    line: int       # 1-based line of the offending node (0 = module)
    message: str
    # "error" findings gate lint-invariants; "warn" is reserved for
    # advisory output (--report surfaces), never emitted by the gating
    # passes today.  Machine consumers read it from --json.
    severity: str = "error"
    # Whether a pragma of the sanctioning kind could suppress this
    # finding (the --json "pragma" field: tooling distinguishes
    # annotate-to-sanction findings from hard structural ones).
    sanctionable: bool = False

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.checker}/{self.rule}] "
            f"{self.message}"
        )


class Pragmas:
    """``# audit:`` pragmas of one source file, indexed by line."""

    def __init__(self, by_line: Dict[int, List[Tuple[str, str]]],
                 bad_lines: List[Tuple[int, str]],
                 records: Optional[List[Tuple[int, str, str]]] = None):
        self._by_line = by_line
        self.bad_lines = bad_lines  # [(line, raw kind)] unknown kinds
        # One (first_line, kind, reason) per pragma — the --report
        # surface (by_line duplicates multi-line pragmas per line).
        self.records = records if records is not None else []

    @classmethod
    def scan(cls, source: str) -> "Pragmas":
        """Collect pragmas.  A reason may wrap across CONSECUTIVE
        comment lines (``# audit: kind(start of reason`` ... ``# end)``);
        the pragma then covers every line it spans."""
        by_line: Dict[int, List[Tuple[str, str]]] = {}
        bad: List[Tuple[int, str]] = []
        records: List[Tuple[int, str, str]] = []

        def record(kind: str, reason: str, lines: List[int]) -> None:
            reason = reason.strip()
            if kind not in PRAGMA_KINDS or not reason:
                bad.append((lines[0], kind))
                return
            records.append((lines[0], kind, reason))
            for line in lines:
                by_line.setdefault(line, []).append((kind, reason))

        open_kind: Optional[str] = None
        open_reason = ""
        open_lines: List[int] = []
        try:
            toks = tokenize.generate_tokens(io.StringIO(source).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    if tok.type in (tokenize.NL, tokenize.NEWLINE,
                                    tokenize.INDENT, tokenize.DEDENT):
                        continue
                    if open_kind is not None:
                        # real code interrupted an unclosed pragma
                        bad.append((open_lines[0], open_kind))
                        open_kind = None
                    continue
                text = tok.string
                if open_kind is not None:
                    open_lines.append(tok.start[0])
                    body = text.lstrip("#").strip()
                    if body.endswith(")"):
                        record(open_kind, open_reason + " " + body[:-1],
                               open_lines)
                        open_kind = None
                    else:
                        open_reason += " " + body
                    continue
                m = _PRAGMA_OPEN_RE.search(text)
                if m is None:
                    if "audit:" in text:
                        bad.append((tok.start[0], text.strip()))
                    continue
                kind, rest = m.group(1), m.group(2)
                if rest.rstrip().endswith(")"):
                    record(kind, rest.rstrip()[:-1], [tok.start[0]])
                else:
                    open_kind, open_reason = kind, rest
                    open_lines = [tok.start[0]]
            if open_kind is not None:
                bad.append((open_lines[0], open_kind))
        except tokenize.TokenError:
            pass  # syntactically broken file: the AST parse reports it
        return cls(by_line, bad, records)

    def kinds_in_span(self, lo: int, hi: int) -> Set[str]:
        out: Set[str] = set()
        for line in range(lo, hi + 1):
            for kind, _ in self._by_line.get(line, ()):
                out.add(kind)
        return out

    def allows(self, kind: str, *spans: Tuple[int, int]) -> bool:
        """Is a ``kind`` pragma present on any of the line spans?  A
        span includes the line directly above it, so a pragma on its
        own comment line annotates the statement that follows."""
        for lo, hi in spans:
            if kind in self.kinds_in_span(max(1, lo - 1), hi):
                return True
        return False


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_compile_name(name: str) -> bool:
    # ``torch.compile``, ``torch.jit.script`` / ``torch.jit.trace``, or
    # a bare ``compile`` / ``script`` alias of them.
    return name in ("compile", "script") or name.endswith(
        ("torch.compile", "jit.script", "jit.trace"))


def compiled_decorations(
    tree: ast.Module,
) -> Dict[str, Tuple[ast.FunctionDef, Optional[ast.Call]]]:
    """Module-level defs that run only inside a compiled graph: wrapped
    in ``torch.compile`` / ``torch.jit.script`` -- directly, via
    ``functools.partial(torch.compile, ...)``, or through an alias -- as
    ``{name: (fn, decorator Call or None for a bare decorator)}`` (the
    port's counterpart of the JAX package's ``jit_decorations``; the
    port's serving programs are eager today, ROADMAP A4)."""
    out: Dict[str, Tuple[ast.FunctionDef, Optional[ast.Call]]] = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = dotted_name(target) or ""
            if _is_compile_name(name):
                out[node.name] = (
                    node, dec if isinstance(dec, ast.Call) else None
                )
            elif isinstance(dec, ast.Call) and name.endswith("partial"):
                if any(
                    _is_compile_name(dotted_name(a) or "")
                    for a in dec.args
                ):
                    out[node.name] = (node, dec)
    return out


def program_decorations(
    tree: ast.Module,
) -> Dict[str, Tuple[ast.FunctionDef, ast.Call]]:
    """Module-level defs decorated with ``program("<name>", ...)``
    (``utils.programs``, the port's counterpart of ``jax.jit``), as
    ``{program name: (fn, decorator Call)}``: the counterpart of the JAX
    package's ``jit_decorations``."""
    out: Dict[str, Tuple[ast.FunctionDef, ast.Call]] = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            name = dotted_name(dec.func) or ""
            if (name.rsplit(".", 1)[-1] == "program" and dec.args
                    and isinstance(dec.args[0], ast.Constant)
                    and isinstance(dec.args[0].value, str)):
                out[dec.args[0].value] = (node, dec)
    return out


def node_span(node: ast.AST) -> Tuple[int, int]:
    lo = getattr(node, "lineno", 0)
    hi = getattr(node, "end_lineno", lo) or lo
    return lo, hi


def def_line_span(fn: ast.AST) -> Tuple[int, int]:
    """The ``def`` line (after decorators) of a FunctionDef — a pragma
    there covers the whole function body for its kind."""
    lo = getattr(fn, "lineno", 0)
    return lo, lo


def package_root() -> str:
    """Directory of the ``jax_llama_tpu_torch`` package this module
    lives in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_package_sources(
    root: Optional[str] = None,
    only: Optional[Sequence[str]] = None,
) -> Iterable[Tuple[str, str]]:
    """Yield ``(path, source)`` for package modules.

    ``only`` restricts to module basenames (no ``.py``); default is
    every ``.py`` file under the package (analysis/ itself included —
    the auditor holds its own code to its rules).
    """
    root = root or package_root()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__"
        )
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            if only is not None and fname[:-3] not in only:
                continue
            path = os.path.join(dirpath, fname)
            with open(path, "r", encoding="utf-8") as f:
                yield path, f.read()


def parse_module(
    path: str, source: str, checker: str
) -> Tuple[Optional[ast.Module], List[Finding]]:
    """Parse ``source``; a syntax error becomes a finding, not a crash."""
    try:
        return ast.parse(source), []
    except SyntaxError as e:
        return None, [Finding(
            checker=checker, rule="syntax-error", path=path,
            line=e.lineno or 0, message=f"unparseable module: {e.msg}",
        )]


def pragma_findings(path: str, pragmas: Pragmas,
                    checker: str) -> List[Finding]:
    """Unknown/malformed pragmas are findings (typo defense)."""
    return [
        Finding(
            checker=checker, rule="bad-pragma", path=path, line=line,
            message=(
                f"unrecognized audit pragma {raw!r}: known kinds are "
                f"{sorted(PRAGMA_KINDS)} and a (reason) is mandatory"
            ),
        )
        for line, raw in pragmas.bad_lines
    ]
