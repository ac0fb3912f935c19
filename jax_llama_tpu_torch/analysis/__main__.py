"""CLI: ``python -m jax_llama_tpu_torch.analysis`` -- run the invariant
auditor over the port (or explicit files) and exit non-zero on any
finding (port of ``jax_llama_tpu/analysis/__main__.py``, the same flags
and exit codes).

    python -m jax_llama_tpu_torch.analysis                  # every pass
    python -m jax_llama_tpu_torch.analysis --checker host   # one pass
    python -m jax_llama_tpu_torch.analysis --no-trace       # skip the
                                                  # layers that run
                                                  # programs (lowering's
                                                  # recorded runs, the
                                                  # retrace drill, the
                                                  # comms budgets)
    python -m jax_llama_tpu_torch.analysis path/to/file.py  # lint files
                                                  # (host + lock only)
    python -m jax_llama_tpu_torch.analysis --contracts pkg.mod
                                                  # audit an external
                                                  # REGISTRY (tests)
    python -m jax_llama_tpu_torch.analysis --json           # findings
                                                  # as JSON, per-pass
                                                  # exit codes
    python -m jax_llama_tpu_torch.analysis --report         # the
                                                  # sanctioned pragma
                                                  # surface + schedule
                                                  # models

Exit codes: 0 clean, 1 findings, 2 usage/internal error.  Under
``--json`` the findings code is per-pass stable instead of 1:

    9  findings in more than one pass
    10 host-boundary   11 lowering   12 lock-discipline
    13 retrace         14 comms      15 schedules        16 metrics

"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import List, Optional, Sequence

from .common import Finding, Pragmas, iter_package_sources
from .hostsync import HostBoundaryChecker
from .lockcheck import LockDisciplineChecker
from .lowering import LoweringAuditor

# Pass order is the exit-code order (module docstring).
PASS_CODES = {
    "host-boundary": 10, "lowering": 11, "lock-discipline": 12,
    "retrace": 13, "comms": 14, "schedules": 15, "metrics": 16,
}

_CHECKER_CHOICES = (
    "all", "host", "lowering", "lock", "retrace", "comms",
    "schedules", "metrics",
)

def _file_findings(paths: Sequence[str], checker: str) -> List[Finding]:
    out: List[Finding] = []
    host, lock = HostBoundaryChecker(), LockDisciplineChecker()
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        if checker in ("all", "host"):
            out.extend(host.check_source(path, source))
        if checker in ("all", "lock"):
            out.extend(lock.check_source(path, source))
    return out


def _report() -> dict:
    """The sanctioned-surface dump: every audit pragma in the package
    with kind, site and reason, plus the schedule models (name, site,
    claim) the cross-thread pragmas resolve to."""
    from .schedules import MODELS, pragma_sites

    pragmas = []
    for path, source in iter_package_sources():
        for line, kind, reason in Pragmas.scan(source).records:
            pragmas.append({
                "path": path, "line": line, "kind": kind,
                "reason": reason,
            })
    sites = {(s.module, s.func) for s in pragma_sites()}
    models = []
    for mk in MODELS:
        m = mk()
        models.append({
            "model": m.name, "site": f"{m.module}.{m.func}",
            "claim": m.claim,
            "pragma_site_exists": (m.module, m.func) in sites,
        })
    by_kind: dict = {}
    for p in pragmas:
        by_kind[p["kind"]] = by_kind.get(p["kind"], 0) + 1
    return {
        "pragmas": sorted(
            pragmas, key=lambda p: (p["kind"], p["path"], p["line"])
        ),
        "pragma_counts": by_kind,
        "schedule_models": models,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m jax_llama_tpu_torch.analysis",
        description="Invariant auditor for the port's serving stack "
                    "(host-boundary lint, lowering contracts, lock "
                    "discipline, retrace domains, comms budgets, schedule "
                    "models, metrics registry).",
    )
    parser.add_argument(
        "--checker", choices=_CHECKER_CHOICES, default="all",
    )
    parser.add_argument(
        "--no-trace", action="store_true",
        help="skip the layers that run programs: the lowering auditor's "
             "recorded runs, the retrace drill and the comms budgets, "
             "which spawn two ranks (the static layers still run)",
    )
    parser.add_argument(
        "--contracts", metavar="MODULE",
        help="import MODULE and audit its REGISTRY instead of the "
             "built-in one (fixture/testing hook)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable findings (checker, rule, path, line, "
             "message, severity, sanctionable) and per-pass stable "
             "exit codes",
    )
    parser.add_argument(
        "--report", action="store_true",
        help="dump the sanctioned surface (every audit pragma with "
             "its reason + the schedule-model table) as JSON and exit 0",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="explicit .py files to lint (host + lock checkers only); "
             "default: the audited package modules",
    )
    args = parser.parse_args(argv)

    if args.report:
        print(json.dumps(_report(), indent=2))
        return 0
    if args.contracts and args.no_trace:
        # An external registry has ONLY the recorded-run layer --
        # static-only would silently audit nothing.
        print(
            "--contracts audits an external registry's programs; "
            "--no-trace would skip the only layer it has",
            file=sys.stderr,
        )
        return 2
    if args.no_trace and args.checker == "comms":
        # The comms pass IS the two-rank run -- "clean" under --no-trace
        # would mean "never ran".
        print(
            "--checker comms has only the two-rank layer; --no-trace "
            "would skip it and report a vacuous clean",
            file=sys.stderr,
        )
        return 2
    if args.contracts and args.checker == "retrace":
        # The retrace static layer audits the PACKAGE's dispatch call
        # sites and the drill is package-batcher-driven: neither can
        # audit an external fixture registry.
        print(
            "--checker retrace audits the package's own call sites "
            "and cache drill; it cannot audit an external --contracts "
            "registry (use --checker lowering/comms with --contracts)",
            file=sys.stderr,
        )
        return 2
    if args.paths and args.checker not in ("all", "host", "lock"):
        # Registry-driven passes audit the package, not source paths --
        # "clean" would mean "never ran".
        print(
            f"--checker {args.checker} audits the package registries "
            "and does not take file paths (use --checker host/lock/"
            "all with paths)",
            file=sys.stderr,
        )
        return 2

    findings: List[Finding] = []
    try:
        if args.paths:
            findings.extend(_file_findings(args.paths, args.checker))
        else:
            if args.checker in ("all", "host"):
                findings.extend(HostBoundaryChecker().check_package())
            if args.checker in ("all", "lock"):
                findings.extend(LockDisciplineChecker().check_package())
            if args.checker in ("all", "retrace"):
                from . import retrace

                findings.extend(retrace.check_static())
                if not args.no_trace and not args.contracts:
                    findings.extend(retrace.check_runtime())
            if args.checker in ("all", "schedules"):
                from . import schedules

                findings.extend(schedules.check_package())
            if args.checker in ("all", "metrics"):
                from . import metricscheck

                findings.extend(metricscheck.check_package())
        if args.checker in ("all", "lowering", "comms") and not args.paths:
            if args.contracts:
                # External registry: audit ITS programs only (the static
                # coverage layer is about the package's own modules).
                registry = importlib.import_module(args.contracts).REGISTRY
                if args.checker in ("all", "lowering"):
                    from .lowering import check_traces

                    findings.extend(check_traces(registry))
                if args.checker in ("all", "comms"):
                    from . import comms

                    findings.extend(comms.check_package({
                        c.function or c.name: c.comms
                        for c in registry.values() if c.comms}))
            else:
                if args.checker in ("all", "lowering"):
                    findings.extend(LoweringAuditor().check_package(
                        trace=not args.no_trace))
                if args.checker in ("all", "comms") and not args.no_trace:
                    from . import comms

                    findings.extend(comms.check_package())
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"analysis failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if args.json:
        print(json.dumps([vars(f) for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        n = len(findings)
        print(
            f"invariant audit: {n} finding{'s' if n != 1 else ''}"
            + ("" if n else " -- clean")
        )
    if not findings:
        return 0
    if args.json:
        passes = {f.checker for f in findings}
        if len(passes) == 1:
            return PASS_CODES.get(passes.pop(), 1)
        return 9
    return 1


if __name__ == "__main__":
    sys.exit(main())
