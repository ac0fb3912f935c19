"""CLI: ``python -m jax_llama_tpu_torch.analysis`` -- run the invariant
auditor over the port (or explicit files) and exit non-zero on any
finding (port of ``jax_llama_tpu/analysis/__main__.py``, the same flags
and exit codes).

    python -m jax_llama_tpu_torch.analysis                  # every pass
    python -m jax_llama_tpu_torch.analysis --checker host   # one pass
    python -m jax_llama_tpu_torch.analysis --no-trace       # skip the
                                                  # comms budgets (they
                                                  # spawn two ranks)
    python -m jax_llama_tpu_torch.analysis path/to/file.py  # lint files
                                                  # (host + lock only)
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

``--checker lowering``, ``--checker retrace`` and ``--contracts`` are
the JAX package's jaxpr passes, ROADMAP A16 part 3: the port has no
compiled program for them to read until its CUDA graphs (A4), so they
exit 2 and say so.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from .common import Finding, Pragmas, iter_package_sources
from .hostsync import HostBoundaryChecker
from .lockcheck import LockDisciplineChecker

# Pass order is the exit-code order (module docstring).
PASS_CODES = {
    "host-boundary": 10, "lowering": 11, "lock-discipline": 12,
    "retrace": 13, "comms": 14, "schedules": 15, "metrics": 16,
}

_CHECKER_CHOICES = (
    "all", "host", "lowering", "lock", "retrace", "comms",
    "schedules", "metrics",
)

_PART3 = ("is the JAX package's jaxpr pass, ROADMAP A16 part 3: the port "
          "has no compiled program for it to read until its CUDA graphs "
          "(A4)")


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
                    "(host-boundary lint, lock discipline, schedule "
                    "models, metrics registry, comms budgets).",
    )
    parser.add_argument(
        "--checker", choices=_CHECKER_CHOICES, default="all",
    )
    parser.add_argument(
        "--no-trace", action="store_true",
        help="skip the comms budgets, which run the serving programs on "
             "two spawned ranks (the static layers still run)",
    )
    parser.add_argument(
        "--contracts", metavar="MODULE",
        help="the JAX package's external lowering REGISTRY hook: ROADMAP "
             "A16 part 3, not in the port yet",
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
    if args.contracts:
        print(f"--contracts {_PART3}", file=sys.stderr)
        return 2
    if args.checker in ("lowering", "retrace"):
        print(f"--checker {args.checker} {_PART3}", file=sys.stderr)
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
            if args.checker in ("all", "schedules"):
                from . import schedules

                findings.extend(schedules.check_package())
            if args.checker in ("all", "metrics"):
                from . import metricscheck

                findings.extend(metricscheck.check_package())
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
