"""``python -m repro_torch.analysis`` — the port's static verifier CLI.

Usage::

    python -m repro_torch.analysis
    python -m repro_torch.analysis --format github src/repro_torch chip_smoke.py
    python -m repro_torch.analysis --format json --no-contracts path/to/corpus

With no paths it scans the port's own files: ``src/repro_torch``, the
``tests/test_torch_*.py`` files and ``chip_smoke.py``.  Run over
``src/repro`` it would rightly flag the reference's backend names
(``"pallas"``): those are not the port's vocabulary.

Two layers run by default:

1. **AST passes** over every ``.py`` file under the given paths
   (donation hazards, loop-jit, ContextVar discipline, backend drift)
   plus the tuning-cache contract on every ``.json`` under the paths
   that parses as a cache file.
2. **Contract checks** (``--no-contracts`` skips them): the backend
   registry closure, the shipped control-tree family, and the
   ``BENCH_*.json`` schema under ``--artifacts`` (default
   ``artifacts/bench`` when it exists).

Exit status is the number of findings clamped to 1 — a clean tree exits
0, anything else fails CI.  Directories named ``fixtures`` are skipped
during recursive discovery (the test corpus is *supposed* to be dirty)
but analyzed when named explicitly on the command line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from repro_torch.analysis import ast_checks, configcheck, registry
from repro_torch.analysis.diagnostics import (
    CODES,
    Diagnostic,
    apply_suppressions,
    render,
)

_SKIP_DIRS = frozenset(
    {"fixtures", "__pycache__", ".git", ".venv", "node_modules"}
)


def build_vocabulary() -> frozenset[str]:
    """The backend-token vocabulary, keyed off the live registries."""

    from repro_torch.core.execution import backend_vocabulary
    from repro_torch.tuning.measure import MEASURE_BACKEND_NAMES

    return frozenset(backend_vocabulary()) | frozenset(MEASURE_BACKEND_NAMES)


def build_objectives() -> frozenset[str]:
    """The scheduling-objective vocabulary, keyed off the live tuple.

    Sourced from ``repro_torch.core.schedule.OBJECTIVES`` so the drift check
    can never disagree with what ``validate_objective`` accepts.
    """

    from repro_torch.core.schedule import OBJECTIVES

    return frozenset(OBJECTIVES)


def build_fault_points() -> frozenset[str]:
    """The fault-injection point vocabulary, keyed off the live registry.

    Sourced from ``repro_torch.runtime.faults.FAULT_POINTS`` so the drift check
    can never disagree with what ``validate_point`` accepts.
    """

    from repro_torch.runtime.faults import FAULT_POINTS

    return frozenset(FAULT_POINTS)


def default_paths(root: str = ".") -> list[str]:
    """The port's own files under ``root``: ``src/repro_torch``, the
    ``tests/test_torch_*.py`` files and ``chip_smoke.py``, those present."""

    out = [os.path.join(root, "src", "repro_torch")]
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        out += [
            os.path.join(tests, f) for f in sorted(os.listdir(tests))
            if f.startswith("test_torch_") and f.endswith(".py")
        ]
    out.append(os.path.join(root, "chip_smoke.py"))
    return [p for p in out if os.path.exists(p)]


def discover(paths: list[str]) -> tuple[list[str], list[str]]:
    """(.py files, .json files) under the given paths, fixtures pruned."""

    py: list[str] = []
    js: list[str] = []
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                py.append(path)
            elif path.endswith(".json"):
                js.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
            for fname in sorted(files):
                full = os.path.join(root, fname)
                if fname.endswith(".py"):
                    py.append(full)
                elif fname.endswith(".json"):
                    js.append(full)
    return py, js


def analyze_file(
    path: str,
    vocabulary: Optional[frozenset[str]] = None,
    objectives: Optional[frozenset[str]] = None,
    fault_points: Optional[frozenset[str]] = None,
) -> list[Diagnostic]:
    """All applicable AST passes + suppressions for one Python file."""

    if vocabulary is None:
        vocabulary = build_vocabulary()
    if objectives is None:
        objectives = build_objectives()
    if fault_points is None:
        fault_points = build_fault_points()
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        diags = ast_checks.run_ast_checks(
            path, source, vocabulary, objectives, fault_points
        )
    except SyntaxError as e:
        # Not our diagnostic to own: surface as a hard error.
        raise SystemExit(f"{path}: cannot parse: {e}") from e
    return apply_suppressions(path, source, diags)


def analyze_paths(
    paths: list[str],
    *,
    contracts: bool = True,
    artifacts: Optional[str] = None,
    vocabulary: Optional[frozenset[str]] = None,
    objectives: Optional[frozenset[str]] = None,
    fault_points: Optional[frozenset[str]] = None,
) -> list[Diagnostic]:
    """The full analyzer: AST passes over ``paths`` + contract checks."""

    if vocabulary is None:
        vocabulary = build_vocabulary()
    if objectives is None:
        objectives = build_objectives()
    if fault_points is None:
        fault_points = build_fault_points()
    diags: list[Diagnostic] = []
    py_files, json_files = discover(paths)
    for path in py_files:
        diags.extend(analyze_file(path, vocabulary, objectives, fault_points))
    for path in json_files:
        diags.extend(configcheck.check_tuning_cache_file(path))
    if contracts:
        diags.extend(registry.check_registry())
        diags.extend(configcheck.check_shipped_trees())
        if artifacts is None and os.path.isdir(
            os.path.join("artifacts", "bench")
        ):
            artifacts = os.path.join("artifacts", "bench")
        if artifacts:
            diags.extend(configcheck.check_artifacts_dir(artifacts))
    return diags


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verifier for the port's in-place state, "
                    "backend-registry, shared-memory and context-discipline "
                    "invariants.",
    )
    ap.add_argument(
        "paths", nargs="*", default=None,
        help="files/directories to lint (default: src/repro_torch, "
             "tests/test_torch_*.py, chip_smoke.py)",
    )
    ap.add_argument(
        "--format", choices=("text", "github", "json"), default="text",
        help="diagnostic output format (github = PR annotations)",
    )
    ap.add_argument(
        "--no-contracts", action="store_true",
        help="skip the registry/tree/artifact contract checks (AST only)",
    )
    ap.add_argument(
        "--artifacts", default=None, metavar="DIR",
        help="bench-artifact dir for the BENCH_*.json schema check "
             "(default: artifacts/bench when present)",
    )
    ap.add_argument(
        "--list-codes", action="store_true",
        help="print the diagnostic catalogue and exit",
    )
    args = ap.parse_args(argv)

    if args.list_codes:
        print(json.dumps(CODES, indent=1, sort_keys=True))
        return 0

    if not args.paths:
        args.paths = default_paths()
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such path(s): {missing}", file=sys.stderr)
        return 2

    diags = analyze_paths(
        args.paths,
        contracts=not args.no_contracts,
        artifacts=args.artifacts,
    )
    out = render(diags, args.format)
    if out:
        print(out)
    if args.format != "json":
        print(
            f"repro_torch.analysis: {len(diags)} finding(s)"
            if diags else "repro_torch.analysis: clean",
            file=sys.stderr,
        )
    return 1 if diags else 0


if __name__ == "__main__":
    raise SystemExit(main())
