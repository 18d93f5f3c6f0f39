"""Diagnostic model for the repro_torch static verifier.

One :class:`Diagnostic` per finding, carrying a stable ``RPR0xx`` code so
call sites can suppress (and CI can grep) without matching message prose.
The code space is partitioned by layer:

  * ``RPR0xx`` — AST lint passes over source trees (no imports executed),
  * ``RPR1xx`` — backend-registry contract checks (the dispatch tables),
  * ``RPR2xx`` — config/artifact contract checks (tuning caches, shipped
    control trees, ``BENCH_*.json`` schemas).

Suppression is inline and reasoned::

    risky_line()  # repro_torch: noqa=RPR001 -- twin trainer reads the old state by design

A suppression names its code(s) and must carry a ``-- reason``; one with
no reason is itself reported (``RPR000``) so unexplained escapes cannot
accumulate.  A suppression comment applies to
the physical lines its statement spans (multi-line calls may carry it on
any of their lines).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Iterable, Optional

# code -> one-line invariant description (the catalogue DESIGN.md §8 mirrors).
CODES: dict[str, str] = {
    "RPR000": "suppression without a reason (`# repro_torch: noqa=CODE -- why`)",
    "RPR001": "read-after-update: value read after being passed in a position "
              "a state updater writes in place (it now holds the new state)",
    "RPR002": "in-place pin: a copy (np.asarray, .numpy(), .cpu(), .clone()) "
              "flows into an updated-in-place position (the update lands on it)",
    "RPR003": "torch.compile / torch.jit / kernel library load inside a loop "
              "body (per-iteration rebuild/recompile hazard)",
    "RPR004": "raw ContextVar.set without token-reset-in-finally outside the "
              "blessed helpers (execution.py / trace.py discipline)",
    "RPR005": "backend-name or scheduling-objective string literal outside "
              "the live vocabulary (execution.BACKENDS / schedule.OBJECTIVES "
              "drift)",
    "RPR006": "fault-point name string literal outside the live injection "
              "registry (runtime.faults.FAULT_POINTS drift)",
    "RPR101": "backend-registry closure violation (BACKENDS / BACKEND_OPS / "
              "PLAIN_TWIN / LEAN_VARIANTS)",
    "RPR102": "kernel-family closure violation (GEMM_KERNELS / paged-attn "
              "family not closed under align_backend_family)",
    "RPR201": "block-config contract violation (shared memory under the "
              "kernel's stage model, compiled tile, padded-problem "
              "bound, shared-bk constraint)",
    "RPR202": "bench artifact schema violation (BENCH_*.json meta/records)",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code + location + human message."""

    code: str
    path: str
    line: int
    message: str
    col: int = 0

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")

    def key(self) -> tuple:
        return (self.path, self.line, self.col, self.code, self.message)


# ``# repro_torch: noqa=RPR001 -- why`` / ``# repro_torch: noqa=RPR001,RPR002 -- why``
_NOQA_RE = re.compile(
    r"#\s*repro_torch:\s*noqa\s*=\s*(?P<codes>RPR\d{3}(?:\s*,\s*RPR\d{3})*)"
    r"(?:\s*--\s*(?P<reason>.*\S))?"
)


@dataclasses.dataclass
class Suppressions:
    """Per-file map of line -> suppressed codes, parsed from comments."""

    by_line: dict[int, frozenset[str]]
    missing_reason: list[int]  # lines with a noqa but no `-- reason`

    @classmethod
    def scan(cls, source: str) -> "Suppressions":
        by_line: dict[int, frozenset[str]] = {}
        missing: list[int] = []
        for i, text in enumerate(source.splitlines(), start=1):
            m = _NOQA_RE.search(text)
            if not m:
                continue
            codes = frozenset(c.strip() for c in m.group("codes").split(","))
            by_line[i] = by_line.get(i, frozenset()) | codes
            if not m.group("reason"):
                missing.append(i)
        return cls(by_line=by_line, missing_reason=missing)

    def covers(self, code: str, lines: Iterable[int]) -> bool:
        return any(code in self.by_line.get(ln, ()) for ln in lines)


def apply_suppressions(
    path: str, source: str, diags: list[Diagnostic]
) -> list[Diagnostic]:
    """Drop suppressed findings; report reason-less noqa comments."""

    supp = Suppressions.scan(source)
    lines = source.splitlines()
    out = []
    for d in diags:
        span = _statement_span(lines, d.line)
        if not supp.covers(d.code, span):
            out.append(d)
    for ln in supp.missing_reason:
        out.append(
            Diagnostic(
                code="RPR000",
                path=path,
                line=ln,
                message="suppression must explain itself: "
                        "`# repro_torch: noqa=CODE -- reason`",
            )
        )
    return out


def _statement_span(lines: list[str], lineno: int, reach: int = 8) -> range:
    """Physical lines a finding's suppression may sit on.

    A multi-line statement (call spanning several lines) may carry the
    noqa on any of its continuation lines; without a full parse we accept
    a bounded look-ahead from the flagged line through lines that are
    clearly continuations (deeper indent / closing brackets), capped at
    ``reach`` lines.
    """

    if lineno < 1 or lineno > len(lines):
        return range(lineno, lineno + 1)
    end = lineno
    base_indent = len(lines[lineno - 1]) - len(lines[lineno - 1].lstrip())
    for ln in range(lineno + 1, min(lineno + reach, len(lines)) + 1):
        text = lines[ln - 1]
        stripped = text.strip()
        if not stripped:
            break
        indent = len(text) - len(text.lstrip())
        if indent > base_indent or stripped[0] in ")]}":
            end = ln
        else:
            break
    return range(lineno, end + 1)


# ---------------------------------------------------------------------------
# Output formats
# ---------------------------------------------------------------------------


def format_text(diags: list[Diagnostic]) -> str:
    return "\n".join(
        f"{d.path}:{d.line}:{d.col}: {d.code} {d.message}" for d in diags
    )


def format_github(diags: list[Diagnostic]) -> str:
    """GitHub Actions workflow-command annotations (render on the PR diff)."""

    out = []
    for d in diags:
        msg = f"{d.code} {d.message}".replace("%", "%25").replace(
            "\n", "%0A"
        )
        out.append(
            f"::error file={d.path},line={d.line},col={max(d.col, 1)},"
            f"title={d.code}::{msg}"
        )
    return "\n".join(out)


def format_json(diags: list[Diagnostic]) -> str:
    return json.dumps(
        {
            "version": 1,
            "codes": CODES,
            "diagnostics": [dataclasses.asdict(d) for d in diags],
        },
        indent=1,
        sort_keys=True,
    )


FORMATTERS = {"text": format_text, "github": format_github, "json": format_json}


def render(diags: list[Diagnostic], fmt: str) -> str:
    try:
        formatter = FORMATTERS[fmt]
    except KeyError:
        raise ValueError(
            f"unknown format {fmt!r}; known: {sorted(FORMATTERS)}"
        ) from None
    return formatter(sorted(diags, key=Diagnostic.key))


__all__ = [
    "CODES",
    "Diagnostic",
    "Suppressions",
    "apply_suppressions",
    "render",
    "FORMATTERS",
]
