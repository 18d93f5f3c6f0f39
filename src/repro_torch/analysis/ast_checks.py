"""AST lint passes: rebuild hazards, context discipline, backend drift.

* **RPR003 — a compiled callable built in a loop body.**  The port's
  counterparts of ``jax.jit`` / ``pl.pallas_call``: ``torch.compile``,
  ``torch.jit.script`` / ``torch.jit.trace``, and the kernel library
  loader ``kernels/build.py``'s ``load`` (``build.load``).  Each builds
  (or looks up and re-binds) a compiled callable; building one per loop
  iteration recompiles or re-resolves every pass.  Flagged when the call
  sits syntactically inside a ``for``/``while`` of the same function
  scope (a nested ``def`` resets the scope).

* **RPR004 — raw ``ContextVar.set``.**  The port keeps the reference's
  context discipline: every ``ContextVar.set`` is paired with a token
  reset on exit, in a ``finally`` or in the ``__exit__`` of the same
  context-manager class.  ``core/execution.py`` and
  ``observability/trace.py`` hold the port's ContextVars and are exempt
  wholesale (they *are* the helpers); elsewhere the pairing is checked
  structurally.

* **RPR005 — backend-name drift.**  The port has one registry
  (``repro_torch.core.execution.BACKENDS``); this pass flags any
  backend-shaped string literal (a ``backend=`` / ``kernel_backend=`` /
  ``attn_backend=`` keyword, a comparison or ``in`` test against a
  ``*backend``-named expression, a subscript of a registry table:
  ``BACKENDS``, ``BACKEND_OPS``, ``PLAIN_TWIN``, ``LEAN_VARIANTS``,
  ``GEMM_KERNELS``, a positional argument of a registry funnel) whose
  value is outside the vocabulary the caller passes in, which the CLI
  builds from the *live* registries.  The objective arm is the
  reference's rule unchanged, against the port's ``schedule.OBJECTIVES``.

* **RPR006 — fault-point drift**, against the port's
  ``runtime.faults.FAULT_POINTS``: positional string arguments of the
  funnels (``fault_active`` / ``validate_point``), a ``point=`` keyword,
  and string subscripts of ``FAULT_POINTS``.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.donation import dotted_name

# Modules allowed to touch ContextVars rawly: they implement the token
# discipline everything else must inherit via their context managers.
BLESSED_CONTEXTVAR_MODULES = (
    "core/execution.py",
    "observability/trace.py",
)

# Dotted suffixes that mark an expression as backend-valued.
_BACKEND_NAME_HINTS = ("backend", "kernel_backend", "exec_backend")

# Registry-table names whose string subscripts must be vocabulary members.
_REGISTRY_TABLES = frozenset(
    {"BACKENDS", "BACKEND_OPS", "PLAIN_TWIN", "LEAN_VARIANTS",
     "GEMM_KERNELS"}
)

# Registry funnels whose positional string arguments are backend names.
_BACKEND_FUNCS = frozenset(
    {"resolve_backend", "resolve_paged_attn_backend",
     "resolve_flash_attn_backend", "plain_twin", "backend_op",
     "backend_stages", "align_backend_family"}
)

# Keywords whose string values are backend names.
_BACKEND_KEYWORDS = ("backend", "kernel_backend", "attn_backend")


def _is_backend_named(node: ast.AST) -> bool:
    name = dotted_name(node)
    if name is None:
        return False
    last = name.split(".")[-1]
    return last == "backend" or any(
        last == h or last.endswith("_" + h) for h in _BACKEND_NAME_HINTS
    )


def _is_objective_named(node: ast.AST) -> bool:
    name = dotted_name(node)
    if name is None:
        return False
    last = name.split(".")[-1]
    return last == "objective" or last.endswith("_objective")


# ---------------------------------------------------------------------------
# RPR003: compiled callables (torch.compile / torch.jit / build.load) in loops
# ---------------------------------------------------------------------------


def _compiled_builder(name: str) -> str:
    """What a dotted callee builds, when it builds a compiled callable:
    ``torch.compile``, ``jit.script`` / ``jit.trace`` under any module
    alias, the kernel loader ``build.load``; else ``""``."""

    parts = name.split(".")
    if parts[-1] == "compile" and parts[0] == "torch":
        return "torch.compile"
    if len(parts) >= 2 and parts[-2] == "jit" and parts[-1] in ("script", "trace"):
        return f"torch.jit.{parts[-1]}"
    if len(parts) >= 2 and parts[-2] == "build" and parts[-1] == "load":
        return "build.load (the kernel library loader)"
    return ""


class _LoopJitVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.depth = 0
        self.diags: list[Diagnostic] = []

    def _visit_scope(self, node) -> None:
        saved, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = saved

    visit_FunctionDef = _visit_scope
    visit_AsyncFunctionDef = _visit_scope
    visit_Lambda = _visit_scope

    def _visit_loop(self, node) -> None:
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def visit_Call(self, node: ast.Call) -> None:
        if self.depth > 0:
            name = dotted_name(node.func) or ""
            what = _compiled_builder(name)
            if what:
                self._flag(node, what)
        self.generic_visit(node)

    def _flag(self, node: ast.Call, what: str) -> None:
        self.diags.append(
            Diagnostic(
                code="RPR003",
                path=self.path,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"{what} called inside a loop body: each iteration "
                    "builds a fresh compiled callable (recompiling or "
                    "re-resolving it) — hoist the construction out of the "
                    "loop"
                ),
            )
        )


# ---------------------------------------------------------------------------
# RPR004: raw ContextVar.set outside the blessed helpers
# ---------------------------------------------------------------------------


def _contextvar_names(tree: ast.Module) -> set[str]:
    """Module-level names bound to ``contextvars.ContextVar(...)``."""

    out: set[str] = set()
    for stmt in tree.body:
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        if not isinstance(value, ast.Call):
            continue
        fname = dotted_name(value.func)
        if fname and fname.split(".")[-1] == "ContextVar":
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _has_reset_in_finally(fn: ast.AST, var: str) -> bool:
    """Does this function reset ``var`` in a ``finally`` block?"""

    for node in ast.walk(fn):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                for call in ast.walk(stmt):
                    if isinstance(call, ast.Call):
                        fname = dotted_name(call.func)
                        if fname == f"{var}.reset":
                            return True
    return False


def _class_resets_in_exit(cls: ast.ClassDef, var: str) -> bool:
    """Does the enclosing class pair the set with a reset in __exit__?"""

    for item in cls.body:
        if (
            isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
            and item.name == "__exit__"
        ):
            for call in ast.walk(item):
                if isinstance(call, ast.Call):
                    fname = dotted_name(call.func)
                    if fname is not None and fname.startswith(var + "."):
                        if fname.split(".")[-1] in ("reset", "set"):
                            return True
    return False


def check_contextvar_sets(path: str, tree: ast.Module) -> list[Diagnostic]:
    norm = path.replace("\\", "/")
    if any(norm.endswith(b) for b in BLESSED_CONTEXTVAR_MODULES):
        return []
    cvars = _contextvar_names(tree)
    if not cvars:
        return []
    diags: list[Diagnostic] = []

    def scan(body: Iterable[ast.stmt], enclosing_class: Optional[ast.ClassDef],
             enclosing_fn: Optional[ast.AST]) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                scan(stmt.body, stmt, None)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(stmt.body, enclosing_class, stmt)
                continue
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                fname = dotted_name(node.func)
                if fname is None or not fname.endswith(".set"):
                    continue
                var = fname[: -len(".set")]
                if var not in cvars:
                    continue
                ok = False
                if enclosing_fn is not None and _has_reset_in_finally(
                    enclosing_fn, var
                ):
                    ok = True
                if (
                    not ok
                    and enclosing_class is not None
                    and enclosing_fn is not None
                    and getattr(enclosing_fn, "name", "") in (
                        "__enter__", "__exit__"
                    )
                    and _class_resets_in_exit(enclosing_class, var)
                ):
                    ok = True
                if not ok:
                    diags.append(
                        Diagnostic(
                            code="RPR004",
                            path=path,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"raw ContextVar set on `{var}` without a "
                                "token reset in a finally/__exit__: use the "
                                "blessed context managers (ExecutionContext"
                                "/trace.span) or pair set with reset"
                            ),
                        )
                    )

    scan(tree.body, None, None)
    return diags


# ---------------------------------------------------------------------------
# RPR005: backend-string drift against the live registry vocabulary
# ---------------------------------------------------------------------------


def _str_literals(node: ast.AST) -> list[ast.Constant]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [
            e for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        ]
    return []


class _BackendDriftVisitor(ast.NodeVisitor):
    def __init__(
        self,
        path: str,
        vocabulary: frozenset[str],
        objectives: Optional[frozenset[str]] = None,
    ):
        self.path = path
        self.vocab = vocabulary
        self.objectives = objectives
        self.diags: list[Diagnostic] = []

    def _check(self, lit: ast.Constant, where: str) -> None:
        if lit.value not in self.vocab:
            self.diags.append(
                Diagnostic(
                    code="RPR005",
                    path=self.path,
                    line=lit.lineno,
                    col=lit.col_offset,
                    message=(
                        f"backend name {lit.value!r} ({where}) is not in "
                        "the registry vocabulary — add it to "
                        "repro_torch execution.BACKENDS or fix the drift"
                    ),
                )
            )

    def _check_objective(self, lit: ast.Constant, where: str) -> None:
        if self.objectives is not None and lit.value not in self.objectives:
            self.diags.append(
                Diagnostic(
                    code="RPR005",
                    path=self.path,
                    line=lit.lineno,
                    col=lit.col_offset,
                    message=(
                        f"objective name {lit.value!r} ({where}) is not in "
                        "the scheduling-objective vocabulary "
                        "(schedule.OBJECTIVES) — fix the drift"
                    ),
                )
            )

    def visit_Call(self, node: ast.Call) -> None:
        callee = dotted_name(node.func)
        last = callee.split(".")[-1] if callee else ""
        if last != "add_argument":  # argparse flags define their own enums
            for kw in node.keywords:
                if kw.arg in _BACKEND_KEYWORDS:
                    for lit in _str_literals(kw.value):
                        self._check(lit, f"keyword {kw.arg}=")
                elif kw.arg == "objective":
                    for lit in _str_literals(kw.value):
                        self._check_objective(lit, "keyword objective=")
        if last in _BACKEND_FUNCS:
            for arg in node.args:
                for lit in _str_literals(arg):
                    self._check(lit, f"argument of {last}")
        if last == "validate_objective":
            for arg in node.args:
                for lit in _str_literals(arg):
                    self._check_objective(lit, f"argument of {last}")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        sides = [node.left, *node.comparators]
        backendish = any(_is_backend_named(s) for s in sides)
        if backendish:
            for s in sides:
                for lit in _str_literals(s):
                    self._check(lit, "comparison with a backend value")
        elif any(_is_objective_named(s) for s in sides):
            for s in sides:
                for lit in _str_literals(s):
                    self._check_objective(lit, "comparison with an objective value")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        base = dotted_name(node.value)
        if base and base.split(".")[-1] in _REGISTRY_TABLES:
            for lit in _str_literals(node.slice):
                self._check(lit, f"subscript of {base.split('.')[-1]}")
        self.generic_visit(node)


def check_backend_drift(
    path: str,
    tree: ast.Module,
    vocabulary: frozenset[str],
    objectives: Optional[frozenset[str]] = None,
) -> list[Diagnostic]:
    v = _BackendDriftVisitor(path, vocabulary, objectives)
    v.visit(tree)
    return v.diags


# ---------------------------------------------------------------------------
# RPR006: fault-point drift against the live FAULT_POINTS registry
# ---------------------------------------------------------------------------

# Funnels whose positional string arguments name an injection point.
_FAULT_FUNCS = frozenset({"fault_active", "validate_point"})


class _FaultPointDriftVisitor(ast.NodeVisitor):
    def __init__(self, path: str, fault_points: frozenset[str]):
        self.path = path
        self.points = fault_points
        self.diags: list[Diagnostic] = []

    def _check(self, lit: ast.Constant, where: str) -> None:
        if lit.value not in self.points:
            self.diags.append(
                Diagnostic(
                    code="RPR006",
                    path=self.path,
                    line=lit.lineno,
                    col=lit.col_offset,
                    message=(
                        f"fault point {lit.value!r} ({where}) is not in the "
                        "injection registry — a plan naming it never fires; "
                        "add it to runtime.faults.FAULT_POINTS or fix the "
                        "drift"
                    ),
                )
            )

    def visit_Call(self, node: ast.Call) -> None:
        callee = dotted_name(node.func)
        last = callee.split(".")[-1] if callee else ""
        if last in _FAULT_FUNCS:
            for arg in node.args:
                for lit in _str_literals(arg):
                    self._check(lit, f"argument of {last}")
        for kw in node.keywords:
            if kw.arg == "point":  # FaultEvent(point=...) and friends
                for lit in _str_literals(kw.value):
                    self._check(lit, "keyword point=")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        base = dotted_name(node.value)
        if base and base.split(".")[-1] == "FAULT_POINTS":
            for lit in _str_literals(node.slice):
                self._check(lit, "subscript of FAULT_POINTS")
        self.generic_visit(node)


def check_fault_point_drift(
    path: str, tree: ast.Module, fault_points: frozenset[str]
) -> list[Diagnostic]:
    v = _FaultPointDriftVisitor(path, fault_points)
    v.visit(tree)
    return v.diags


def check_loop_jit(path: str, tree: ast.Module) -> list[Diagnostic]:
    v = _LoopJitVisitor(path)
    v.visit(tree)
    return v.diags


def run_ast_checks(
    path: str,
    source: str,
    vocabulary: frozenset[str],
    objectives: Optional[frozenset[str]] = None,
    fault_points: Optional[frozenset[str]] = None,
) -> list[Diagnostic]:
    """All AST passes (donation included) over one file's source."""

    from repro_torch.analysis import donation

    tree = ast.parse(source, filename=path)
    diags = []
    diags.extend(donation.check_module(path, tree))
    diags.extend(check_loop_jit(path, tree))
    diags.extend(check_contextvar_sets(path, tree))
    diags.extend(check_backend_drift(path, tree, vocabulary, objectives))
    if fault_points is not None:
        diags.extend(check_fault_point_drift(path, tree, fault_points))
    return diags


__all__ = [
    "BLESSED_CONTEXTVAR_MODULES",
    "run_ast_checks",
    "check_loop_jit",
    "check_contextvar_sets",
    "check_backend_drift",
    "check_fault_point_drift",
]
