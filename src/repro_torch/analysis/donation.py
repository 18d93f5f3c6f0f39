"""In-place state dataflow lint: read-after-update and copy pins.

JAX donates a jitted step's big state (the decode caches, the paged
arena, the trainer's params and optimizer trees) so XLA reuses the
buffers; PyTorch has no donation.  Where the reference donates, the port
updates the state **in place**:

  * the decode state — ``model_zoo.make_decode_fn(cfg)``'s step writes
    the new K/V (or SSM state) into ``state`` (``runtime/serving.py``);
    the cache-carrying prefill (``make_prefill_fn(cfg, with_cache=True)``,
    ``bulk_prefill_from_decode``) and ``transformer.decode_step`` too;
  * the paged arena — ``layers.decode_attention_paged`` writes its
    ``pages_k`` / ``pages_v`` (``runtime/paging.py``), as
    ``layers.decode_attention`` writes its dense ``cache_k`` / ``cache_v``;
  * AdamW's trees — ``adamw.adamw_update`` writes ``params``, ``grads``
    and ``state`` (``optim/adamw.py``).

The reference's two donation codes keep their hazard, re-read for an
in-place update:

* **RPR001 — read-after-update.**  A name passed in an updated-in-place
  position and read afterwards, before being rebound, now holds the *new*
  state: a read that meant the old value (a loss of the old params, the
  cache before the step) silently sees the updated one.  The safe idiom
  is the reference's: rebind in the same statement,
  ``logits, state = decode(params, batch, state, pos)``.

* **RPR002 — copy pin.**  A copy of the state (``np.asarray`` /
  ``np.array``, ``.numpy()``, ``.cpu()``, ``.clone()``,
  ``copy.deepcopy``) handed to the function that updates it in place:
  the update lands on the copy, and the caller's state never moves.  It
  is the reference's donation-pin bug read for in-place state: there the host
  copy silently disabled donation, here it silently drops the update.

The analysis is intraprocedural but *module-aware* for bindings: a
``self._decode = Z.make_decode_fn(cfg)`` in ``__init__`` is recognized at
call sites in other methods (dotted names are matched textually).  The
updaters are named by the tables below, keyed by the callee's last dotted
component; positions are positional argument indices.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, Optional

from repro_torch.analysis.diagnostics import Diagnostic

_NP_FUNCS = frozenset({"asarray", "array"})
# Tensor methods returning a copy of their receiver.
_COPY_METHODS = frozenset({"numpy", "cpu", "clone"})

# Functions that update arguments in place when called: name -> positions.
IN_PLACE_CALLS: dict[str, frozenset[int]] = {
    "adamw_update": frozenset({0, 1, 2}),    # params, grads, state
    "decode_step": frozenset({3}),           # (params, cfg, batch, state, pos)
    "decode_attention": frozenset({3, 4}),   # cache_k, cache_v
    "decode_attention_paged": frozenset({3, 4}),  # pages_k, pages_v
}

# Factories whose returned callable updates arguments in place:
# name -> positions of the returned callable.  ``make_prefill_fn`` only
# with ``with_cache=True`` (the logits-only prefill keeps no state).
IN_PLACE_FACTORIES: dict[str, frozenset[int]] = {
    "make_decode_fn": frozenset({2}),        # (params, batch, state, pos)
    "bulk_prefill_from_decode": frozenset({2}),
    "make_prefill_fn": frozenset({2}),
}
_NEEDS_WITH_CACHE = frozenset({"make_prefill_fn"})


def dotted_name(node: ast.AST) -> Optional[str]:
    """``self._step`` / ``step`` as a dotted string; None for non-chains."""

    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(node: ast.AST) -> str:
    name = dotted_name(node)
    return name.split(".")[-1] if name else ""


class _ModuleIndex(ast.NodeVisitor):
    """Module-wide facts: import aliases and in-place updater bindings."""

    def __init__(self) -> None:
        self.numpy_aliases: set[str] = set()
        self.np_func_names: set[str] = set()   # `from numpy import asarray`
        self.deepcopy_names: set[str] = set()  # `from copy import deepcopy`
        # dotted binding name -> updated positional indices
        self.updaters: dict[str, frozenset[int]] = {}

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.name.split(".")[0] == "numpy":
                self.numpy_aliases.add(a.asname or "numpy")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = (node.module or "").split(".")[0]
        for a in node.names:
            if mod == "numpy" and a.name in _NP_FUNCS:
                self.np_func_names.add(a.asname or a.name)
            if mod == "copy" and a.name == "deepcopy":
                self.deepcopy_names.add(a.asname or a.name)

    def factory_positions(self, call: ast.Call) -> frozenset[int]:
        """Updated positions of the callable a factory call returns."""

        name = _last(call.func)
        if name not in IN_PLACE_FACTORIES:
            return frozenset()
        if name in _NEEDS_WITH_CACHE and not any(
            kw.arg == "with_cache" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in call.keywords
        ):
            return frozenset()
        return IN_PLACE_FACTORIES[name]

    def is_copy_call(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Name):
            return f.id in self.np_func_names or f.id in self.deepcopy_names
        if not isinstance(f, ast.Attribute):
            return False
        base = dotted_name(f.value)
        if f.attr in _NP_FUNCS and base is not None and base in self.numpy_aliases:
            return True
        if f.attr == "deepcopy" and base == "copy":
            return True
        return f.attr in _COPY_METHODS and not call.args and not call.keywords

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            pos = self.factory_positions(node.value)
            if pos:
                for target in node.targets:
                    name = dotted_name(target)
                    if name is not None:
                        self.updaters[name] = pos
        self.generic_visit(node)


def _statements(body: list[ast.stmt]) -> Iterator[ast.stmt]:
    """Simple statements of a scope in textual order (compound statements
    flattened; nested function/class scopes are opaque)."""

    for stmt in body:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While)):
            yield stmt  # the header (test/iter) is part of this unit
            yield from _statements(stmt.body)
            yield from _statements(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield stmt
            yield from _statements(stmt.body)
        elif isinstance(stmt, ast.Try):
            yield from _statements(stmt.body)
            for h in stmt.handlers:
                yield from _statements(h.body)
            yield from _statements(stmt.orelse)
            yield from _statements(stmt.finalbody)
        else:
            yield stmt


def _shallow_walk(stmt: ast.stmt) -> Iterator[ast.AST]:
    """Walk a statement without descending into nested scopes or into the
    bodies of compound statements (those are separate units)."""

    if isinstance(stmt, (ast.If, ast.While)):
        roots: list[ast.AST] = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        roots = [stmt.target, stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        roots = list(stmt.items)
    else:
        roots = [stmt]
    for root in roots:
        for node in ast.walk(root):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                       ast.Lambda)
            ):
                continue
            yield node


@dataclasses.dataclass
class _Update:
    name: str          # dotted name of the updated state
    unit: int          # statement-unit index of the updating call
    line: int


def _stores_and_loads(stmt: ast.stmt) -> tuple[set[str], list[tuple[str, int]]]:
    stores: set[str] = set()
    loads: list[tuple[str, int]] = []
    for node in _shallow_walk(stmt):
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = dotted_name(node)
            if name is None:
                continue
            ctx = getattr(node, "ctx", None)
            if isinstance(ctx, (ast.Store, ast.Del)):
                stores.add(name)
            elif isinstance(ctx, ast.Load):
                loads.append((name, node.lineno))
    return stores, loads


def _updated_positions_of_call(call: ast.Call, index: _ModuleIndex) -> frozenset[int]:
    """Updated positions if this call invokes an in-place updater: a named
    updater, a binding of a factory's callable, or a factory called inline
    (``Z.make_decode_fn(cfg)(params, batch, state, pos)``)."""

    func = call.func
    name = dotted_name(func)
    if name is not None and name in index.updaters:
        return index.updaters[name]
    if name is not None and name.split(".")[-1] in IN_PLACE_CALLS:
        return IN_PLACE_CALLS[name.split(".")[-1]]
    if isinstance(func, ast.Call):
        return index.factory_positions(func)
    return frozenset()


def check_scope(
    path: str,
    scope_body: list[ast.stmt],
    index: _ModuleIndex,
) -> list[Diagnostic]:
    """Run the in-place checks over one function (or module) body."""

    diags: list[Diagnostic] = []
    units = list(_statements(scope_body))
    # name -> line of the copy assignment it came from
    copies: dict[str, int] = {}
    updates: list[_Update] = []

    for i, stmt in enumerate(units):
        for node in _shallow_walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            positions = _updated_positions_of_call(node, index)
            for p in sorted(positions):
                if p >= len(node.args):
                    continue
                arg = node.args[p]
                if isinstance(arg, ast.Call) and index.is_copy_call(arg):
                    diags.append(
                        Diagnostic(
                            code="RPR002",
                            path=path,
                            line=arg.lineno,
                            col=arg.col_offset,
                            message=(
                                f"a copy passed in updated-in-place position "
                                f"{p}: the update lands on the copy and the "
                                "caller's state never moves"
                            ),
                        )
                    )
                    continue
                name = dotted_name(arg)
                if name is None:
                    continue
                if name in copies:
                    diags.append(
                        Diagnostic(
                            code="RPR002",
                            path=path,
                            line=copies[name],
                            message=(
                                f"`{name}` is a copy (line {copies[name]}) "
                                f"passed in updated-in-place position {p} at "
                                f"line {node.lineno}: the update lands on the "
                                "copy"
                            ),
                        )
                    )
                updates.append(_Update(name=name, unit=i, line=node.lineno))

        # Stores apply after the unit's right-hand side ran (so
        # `x = step(x)` with a copied `x` is still caught above), then new
        # copy origins are recorded.
        stores, _ = _stores_and_loads(stmt)
        for s in stores:
            copies.pop(s, None)
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            if index.is_copy_call(stmt.value):
                for target in stmt.targets:
                    name = dotted_name(target)
                    if name is not None:
                        copies[name] = stmt.lineno

    # read-after-update: a Load of the updated name in a later unit, before
    # the first unit that rebinds it.  A store in the updating unit itself
    # (`state = step(x, state)`, the safe idiom) rebinds at once.
    for upd in updates:
        same_unit_stores, _ = _stores_and_loads(units[upd.unit])
        if upd.name in same_unit_stores:
            continue
        for j in range(upd.unit + 1, len(units)):
            stores, loads = _stores_and_loads(units[j])
            read = next((ln for (n, ln) in loads if n == upd.name), None)
            if read is not None:
                diags.append(
                    Diagnostic(
                        code="RPR001",
                        path=path,
                        line=read,
                        message=(
                            f"`{upd.name}` was updated in place at line "
                            f"{upd.line} and is read here before being "
                            "rebound: it holds the new state, not the old"
                        ),
                    )
                )
                break
            if upd.name in stores:
                break
    return diags


def check_module(path: str, tree: ast.Module) -> list[Diagnostic]:
    """In-place checks over every scope of a parsed module."""

    index = _ModuleIndex()
    index.visit(tree)
    diags = check_scope(path, tree.body, index)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            diags.extend(check_scope(path, node.body, index))
    return diags


__all__ = ["IN_PLACE_CALLS", "IN_PLACE_FACTORIES", "check_module", "dotted_name"]
