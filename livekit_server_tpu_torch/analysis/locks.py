"""Lexical lock-region analysis shared by GC01 and GC03.

Locks are identified by the final attribute segment of the guarded
expression (`self.runtime.state_lock` → "state_lock"), which matches how
this codebase names them: one state lock per runtime, one checkpoint
lock per manager. A name bound from a lock container
(`lock = self._create_locks.setdefault(...)`) aliases to the container's
name.

Two acquisition shapes are recognized:

  * ``async with <lockexpr>:`` / ``with <lockexpr>:`` — held for the body
  * ``await <lockexpr>.acquire()`` … ``<lockexpr>.release()`` — held for
    the statements between them in the same block (the serving loop's
    explicit-acquire shape in PlaneRuntime._run); a release inside a
    ``finally`` closes the region after its try statement, so the try
    body itself is analyzed as held

Nested function bodies do NOT inherit the enclosing held set: a closure
defined under a lock runs whenever it is later called, not while the
lock is held.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from livekit_server_tpu_torch.analysis.callgraph import dotted_name


def lock_aliases(func_node: ast.AST, lock_names: set[str]) -> dict[str, str]:
    """Local names bound from expressions that mention a lock container:
    `lock = self._create_locks.setdefault(n, Lock())` → {lock: _create_locks}."""
    out: dict[str, str] = {}
    for node in ast.walk(func_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Attribute) and sub.attr in lock_names:
                    out[node.targets[0].id] = sub.attr
                elif isinstance(sub, ast.Name) and sub.id in lock_names:
                    out[node.targets[0].id] = sub.id
    return out


def match_lock(expr: ast.AST, lock_names: set[str],
               aliases: dict[str, str]) -> str | None:
    """Lock name if `expr` denotes one of the configured locks."""
    dotted = dotted_name(expr)
    if dotted is None:
        return None
    tail = dotted.rsplit(".", 1)[-1]
    if tail in lock_names:
        return tail
    return aliases.get(dotted)


@dataclass
class LockInfo:
    """Per-function lexical lock facts."""

    # id(ast node) → frozenset of lock names held at that node
    held_at: dict[int, frozenset] = field(default_factory=dict)
    # (lock, node, held-before) for every acquisition site
    acquisitions: list[tuple[str, ast.AST, frozenset]] = field(
        default_factory=list
    )
    # (call node, held) for every call made while ≥1 lock is held
    locked_calls: list[tuple[ast.Call, frozenset]] = field(
        default_factory=list
    )

    def held(self, node: ast.AST) -> frozenset:
        return self.held_at.get(id(node), frozenset())


def _acquire_of(stmt: ast.stmt, lock_names, aliases) -> str | None:
    """Lock name when stmt is `await <lock>.acquire()` (possibly assigned)."""
    expr = stmt.value if isinstance(stmt, (ast.Expr, ast.Assign)) else None
    if isinstance(expr, ast.Await):
        expr = expr.value
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "acquire":
        return match_lock(expr.func.value, lock_names, aliases)
    return None


def _releases_in(stmt: ast.stmt, lock_names, aliases) -> set[str]:
    """Locks released anywhere inside stmt (e.g. in its finally block)."""
    out: set[str] = set()
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "release":
            lock = match_lock(node.func.value, lock_names, aliases)
            if lock:
                out.add(lock)
    return out


_NESTED = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


_COMPOUND = (ast.If, ast.While, ast.For, ast.AsyncFor, ast.Try)


def analyze_function(func_node: ast.AST, lock_names) -> LockInfo:
    lock_names = set(lock_names)
    aliases = lock_aliases(func_node, lock_names)
    info = LockInfo()

    def mark(node: ast.AST, held: frozenset) -> None:
        """Annotate an expression/simple-statement subtree. Nested defs
        restart at ∅; nested with-statements restate their own held sets."""
        stack = [node]
        while stack:
            n = stack.pop()
            info.held_at[id(n)] = held
            if isinstance(n, ast.Call) and held:
                info.locked_calls.append((n, held))
            for child in ast.iter_child_nodes(n):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit_block(child.body, frozenset())
                elif isinstance(child, ast.Lambda):
                    mark(child.body, frozenset())
                elif isinstance(child, (ast.With, ast.AsyncWith)):
                    visit_with(child, held)
                else:
                    stack.append(child)

    def visit_with(node: ast.With | ast.AsyncWith, held: frozenset) -> None:
        info.held_at[id(node)] = held
        acquired = set()
        for item in node.items:
            mark(item.context_expr, held)
            lock = match_lock(item.context_expr, lock_names, aliases)
            if lock:
                info.acquisitions.append((lock, node, held))
                acquired.add(lock)
        visit_block(node.body, held | frozenset(acquired))

    def visit_stmt(stmt: ast.stmt, held: frozenset) -> frozenset:
        """Process one statement; return the held set after it."""
        acq = _acquire_of(stmt, lock_names, aliases)
        if acq is not None:
            info.held_at[id(stmt)] = held
            info.acquisitions.append((acq, stmt, held))
            return held | {acq}
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            info.held_at[id(stmt)] = held
            visit_block(stmt.body, frozenset())
            return held
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            visit_with(stmt, held)
            return held - _releases_in(stmt, lock_names, aliases)
        if isinstance(stmt, _COMPOUND):
            info.held_at[id(stmt)] = held
            # header expressions (test / iter) run with the entry set
            for child in ast.iter_child_nodes(stmt):
                if not isinstance(child, (ast.stmt, ast.ExceptHandler)):
                    mark(child, held)
            if isinstance(stmt, ast.Try):
                # An acquire in the try body stays held through the
                # finally (where this codebase releases it); handlers
                # may be entered before the acquire, so they start at
                # the entry set — conservative both ways.
                h = visit_block(stmt.body, held)
                for handler in stmt.handlers:
                    info.held_at[id(handler)] = held
                    visit_block(handler.body, held)
                visit_block(stmt.orelse, h)
                visit_block(stmt.finalbody, h)
                return h - _releases_in(stmt, lock_names, aliases)
            visit_block(stmt.body, held)
            visit_block(getattr(stmt, "orelse", []), held)
            # a branch-local acquire does not propagate out; releases do
            return held - _releases_in(stmt, lock_names, aliases)
        mark(stmt, held)
        return held - _releases_in(stmt, lock_names, aliases)

    def visit_block(body, held: frozenset) -> frozenset:
        if not isinstance(body, list):
            mark(body, held)  # Lambda body expression
            return held
        for stmt in body:
            held = visit_stmt(stmt, held)
        return held

    visit_block(getattr(func_node, "body", []), frozenset())
    return info
