"""GC08 — page-handle staleness across await / lock-release boundaries.

Device page indices minted from the pager (`pages_of_room(...)` and
friends) are only valid for the page-table epoch they were minted at:
any structural pager change — alloc, grow, release, compaction — bumps
`RoomPager.epoch` and may remap or free the pages behind the handle.
Inside one locked, synchronous region that is safe by construction;
the hazard is a handle that SURVIVES a scheduling boundary:

- an `await` between mint and use (the event loop may run an admission
  or a drain that reallocates the pages), or
- minting inside a `with state_lock:` block and using the handle after
  the block exits (another thread may compact between).

This rule flags any use of a minted handle after such a boundary,
unless a configured revalidation call (`check_epoch(...)` by default)
or a re-mint sits between the boundary and the use. Epoch-pinned
wrappers (`LayoutXlate`) re-validate internally and are not handles.

Deliberate exceptions carry `# graftcheck: disable=GC08` with a
justification.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _call_tail(node: ast.expr) -> str | None:
    if not isinstance(node, ast.Call):
        return None
    dotted = dotted_name(node.func)
    return dotted.rsplit(".", 1)[-1] if dotted else None


def _walk_skip_nested(fn: ast.AST):
    """Walk a function body without descending into nested defs (their
    handles live in their own scope and are analyzed separately)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FUNCS):
            continue
        stack.extend(ast.iter_child_nodes(node))


_WITHS = (ast.With, ast.AsyncWith)


def _lock_with(node: ast.With | ast.AsyncWith, lock_names: set[str]) -> bool:
    for item in node.items:
        for sub in ast.walk(item.context_expr):
            if isinstance(sub, ast.Attribute) and sub.attr in lock_names:
                return True
            if isinstance(sub, ast.Name) and sub.id in lock_names:
                return True
    return False


def run(project: Project, cfg: dict) -> list[Finding]:
    mint_calls = set(cfg["mint_calls"])
    revalidate = set(cfg["revalidate_calls"])
    lock_names = set(cfg["lock_names"])
    findings: list[Finding] = []
    for sf in project.under(cfg["paths"]):
        if sf.tree is None:
            continue
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, _FUNCS):
                continue
            # mints: var name -> [(mint line, enclosing lock-with end or 0)]
            mints: dict[str, list[tuple[int, int]]] = {}
            awaits: list[int] = []
            revals: list[int] = []
            uses: list[tuple[int, str]] = []
            lock_spans: list[tuple[int, int]] = []
            for node in ast.walk(fn):
                if isinstance(node, _WITHS) and _lock_with(node, lock_names):
                    lock_spans.append((node.lineno, node.end_lineno or node.lineno))
            for node in _walk_skip_nested(fn):
                if isinstance(node, ast.Await):
                    awaits.append(node.lineno)
                elif isinstance(node, ast.Call):
                    tail = _call_tail(node)
                    if tail in revalidate:
                        revals.append(node.lineno)
                elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt = node.targets[0]
                    if isinstance(tgt, ast.Name) and _call_tail(node.value) in mint_calls:
                        # earliest lock release after the mint = first
                        # point the handle can go stale under contention
                        span_end = 0
                        for lo, hi in lock_spans:
                            if lo <= node.lineno <= hi:
                                span_end = hi if not span_end else min(span_end, hi)
                        mints.setdefault(tgt.id, []).append((node.lineno, span_end))
                elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                    uses.append((node.lineno, node.id))
            if not mints:
                continue
            flagged: set[str] = set()
            for use, name in sorted(uses):
                if name in flagged or name not in mints:
                    continue
                # a use is scoped to the LATEST mint before it (a re-mint
                # starts a fresh epoch-valid handle)
                prior = [m for m in mints[name] if m[0] < use]
                if not prior:
                    continue
                mint_line, lock_end = max(prior)
                boundary = 0
                for aw in awaits:
                    if mint_line < aw <= use:
                        boundary = max(boundary, aw)
                if lock_end and use > lock_end:
                    boundary = max(boundary, lock_end)
                if not boundary:
                    continue
                if any(boundary < rv <= use for rv in revals):
                    continue
                kind = (
                    "an await" if boundary in awaits
                    else f"the {'/'.join(sorted(lock_names))} release"
                )
                findings.append(
                    Finding(
                        "GC08", sf.rel, use,
                        f"page handle `{name}` (minted line {mint_line}) "
                        f"used across {kind} without epoch revalidation",
                        hint="the pager may alloc/grow/compact at any "
                        "scheduling boundary; call pager.check_epoch(...) "
                        "or re-fetch the pages after the boundary",
                    )
                )
                # one finding per handle keeps the output readable
                flagged.add(name)
    return findings
