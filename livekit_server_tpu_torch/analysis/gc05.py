"""GC05 — bounded queues.

Every `asyncio.Queue` (and stdlib `queue.Queue` variants) or
`collections.deque` constructed in the runtime and routing planes must
carry an explicit bound (`maxsize=` / `maxlen=`, or the corresponding
positional argument). An unbounded buffer between a producer that never
blocks and a consumer that can fall behind converts overload into
unbounded memory growth — the failure the overload governor exists to
prevent, and one that no drop counter will ever report because nothing
is ever dropped. Deliberately unbounded structures carry an inline
`# graftcheck: disable=GC05` with a justification.

A bound of literal `0` (asyncio's "infinite" sentinel) or `maxlen=None`
is flagged the same as a missing bound: it spells unbounded while
looking like a choice.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project


def _is_unbounded_literal(node: ast.expr | None) -> bool:
    """True when the bound expression is literally 0 or None."""
    return isinstance(node, ast.Constant) and (
        node.value is None or node.value == 0
    )


def _bound_arg(call: ast.Call, kw_name: str, pos_index: int) -> ast.expr | None:
    """The expression supplying the bound, or None when absent."""
    for kw in call.keywords:
        if kw.arg == kw_name:
            return kw.value
    if len(call.args) > pos_index:
        return call.args[pos_index]
    return None


def run(project: Project, cfg: dict) -> list[Finding]:
    queue_calls = set(cfg["queue_calls"])
    deque_calls = set(cfg["deque_calls"])
    findings: list[Finding] = []
    for sf in project.under(cfg["paths"]):
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted is None:
                continue
            tail = dotted.rsplit(".", 1)[-1]
            if tail in queue_calls:
                kw_name, pos_index = "maxsize", 0
            elif tail in deque_calls:
                kw_name, pos_index = "maxlen", 1
            else:
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue  # **kwargs splat: can't prove absence statically
            bound = _bound_arg(node, kw_name, pos_index)
            if bound is None:
                findings.append(
                    Finding(
                        "GC05", sf.rel, node.lineno,
                        f"unbounded `{dotted}(...)`: no {kw_name}= given",
                        hint=f"pass an explicit {kw_name}= (overload must "
                        "surface as counted drops, not memory growth); "
                        "disable with a justification if unbounded is "
                        "deliberate",
                    )
                )
            elif _is_unbounded_literal(bound):
                findings.append(
                    Finding(
                        "GC05", sf.rel, node.lineno,
                        f"`{dotted}(...)` bound is literally unbounded "
                        f"({kw_name}={ast.unparse(bound)})",
                        hint=f"use a positive {kw_name} — 0/None spell "
                        "infinite while looking like a bound",
                    )
                )
    return findings
