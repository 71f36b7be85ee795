"""GC04 — retry policy.

Network sends and dials in the routing plane and the media relay must
route through `utils/backoff.retry_async` (with a `BackoffPolicy` and,
for persistent peers, a `CircuitBreaker`). Hand-rolled
`while: try/except(ConnectionError): sleep()` loops retry instantly
under partitions, synchronize reconnect storms across nodes, and never
trip a breaker — exactly the shape the fault-injection drills punish.

Two findings:

  * a `while` loop that catches a network error class and sleeps *as
    backoff* is an ad-hoc retry loop. "As backoff" means the sleep sits
    at or after the net-catching `try` — inside the handler, or at the
    loop tail after a swallowed failure. A periodic poll worker that
    sleeps at the TOP of its body (the sleep is the schedule, not a
    reaction to failure) and then tolerates a net error until the next
    interval is NOT a finding — that shape already has bounded, fixed
    cadence and cannot storm;
  * a direct dial call (`asyncio.open_connection`,
    `create_datagram_endpoint`, ...) in a function that is not itself
    passed to `retry_async` is an unmanaged dial. Listen-side binds and
    deliberate fail-fast initial dials carry an inline
    `# graftcheck: disable=GC04` with a justification.

Bounded in-process polls (no network except handler) are not findings.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project

_SLEEPS = {"asyncio.sleep", "time.sleep"}


def _handler_names(handler: ast.ExceptHandler, cg, modname: str) -> set[str]:
    t = handler.type
    exprs = t.elts if isinstance(t, ast.Tuple) else [t] if t else []
    out = set()
    for e in exprs:
        dotted = dotted_name(e)
        if dotted:
            full = cg.expand_alias(dotted, modname)
            out.add(full)
            out.add(full.rsplit(".", 1)[-1])
    return out


def _retry_wrapped_names(sf, cg, cfg) -> set[str]:
    """Names of functions passed to retry helpers anywhere in the module
    (`await retry_async(dial, policy, ...)` marks `dial` as managed)."""
    out: set[str] = set()
    if sf.tree is None:
        return out
    helpers = set(cfg["retry_helpers"])
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = dotted_name(node.func)
        if dotted is None or dotted.rsplit(".", 1)[-1] not in helpers:
            continue
        for arg in node.args:
            if isinstance(arg, ast.Name):
                out.add(arg.id)
    return out


def run(project: Project, cfg: dict) -> list[Finding]:
    cg = project.callgraph
    net_errors = set(cfg["net_errors"])
    dial_calls = set(cfg["dial_calls"])
    findings: list[Finding] = []

    for sf in project.under(cfg["paths"]):
        if sf.tree is None:
            continue
        managed = _retry_wrapped_names(sf, cg, cfg)

        # ad-hoc retry loops: while + except(net error) + sleep-as-backoff.
        # The sleep must sit at or after the net-catching try (inside the
        # handler, or at the loop tail behind a swallowed failure); a
        # schedule-sleep at the top of a poll worker's body is cadence,
        # not backoff, and does not fire.
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.While):
                continue
            caught: set[str] = set()
            net_try_line: int | None = None
            sleep_lines: list[int] = []
            for sub in ast.walk(node):
                if isinstance(sub, ast.Try):
                    for h in sub.handlers:
                        got = _handler_names(h, cg, sf.modname) & net_errors
                        if got:
                            caught |= got
                            if net_try_line is None or sub.lineno < net_try_line:
                                net_try_line = sub.lineno
                elif isinstance(sub, ast.Call):
                    dotted = dotted_name(sub.func)
                    if dotted and cg.expand_alias(
                        dotted, sf.modname
                    ) in _SLEEPS:
                        sleep_lines.append(sub.lineno)
            if caught and net_try_line is not None and any(
                ln >= net_try_line for ln in sleep_lines
            ):
                findings.append(
                    Finding(
                        "GC04", sf.rel, node.lineno,
                        "ad-hoc retry loop: catches "
                        f"{sorted(caught)} and sleeps inline",
                        hint="route the attempt through "
                        "utils.backoff.retry_async with a BackoffPolicy "
                        "(+ CircuitBreaker for persistent peers)",
                    )
                )

        # unmanaged direct dials
        for (mod, qual), fi in cg.funcs.items():
            if mod != sf.modname:
                continue
            if fi.name in managed:
                continue
            body = getattr(fi.node, "body", [])
            stack = list(body) if isinstance(body, list) else [body]
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    continue  # nested fn is its own FuncInfo
                if isinstance(node, ast.Call):
                    dotted = dotted_name(node.func)
                    if dotted is not None:
                        full = cg.expand_alias(dotted, sf.modname)
                        tail = full.rsplit(".", 1)[-1]
                        if full in dial_calls or tail in dial_calls:
                            findings.append(
                                Finding(
                                    "GC04", sf.rel, node.lineno,
                                    f"direct dial `{dotted}` in {fi.qual} "
                                    "outside retry_async",
                                    hint="wrap the dial in a closure passed "
                                    "to utils.backoff.retry_async, or "
                                    "disable with a justification if this "
                                    "is a listen-side bind / deliberate "
                                    "fail-fast path",
                                )
                            )
                stack.extend(ast.iter_child_nodes(node))
    return findings
