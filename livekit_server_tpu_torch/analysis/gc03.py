"""GC03 — lock discipline.

Builds an acquisition-order graph over the media plane's asyncio locks
(`state_lock`, `_ckpt_lock`, the per-room `_create_locks` entries) and
flags:

  * lock-order cycles — two code paths acquiring the same pair of locks
    in opposite orders will deadlock under contention;
  * re-acquisition of a non-reentrant asyncio lock already held on the
    same path (directly, or through a call into a function that
    acquires it);
  * blocking synchronous calls (`time.sleep`, sync sockets, subprocess,
    and the host syncs of the card: `torch.cuda.synchronize()`,
    `.item()`, `.cpu()`, `.tolist()`, `.numpy()`, `Stream/Event
    .synchronize()`) made while an asyncio lock is held — they stall the
    entire event loop for every other lock waiter.

Edges are collected both lexically (acquire inside an outer lock's
region) and interprocedurally via a conservative `acquires*` fixed
point over resolvable callees. Unresolvable calls contribute no edge:
a fabricated edge would invent deadlocks, so only unique-name matches
count.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import (
    FuncInfo,
    body_calls,
    dotted_name,
)
from livekit_server_tpu_torch.analysis.core import Finding, Project
from livekit_server_tpu_torch.analysis.locks import LockInfo, analyze_function


def _blocking(full: str, patterns: list[str]) -> bool:
    return any(
        full.startswith(p) if p.endswith(".") else full == p
        for p in patterns
    )


def run(project: Project, cfg: dict) -> list[Finding]:
    cg = project.callgraph
    lock_names = set(cfg["lock_names"])
    blocking_methods = set(cfg.get("blocking_methods", []))
    findings: list[Finding] = []

    infos: dict[int, tuple[FuncInfo, LockInfo]] = {}
    for sf in project.under(cfg["paths"]):
        if sf.tree is None:
            continue
        for (mod, qual), fi in cg.funcs.items():
            if mod == sf.modname and fi.parent is None:
                infos[id(fi)] = (fi, analyze_function(fi.node, lock_names))

    # acquires*(f): locks f may take, directly or through callees
    direct = {k: {l for (l, _, _) in info.acquisitions}
              for k, (fi, info) in infos.items()}
    callees: dict[int, list[int]] = {}
    for k, (fi, info) in infos.items():
        outs = []
        for call in body_calls(fi.node):
            target = cg.resolve_unique(call.func, fi, fi.module)
            if target is not None and id(target) in infos:
                outs.append(id(target))
        callees[k] = outs
    star = {k: set(v) for k, v in direct.items()}
    changed = True
    while changed:
        changed = False
        for k, outs in callees.items():
            for o in outs:
                if not star[o] <= star[k]:
                    star[k] |= star[o]
                    changed = True

    # edges: held-lock → acquired-lock, with a representative site each
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}

    def add_edge(h: str, l: str, sf_rel: str, line: int, qual: str) -> None:
        edges.setdefault((h, l), (sf_rel, line, qual))

    for k, (fi, info) in infos.items():
        rel = fi.module.rel
        for lock, node, held in info.acquisitions:
            if lock in held:
                findings.append(
                    Finding(
                        "GC03", rel, node.lineno,
                        f"re-acquisition of `{lock}` already held in "
                        f"{fi.qual} — asyncio locks are not reentrant",
                        hint="split the locked section or pass state in",
                    )
                )
            for h in held:
                add_edge(h, lock, rel, node.lineno, fi.qual)
        for call, held in info.locked_calls:
            dotted = dotted_name(call.func)
            sync = (isinstance(call.func, ast.Attribute)
                    and call.func.attr in blocking_methods)
            if sync and dotted is None:
                dotted = f"….{call.func.attr}"   # a method on a computed receiver
            if dotted is not None:
                full = cg.expand_alias(dotted, fi.module.modname)
                if sync or _blocking(full, cfg["blocking_calls"]):
                    findings.append(
                        Finding(
                            "GC03", rel, call.lineno,
                            f"blocking call `{dotted}` while holding "
                            f"{sorted(held)} in {fi.qual} — stalls the "
                            "event loop for every lock waiter",
                            hint="use the async equivalent or move the "
                            "call outside the locked region",
                        )
                    )
            target = cg.resolve_unique(call.func, fi, fi.module)
            if target is None or id(target) not in infos:
                continue
            for l in star[id(target)]:
                if l in held:
                    findings.append(
                        Finding(
                            "GC03", rel, call.lineno,
                            f"call into `{target.qual}` (which may acquire "
                            f"`{l}`) while `{l}` is already held in "
                            f"{fi.qual}",
                            hint="hoist the inner acquisition to the caller "
                            "or document a lock-held contract",
                        )
                    )
                for h in held:
                    if h != l:
                        add_edge(h, l, rel, call.lineno, fi.qual)

    # cycle detection over the lock-order graph
    graph: dict[str, set[str]] = {}
    for (h, l) in edges:
        graph.setdefault(h, set()).add(l)
    reported: set[frozenset] = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    cyc = frozenset(path)
                    if cyc in reported:
                        continue
                    reported.add(cyc)
                    sites = " ; ".join(
                        f"{a}->{b} at {edges[(a, b)][0]}:{edges[(a, b)][1]}"
                        for a, b in zip(path, path[1:] + [start])
                    )
                    rel, line, qual = edges[(path[-1], start)]
                    findings.append(
                        Finding(
                            "GC03", rel, line,
                            "lock-order cycle "
                            f"{' -> '.join(path + [start])} ({sites})",
                            hint="pick one global acquisition order and "
                            "restructure the later acquisition",
                        )
                    )
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return findings
