"""GC07 — allocation-free trace emits on the tick hot path.

The flight-recorder APIs (`TickTraceRing.record_tick`, `set_shard`,
`BlackBox.emit`, `LatencyAttribution.observe_batch` /
`observe_express`) are designed as fixed-ring scalar stores precisely
so they can run inside the tick loop at zero steady-state allocation.
That property dies at the *call site*: an f-string, dict/list/set
display, comprehension, or `.format(...)` built just to pass into the
recorder allocates on every tick even though the recorder itself does
not. This rule flags any allocating expression in the arguments of a
configured emit call, unless the call sits inside a sampling branch —
an `if` whose condition mentions a configured sampling name (sample /
sampled / mask / stamped, by default) or a `%` decimation test — where
the allocation is paid only 1-in-K times by construction.

Formatting belongs in `dump`/`dump_to`/`snapshot` (the cold read side),
not in the emit. Deliberate exceptions carry an inline
`# graftcheck: disable=GC07` with a justification.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project

# Expression nodes whose evaluation allocates a fresh container/str.
_ALLOC_NODES = (
    ast.JoinedStr,       # f-string
    ast.Dict,
    ast.List,
    ast.Set,
    ast.ListComp,
    ast.SetComp,
    ast.DictComp,
    ast.GeneratorExp,
)


def _alloc_in(node: ast.expr) -> tuple[int, str] | None:
    """(line, kind) of the first allocating construct inside `node`."""
    for sub in ast.walk(node):
        if isinstance(sub, _ALLOC_NODES):
            kind = {
                ast.JoinedStr: "f-string",
                ast.Dict: "dict display",
                ast.List: "list display",
                ast.Set: "set display",
            }.get(type(sub), "comprehension")
            return sub.lineno, kind
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "format"
        ):
            return sub.lineno, "str.format(...)"
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod) and (
            isinstance(sub.left, (ast.Constant, ast.JoinedStr))
            and isinstance(getattr(sub.left, "value", None), str)
        ):
            return sub.lineno, "%-format"
    return None


def _is_sampling_test(test: ast.expr, guard_names: set[str]) -> bool:
    """A condition that decimates: mentions a sampling name or takes
    `x % k` — the idiom of deterministic 1-in-K selection."""
    for sub in ast.walk(test):
        if isinstance(sub, ast.Name) and any(
            g in sub.id.lower() for g in guard_names
        ):
            return True
        if isinstance(sub, ast.Attribute) and any(
            g in sub.attr.lower() for g in guard_names
        ):
            return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod):
            # exclude str % tuple formatting, which _alloc_in flags
            if not (
                isinstance(sub.left, ast.Constant)
                and isinstance(sub.left.value, str)
            ):
                return True
    return False


def run(project: Project, cfg: dict) -> list[Finding]:
    emit_calls = set(cfg["emit_calls"])
    guard_names = {g.lower() for g in cfg["sample_guards"]}
    findings: list[Finding] = []
    for sf in project.under(cfg["paths"]):
        if sf.tree is None:
            continue
        # parent links so a flagged call can look up enclosing ifs
        parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(sf.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted is None or dotted.rsplit(".", 1)[-1] not in emit_calls:
                continue
            hit = None
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                hit = _alloc_in(arg)
                if hit is not None:
                    break
            if hit is None:
                continue
            # exempt when any enclosing `if` is a sampling/decimation test
            sampled = False
            cur: ast.AST | None = parents.get(node)
            while cur is not None:
                if isinstance(cur, ast.If) and _is_sampling_test(
                    cur.test, guard_names
                ):
                    sampled = True
                    break
                cur = parents.get(cur)
            if sampled:
                continue
            line, kind = hit
            findings.append(
                Finding(
                    "GC07", sf.rel, line,
                    f"allocating {kind} in `{dotted}(...)` args outside a "
                    "sampled branch",
                    hint="trace/black-box emits on the tick hot path must "
                    "pass scalars only (format in dump/snapshot, the cold "
                    "side), or guard the emit behind the 1-in-K sampling "
                    "test",
                )
            )
    return findings
