"""Module/function index + heuristic call resolution for graftcheck.

Static resolution is deliberately conservative: it follows the shapes
this codebase actually uses (module-alias calls, `from X import f`,
nested closures, `self.method()` within a class, `functools.partial`).
Anything it cannot resolve, it skips — rules built on top must treat an
unresolved call as "not an edge", never as an error.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from livekit_server_tpu_torch.analysis.core import Project, SourceFile


def dotted_name(expr: ast.AST) -> str | None:
    """`a.b.c` for Name/Attribute chains; None for anything dynamic."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FuncInfo:
    qual: str                  # Class.method / outer.inner (module-local)
    name: str
    node: ast.AST              # FunctionDef | AsyncFunctionDef | Lambda
    module: SourceFile
    cls: str | None = None     # enclosing class name, if a method
    parent: "FuncInfo | None" = None   # enclosing function (closures)
    # names of functions defined directly inside this one
    locals_: dict[str, "FuncInfo"] = field(default_factory=dict)



class CallGraph:
    """Index of every function/method/closure plus import alias maps."""

    def __init__(self, project: Project):
        self.project = project
        # (modname, qual) → FuncInfo; module-level name → FuncInfo
        self.funcs: dict[tuple[str, str], FuncInfo] = {}
        self.module_scope: dict[str, dict[str, FuncInfo]] = {}
        # modname → alias → real dotted target ("np" → "numpy",
        # "plane" → "livekit_server_tpu_torch.models.plane",
        # "retry_async" → "livekit_server_tpu_torch.utils.backoff.retry_async")
        self.aliases: dict[str, dict[str, str]] = {}
        # function simple name → [FuncInfo] across the project (for the
        # unique-name fallback the lock analyzer uses)
        self.by_name: dict[str, list[FuncInfo]] = {}
        for sf in project.files:
            if sf.tree is None:
                continue
            self.module_scope[sf.modname] = {}
            self.aliases[sf.modname] = self._collect_imports(sf.tree)
            self._index_body(sf, sf.tree.body, cls=None, parent=None)

    # -- indexing ---------------------------------------------------------
    def _collect_imports(self, tree: ast.Module) -> dict[str, str]:
        # Function-local and try/except-guarded imports are folded into
        # one per-module map: an alias map approximates name binding, and
        # this codebase never rebinds an import alias across scopes.
        out: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def _index_body(self, sf, body, cls, parent, prefix=""):
        for node in body:
            if isinstance(node, ast.ClassDef):
                self._index_body(sf, node.body, cls=node.name, parent=None,
                                 prefix=f"{prefix}{node.name}.")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                fi = FuncInfo(qual, node.name, node, sf, cls=cls, parent=parent)
                self.funcs[(sf.modname, qual)] = fi
                self.by_name.setdefault(node.name, []).append(fi)
                if parent is not None:
                    parent.locals_[node.name] = fi
                elif cls is None:
                    self.module_scope[sf.modname][node.name] = fi
                self._index_body(sf, node.body, cls=cls, parent=fi,
                                 prefix=f"{qual}.")
            else:
                # defs nested under if/try/with still belong to this scope
                for fname in ("body", "orelse", "finalbody"):
                    sub = getattr(node, fname, None)
                    if isinstance(sub, list):
                        self._index_body(sf, sub, cls, parent, prefix)
                for h in getattr(node, "handlers", []) or []:
                    self._index_body(sf, h.body, cls, parent, prefix)

    # -- resolution -------------------------------------------------------
    def expand_alias(self, dotted: str, modname: str) -> str:
        """Rewrite the leading segment through the module's import map:
        np.asarray → numpy.asarray, plane.media_plane_tick →
        livekit_server_tpu_torch.models.plane.media_plane_tick."""
        head, _, rest = dotted.partition(".")
        target = self.aliases.get(modname, {}).get(head)
        if target is None:
            return dotted
        return f"{target}.{rest}" if rest else target

    def _lookup_scoped(self, name: str, scope: FuncInfo | None,
                       modname: str) -> FuncInfo | None:
        """Python name lookup for a bare function name: enclosing closures
        outward, then module scope, then `from X import f` targets."""
        fi = scope
        while fi is not None:
            if name in fi.locals_:
                return fi.locals_[name]
            fi = fi.parent
        mod = self.module_scope.get(modname, {})
        if name in mod:
            return mod[name]
        target = self.aliases.get(modname, {}).get(name)
        if target and "." in target:
            tmod, _, tname = target.rpartition(".")
            got = self.funcs.get((tmod, tname))
            if got is not None:
                return got
        return None

    def resolve(self, expr: ast.AST, scope: FuncInfo | None,
                sf: SourceFile, _depth: int = 0) -> FuncInfo | None:
        """Resolve a callable expression to a FuncInfo, or None.

        Handles: bare names (closures → module → imports), module-alias
        attributes (plane.f), `self.method` and functools.partial(f, ...).
        """
        if _depth > 8:
            return None
        if isinstance(expr, ast.Call):
            # functools.partial(f, ...) / wraps(f) → first arg.
            # Alias-expand first: `from functools import partial as p`
            # must still unwrap.
            inner = dotted_name(expr.func)
            if inner is not None and expr.args and self.expand_alias(
                inner, sf.modname
            ).rsplit(".", 1)[-1] in ("partial", "wraps"):
                return self.resolve(expr.args[0], scope, sf, _depth + 1)
            return None
        if isinstance(expr, ast.Name):
            return self._lookup_scoped(expr.id, scope, sf.modname)
        if isinstance(expr, ast.Attribute):
            dotted = dotted_name(expr)
            if dotted is None:
                return None
            # self.method() → method of the enclosing class
            if dotted.startswith("self.") and dotted.count(".") == 1:
                fi = scope
                while fi is not None and fi.cls is None:
                    fi = fi.parent
                if fi is not None:
                    return self.funcs.get((sf.modname, f"{fi.cls}.{expr.attr}"))
                return None
            full = self.expand_alias(dotted, sf.modname)
            tmod, _, tname = full.rpartition(".")
            return self.funcs.get((tmod, tname))
        return None

    def resolve_unique(self, expr: ast.AST, scope: FuncInfo | None,
                       sf: SourceFile) -> FuncInfo | None:
        """resolve(), falling back to project-wide unique simple-name
        match for attribute calls (`self.runtime.snapshot_room` →
        PlaneRuntime.snapshot_room when only one `snapshot_room` exists).
        Used by the lock analyzer, where a missed edge hides a deadlock
        but a duplicated name would fabricate one — hence *unique* only."""
        got = self.resolve(expr, scope, sf)
        if got is not None:
            return got
        if isinstance(expr, ast.Attribute):
            cands = self.by_name.get(expr.attr, [])
            if len(cands) == 1:
                return cands[0]
        return None


def body_calls(func_node: ast.AST):
    """Yield every Call lexically inside the function body, nested
    function / lambda / class bodies included (GC03's interprocedural
    edges: a closure called under a lock runs under it)."""
    body = getattr(func_node, "body", [])
    stack = list(body) if isinstance(body, list) else [body]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))
