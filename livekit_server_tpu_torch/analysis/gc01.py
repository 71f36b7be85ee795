"""GC01 — the device state under `state_lock`.

`PlaneRuntime.state` is a tree of device tensors that the step on the
executor's thread reads and the control upload, the page-table lane and
the snapshot/restore family write in place. Any host read or write of
`self.state` (or a call into a staging method that touches it) that is
not serialized behind `state_lock` can observe a half-written state or
replace tensors under a running step — the failover race class.

The rule is lexical: the access must sit inside an
`async with ...state_lock:` block (or the explicit
`await state_lock.acquire()` … `release()` region the serving loop
uses), or the enclosing function must be allowlisted in
`[gc01] lock_held` of analysis/config.toml — functions whose *callers* are
required to hold the lock. That contract is itself checked: calling a
state method on a runtime object without the lock is a finding too.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project, qual_allowed
from livekit_server_tpu_torch.analysis.locks import analyze_function


def _scoped_classes(sf, cfg) -> set[str]:
    """Classes whose `self.state` is lock-guarded: the configured
    state classes plus any class whose body mentions a guarded lock (a
    class that carries the state lock must be using it)."""
    out = set(cfg["state_classes"])
    if sf.tree is None:
        return out
    lock_names = set(cfg["lock_names"])
    for node in sf.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr in lock_names:
                out.add(node.name)
                break
    return out


def run(project: Project, cfg: dict) -> list[Finding]:
    cg = project.callgraph
    lock_names = set(cfg["lock_names"])
    runtime_names = set(cfg["runtime_names"])
    state_attrs = set(cfg.get("state_attrs", ["state"]))
    state_methods = set(cfg["state_methods"])
    findings: list[Finding] = []

    for sf in project.under(cfg["paths"]):
        if sf.tree is None:
            continue
        scoped = _scoped_classes(sf, cfg)
        for (mod, qual), fi in cg.funcs.items():
            if mod != sf.modname or fi.parent is not None:
                continue
            if qual_allowed(fi.qual, cfg["lock_held"]):
                continue
            info = analyze_function(fi.node, lock_names)
            for node in ast.walk(fi.node):
                dotted = None
                if isinstance(node, ast.Attribute) and node.attr in state_attrs:
                    dotted = dotted_name(node)
                    kind = f"access of `{dotted}`"
                elif isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr in state_methods:
                    dotted = dotted_name(node.func)
                    kind = f"call to state method `{dotted}()`"
                if dotted is None:
                    continue
                parts = dotted.split(".")
                recv = parts[:-1]
                # self.state inside a lock-guarded class, or
                # <anything>.runtime.state / rt.state from outside it
                mine = recv == ["self"] and fi.cls in scoped
                theirs = recv and recv[-1] in runtime_names
                if not (mine or theirs):
                    continue
                if lock_names & info.held(node):
                    continue
                findings.append(
                    Finding(
                        "GC01", sf.rel, node.lineno,
                        f"{kind} outside state_lock in {fi.qual} — "
                        "the device step reads and writes the state tree",
                        hint="wrap in `async with ...state_lock:` or add the "
                        "function to [gc01] lock_held in config.toml with "
                        "a caller-holds-the-lock contract",
                    )
                )
    return findings
