"""GC09 — fencing discipline for room-ownership KV state.

The fleet plane (routing/fleet.py) makes room ownership an epoch CAS:
every checkpoint/snapshot write and every pin move must ride the fenced
writer API (RoomFence.guarded_set / guarded_delete, or the KVRouter pin
movers that claim/transfer the epoch), so a stale owner's write LOSES
instead of clobbering the takeover winner's state. A raw ``bus.set`` /
``bus.delete`` on a room-checkpoint/snapshot/epoch key — or a raw
``bus.hset`` / ``bus.hdel`` on the room-pin hash — silently bypasses
the fence and reintroduces exactly the split-brain clobber the epoch
exists to prevent.

This rule flags any bus mutation whose key is a string literal (or an
f-string with a literal head) carrying a fenced prefix, or the room-pin
hash name, outside the allowlisted writer functions. Variable-keyed
calls inside the writer API itself are the sanctioned indirection and
are invisible to the rule by construction — the point is that every
LITERAL fenced key in the tree must sit behind the API.

Deliberate exceptions carry ``# graftcheck: disable=GC09`` with a
justification.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project, qual_allowed

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_KV_MUTATORS = ("set", "delete", "setnx", "cas")
_HASH_MUTATORS = ("hset", "hdel")


def _literal_head(node: ast.expr) -> str | None:
    """The literal string head of a key expression: a str constant, or
    an f-string's leading constant segment. None = not statically known
    (the sanctioned writer-API indirection passes keys as variables)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return head.value
    return None


def _iter_funcs(tree: ast.AST):
    """(qualname, function node) for every def, nested via dotted path."""
    def rec(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCS):
                qual = f"{prefix}{child.name}"
                yield qual, child
                yield from rec(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
            else:
                yield from rec(child, prefix)
    yield from rec(tree, "")


def run(project: Project, cfg: dict) -> list[Finding]:
    prefixes = tuple(cfg["fenced_prefixes"])
    pin_hashes = set(cfg["pin_hashes"])
    pin_hash_names = set(cfg["pin_hash_names"])
    allowed = cfg["allowed_in"]
    findings: list[Finding] = []
    for sf in project.under(cfg["paths"]):
        if sf.tree is None:
            continue
        for qual, fn in _iter_funcs(sf.tree):
            if qual_allowed(qual, allowed):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                dotted = dotted_name(node.func)
                if not dotted or "." not in dotted:
                    continue
                recv, tail = dotted.rsplit(".", 1)
                if "bus" not in recv.rsplit(".", 1)[-1]:
                    continue
                key = node.args[0]
                bad = ""
                if tail in _KV_MUTATORS:
                    head = _literal_head(key)
                    if head is not None and head.startswith(prefixes):
                        bad = f"key {head!r}…"
                elif tail in _HASH_MUTATORS:
                    head = _literal_head(key)
                    if head is not None and head in pin_hashes:
                        bad = f"hash {head!r}"
                    elif (
                        isinstance(key, ast.Name) and key.id in pin_hash_names
                    ):
                        bad = f"hash {key.id}"
                if not bad:
                    continue
                findings.append(
                    Finding(
                        "GC09", sf.rel, node.lineno,
                        f"unfenced bus.{tail} on ownership-fenced {bad} "
                        f"in `{qual}`",
                        hint="route room-checkpoint/snapshot/epoch writes "
                        "through RoomFence.guarded_set/guarded_delete and "
                        "pin moves through the KVRouter fenced movers, so "
                        "a stale owner's write loses the epoch CAS instead "
                        "of clobbering the takeover winner",
                    )
                )
    return findings
