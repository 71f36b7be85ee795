"""GC12 — host-sync hygiene on the tick path.

The tick's budget assumes one blocking device round trip per tick, at
the declared fetch seam. Any other blocking read — `.item()`, `.cpu()`,
`.tolist()`, `.numpy()`, `.to("cpu")`, `torch.cuda.synchronize()`,
`Event/Stream.synchronize()`, or `np.asarray`/`float()`/`int()`/`bool()`
fed a device tensor — inserts a hidden bubble: the host waits for the
card's stream to drain everything queued before it, not just the one
tensor.

The rule walks the call graph from the configured tick-path roots
(`PlaneRuntime._device_step`, the paged live step, the upload/stage
slices, and the device steps they call through a bound attribute),
skipping the declared seams, and flags blocking reads anywhere in the
reachable set. The method reads and the synchronize calls are flagged
unconditionally (`.item()` and `.tolist()` of a host array are cheap,
but the rule cannot tell a host array from a tensor, so such a site is
baselined with its reason); `np.asarray` / `np.array` / `float()` /
`int()` / `bool()` only flag when the argument mentions a
`device_names` identifier (`state`, `out`, `buf`, `dec`, `table` —
device-resident by convention on the tick path).
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project, qual_allowed

_NP_SINKS = {"numpy.asarray", "numpy.array", "numpy.copy"}
_CAST_SINKS = {"float", "int", "bool"}
_READ_METHODS = {
    "item": "a blocking scalar read",
    "cpu": "a blocking device→host copy",
    "tolist": "a blocking device→host copy",
    "numpy": "a host view that needs a device→host copy first",
}


def _mentions_device(node: ast.AST, device_names: set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in device_names:
            return True
        if isinstance(n, ast.Attribute) and n.attr in device_names:
            return True
    return False


def _to_cpu(call: ast.Call) -> bool:
    """`x.to("cpu", ...)` / `x.to(device="cpu")`."""
    args = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)


def _blocking(call: ast.Call, cg, modname: str, cfg: dict) -> str | None:
    """Reason string when this call is a blocking device read."""
    device_names = set(cfg.get("device_names", []))
    dotted = dotted_name(call.func)
    if dotted is not None:
        full = cg.expand_alias(dotted, modname)
        if full == "torch.cuda.synchronize":
            return f"`{dotted}()` waits for every stream of the card"
        if full in _NP_SINKS and call.args and _mentions_device(
            call.args[0], device_names
        ):
            return (f"`{dotted}` on a device-resident value forces a "
                    "blocking transfer")
        if full in _CAST_SINKS and call.args and _mentions_device(
            call.args[0], device_names
        ):
            return (f"`{dotted}()` on a device-resident value forces a "
                    "blocking scalar read")
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _READ_METHODS:
            return f"`.{attr}()` is {_READ_METHODS[attr]}"
        if attr == "synchronize":
            return "`.synchronize()` blocks on the card's stream"
        if attr == "to" and _to_cpu(call):
            return "`.to(\"cpu\")` is a blocking device→host copy"
    # np.asarray passed as a callback (tree_map(np.asarray, out))
    for arg in call.args:
        d = dotted_name(arg)
        if d is not None and cg.expand_alias(d, modname) in _NP_SINKS:
            if _mentions_device(call, device_names):
                return (f"`{d}` mapped over a device tree forces a "
                        "blocking transfer")
    return None


def run(project: Project, cfg: dict) -> list[Finding]:
    cg = project.callgraph
    findings: list[Finding] = []
    seams = cfg.get("seams", [])
    prefixes = tuple(p.rstrip("/") for p in cfg["paths"])
    roots = []
    for sf in project.under(cfg["paths"]):
        for (mod, qual), fi in cg.funcs.items():
            if mod == sf.modname and qual in cfg.get("roots", []):
                roots.append(fi)
    seen: set[int] = set()
    seen_sites: set[tuple[str, int]] = set()   # one finding a line
    queue = [(fi, fi.qual) for fi in roots]
    while queue:
        fi, root = queue.pop()
        if id(fi) in seen:
            continue
        seen.add(id(fi))
        sf = fi.module
        # walk the whole body incl. nested defs: closures run on the
        # same thread when called from here
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            callee = cg.resolve_unique(node.func, fi, sf)
            if callee is not None and qual_allowed(callee.qual, seams):
                continue
            why = _blocking(node, cg, sf.modname, cfg)
            if why is not None:
                key = (sf.rel, node.lineno)
                if key not in seen_sites:
                    seen_sites.add(key)
                    findings.append(Finding(
                        "GC12", sf.rel, node.lineno,
                        f"{why} on the tick path (reachable from "
                        f"`{root}`)",
                        hint="move the read to a declared seam, or defer "
                        "it off the tick thread",
                    ))
                continue
            # only descend into tick-path callees; library helpers
            # outside cfg paths are out of scope
            if callee is not None and callee.module.rel.startswith(prefixes):
                queue.append((callee, root))
    return findings
