"""GC06 — checkpoint hygiene.

Every serialized snapshot that leaves process memory (KV-bus room
checkpoints, supervisor checkpoint generations, handoff payloads) must
ride inside the utils/checksum frame: a restore path that scatters
unverified bytes into the device state turns one flipped bit into a
silently-wrong media plane. The rule enforces the mechanical half of
that contract statically: in the checkpoint-bearing modules, a function
that SERIALIZES (`pickle.dumps`, `marshal.dumps`, `np.savez*`,
`np.save`, `.tobytes()`) must also call the checksum codec
(`encode_frame`/`decode_frame` or their b64 variants) in the same
function — the codec call is the evidence the bytes were framed before
(or verified after) crossing the process boundary. Module-level
serializer calls are always flagged: there is no enclosing function to
carry the pairing.

utils/checksum.py itself is exempt (it IS the codec), as is any path in
cfg["exempt"]. Deliberate raw serialization (debug dumps) carries an
inline `# graftcheck: disable=GC06` with a justification.
"""

from __future__ import annotations

import ast

from livekit_server_tpu_torch.analysis.callgraph import dotted_name
from livekit_server_tpu_torch.analysis.core import Finding, Project


def _collect_calls(
    node: ast.AST,
    current: ast.AST | None,
    per_func: dict,
    module_calls: list,
) -> None:
    """Assign every Call to its nearest enclosing function (or the module
    body), so the codec-call pairing is judged per function scope."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            per_func.setdefault(child, [])
            _collect_calls(child, child, per_func, module_calls)
            continue
        if isinstance(child, ast.Call):
            if current is not None:
                per_func[current].append(child)
            else:
                module_calls.append(child)
        _collect_calls(child, current, per_func, module_calls)


def run(project: Project, cfg: dict) -> list[Finding]:
    serializer_calls = set(cfg["serializer_calls"])   # exact dotted names
    serializer_tails = set(cfg["serializer_tails"])   # method/function tails
    codec_calls = set(cfg["codec_calls"])
    exempt = set(cfg.get("exempt", []))

    def is_serializer(call: ast.Call) -> str | None:
        dotted = dotted_name(call.func)
        if dotted is None:
            return None
        tail = dotted.rsplit(".", 1)[-1]
        if dotted in serializer_calls or tail in serializer_tails:
            return dotted
        # `pickle.dumps` via a bound alias (`import pickle as p`) still
        # ends in `.dumps`; require a module-ish receiver so data-class
        # `.dumps` methods don't false-positive.
        if tail in ("dumps", "dump") and dotted.split(".", 1)[0] in (
            "pickle", "cPickle", "marshal"
        ):
            return dotted
        return None

    def has_codec(calls: list) -> bool:
        for call in calls:
            dotted = dotted_name(call.func)
            if dotted is not None and dotted.rsplit(".", 1)[-1] in codec_calls:
                return True
        return False

    findings: list[Finding] = []
    for sf in project.under(cfg["paths"]):
        if sf.tree is None or sf.rel in exempt:
            continue
        per_func: dict = {}
        module_calls: list = []
        _collect_calls(sf.tree, None, per_func, module_calls)
        for call in module_calls:
            dotted = is_serializer(call)
            if dotted is not None:
                findings.append(
                    Finding(
                        "GC06", sf.rel, call.lineno,
                        f"module-level `{dotted}(...)` serializes checkpoint "
                        "bytes outside any function — cannot pair with the "
                        "checksum codec",
                        hint="serialize inside a function that frames the "
                        "bytes with utils/checksum.encode_frame",
                    )
                )
        for func, calls in per_func.items():
            if has_codec(calls):
                continue
            for call in calls:
                dotted = is_serializer(call)
                if dotted is None:
                    continue
                findings.append(
                    Finding(
                        "GC06", sf.rel, call.lineno,
                        f"`{dotted}(...)` in {func.name}() serializes "
                        "checkpoint bytes without the utils/checksum codec "
                        "in the same function",
                        hint="frame the bytes with checksum.encode_frame / "
                        "encode_frame_b64 (or verify with decode_frame) "
                        "before they reach the KV bus or snapshot store; "
                        "disable with a justification if the bytes never "
                        "leave process memory",
                    )
                )
    return findings
