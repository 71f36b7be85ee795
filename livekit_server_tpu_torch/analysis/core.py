"""graftcheck engine: finding model, source index, config, baseline.

The engine is dependency-free (ast + stdlib only), so the checker runs
wherever the package's files are: on a machine without torch, and in the
tier-1 pytest gate, where tests/test_torch_static_analysis.py runs every
rule over the port's tree and asserts zero non-baselined findings.
"""

from __future__ import annotations

import ast
import fnmatch
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

# -- finding model ----------------------------------------------------------

# GC02, GC10 and GC11 are about jax.jit wrap sites, which the port does
# not have (see analysis/__init__.py for where their purposes went).
RULES = ("GC01", "GC03", "GC04", "GC05", "GC06", "GC07", "GC08", "GC09", "GC12")

# Parse/config failures surface as findings too (rule GC00) so the runner
# has one reporting path; the runner's compileall pass catches the rest.
PARSE_RULE = "GC00"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int          # 1-based
    message: str
    hint: str = ""     # fix hint shown to the developer

    def render(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule}: {self.message}"
        if self.hint:
            s += f"  [hint: {self.hint}]"
        return s


# -- source files + suppressions -------------------------------------------

_DISABLE_RE = re.compile(r"#\s*graftcheck:\s*disable=([A-Z0-9,\s]+)")
_DISABLE_FILE_RE = re.compile(r"#\s*graftcheck:\s*disable-file=([A-Z0-9,\s]+)")


def _rule_list(raw: str) -> set[str]:
    return {r.strip() for r in raw.split(",") if r.strip()}


class SourceFile:
    """One parsed module: AST + raw lines + suppression directives."""

    def __init__(self, abspath: Path, rel: str, modname: str, text: str):
        self.abspath = abspath
        self.rel = rel
        self.modname = modname
        self.text = text
        self.lines = text.splitlines()
        self.parse_error: SyntaxError | None = None
        try:
            self.tree: ast.Module | None = ast.parse(text)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = e
        # line (1-based) → rules disabled on exactly that line
        self.line_disables: dict[int, set[str]] = {}
        self.file_disables: set[str] = set()
        for i, line in self._directive_lines():
            m = _DISABLE_FILE_RE.search(line)
            if m:
                self.file_disables |= _rule_list(m.group(1))
                continue
            m = _DISABLE_RE.search(line)
            if m:
                self.line_disables.setdefault(i, set()).update(
                    _rule_list(m.group(1))
                )

    def _directive_lines(self):
        """(lineno, comment text) for real COMMENT tokens only.

        Tokenizing (rather than scanning raw lines) keeps directive text
        quoted inside docstrings — e.g. the suppression docs in
        analysis/__init__.py — from registering as live suppressions,
        which matters now that a suppression matching no finding is
        itself an error. Falls back to the raw-line scan when the file
        doesn't tokenize (it then has a parse_error finding anyway).
        """
        try:
            return [
                (tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline
                )
                if tok.type == tokenize.COMMENT and "graftcheck" in tok.string
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return [
                (i, line)
                for i, line in enumerate(self.lines, start=1)
                if "graftcheck" in line
            ]

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_disables:
            return True
        return rule in self.line_disables.get(line, set())

    def line_content(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class Project:
    """Every scanned module, indexed by relative path and module name."""

    def __init__(self, root: Path, files: list[SourceFile]):
        self.root = root
        self.files = files
        self.by_rel = {f.rel: f for f in files}
        self.by_mod = {f.modname: f for f in files}
        self._callgraph = None

    def under(self, prefixes: list[str]) -> list[SourceFile]:
        """Files whose relative path starts with any prefix (a prefix may
        also name a single file exactly)."""
        out = []
        for f in self.files:
            for p in prefixes:
                p = p.rstrip("/")
                if f.rel == p or f.rel.startswith(p + "/"):
                    out.append(f)
                    break
        return out

    @property
    def callgraph(self):
        if self._callgraph is None:
            from livekit_server_tpu_torch.analysis.callgraph import CallGraph

            self._callgraph = CallGraph(self)
        return self._callgraph


def load_project(root: Path, paths: list[str]) -> Project:
    root = Path(root)
    files: list[SourceFile] = []
    seen: set[str] = set()
    for p in paths:
        base = root / p
        candidates = [base] if base.is_file() else sorted(base.rglob("*.py"))
        for f in candidates:
            rel = f.relative_to(root).as_posix()
            if rel in seen:
                continue
            seen.add(rel)
            modname = rel[:-3].replace("/", ".")
            if modname.endswith(".__init__"):
                modname = modname[: -len(".__init__")]
            files.append(SourceFile(f, rel, modname, f.read_text()))
    return Project(root, files)


# -- config -----------------------------------------------------------------

PKG = "livekit_server_tpu_torch"

DEFAULT_CONFIG: dict = {
    "paths": [PKG],
    "baseline": f"{PKG}/analysis/baseline.json",
    "gc01": {
        "paths": [f"{PKG}/runtime", f"{PKG}/service"],
        # self.state is guarded inside these classes — plus any class whose
        # body mentions a guarded lock (a class carrying the state lock
        # must use it).
        "state_classes": ["PlaneRuntime"],
        # attribute tails that denote a PlaneRuntime held by another object
        # (self.runtime.state, rt.state, ...)
        "runtime_names": ["runtime", "rt"],
        # methods that touch the device state on behalf of the caller —
        # calling one requires the lock exactly like touching state does.
        # The staging half (_stage_host/_schedule_probe) reads host
        # mirrors only and runs lock-free beside the device step.
        "state_methods": [
            "snapshot", "snapshot_room", "restore", "restore_room",
            "repair_room_row", "_upload_ctrl", "_device_step",
        ],
        "lock_names": ["state_lock"],
        # lock-held-by-contract: bodies may touch state because every
        # caller holds state_lock (enforced via the state_methods check).
        "lock_held": [
            "PlaneRuntime.__init__",
            "PlaneRuntime._upload_ctrl",
            "PlaneRuntime._device_step",
            "PlaneRuntime.snapshot",
            "PlaneRuntime.snapshot_room",
            "PlaneRuntime.restore",
            "PlaneRuntime.restore_room",
            "PlaneRuntime.repair_room_row",
            "IntegrityMonitor.maybe_audit",
            "FaultInjector.maybe_bitflip",
        ],
    },
    "gc03": {
        "paths": [PKG],
        "lock_names": ["state_lock", "_ckpt_lock", "_create_locks"],
        # Host syncs on the card are blocking calls too: under an asyncio
        # lock they stall every waiter until the device drains. The
        # method tails (`.item()`, `.synchronize()`, ...) are matched on
        # any receiver.
        "blocking_calls": [
            "time.sleep", "socket.create_connection", "os.system",
            "subprocess.run", "subprocess.call", "subprocess.check_output",
            "requests.", "urllib.request.", "torch.cuda.synchronize",
        ],
        "blocking_methods": ["item", "cpu", "tolist", "numpy", "synchronize"],
    },
    "gc04": {
        "paths": [f"{PKG}/routing", f"{PKG}/runtime/relay.py", f"{PKG}/service"],
        "net_errors": [
            "ConnectionError", "ConnectionResetError", "ConnectionRefusedError",
            "BrokenPipeError", "OSError", "TimeoutError", "IncompleteReadError",
            "socket.error", "asyncio.TimeoutError", "asyncio.IncompleteReadError",
        ],
        "dial_calls": [
            "asyncio.open_connection", "open_connection",
            "create_datagram_endpoint", "create_connection",
        ],
        "retry_helpers": ["retry_async", "CircuitBreaker"],
    },
    "gc05": {
        "paths": [f"{PKG}/runtime", f"{PKG}/routing"],
        "queue_calls": ["Queue", "LifoQueue", "PriorityQueue"],
        "deque_calls": ["deque"],
    },
    "gc06": {
        # Checkpoint-bearing modules: where serialized state meets the KV
        # bus or the supervisor's snapshot store.
        "paths": [
            f"{PKG}/runtime/plane_runtime.py",
            f"{PKG}/runtime/supervisor.py",
            f"{PKG}/runtime/integrity.py",
            f"{PKG}/service/roommanager.py",
            f"{PKG}/service/store.py",
            f"{PKG}/routing",
        ],
        "exempt": [f"{PKG}/utils/checksum.py"],
        "serializer_calls": [
            "pickle.dumps", "pickle.dump", "marshal.dumps", "marshal.dump",
            "numpy.save", "np.save", "torch.save",
        ],
        "serializer_tails": ["savez", "savez_compressed", "tobytes"],
        "codec_calls": [
            "encode_frame", "encode_frame_b64",
            "decode_frame", "decode_frame_b64",
        ],
    },
    "gc07": {
        # Flight-recorder emit hygiene on the tick loop and the planes it
        # drives synchronously.
        "paths": [f"{PKG}/runtime", f"{PKG}/service"],
        # method tails that are bounded non-allocating recorders — their
        # ARGUMENTS must not allocate either.
        "emit_calls": [
            "record_tick", "set_shard", "emit",
            "observe_batch", "observe_express",
        ],
        # identifier substrings that mark a decimating `if`
        "sample_guards": ["sample", "sampled", "mask", "stamped"],
    },
    "gc08": {
        # Page-handle staleness wherever device page indices are minted.
        "paths": [f"{PKG}/runtime", f"{PKG}/service"],
        "mint_calls": ["pages_of_room"],
        "revalidate_calls": ["check_epoch"],
        "lock_names": ["state_lock"],
    },
    "gc09": {
        # Fencing discipline for room-ownership KV state.
        "paths": [f"{PKG}/routing", f"{PKG}/service"],
        "fenced_prefixes": ["room_checkpoint:", "room_snapshot:", "room_epoch:"],
        "pin_hashes": ["room_node_map"],
        "pin_hash_names": ["NODE_ROOM_KEY"],
        "allowed_in": [
            "RoomFence.*",
            "KVRouter.set_node_for_room",
            "KVRouter.clear_room_state",
            "FailoverOrchestrator.run_once",
        ],
    },
    "gc12": {
        # Host-sync hygiene: blocking device reads reachable from the
        # tick path must happen only at the declared seams. Roots are
        # the per-tick methods and the device steps they call
        # through a bound attribute; seams are the sanctioned
        # device→host points (fnmatch quals).
        "paths": [f"{PKG}/runtime", f"{PKG}/models", f"{PKG}/parallel"],
        "roots": [
            "PlaneRuntime._device_step",
            "PlaneRuntime._stage_host",
            "PlaneRuntime._upload_ctrl",
            "PlaneRuntime._complete",
            "PagedPlaneRuntime._device_step",
            "PagedPlaneRuntime._live_step",
            "PagedPlaneRuntime._sync_pages",
            "PagedPlaneRuntime._upload_ctrl",
        ],
        "seams": [],
        # np.asarray / float() / int() / bool() are host-side no-ops on
        # host data; they only block when fed a device tensor. Flag them
        # when the argument mentions one of these names.
        "device_names": ["state", "out", "buf", "dec", "table"],
    },
    "devicecheck": {
        "baseline": f"{PKG}/analysis/devicecheck_baseline.json",
        # relative tolerance on the FLOP/byte tripwire: shapes and dtypes
        # compare exactly, cost drifts fail past this band.
        "cost_rtol": 0.25,
        # entries whose outputs may be fresh allocations of an input's
        # shape and dtype, each with its reason (config.toml)
        "allow_no_inplace": {},
        # input leaf size (bytes) from which a fresh output of the same
        # shape and dtype counts as a copy
        "min_inplace_bytes": 1048576,
    },
}

# Allowlists whose entries are qualified names (fnmatch patterns over
# `Class.method` / `outer.inner`) or class names: each must still name
# something in the scanned tree, or the config is stale.
QUAL_ALLOWLISTS = (("gc01", "lock_held"), ("gc09", "allowed_in"),
                   ("gc12", "roots"), ("gc12", "seams"))
CLASS_ALLOWLISTS = (("gc01", "state_classes"),)
CONFIG_FILE = f"{PKG}/analysis/config.toml"


class ConfigError(Exception):
    """The checker's config names something the tree does not have."""


@dataclass
class Config:
    root: Path
    paths: list[str] = field(default_factory=lambda: [PKG])
    baseline: str = DEFAULT_CONFIG["baseline"]
    rules: dict = field(default_factory=dict)

    def rule(self, name: str) -> dict:
        """Per-rule table: defaults overlaid with config.toml overrides."""
        merged = dict(DEFAULT_CONFIG.get(name, {}))
        merged.update(self.rules.get(name, {}))
        return merged


def load_config(root: Path, path: Path | None = None) -> Config:
    """`livekit_server_tpu_torch/analysis/config.toml` (or `path`) over
    the built-in defaults. A table naming an unknown rule is a
    ConfigError."""
    import tomllib

    p = Path(path) if path is not None else Path(root) / CONFIG_FILE
    raw = tomllib.loads(p.read_text()) if p.exists() else {}
    cfg = Config(root=Path(root))
    cfg.paths = raw.get("paths", DEFAULT_CONFIG["paths"])
    cfg.baseline = raw.get("baseline", DEFAULT_CONFIG["baseline"])
    cfg.rules = {k: v for k, v in raw.items() if isinstance(v, dict)}
    unknown = sorted(set(cfg.rules) - set(DEFAULT_CONFIG))
    if unknown:
        raise ConfigError(f"{p.name}: unknown table(s) {', '.join(unknown)}")
    return cfg


def check_config(project: Project, config: Config) -> list[str]:
    """Allowlist names that match nothing in the scanned tree (a renamed
    or deleted method left behind in the config)."""
    cg = project.callgraph
    quals = {qual for (_mod, qual) in cg.funcs}
    classes = {
        node.name for sf in project.files if sf.tree is not None
        for node in ast.walk(sf.tree) if isinstance(node, ast.ClassDef)
    }
    problems = []
    for rule, key in QUAL_ALLOWLISTS:
        for pat in config.rule(rule).get(key, []):
            if not any(fnmatch.fnmatchcase(q, pat) for q in quals):
                problems.append(f"[{rule}] {key}: `{pat}` names no function in the tree")
    for rule, key in CLASS_ALLOWLISTS:
        for name in config.rule(rule).get(key, []):
            if name not in classes:
                problems.append(f"[{rule}] {key}: `{name}` names no class in the tree")
    return problems


def qual_allowed(qual: str, patterns: list[str]) -> bool:
    """fnmatch a function qualname (`Class.method` / `outer.inner`)
    against the config allowlist."""
    return any(fnmatch.fnmatchcase(qual, pat) for pat in patterns)


# -- engine -----------------------------------------------------------------

def run_all(
    project: Project, config: Config, rules: list[str] | None = None,
    stale_suppressions: list[Finding] | None = None,
) -> list[Finding]:
    """Run the analyzers, apply per-line/file suppressions, sort.

    When `stale_suppressions` is passed, inline `# graftcheck: disable=`
    directives that suppressed NOTHING for a rule that ran are appended
    to it as GC00 findings — the shrink-only contract for the baseline,
    extended to suppressions: a directive may only exist while its
    finding does.
    """
    from livekit_server_tpu_torch.analysis import (
        gc01,
        gc03,
        gc04,
        gc05,
        gc06,
        gc07,
        gc08,
        gc09,
        gc12,
    )

    impls: dict[str, Callable[[Project, dict], list[Finding]]] = {
        "GC01": gc01.run,
        "GC03": gc03.run,
        "GC04": gc04.run,
        "GC05": gc05.run,
        "GC06": gc06.run,
        "GC07": gc07.run,
        "GC08": gc08.run,
        "GC09": gc09.run,
        "GC12": gc12.run,
    }
    findings: list[Finding] = []
    for f in project.files:
        if f.parse_error is not None:
            findings.append(
                Finding(
                    PARSE_RULE, f.rel, f.parse_error.lineno or 0,
                    f"syntax error: {f.parse_error.msg}",
                )
            )
    ran = list(rules or list(impls))
    for rule in ran:
        findings.extend(impls[rule](project, config.rule(rule.lower())))
    kept = []
    hit: set[tuple[str, int, str]] = set()      # (path, line, rule) used
    hit_file: set[tuple[str, str]] = set()      # (path, rule) used
    for fd in findings:
        sf = project.by_rel.get(fd.path)
        if sf is not None and sf.suppressed(fd.rule, fd.line):
            hit_file.add((fd.path, fd.rule))
            if fd.rule in sf.line_disables.get(fd.line, set()):
                hit.add((fd.path, fd.line, fd.rule))
            continue
        kept.append(fd)
    if stale_suppressions is not None:
        ran_set = set(ran)
        for sf in project.files:
            for line, ruleset in sorted(sf.line_disables.items()):
                for rule in sorted(ruleset & ran_set):
                    if (sf.rel, line, rule) not in hit:
                        stale_suppressions.append(Finding(
                            PARSE_RULE, sf.rel, line,
                            f"stale suppression: disable={rule} matches "
                            "no finding on this line",
                            hint="the finding it silenced is gone — "
                            "delete the directive",
                        ))
            for rule in sorted(sf.file_disables & ran_set):
                if (sf.rel, rule) not in hit_file:
                    stale_suppressions.append(Finding(
                        PARSE_RULE, sf.rel, 1,
                        f"stale suppression: disable-file={rule} matches "
                        "no finding in this file",
                        hint="the findings it silenced are gone — "
                        "delete the directive",
                    ))
    kept.sort(key=lambda fd: (fd.path, fd.line, fd.rule, fd.message))
    return kept


# -- baseline ---------------------------------------------------------------
#
# Entries key on (rule, path, stripped line content) rather than line
# numbers, so unrelated edits above a baselined finding don't churn the
# file. Identical lines are disambiguated by an occurrence counter.

def _baseline_key(fd: Finding, project: Project) -> tuple[str, str, str]:
    sf = project.by_rel.get(fd.path)
    content = sf.line_content(fd.line) if sf is not None else ""
    return (fd.rule, fd.path, content)


def load_baseline(path: Path) -> list[dict]:
    p = Path(path)
    if not p.exists():
        return []
    data = json.loads(p.read_text())
    return data.get("findings", [])


def write_baseline(path: Path, findings: list[Finding], project: Project) -> None:
    """Write the findings as the baseline, keeping the `why` of every
    entry the old baseline already justified (a new entry's `why` is
    empty, which the runner refuses until someone writes one)."""
    from collections import defaultdict

    reasons: dict[tuple, list[str]] = defaultdict(list)
    for e in load_baseline(path):
        reasons[(e.get("rule", ""), e.get("path", ""), e.get("content", ""))].append(
            e.get("why", ""))
    entries = []
    for key in sorted(_baseline_key(fd, project) for fd in findings):
        why = reasons[key].pop(0) if reasons[key] else ""
        r, p, c = key
        entries.append({"rule": r, "path": p, "content": c, "why": why})
    Path(path).write_text(
        json.dumps({"version": 1, "findings": entries}, indent=1) + "\n"
    )


def unjustified(baseline: list[dict]) -> list[dict]:
    """Baseline entries without a `why`: every accepted finding says why
    it is the design."""
    return [e for e in baseline if not str(e.get("why", "")).strip()]


def diff_baseline(
    findings: list[Finding], baseline: list[dict], project: Project
) -> tuple[list[Finding], list[dict]]:
    """→ (new findings not covered by the baseline, stale baseline entries
    whose finding no longer exists). Stale entries FAIL the run: the
    baseline may only shrink, never silently rot."""
    from collections import Counter

    have = Counter(
        (e.get("rule", ""), e.get("path", ""), e.get("content", ""))
        for e in baseline
    )
    new: list[Finding] = []
    for fd in findings:
        key = _baseline_key(fd, project)
        if have.get(key, 0) > 0:
            have[key] -= 1
        else:
            new.append(fd)
    stale = [
        {"rule": r, "path": p, "content": c}
        for (r, p, c), n in have.items()
        for _ in range(n)
        if n > 0
    ]
    return new, stale
