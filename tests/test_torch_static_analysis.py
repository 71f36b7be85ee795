"""The port's graftcheck (livekit_server_tpu_torch/analysis): the AST
rules on fixtures, the shrink-only baseline and suppressions, the config
check, and the real-tree gate.

The rules the port carries over (GC01, GC03–GC09) are held to the
reference's own fixtures (tests/test_static_analysis.py): on every
fixture the port's rule reports the lines the reference's reports. The
port's additions — the card's host syncs under an asyncio lock (GC03) and
the torch reads of GC12 — have fixtures of their own. The reference's
analysis package is imported here only to compare; the port imports none
of it.
"""

from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import tests.test_static_analysis as ref_t  # noqa: E402
from livekit_server_tpu.analysis import core as ref_core  # noqa: E402
from livekit_server_tpu.analysis import load_project as ref_load_project  # noqa: E402
from livekit_server_tpu_torch.analysis import (  # noqa: E402
    core, diff_baseline, gc01, gc03, gc04, gc05, gc06, gc07, gc08, gc09, gc12,
    load_project, run_all, write_baseline,
)
from livekit_server_tpu_torch.analysis.__main__ import main  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT_RULES = {"gc01": gc01, "gc03": gc03, "gc04": gc04, "gc05": gc05, "gc06": gc06,
              "gc07": gc07, "gc08": gc08, "gc09": gc09}
GC04_POLL_TAIL = ref_t.GC04_POLL + ref_t.GC04_TAIL.replace("class C", "class D")

# (rule, fixture source, config overrides) — the reference's fixtures
REFERENCE_CASES = [
    ("gc01", ref_t.GC01_FIXTURE, {"lock_held": ["PlaneRuntime.__init__"]}),
    ("gc01", ref_t.GC01_FIXTURE, {"lock_held": ["PlaneRuntime.__init__",
                                                "PlaneRuntime.bad*", "Manager.bad"]}),
    ("gc01", ref_t.GC01_SPLIT_FIXTURE, {}),
    ("gc03", ref_t.GC03_FIXTURE, {"lock_names": ["a_lock", "b_lock"]}),
    ("gc04", ref_t.GC04_BAD, {}),
    ("gc04", ref_t.GC04_GOOD, {}),
    ("gc04", GC04_POLL_TAIL, {}),
    ("gc05", ref_t.GC05_FIXTURE, {}),
    ("gc06", ref_t.GC06_FIXTURE, {}),
    ("gc07", ref_t.GC07_FIXTURE, {}),
    ("gc07", ref_t.GC07_SAMPLED, {}),
    ("gc08", ref_t.GC08_BAD, {}),
    ("gc08", ref_t.GC08_LOCK_BAD, {}),
    ("gc08", ref_t.GC08_GOOD, {}),
    ("gc09", ref_t.GC09_BAD, {}),
    ("gc09", ref_t.GC09_GOOD, {}),
]


def make_project(tmp_path, files: dict[str, str], loader=load_project):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return loader(tmp_path, ["pkg"])


def cfg_for(rule: str, defaults=core.DEFAULT_CONFIG, **overrides) -> dict:
    merged = dict(defaults[rule])
    merged["paths"] = ["pkg"]
    merged.update(overrides)
    return merged


def lines(findings, rule=None):
    return sorted(f.line for f in findings if rule is None or f.rule == rule)


def run_all_pkg(project):
    config = core.Config(root=project.root, paths=["pkg"])
    config.rules = {r.lower(): {"paths": ["pkg"]} for r in core.RULES}
    return run_all(project, config)


def test_ported_rules_match_the_reference_on_its_fixtures(tmp_path):
    """Good and bad fixtures of every ported rule: the port's rule flags
    exactly the lines the reference's flags, and something is flagged on
    every bad fixture."""
    from livekit_server_tpu.analysis import gc01 as r1, gc03 as r3, gc04 as r4, gc05 as r5
    from livekit_server_tpu.analysis import gc06 as r6, gc07 as r7, gc08 as r8, gc09 as r9

    ref_rules = {"gc01": r1, "gc03": r3, "gc04": r4, "gc05": r5, "gc06": r6,
                 "gc07": r7, "gc08": r8, "gc09": r9}
    flagged = set()
    for i, (rule, src, over) in enumerate(REFERENCE_CASES):
        port_p = make_project(tmp_path / f"port{i}", {"pkg/m.py": src})
        ref_p = make_project(tmp_path / f"ref{i}", {"pkg/m.py": src}, ref_load_project)
        got = PORT_RULES[rule].run(port_p, cfg_for(rule, **over))
        want = ref_rules[rule].run(ref_p, cfg_for(rule, ref_core.DEFAULT_CONFIG, **over))
        assert lines(got) == lines(want), (i, rule, [f.render() for f in got])
        assert [f.message for f in got] == [
            f.message.replace("the state tree is donated to the device step",
                              "the device step reads and writes the state tree")
            for f in want], (i, rule)
        if got:
            flagged.add(rule)
    assert flagged == set(PORT_RULES)


GC03_SYNC_FIXTURE = """\
    import asyncio
    import torch

    class R:
        def __init__(self):
            self.state_lock = asyncio.Lock()

        async def bad(self, x, ev):
            async with self.state_lock:
                torch.cuda.synchronize()     # line 10
                n = x.sum().item()           # line 11
                y = x.cpu()                  # line 12
                ev.synchronize()             # line 13
            return n, y

        async def good(self, x):
            n = x.sum().item()               # no lock held: not GC03's
            async with self.state_lock:
                z = x + 1
            return n, z
"""


def test_gc03_card_syncs_under_an_asyncio_lock(tmp_path):
    project = make_project(tmp_path, {"pkg/r.py": GC03_SYNC_FIXTURE})
    findings = gc03.run(project, cfg_for("gc03"))
    assert lines(findings) == [10, 11, 12, 13]
    assert all("blocking call" in f.message for f in findings)


GC12_FIXTURE = """\
    import numpy as np
    import torch

    def fetch_outputs(out):
        return out.cpu().numpy()             # the seam: not flagged

    def helper(state):
        return state.sel.cpu()               # line 8: reached from the root

    def unreached(state):
        return state.item()                  # not on the tick path

    class PlaneRuntime:
        def _device_step(self, state, out, ev, counts):
            flat = fetch_outputs(out)        # the sanctioned round trip
            a = out.fwd_packets.item()       # line 16
            b = out.track_bps.tolist()       # line 17
            torch.cuda.synchronize()         # line 18
            ev.synchronize()                 # line 19
            c = np.asarray(state.meta)       # line 20
            d = float(out.x.sum())           # line 21
            e = out.y.to("cpu")              # line 22
            f = state.z.numpy()              # line 23
            g = helper(state)
            h = int(len(counts))             # host data: clean
            i = np.asarray(counts)           # host data: clean
            j = out.y.to(torch.int32)        # a dtype cast: clean
            return flat, a, b, c, d, e, f, g, h, i, j
"""


def test_gc12_torch_reads_outside_the_seams(tmp_path):
    project = make_project(tmp_path, {"pkg/rt.py": GC12_FIXTURE})
    cfg = cfg_for("gc12", roots=["PlaneRuntime._device_step"], seams=["fetch_outputs"])
    findings = gc12.run(project, cfg)
    assert lines(findings) == [8, 16, 17, 18, 19, 20, 21, 22, 23]
    assert all("reachable from `PlaneRuntime._device_step`" in f.message for f in findings)
    # without the seam, the packed fetch is a finding too (one a line)
    findings = gc12.run(project, cfg_for("gc12", roots=["PlaneRuntime._device_step"]))
    assert lines(findings) == [5, 8, 16, 17, 18, 19, 20, 21, 22, 23]


def test_suppressions_and_stale_suppressions(tmp_path):
    src = ref_t.GC05_FIXTURE.replace("# line 6: no bound", "# graftcheck: disable=GC05")
    src = src.replace("# line 7: literal unbounded", "# graftcheck: disable=GC04")
    src = src.replace("self.e = asyncio.Queue(maxsize=8)     # bounded: OK",
                      "self.e = asyncio.Queue(maxsize=8)  # graftcheck: disable=GC05")
    project = make_project(tmp_path, {"pkg/buf.py": src})
    config = core.Config(root=project.root, paths=["pkg"])
    config.rules = {r.lower(): {"paths": ["pkg"]} for r in core.RULES}
    stale: list = []
    findings = run_all(project, config, stale_suppressions=stale)
    assert lines(findings, "GC05") == [7, 8, 9]            # 6 suppressed, 7 wrong rule
    assert [(f.rule, f.line) for f in stale] == [("GC00", 7), ("GC00", 10)]
    assert all("stale suppression" in f.message for f in stale)
    whole = make_project(tmp_path / "f", {"pkg/buf.py": "# graftcheck: disable-file=GC05\n"
                                          + textwrap.dedent(ref_t.GC05_FIXTURE)})
    assert run_all_pkg(whole) == []


def test_baseline_is_shrink_only_and_justified(tmp_path):
    project = make_project(tmp_path, {"pkg/buf.py": ref_t.GC05_FIXTURE})
    findings = run_all_pkg(project)
    assert len(findings) == 4
    path = tmp_path / "baseline.json"
    write_baseline(path, findings, project)
    entries = core.load_baseline(path)
    assert len(core.unjustified(entries)) == 4              # new entries need a why
    for e in entries:
        e["why"] = "fixture"
    path.write_text(json.dumps({"version": 1, "findings": entries}))
    write_baseline(path, findings, project)                 # a rewrite keeps the whys
    entries = core.load_baseline(path)
    assert core.unjustified(entries) == []
    new, stale = diff_baseline(findings, entries, project)
    assert new == [] and stale == []
    new, stale = diff_baseline(findings[1:], entries, project)   # one fixed
    assert new == [] and len(stale) == 1
    extra = core.Finding("GC01", "pkg/buf.py", 1, "x")
    assert diff_baseline(findings + [extra], entries, project)[0] == [extra]


def _mini_repo(tmp_path, table: str, baseline: list | None = None) -> Path:
    (tmp_path / "pkg").mkdir(parents=True, exist_ok=True)
    (tmp_path / "pkg" / "rt.py").write_text(textwrap.dedent(ref_t.GC01_SPLIT_FIXTURE))
    (tmp_path / "pkg" / "buf.py").write_text(textwrap.dedent(ref_t.GC05_FIXTURE))
    cfg = tmp_path / "config.toml"
    cfg.write_text('paths = ["pkg"]\nbaseline = "baseline.json"\n'
                   '[gc01]\npaths = ["pkg"]\nlock_held = ["PlaneRuntime._upload_ctrl"]\n'
                   '[gc05]\npaths = ["pkg"]\n[gc09]\nallowed_in = []\n'
                   '[gc12]\nroots = []\n' + table)
    if baseline is not None:
        (tmp_path / "baseline.json").write_text(json.dumps({"version": 1,
                                                            "findings": baseline}))
    return cfg


def test_runner_exit_codes_and_a_stale_allowlist_name(tmp_path, capsys):
    rules = ["--no-devicecheck", "--rules", "GC05"]
    cfg = _mini_repo(tmp_path, "")
    assert main(rules, root=tmp_path, config_path=cfg) == 1           # 4 findings
    assert main(rules + ["--baseline"], root=tmp_path, config_path=cfg) == 0
    assert main(rules, root=tmp_path, config_path=cfg) == 2           # no reasons yet
    entries = core.load_baseline(tmp_path / "baseline.json")
    for e in entries:
        e["why"] = "fixture"
    cfg = _mini_repo(tmp_path, "", entries)
    assert main(rules, root=tmp_path, config_path=cfg) == 0
    cfg = _mini_repo(tmp_path, "", entries + [dict(entries[0], content="gone()")])
    assert main(rules, root=tmp_path, config_path=cfg) == 2           # stale entry
    capsys.readouterr()
    # an allowlisted name the tree does not have is a config error
    cfg = _mini_repo(tmp_path, '[gc02]\n', entries)        # no such rule here
    assert main(rules, root=tmp_path, config_path=cfg) == 2
    cfg = _mini_repo(tmp_path, "", entries)
    cfg.write_text(cfg.read_text().replace(
        'lock_held = ["PlaneRuntime._upload_ctrl"]\n',
        'lock_held = ["PlaneRuntime._upload_ctrl", "PlaneRuntime._renamed_away"]\n'
        'state_classes = ["PlaneRuntime", "Gone"]\n'))
    assert main(rules + ["--json"], root=tmp_path, config_path=cfg) == 2
    problems = json.loads(capsys.readouterr().out)["config_problems"]
    assert problems == [
        "[gc01] lock_held: `PlaneRuntime._renamed_away` names no function in the tree",
        "[gc01] state_classes: `Gone` names no class in the tree",
    ]


def test_real_tree_gate(capsys):
    """The tier-1 gate: every ported rule over livekit_server_tpu_torch/
    with no finding beyond the committed baseline, every baseline entry
    with its reason, no stale entry, no stale suppression, no stale
    allowlist name; and the runner agrees (exit 0)."""
    config = core.load_config(REPO_ROOT)
    assert config.paths == ["livekit_server_tpu_torch"]
    assert main(["--no-devicecheck", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["findings"] == [] and report["stale_baseline"] == []
    assert report["config_problems"] == []
    baseline = core.load_baseline(REPO_ROOT / config.baseline)
    assert report["baselined"] == len(baseline) and core.unjustified(baseline) == []
    assert {e["rule"] for e in baseline} == {"GC12"}
    project = load_project(REPO_ROOT, config.paths)
    assert all(not f.rel.startswith("livekit_server_tpu/") for f in project.files)
