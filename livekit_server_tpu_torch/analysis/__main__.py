"""graftcheck runner for the port: the AST rules and the device contracts.

    python -m livekit_server_tpu_torch.analysis                  # rules + devicecheck
    python -m livekit_server_tpu_torch.analysis --no-devicecheck # rules only (no torch)
    python -m livekit_server_tpu_torch.analysis --json           # findings as JSON
    python -m livekit_server_tpu_torch.analysis --rules GC01,GC12
    python -m livekit_server_tpu_torch.analysis --baseline       # rewrite baseline.json
    python -m livekit_server_tpu_torch.analysis --resnapshot     # rewrite the contracts

Run it from the repository root, or anywhere: paths are taken relative
to the directory that holds the package. Config and baselines live in
`livekit_server_tpu_torch/analysis/` (config.toml, baseline.json,
devicecheck_baseline.json).

Exit codes: 0 clean, 1 findings, 2 a stale baseline entry, a baseline
entry without a reason, a stale device contract, or a config problem
(an allowlisted name the tree no longer has, an unknown rule or table).
The baseline may only shrink: a baselined finding that no longer
reproduces must be removed from the file. The same holds for inline
suppressions and for the device contracts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from livekit_server_tpu_torch.analysis import core

REPO_ROOT = Path(__file__).resolve().parents[2]


def main(argv: list[str] | None = None, root: Path = REPO_ROOT,
         config_path: Path | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m livekit_server_tpu_torch.analysis",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", action="store_true",
                    help="rewrite baseline.json from the current findings "
                         "(reasons of kept entries are kept; new ones need one)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the result as JSON")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset, e.g. GC01,GC12")
    ap.add_argument("--no-devicecheck", action="store_true",
                    help="skip the device-entry contracts (they need torch)")
    ap.add_argument("--resnapshot", action="store_true",
                    help="rewrite devicecheck_baseline.json from the live "
                         "tree (the way to land an intended contract change)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    problems: list[str] = []
    try:
        config = core.load_config(root, config_path)
    except (core.ConfigError, OSError, ValueError) as exc:
        print(f"config: {exc}", file=sys.stderr)
        return 2
    rules = None
    if args.rules:
        rules = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        bad = [r for r in rules if r not in core.RULES]
        if bad:
            print(f"unknown rules: {', '.join(bad)}", file=sys.stderr)
            return 2
    project = core.load_project(root, config.paths)
    problems += core.check_config(project, config)
    stale_suppressions: list[core.Finding] = []
    findings = core.run_all(project, config, rules, stale_suppressions=stale_suppressions)

    baseline_path = root / config.baseline
    if args.baseline:
        core.write_baseline(baseline_path, findings, project)
        print(f"baseline written: {len(findings)} finding(s) -> {config.baseline}")
        return 0

    baseline = core.load_baseline(baseline_path)
    new, stale = core.diff_baseline(findings, baseline, project)
    if rules is not None:
        # a subset run cannot tell a stale entry of a rule it skipped
        stale = [e for e in stale if e.get("rule") in rules]
    problems += [f"baseline entry without a reason: {e.get('rule')} {e.get('path')}: "
                 f"{e.get('content')}" for e in core.unjustified(baseline)]
    new = list(new) + stale_suppressions

    device_stale: list[str] = []
    device_s = 0.0
    if not args.no_devicecheck:
        from livekit_server_tpu_torch.analysis import devicecheck

        d0 = time.perf_counter()
        dev_findings, device_stale = devicecheck.run_check(
            root, config.rule("devicecheck"), resnapshot=args.resnapshot)
        device_s = time.perf_counter() - d0
        if args.resnapshot:
            print(f"devicecheck baseline rewritten ({device_s:.2f}s) -> "
                  f"{config.rule('devicecheck')['baseline']}")
        new.extend(dev_findings)

    if args.as_json:
        print(json.dumps({
            "findings": [vars(f) for f in new],
            "stale_baseline": stale,
            "stale_device_contracts": device_stale,
            "config_problems": problems,
            "baselined": len(baseline),
        }, indent=1))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"STALE baseline entry (fixed? remove it): "
                  f"{e.get('rule')} {e.get('path')}: {e.get('content')}")
        for name in device_stale:
            print(f"STALE device contract (entry gone? --resnapshot): {name}")
        for msg in problems:
            print(f"config: {msg}")
        ok = not (new or stale or device_stale or problems)
        print(f"graftcheck: {len(new)} finding(s), {len(baseline)} baselined, "
              f"{len(stale)} stale baseline entr(ies), {len(device_stale)} stale "
              f"device contract(s), {len(problems)} config problem(s), "
              f"{len(project.files)} files in {time.perf_counter() - t0:.2f}s "
              f"(devicecheck {device_s:.2f}s) — {'clean' if ok else 'FAILED'}")

    if stale or device_stale or problems:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
