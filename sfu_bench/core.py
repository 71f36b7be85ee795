"""The harness: one run of one cell, driven by the data files.

A run reads `BENCHMARK.json` at the checkout's root, finds its cell, and
from the cell's names the files that define it: the configuration
(`configs/<config>.json`), the traffic mix (`traffic/<traffic>.json`,
which names its generator and the path the window drives), the path
(`paths/<path>.py`), the readers of the metrics it reports
(`metrics/<metric>.py`) and the limits of its output check
(`limits/<cell>.json`). Adding a configuration, a mix, a path or a
metric adds files and `BENCHMARK.json` entries; nothing here changes.

A run: set-up (the path builds the system under test, its inputs from
the seed, and warms up every shape it uses) → the window (a closed loop
of ticks for `seconds`) → with `trace` on, a profiled stretch of ticks →
the program's state released → the output check against the reference
→ one result line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names the run may not hold once its window has closed,
# compared whole (the port's name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "livekit_server_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result: it exits non-zero, prints none."""


def cache_dirs(root: Path = ROOT) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = root / ".bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing file: {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """`sfu_bench/<kind>/<name>.py`, imported by its file path."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"missing file: sfu_bench/{kind}/{name}.py")
    mod_name = f"sfu_bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of BENCHMARK.json with everything its names point at."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def path(self) -> str:
        return self.traffic["path"]


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_cell(name: str, manifest_: dict | None = None) -> Cell:
    manifest_ = manifest_ if manifest_ is not None else manifest()
    entries = [w for w in manifest_["workloads"] if w["name"] == name]
    if not entries:
        raise BenchError(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[0]
    cfg_entry = [c for c in manifest_["configs"] if c["name"] == entry["config"]][0]
    return Cell(
        name=name, entry=entry,
        config=read_json(ROOT / cfg_entry["file"]),
        traffic=read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in manifest_["end_to_end"] if reports(m, name)],
        per_layer=[m for m in manifest_["per_layer"] if reports(m, name)],
    )


@dataclass
class Ctx:
    """What a path's session is given."""

    cell: Cell
    seed: int
    device: object                 # torch.device
    dims: object = None            # sfu_bench.reference.tick.PlaneDims
    tick_fn: object = None         # replaces the program's tick (control, faults)


@dataclass
class Check:
    """One number the output check compares, with its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class RunRecord:
    """What the metric readers read."""

    cell: str
    dims: tuple
    setup_s: float
    window_s: float
    ticks: int
    writes: int
    tick_s: list
    layers: dict = field(default_factory=dict)
    trace: object = None           # devtrace.TraceSummary, or None
    device_name: str = ""


def dims_of(config: dict):
    from sfu_bench.reference.tick import PlaneDims

    return PlaneDims(config["rooms"], config["tracks_per_room"],
                     config["pkts_per_track_tick"], config["subs_per_room"])


def forbidden_loaded() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None,
             dims=None, tick_fn=None, t_start: float | None = None,
             out=sys.stdout, err=sys.stderr) -> dict:
    """One run; returns the result object (also printed as the last line
    of `out`). `device` None means the card, which must be there."""
    import torch

    from sfu_bench import devtrace

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(name)
    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is false: no card")
        if torch.cuda.device_count() < cell.entry["chips"]:
            raise BenchError(f"{torch.cuda.device_count()} cards; the cell asks for "
                             f"{cell.entry['chips']}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    dev_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"card: {card_line() if on_card else 'none (cpu)'}", file=out)
    ctx = Ctx(cell=cell, seed=seed, device=device, dims=dims or dims_of(cell.config),
              tick_fn=tick_fn)
    path = load_module("paths", cell.path)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    session = path.Session(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start
    speed0 = host_speed()

    # -- the window: a closed loop of ticks ------------------------------
    tick_s, tick_end = [], []
    layers0 = session.layer_totals()
    cpu0 = time.process_time()
    w0 = time.perf_counter()
    while True:
        tick_s.append(session.step())
        elapsed = time.perf_counter() - w0
        tick_end.append(elapsed)
        if elapsed >= seconds:
            break
    cpu_s = time.process_time() - cpu0
    speed1 = host_speed()
    layers1 = session.layer_totals()
    window_s = elapsed
    quarters = np.bincount(np.minimum((np.asarray(tick_end) / window_s * 4).astype(int), 3),
                           minlength=4)
    pct = np.percentile(np.asarray(tick_s) * 1e3, [5, 25, 50, 75, 95, 99])
    print(f"window: {len(tick_s)} ticks in {window_s!r} s, process cpu {cpu_s!r} s; ticks a "
          f"quarter {' '.join(str(q) for q in quarters)}; tick ms p5/25/50/75/95/99 "
          f"{' '.join(f'{x:.3f}' for x in pct)}; host speed: a fixed Python loop took "
          f"{speed0!r} s before the window and {speed1!r} s after", file=out)
    writes = session.window_writes()
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    summary = None
    if trace:
        summary = devtrace.profile(session, int(cell.traffic["trace_ticks"]), device)
    for line in session.report_lines():
        print(line, file=out)
    rec = RunRecord(
        cell=name, dims=tuple(ctx.dims), setup_s=setup_s, window_s=window_s,
        ticks=len(tick_s), writes=writes, tick_s=tick_s,
        layers={k: layers1[k] - layers0[k] for k in layers1}, trace=summary,
        device_name=dev_name,
    )
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # -- the output check, once the program's state is freed ------------
    session.release()
    c0 = time.perf_counter()
    checks, n_checked, n_bad = session.check()
    check_s = time.perf_counter() - c0
    leftover = forbidden_loaded()
    if leftover:
        raise BenchError(f"modules loaded that the run may not hold: {', '.join(leftover)}")
    correct = bool(checks) and all(c.ok for c in checks)
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": dev_name, "count": 1,
                  "memory_peak_bytes": mem_peak}
    if summary is not None:
        device_rec.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": correct, "attempted": len(tick_s), "failed": n_bad,
              "metrics": metrics, "device": device_rec}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    tally = getattr(session, "tally", None)
    full = ", ".join(str(i) for i in getattr(tally, "full", []))
    print(f"checked {n_checked} ticks of sampled rooms{f' (tick {full} at full width)' if full else ''} "
          f"in {check_s:.3f} s; {n_bad} outside a limit", file=err)
    if tally is not None:
        print(f"first integer difference: {tally.first_int or 'none'}; largest float gap "
              f"at {tally.worst or 'none'}", file=err)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return result


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_speed(n: int = 1_000_000) -> float:
    """Seconds a fixed pure-Python loop takes: the host core's speed, which
    paces a tick bound by its launches (read beside the window, outside
    it and outside set-up)."""
    t = time.perf_counter()
    x = 0
    for i in range(n):
        x += i
    return time.perf_counter() - t


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def rooms_sample(rooms: int, n: int, seed: int) -> np.ndarray:
    """`n` rooms drawn from the seed, ascending."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 17])
    return np.sort(rng.choice(rooms, size=min(n, rooms), replace=False))


def check_offset(every: int, seed: int) -> int:
    """Phase of the sampled ticks (tick i is checked when i % every equals
    it), drawn from the seed."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 29])
    return int(rng.integers(every))


def env_setup() -> None:
    """Cache directories inside the checkout; keep libraries that could
    load JAX from doing so."""
    for k, v in cache_dirs().items():
        os.environ[k] = v
        Path(v).mkdir(parents=True, exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
