"""Trace-ring → Chrome/Perfetto trace-event JSON exporter + validator.

The TickTraceRing (runtime/trace.py) stores per-tick span records as raw
perf_counter start/duration pairs. This module renders them in the
Chrome trace-event format (the `traceEvents` array of "X" complete
events with µs timestamps) that chrome://tracing and ui.perfetto.dev
load directly:

  pid 1, one tid per pipeline lane:
    loop    — stage_host (with the express retier nested inside),
              ctrl_upload, and a tick_edge instant marker
    device  — device_step
    fanout  — fan_out (munge+assemble) and egress_send (delivery cbs)
    shard N — per-egress-shard munge/send walls, synthesized inside the
              fan-out/send windows

`validate()` checks the schema the hard way (required fields, dur >= 0,
and strict span nesting per tid — overlap without containment is a
broken trace), and `selftest()` runs a tiny plane on the given device
for a few ticks and validates its own export.

Port of the JAX package's telemetry/trace_export.py over the port's
runtime/trace.py ring; served at /debug/trace (service/server.py).

    python -m livekit_server_tpu_torch.telemetry.trace_export --selftest [--device cpu]
    python -m livekit_server_tpu_torch.telemetry.trace_export --validate trace.json
    python -m livekit_server_tpu_torch.telemetry.trace_export --url http://127.0.0.1:7880 \
        [--ticks 120] [-o trace.json]

`--url` fetches /debug/trace from a running node, writes it to a file
loadable in ui.perfetto.dev or chrome://tracing, prints the sampled
wire-stage sidecar and validates it (`fetch`; `python -m
livekit_server_tpu_torch.tools.trace` is the same CLI with the fetch as
its default). Exit codes: 0 ok, 1 validation problems or a failed fetch,
2 bad usage.
"""

from __future__ import annotations

import json
from typing import Any

# tid lanes (Chrome sorts numerically; names land via metadata events).
TID_LOOP = 1
TID_DEVICE = 2
TID_FANOUT = 3
TID_SHARD0 = 10  # shard i → tid TID_SHARD0 + i

_LANE_NAMES = {TID_LOOP: "loop", TID_DEVICE: "device", TID_FANOUT: "fanout"}


def to_chrome(records: list[dict[str, Any]], tick_ms: int = 0) -> list[dict]:
    """Render trace-ring snapshot records as Chrome trace events."""
    if not records:
        return []
    # Time base: earliest known timestamp in the window → ts 0.
    t0s = []
    for r in records:
        for k in ("edge", "stage_t0", "upload_t0", "device_t0", "fanout_t0"):
            v = r.get(k, 0.0)
            if v > 0.0:
                t0s.append(v)
    base = min(t0s) if t0s else 0.0

    def us(t: float) -> float:
        return round((t - base) * 1e6, 1)

    def dur_us(s: float) -> float:
        return round(max(s, 0.0) * 1e6, 1)

    events: list[dict] = []
    shard_lanes = 0
    for r in records:
        tick = r["tick"]
        args = {"tick": tick, "depth": r.get("depth", 0),
                "late": bool(r.get("late", False))}
        if r.get("edge", 0.0) > 0.0:
            events.append({
                "name": "tick_edge", "ph": "I", "s": "t",
                "ts": us(r["edge"]), "pid": 1, "tid": TID_LOOP,
                "args": {"tick": tick,
                         "wake_over_us": r.get("wake_over_us", 0.0)},
            })
        if r.get("stage_t0", 0.0) > 0.0:
            events.append({
                "name": "stage_host", "ph": "X", "ts": us(r["stage_t0"]),
                "dur": dur_us(r.get("stage_s", 0.0)),
                "pid": 1, "tid": TID_LOOP, "args": args,
            })
            if r.get("retier_s", 0.0) > 0.0:
                # The retier runs first inside stage_host; its span nests
                # at the stage start.
                events.append({
                    "name": "express_retier", "ph": "X",
                    "ts": us(r["stage_t0"]),
                    "dur": min(dur_us(r["retier_s"]),
                               dur_us(r.get("stage_s", 0.0))),
                    "pid": 1, "tid": TID_LOOP, "args": {"tick": tick},
                })
        if r.get("upload_t0", 0.0) > 0.0:
            events.append({
                "name": "ctrl_upload", "ph": "X", "ts": us(r["upload_t0"]),
                "dur": dur_us(r.get("upload_s", 0.0)),
                "pid": 1, "tid": TID_LOOP, "args": {"tick": tick},
            })
        if r.get("device_t0", 0.0) > 0.0:
            events.append({
                "name": "device_step", "ph": "X", "ts": us(r["device_t0"]),
                "dur": dur_us(r.get("device_s", 0.0)),
                "pid": 1, "tid": TID_DEVICE, "args": args,
            })
            # Paged-kernel slice: the phase-0 decide dispatch nested at
            # the head of the device span (0 when the stock tick ran).
            if r.get("kernel_s", 0.0) > 0.0:
                events.append({
                    "name": "paged_kernel", "ph": "X",
                    "ts": us(r["device_t0"]),
                    "dur": dur_us(r["kernel_s"]),
                    "pid": 1, "tid": TID_DEVICE, "args": {"tick": tick},
                })
        f0 = r.get("fanout_t0", 0.0)
        if f0 > 0.0:
            fan_s = r.get("fanout_s", 0.0)
            send_s = r.get("send_s", 0.0)
            events.append({
                "name": "fan_out", "ph": "X", "ts": us(f0),
                "dur": dur_us(fan_s),
                "pid": 1, "tid": TID_FANOUT, "args": args,
            })
            if send_s > 0.0:
                events.append({
                    "name": "egress_send", "ph": "X", "ts": us(f0 + fan_s),
                    "dur": dur_us(send_s),
                    "pid": 1, "tid": TID_FANOUT, "args": {"tick": tick},
                })
            # Per-shard walls: no native start stamps, so each shard's
            # munge rides the fan-out window and its send the send
            # window, on the shard's own lane (clipped to the window).
            munge = r.get("shard_munge_ms", [])
            send = r.get("shard_send_ms", [])
            shard_lanes = max(shard_lanes, len(munge), len(send))
            for i, ms in enumerate(munge):
                if ms > 0.0:
                    events.append({
                        "name": "munge", "ph": "X", "ts": us(f0),
                        "dur": min(round(ms * 1e3, 1), dur_us(fan_s)),
                        "pid": 1, "tid": TID_SHARD0 + i,
                        "args": {"tick": tick},
                    })
            for i, ms in enumerate(send):
                if ms > 0.0:
                    events.append({
                        "name": "send", "ph": "X", "ts": us(f0 + fan_s),
                        "dur": min(round(ms * 1e3, 1), dur_us(send_s))
                        if send_s > 0.0 else round(ms * 1e3, 1),
                        "pid": 1, "tid": TID_SHARD0 + i,
                        "args": {"tick": tick},
                    })
    # Lane-name metadata events (Perfetto thread names).
    for tid, name in _LANE_NAMES.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": name},
        })
    for i in range(shard_lanes):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1,
            "tid": TID_SHARD0 + i, "args": {"name": f"egress-shard-{i}"},
        })
    return events


def validate(events: list[dict]) -> list[str]:
    """Schema + nesting checks; returns a list of problems (empty = ok)."""
    errors: list[str] = []
    spans: dict[tuple, list[tuple[float, float, str]]] = {}
    for i, e in enumerate(events):
        for field in ("name", "ph", "pid", "tid"):
            if field not in e:
                errors.append(f"event {i}: missing {field!r}")
        ph = e.get("ph")
        if ph not in ("X", "I", "M"):
            errors.append(f"event {i}: unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        if "ts" not in e or not isinstance(e["ts"], (int, float)):
            errors.append(f"event {i}: missing/non-numeric ts")
            continue
        if e["ts"] < 0:
            errors.append(f"event {i} ({e.get('name')}): negative ts")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)):
                errors.append(f"event {i} ({e.get('name')}): missing dur")
                continue
            if dur < 0:
                errors.append(f"event {i} ({e.get('name')}): negative dur")
                continue
            spans.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["ts"]) + float(dur),
                 str(e.get("name")))
            )
    # Nesting: on one tid, any two overlapping spans must be contained
    # (chrome://tracing silently mis-renders partial overlap).
    EPS = 0.11  # µs: ts/dur are rounded to 0.1 µs independently
    for (pid, tid), lst in spans.items():
        # same start → longest first, so a parent precedes the children
        # that open with it (stage_host and its nested retier share ts)
        lst.sort(key=lambda x: (x[0], -x[1]))
        stack: list[tuple[float, float, str]] = []
        for s, t, name in lst:
            while stack and stack[-1][1] <= s + EPS:
                stack.pop()
            if stack and t > stack[-1][1] + EPS:
                errors.append(
                    f"tid {tid}: span {name!r} [{s}, {t}] partially "
                    f"overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]}, {stack[-1][1]}]"
                )
            stack.append((s, t, name))
    return errors


def export_json(records: list[dict[str, Any]], tick_ms: int = 0) -> str:
    """Full Chrome trace JSON document for a ring snapshot."""
    return json.dumps(
        {"traceEvents": to_chrome(records, tick_ms),
         "displayTimeUnit": "ms"}
    )


def selftest(ticks: int = 6, device="cuda") -> list[str]:
    """Run a tiny plane on `device` ("cuda" by default; an error without
    a card) with tracing on, export, validate. Returns problems (empty =
    pass)."""
    import asyncio

    import numpy as np

    from livekit_server_tpu_torch.models import plane
    from livekit_server_tpu_torch.runtime.ingest import PacketIn
    from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime
    from livekit_server_tpu_torch.runtime.trace import EV_QUARANTINE

    dims = plane.PlaneDims(rooms=2, tracks=2, pkts=2, subs=2)
    rt = PlaneRuntime(dims, tick_ms=5, egress_shards=1, device=device)

    async def drive() -> None:
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 0, subscribed=True)
        for k in range(ticks):
            rt.ingest.push(PacketIn(room=0, track=0, sn=100 + k,
                                    ts=960 * k, size=8, payload=b"p" * 8))
            await rt.step_once()
        await rt.stop()

    asyncio.run(drive())
    problems: list[str] = []
    records = rt.trace.snapshot() if rt.trace is not None else []
    if len(records) < ticks:
        problems.append(
            f"trace ring recorded {len(records)} ticks, expected {ticks}"
        )
    doc = export_json(records, rt.tick_ms)
    parsed = json.loads(doc)
    events = parsed.get("traceEvents", [])
    if not events:
        problems.append("export produced no trace events")
    problems.extend(validate(events))
    names = {e.get("name") for e in events}
    for want in ("stage_host", "device_step", "fan_out"):
        if want not in names:
            problems.append(f"expected span {want!r} missing from export")
    # Black-box round trip: emit + dump on a lane.
    rt.blackbox.emit(0, EV_QUARANTINE, 1.0)
    dumped = rt.blackbox.dump_to(0, "selftest")
    if not dumped or dumped[-1]["event"] != "quarantine":
        problems.append("black-box emit/dump round trip failed")
    # Attribution sampler: synthetic batch through the stage decomposer.
    ws = rt.wire_stages
    if ws is not None:
        now = 100.0
        sn = np.arange(0, 4 * ws.sample_every, ws.sample_every)
        ta = np.full(len(sn), now - 0.010)
        ws.observe_batch(sn, ta, now - 0.006, now - 0.004, now)
        summ = ws.summary()
        for stage in ("staging", "device", "egress", "total"):
            if stage not in summ:
                problems.append(f"attribution stage {stage!r} not fed")
    return problems


def fetch(url: str, ticks: int = 120, out: str = "trace.json") -> int:
    """Fetch /debug/trace?ticks=N from the node at `url`, write it to
    `out`, print its wire-stage sidecar and validate it. Returns the exit
    code: 0 ok, 1 a failed fetch or validation problems."""
    import sys
    import urllib.error
    import urllib.request

    full = f"{url.rstrip('/')}/debug/trace?ticks={ticks}"
    try:
        with urllib.request.urlopen(full, timeout=10) as resp:
            doc = json.load(resp)
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"fetch failed: {full}: {e}", file=sys.stderr)
        return 1
    events = doc.get("traceEvents", [])
    problems = validate(events)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    print(f"wrote {out}: {len(events)} events ({ticks} ticks requested)")
    stages = (doc.get("otherData") or {}).get("wire_stages") or {}
    for stage, s in stages.items():
        print(f"  {stage:8s} p50={s.get('p50_ms')}ms "
              f"p99={s.get('p99_ms')}ms n={s.get('n')}")
    for p in problems:
        print(p)
    if problems:
        print(f"validation: {len(problems)} problem(s)")
        return 1
    print("load it in ui.perfetto.dev or chrome://tracing")
    return 0


def main(argv: list[str] | None = None, default_url: str | None = None,
         prog: str = "trace_export") -> int:
    """The CLI (module docstring). `default_url` makes the fetch the
    action when no other is asked for."""
    import argparse

    ap = argparse.ArgumentParser(
        prog=prog,
        description="fetch, validate or self-test the trace export",
    )
    ap.add_argument("--url", default=default_url,
                    help="base URL of a running node whose /debug/trace to fetch"
                         + (f" (default {default_url})" if default_url else ""))
    ap.add_argument("--ticks", type=int, default=120,
                    help="newest N ticks to export (default 120)")
    ap.add_argument("-o", "--out", default="trace.json",
                    help="file for the fetched trace (default trace.json)")
    ap.add_argument("--selftest", action="store_true",
                    help="run a tiny traced plane and validate its export")
    ap.add_argument("--validate", metavar="FILE",
                    help="validate an exported trace JSON file")
    ap.add_argument("--device", default="cuda",
                    help="device of the self-test's plane (cpu for the plain path)")
    args = ap.parse_args(argv)
    if args.validate:
        with open(args.validate, encoding="utf-8") as fh:
            doc = json.load(fh)
        events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
        problems = validate(events)
        for p in problems:
            print(p)
        print(f"trace: {len(events)} events, {len(problems)} problem(s)")
        return 1 if problems else 0
    if args.selftest:
        problems = selftest(device=args.device)
        for p in problems:
            print(p)
        print("trace selftest:", "FAILED" if problems else "ok")
        return 1 if problems else 0
    if args.url:
        if args.ticks <= 0:
            ap.print_usage()
            print(f"{prog}: --ticks must be positive")
            return 2
        return fetch(args.url, args.ticks, args.out)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
