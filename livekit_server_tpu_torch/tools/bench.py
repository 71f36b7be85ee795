"""Bench CLI of the port: selective forwarding on one card, device + host.

    python -m livekit_server_tpu_torch.tools.bench [--quick] [--cpu | --device DEV]

Primary metric: RTP packet *writes* per second — one write = actually
forwarding one packet to one subscriber, the unit of the reference's hot
path (`DownTrack.WriteRTP`, pkg/sfu/downtrack.go:680). The reference's own
in-code measurement is ~50 µs per write on a server CPU core
(pkg/sfu/downtrackspreader.go:96-98) ⇒ baseline 20,000 writes/s a core.
Only packets the selector forwards are counted (drops are not).

Sections, in order, each under the run's budget: `primary` (the
production tick at --rooms/--tracks/--pkts/--subs, tools/bench_device.py);
`egress_plane` and `plane_scaling` (the native sharded packet walk,
runtime/egress_plane.py); `wire_local` (this CLI again as a `--wire-only`
child at 8 rooms, tick variants 5, 2, 2e, 5e); `fleet_twin` (the traffic
twin's CLI as a child); the ladder under `configs` (cfg4 first, then
cfg1–cfg3 near the end); `wire_shape_tick`; `northstar` with the 1k-room
× 50-sub memory check; `wire`, `wire_128rooms` and `wire_ramp` (the
real-socket serving loop, tools/bench_wire.py); `paged_capacity`;
`paged_kernel`; `audio_mix` and `audio_mix_1kroom`. A section that fails
records `<section>_error` and the run goes on.

Kill-safe output: the result is re-emitted as one flushed JSON line after
every section and on SIGTERM/SIGINT (`killed_in_section` then names the
section in flight), so a deadline loses at most that section; the last
line of stdout is the result (after a full run, a compact summary).

Keys that differ from the JAX package's bench.py: `device_rtt_ms` (the
card's round trip for a trivial operation) replaces `tunnel_rtt_ms`; the
build ledger (runtime/compile_ledger.py) replaces the XLA compile cache
and watchdog: `kernel_builds_total`, `kernel_builds_post_warmup` and
`kernel_warmup_build_ms` where the reference had `xla_compiles_*`, and
`section_builds` (ledger entries a section added). The twin children run
on the bench's device (the card unless --cpu), not forced onto the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys
import time

BASELINE_WRITES_PER_SEC = 20_000.0  # the reference's ~50 µs per WriteRTP, 1 core

# -- kill-safe result emission ------------------------------------------------
#
# A caller runs the bench under a deadline and keeps the LAST complete JSON
# line of stdout, so:
#   * RESULT is global and re-emitted (one flushed JSON line) after every
#     section, so a kill at any point loses at most the section in flight;
#   * a total budget (BENCH_BUDGET_S env, --budget flag) is checked before
#     each section, with explicit `skipped` entries when it runs out;
#   * SIGTERM/SIGINT (what `timeout` sends first) re-emit and exit 0.

RESULT: dict = {}
_SECTION = ["startup"]
_SECTION_BUILDS = [0]          # the build ledger's total when the section began
_T0 = time.perf_counter()
_BUDGET = [float(os.environ.get("BENCH_BUDGET_S", "480"))]


def emit() -> None:
    # Leading newline terminates any partial line an interrupted print
    # left behind, keeping the last stdout line parseable.
    sys.stdout.write("\n" + json.dumps(RESULT) + "\n")
    sys.stdout.flush()


def _emit_raw() -> None:
    """Async-signal-safe emit: the handler may interrupt a buffered
    sys.stdout.write, and a reentrant call into BufferedWriter raises —
    os.write to fd 1 cannot."""
    os.write(1, ("\n" + json.dumps(RESULT) + "\n").encode())


def _remaining() -> float:
    return _BUDGET[0] - (time.perf_counter() - _T0)


def section_ok(name: str, est_s: float) -> bool:
    """Gate a section on the remaining budget; record the skip if not."""
    if _remaining() < est_s:
        RESULT.setdefault("skipped", {})[name] = (
            f"budget: {_remaining():.0f}s left < ~{est_s:.0f}s needed"
        )
        emit()
        return False
    _SECTION[0] = name
    _SECTION_BUILDS[0] = _ledger_total()
    return True


def section_done(name: str, t_start: float) -> None:
    RESULT.setdefault("section_s", {})[name] = round(
        time.perf_counter() - t_start, 1
    )
    RESULT.setdefault("section_builds", {})[name] = _ledger_total() - _SECTION_BUILDS[0]
    RESULT["kernel_builds_total"] = _ledger_total()
    emit()


def _ledger_total() -> int:
    from livekit_server_tpu_torch.runtime.compile_ledger import LEDGER

    return LEDGER.total


def _on_kill(signum, frame):  # noqa: ARG001
    RESULT["killed_in_section"] = _SECTION[0]
    try:
        _emit_raw()
    finally:
        os._exit(0)


def absorb_twin_json(stdout: str) -> dict:
    """Parse a twin subprocess's stdout under the last-line-JSON contract:
    the child may print anything, but its result is the LAST line that
    starts with `{` (both the wire child and the fleet traffic twin emit
    incrementally, so a timeout kill loses at most the step in flight).
    Raises ValueError when no JSON line survived — the caller records
    that as the section error rather than crashing the bench."""
    lines = [ln for ln in (stdout or "").strip().splitlines()
             if ln.startswith("{")]
    if not lines:
        raise ValueError("twin produced no JSON")
    return json.loads(lines[-1])


def _run_wire(result_key: str, dims, tick_ms: int, duration_s: float,
              device, **kw) -> dict | None:
    """One wire_bench run into RESULT[result_key]; errors are recorded,
    never raised (a wire failure must not take down earlier numbers)."""
    from livekit_server_tpu_torch.tools.bench_wire import wire_bench

    try:
        wire = asyncio.run(wire_bench(dims, tick_ms=tick_ms, duration_s=duration_s,
                                      device=device, **kw))
        RESULT[result_key] = wire
        return wire
    except Exception as e:  # noqa: BLE001
        RESULT[result_key + "_error"] = f"{type(e).__name__}: {e}"
        return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="livekit_server_tpu_torch.tools.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--rooms", type=int, default=128)
    ap.add_argument("--tracks", type=int, default=8)
    ap.add_argument("--pkts", type=int, default=16)
    ap.add_argument("--subs", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--budget", type=float, default=None,
                    help="total seconds (default: BENCH_BUDGET_S env or 480)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every section (default cuda)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path); same as --device cpu")
    ap.add_argument("--quick", action="store_true",
                    help="primary metric only (skip the other sections)")
    ap.add_argument("--wire-only", action="store_true",
                    help="run only the real-time wire bench; print its JSON")
    ap.add_argument("--wire-seconds", type=float, default=8.0)
    ap.add_argument("--wire-tick-ms", type=str, default="5",
                    help="tick_ms for the wire bench; comma list runs "
                         "multiple variants (--wire-only mode); a trailing "
                         "'e' turns the express lane on for that variant")
    ap.add_argument("--wire-rooms", type=int, default=32)
    ap.add_argument("--wire-kbps", type=float, default=3000.0)
    ap.add_argument("--wire-low-latency", action="store_true",
                    help="complete egress in-tick (PlaneRuntime low_latency)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.budget is not None:
        _BUDGET[0] = args.budget

    from livekit_server_tpu_torch.device import resolve

    try:
        device = resolve("cpu" if args.cpu else args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2

    signal.signal(signal.SIGTERM, _on_kill)
    signal.signal(signal.SIGINT, _on_kill)

    from livekit_server_tpu_torch.models import plane
    from livekit_server_tpu_torch.tools import bench_device as bd

    if device.type == "cuda":
        from livekit_server_tpu_torch.ops import cuda

        cuda.build()              # every kernel, in parallel, before any timing

    # Variant specs: "5,2,2e" — a trailing 'e' runs that tick rate with
    # the express lane enabled (express_max_subs = the wire shape's subs,
    # so every room is eligible).
    wire_specs = [s.strip() for s in str(args.wire_tick_ms).split(",")]
    wire_ticks = [int(s.rstrip("e")) for s in wire_specs]

    if args.wire_only:
        # Child mode: every requested tick variant in one process.
        for spec, t in zip(wire_specs, wire_ticks):
            key = "wire" if spec == wire_specs[0] else f"wire_tick{spec}"
            _SECTION[0] = key
            dims_w = plane.PlaneDims(args.wire_rooms, 8, 8, 6)
            _run_wire(key, dims_w, t, args.wire_seconds, device,
                      video_kbps=args.wire_kbps, low_latency=args.wire_low_latency,
                      express_max_subs=dims_w.subs if spec.endswith("e") else 0)
            emit()
        return 0

    # -- primary metric (always; it IS the scoreboard line) ---------------
    _SECTION[0] = "primary"
    t_sec = time.perf_counter()
    dims = plane.PlaneDims(args.rooms, args.tracks, args.pkts, args.subs)
    spec = bd.DEFAULT_SPEC
    RESULT.update({
        "metric": "sfu_pkt_sub_writes_per_sec_per_chip",
        "value": 0.0,
        "unit": "writes/s",
        "vs_baseline": 0.0,
        "counted": "forwarded (pkt × subscriber) writes; drops excluded",
        "device": str(device),
        "device_name": torch_device_name(device),
    })
    emit()  # a diagnosable record exists from the first seconds on
    try:
        primary = bd.device_bench(dims, spec, args.ticks, args.warmup, device=device)
        RESULT.update({
            "value": primary["fwd_writes_per_s"],
            "vs_baseline": round(primary["fwd_writes_per_s"] / BASELINE_WRITES_PER_SEC, 2),
            "evaluated_per_s": primary["evaluated_per_s"],
            "device_tick_ms": primary["device_tick_ms"],
        })
        if primary.get("dispatch_bound"):
            RESULT["dispatch_bound"] = True
    except Exception as e:  # noqa: BLE001 — a primary crash must still
        # leave a parseable record on stdout.
        RESULT["primary_error"] = f"{type(e).__name__}: {e}"
    _SECTION_BUILDS[0] = 0
    section_done("primary", t_sec)
    if args.quick:
        return 0

    # -- sharded egress plane microbench (host packet walk, no device) ----
    # Datagrams/s through the native sharded assemble(+seal) walk on a
    # wire-shaped batch (32 rooms × 6 subs × 4 video tracks × 7 pkts at
    # 1100 B ≈ the wire bench's video load a tick); clear vs sealed makes
    # the AES share visible.
    if section_ok("egress_plane", 20):
        t_sec = time.perf_counter()
        try:
            from livekit_server_tpu_torch.runtime.egress_plane import bench_plane_scaling

            RESULT["egress_plane"] = ep = egress_plane_section()
            # Shard-scaling curve: N shards on N cores, sealed walk; a
            # 1-CPU host records a single (flagged) point.
            if (os.cpu_count() or 1) > 1 and section_ok("plane_scaling", 10):
                ep["scaling"] = bench_plane_scaling(
                    payload_len=1100, sealed=True, seconds_per_point=1.0, **PLANE_SHAPE)
            RESULT["host_egress_pps"] = ep["pps_clear_build"]
        except Exception as e:  # noqa: BLE001
            RESULT["egress_plane_error"] = f"{type(e).__name__}: {e}"
        section_done("egress_plane", t_sec)

    # Section order is by information value under the budget: the wire
    # child and the two headline device shapes (cfg4, north star) come
    # before the wire variants, the tiny ladder configs and the mixes.

    # -- the wire bench in a child process --------------------------------
    # This CLI again with --wire-only at 8 rooms × 1.5 Mbps, tick variants
    # 5, 2, 2e and 5e in one process, on the bench's device.
    if section_ok("wire_local", 100):
        t_sec = time.perf_counter()
        try:
            budget = max(min(_remaining() - 20, 200), 45)
            cmd = [sys.executable, "-m", "livekit_server_tpu_torch.tools.bench",
                   "--wire-only", "--device", str(device),
                   "--wire-seconds", str(args.wire_seconds),
                   "--wire-tick-ms", f"{wire_ticks[0]},2,2e,5e",
                   "--wire-rooms", "8", "--wire-kbps", "1500"]
            try:
                cp = subprocess.run(cmd, capture_output=True, text=True, timeout=budget)
                absorb_wire_child(cp.stdout)
            except subprocess.TimeoutExpired as e:
                # The child emits incrementally too: salvage what it
                # printed before the timeout killed it.
                RESULT["wire_local_error"] = "TimeoutExpired"
                out = e.stdout
                if out:
                    absorb_wire_child(out.decode() if isinstance(out, bytes) else out)
        except Exception as e:  # noqa: BLE001
            RESULT["wire_local_error"] = f"{type(e).__name__}: {e}"
        section_done("wire_local", t_sec)

    # -- fleet traffic twin (capacity/SLO envelope) -----------------------
    # The twin's CLI as a child: Scenario.standard(seed 20, 60 ticks) on two
    # nodes over a loopback bus, swept over four offered loads; it drives
    # virtual time through admission → governor → plane → egress and
    # emits a partial curve after every load.
    if section_ok("fleet_twin", 90):
        t_sec = time.perf_counter()
        try:
            budget = max(min(_remaining() - 20, 240), 60)
            cmd = [sys.executable, "-m", "livekit_server_tpu_torch.runtime.traffic_twin",
                   "--seed", "20", "--ticks", "60", "--nodes", "2",
                   "--loads", "0.5,1.0,2.0,4.0", "--device", str(device)]
            try:
                cp = subprocess.run(cmd, capture_output=True, text=True, timeout=budget)
                RESULT["fleet_twin"] = absorb_twin_json(cp.stdout)
            except subprocess.TimeoutExpired as e:
                RESULT["fleet_twin_error"] = "TimeoutExpired"
                out = e.stdout
                if out:
                    RESULT["fleet_twin"] = absorb_twin_json(
                        out.decode() if isinstance(out, bytes) else out)
        except Exception as e:  # noqa: BLE001
            RESULT["fleet_twin_error"] = f"{type(e).__name__}: {e}"
        section_done("fleet_twin", t_sec)

    # -- BASELINE.md ladder (device throughput) ---------------------------
    configs = RESULT.setdefault("configs", {})

    def run_ladder(name):
        d, s, est = bd.LADDER[name]
        if not section_ok(name, est):
            return
        t_sec = time.perf_counter()
        try:
            r = bd.device_bench(d, s, ticks=15, warmup=3, device=device)
            configs[name] = r["fwd_writes_per_s"]
            configs[name + "_tick_ms"] = r["device_tick_ms"]
            if r.get("dispatch_bound"):
                configs[name + "_dispatch_bound"] = True
        except Exception as e:  # noqa: BLE001
            configs[name] = f"error: {type(e).__name__}"
            RESULT[name + "_error"] = f"{type(e).__name__}: {e}"
        section_done(name, t_sec)

    # cfg4 first: it is the ladder's load-bearing rung.
    run_ladder("cfg4_1krooms_10p_mixed_svc")
    RESULT["cfg5_note"] = "multi-node: the fleet_twin section and chip_smoke.py's migration phase"

    # -- device tick at the wire shape ------------------------------------
    if section_ok("wire_shape_tick", 30):
        t_sec = time.perf_counter()
        try:
            r = bd.device_bench(*bd.WIRE_SHAPE, ticks=50, warmup=5, device=device)
            RESULT["wire_shape_device_tick_ms"] = r["device_tick_ms"]
            if r.get("dispatch_bound"):
                RESULT["wire_shape_dispatch_bound"] = True
        except Exception as e:  # noqa: BLE001
            RESULT["wire_shape_error"] = f"{type(e).__name__}: {e}"
        section_done("wire_shape_tick", t_sec)

    # -- north-star tick: the full 10k-rooms × 50-subs plane on one card --
    if section_ok("northstar", 80):
        t_sec = time.perf_counter()
        try:
            r = bd.device_bench(*bd.NORTH_STAR, ticks=5, warmup=1, device=device)
            RESULT["northstar_10240rooms_50subs_tick_ms"] = r["device_tick_ms"]
            RESULT["mem_1k_rooms_50subs_ok"] = True  # 10k×50 subsumes it
            for key in ("peak_mem_gib", "device_free_gib", "device_total_gib"):
                if key in r:
                    RESULT[f"northstar_{key}"] = r[key]
        except Exception as e:  # noqa: BLE001
            RESULT["northstar_error"] = f"{type(e).__name__}: {e}"
            # 10k failing says nothing about 1k×50: measure the smaller
            # claim on its own before reporting False.
            try:
                release(device)
                bd.device_bench(*bd.MEM_1K, ticks=2, warmup=1, device=device)
                RESULT["mem_1k_rooms_50subs_ok"] = True
            except Exception as e1:  # noqa: BLE001
                RESULT["mem_1k_rooms_50subs_ok"] = False
                RESULT["mem_error"] = f"{type(e1).__name__}: {e1}"
        release(device)
        section_done("northstar", t_sec)

    # -- the real-time wire bench at the wire shape -----------------------
    # 32 rooms × 6 subs within the loopback path's capacity (the dense
    # primary shape over-subscribes loopback and would measure socket
    # queueing, not the server).
    if section_ok("wire", 75):
        t_sec = time.perf_counter()
        wire = _run_wire("wire", plane.PlaneDims(32, 8, 8, 6), wire_ticks[0],
                         args.wire_seconds, device)
        if wire:
            RESULT["p50_wire_ms"] = wire["p50_wire_ms"]
            RESULT["p99_wire_ms"] = wire["p99_wire_ms"]
            # End-to-end (tick-scheduled, socket-backed) egress rate; the
            # isolated packet walk is RESULT["host_egress_pps"].
            RESULT["wire_host_egress_pps"] = wire["host_egress_pps"]
            RESULT["kernel_builds_post_warmup"] = wire["kernel_builds_post_warmup"]
        section_done("wire", t_sec)

    # -- wire bench at 128-room scale -------------------------------------
    # Loopback's sender-inline delivery caps total wire bytes, so scale
    # rooms while trimming per-room load (2 × 500 kbps video + 4 audio ×
    # 4 subs).
    if section_ok("wire_128rooms", 75):
        t_sec = time.perf_counter()
        wire_big = _run_wire("wire_128rooms", plane.PlaneDims(128, 6, 8, 4), wire_ticks[0],
                             args.wire_seconds, device,
                             video_tracks=2, audio_tracks=4, video_kbps=500.0)
        if wire_big:
            RESULT["p99_wire_128rooms_ms"] = wire_big["p99_wire_ms"]
        section_done("wire_128rooms", t_sec)

    # -- wire-shape ramp: rooms up until the serving loop breaks ----------
    if section_ok("wire_ramp", 120):
        t_sec = time.perf_counter()
        RESULT["wire_ramp"] = wire_ramp(wire_ticks[0], args.wire_seconds, device)
        section_done("wire_ramp", t_sec)

    # -- ladder configs 1-3 (small shapes; flagged when launch-bound) -----
    run_ladder("cfg1_1room_2p_audio")
    run_ladder("cfg2_1room_50p_audio")
    run_ladder("cfg3_1room_25p_vp8_simulcast")

    # -- paged capacity at a realistic room-size distribution -------------
    if section_ok("paged_capacity", 10):
        t_sec = time.perf_counter()
        try:
            rec, ratio, rooms = bd.paged_capacity(args.pkts, device=device)
            RESULT["paged_capacity"] = rec
            RESULT["paged_vs_dense_rooms_ratio"] = ratio
            RESULT["rooms_per_chip_realistic"] = rooms
        except Exception as e:  # noqa: BLE001
            RESULT["paged_capacity_error"] = f"{type(e).__name__}: {e}"
        section_done("paged_capacity", t_sec)

    # -- ragged pooled tick: pay compute only for live pages --------------
    if section_ok("paged_kernel", 120):
        t_sec = time.perf_counter()
        try:
            RESULT["paged_kernel"] = bd.paged_kernel_bench(device=device)
            RESULT["paged_kernel_tick_ms"] = RESULT["paged_kernel"]["tick_ms_full"]
        except Exception as e:  # noqa: BLE001
            RESULT["paged_kernel_error"] = f"{type(e).__name__}: {e}"
        section_done("paged_kernel", t_sec)

    # -- batched audio mix (ops/mix — BASELINE config 2's MCU seat) -------
    if section_ok("audio_mix", 25):
        t_sec = time.perf_counter()
        try:
            RESULT["audio_mix_50p_tick_ms"] = bd.audio_mix_bench(device=device)
        except Exception as e:  # noqa: BLE001
            RESULT["audio_mix_error"] = f"{type(e).__name__}: {e}"
        section_done("audio_mix", t_sec)

    # -- batched audio mix at the 1000-room MCU shape ---------------------
    if section_ok("audio_mix_1kroom", 30):
        t_sec = time.perf_counter()
        try:
            RESULT["audio_mix_1kroom_tick_ms"] = bd.audio_mix_1kroom_bench(device=device)
        except Exception as e:  # noqa: BLE001
            RESULT["audio_mix_1kroom_error"] = f"{type(e).__name__}: {e}"
        section_done("audio_mix_1kroom", t_sec)

    RESULT["bench_total_s"] = round(time.perf_counter() - _T0, 1)
    emit()
    # Compact summary, printed last: headline scalars only (the full
    # record is the emit() line above it).
    sys.stdout.write(json.dumps(summary()) + "\n")
    sys.stdout.flush()
    return 0


# The wire bench's video load a tick: 32 rooms × 6 subs × 4 tracks × 7 packets.
PLANE_SHAPE = dict(n_rooms=32, subs_per_room=6, tracks=4, pkts=7)


def egress_plane_section() -> dict:
    """Clear 1100 B, sealed 1100 B and sealed 160 B (audio) walks on all
    local cores at PLANE_SHAPE; raises unless every shard of every run
    built entries."""
    from livekit_server_tpu_torch import native
    from livekit_server_tpu_torch.runtime.egress_plane import EgressPlane, bench_plane

    ep = EgressPlane(0)
    # Warm pass (discarded): pool spin-up and page faults on the scratch
    # and out buffers land here, not in the measurement.
    bench_plane(ep, payload_len=1100, sealed=False, seconds=0.5, **PLANE_SHAPE)
    clear = max(
        (bench_plane(ep, payload_len=1100, sealed=False, seconds=2.0, **PLANE_SHAPE)
         for _ in range(2)),
        key=lambda r: r.get("pps", 0.0),
    )
    sealed = bench_plane(ep, payload_len=1100, sealed=True, seconds=2.0, **PLANE_SHAPE)
    audio = bench_plane(ep, payload_len=160, sealed=True, seconds=1.5, **PLANE_SHAPE)
    for r in (clear, sealed, audio):
        if "error" in r or not all(r["shard_built"]):
            raise RuntimeError(f"bench_plane: {r}")
    return {
        "shards": ep.shards,
        "pool_size": native.egress.pool_size(),
        "pps_clear_build": clear["pps"],
        "pps_sealed_build": sealed["pps"],
        "pps_sealed_160B": audio["pps"],
        "grouped_pct": sealed["grouped_pct"],
        "entries_per_call": sealed["entries_per_call"],
    }


def absorb_wire_child(stdout: str) -> None:
    """The wire child's variants into RESULT; the headline latency is the
    express tier's when an express variant carried samples (the serving
    configuration an interactive room gets), the batched one beside it."""
    twin = absorb_twin_json(stdout)
    RESULT["wire_local"] = twin.get("wire")
    RESULT["wire_local_tick2"] = twin.get("wire_tick2")
    RESULT["wire_local_express"] = twin.get("wire_tick2e")
    RESULT["wire_local_express_tick5"] = twin.get("wire_tick5e")
    for key, val in twin.items():
        if key.endswith("_error"):
            RESULT[f"wire_local_{key}"] = val
    if RESULT["wire_local"]:
        RESULT["p99_wire_local_ms"] = RESULT["wire_local"]["p99_wire_ms"]
    express_runs = [(spec, twin.get(f"wire_tick{spec}") or {}) for spec in ("2e", "5e")]
    express_runs = [(spec, w) for spec, w in express_runs if w.get("express_samples")]
    if express_runs:
        spec, best = min(express_runs, key=lambda sw: sw[1]["p99_wire_express_ms"])
        RESULT["p99_wire_local_batched_ms"] = RESULT.get("p99_wire_local_ms")
        RESULT["p99_wire_local_ms"] = best["p99_wire_express_ms"]
        RESULT["p99_wire_local_express_variant"] = f"tick{spec}"


def wire_ramp(tick_ms: int, wire_seconds: float, device) -> dict:
    """The wire shape at 32, 48, 64, 96 and 128 rooms until late ticks pass
    10 % of the window or ingest drops pass 5 %; the last clean rung is
    the rooms one node serves end to end. A first rung that breaks on
    lateness at a short tick is re-run once at a 20 ms tick, so that the
    ramp reports the serving ceiling rather than the device deadline."""
    from livekit_server_tpu_torch.models import plane

    steps: list[dict] = []
    max_ok = 0
    rungs = [32, 48, 64, 96, 128]
    i = 0
    while i < len(rungs):
        rooms = rungs[i]
        if _remaining() < 35:
            RESULT.setdefault("skipped", {})["wire_ramp_tail"] = (
                f"budget: stopped before {rooms} rooms")
            break
        w = _run_wire(f"wire_ramp_{rooms}_t{tick_ms}", plane.PlaneDims(rooms, 8, 8, 6),
                      tick_ms, min(wire_seconds, 4.0), device)
        if w is None:
            break
        late_pct = round(100.0 * w["late_ticks"] / max(w["ticks"], 1), 1)
        steps.append({"rooms": rooms, "tick_ms": tick_ms, "late_pct": late_pct,
                      "ingest_dropped_pct": w["ingest_dropped_pct"],
                      "wire_out_pps": w["wire_out_pps"],
                      "host_egress_pps": w["host_egress_pps"]})
        RESULT["wire_ramp"] = {"steps": steps, "max_rooms_ok": max_ok, "tick_ms": tick_ms}
        emit()
        if late_pct > 10.0 or w["ingest_dropped_pct"] > 5.0:
            if max_ok == 0 and tick_ms < 20:
                tick_ms = 20
                continue
            break
        max_ok = rooms
        i += 1
    return {"steps": steps, "max_rooms_ok": max_ok, "tick_ms": tick_ms}


def release(device) -> None:
    """Hand cached device memory back between the large sections."""
    import gc

    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def torch_device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


SUMMARY_KEYS = ("metric", "value", "unit", "vs_baseline", "device_tick_ms",
                "device", "device_name", "host_egress_pps", "wire_host_egress_pps",
                "p50_wire_ms", "p99_wire_ms", "p99_wire_local_ms",
                "northstar_10240rooms_50subs_tick_ms", "wire_shape_device_tick_ms",
                "audio_mix_50p_tick_ms", "audio_mix_1kroom_tick_ms",
                "paged_kernel_tick_ms", "rooms_per_chip_realistic",
                "paged_vs_dense_rooms_ratio", "kernel_builds_total", "bench_total_s")


def summary() -> dict:
    """The headline scalars of RESULT, the egress plane, the ramp's
    ceiling, the twin's capacity curve, the wire stage split and the build
    ledger of the preferred wire run, every `*_error` and the skips."""
    out = {"summary": True}
    for key in SUMMARY_KEYS:
        if key in RESULT:
            out[key] = RESULT[key]
    if "egress_plane" in RESULT:
        out["egress_plane"] = RESULT["egress_plane"]
    if "wire_ramp" in RESULT:
        out["wire_ramp_max_rooms_ok"] = RESULT["wire_ramp"].get("max_rooms_ok", 0)
    if "fleet_twin" in RESULT:
        ft = RESULT["fleet_twin"]
        out["fleet_twin"] = {
            "capacity_knee_load": ft.get("capacity_knee_load"),
            "steps": [
                {
                    "load": s.get("offered_load"),
                    "admission_rate": s.get("admission_rate"),
                    "audio_continuity": s.get("audio_continuity"),
                    "dup_wire_packets": s.get("dup_wire_packets"),
                    "wire_p99_ms": s.get("wire_p99_ms"),
                    "rung_residency": s.get("rung_residency"),
                    "recovery_ticks": s.get("recovery_ticks"),
                }
                for s in ft.get("steps", [])
            ],
        }
    for wk in ("wire_local", "wire"):
        st = (RESULT.get(wk) or {}).get("stages")
        if st:
            out["wire_stages"] = {s: {"p50_ms": v.get("p50_ms"), "p99_ms": v.get("p99_ms")}
                                  for s, v in st.items()}
            break
    for wk in ("wire_local", "wire"):
        w = RESULT.get(wk) or {}
        if "kernel_builds_post_warmup" in w:
            out["kernel_builds_post_warmup"] = w["kernel_builds_post_warmup"]
            out["kernel_warmup_build_ms"] = w.get("kernel_warmup_build_ms")
            break
    errors = {k: v for k, v in RESULT.items() if k.endswith("_error")}
    if errors:
        out["errors"] = errors
    if "skipped" in RESULT:
        out["skipped"] = sorted(RESULT["skipped"])
    return out


if __name__ == "__main__":
    raise SystemExit(main())
