"""The bench's real-time wire run (`wire_bench`) and its traffic helpers.

The production serving loop runs at real tick cadence; publishers put
raw RTP on the server's own UDP socket; the first subscriber of each
room is a sealed client whose egress carries TWCC counters and whose
reader task acks them with RTPFB fmt-15 frames through the server's real
RTCP path; the rest are cleartext clients driving the estimate channel
with REMB frames — no direct estimate injection anywhere. Per-packet
forward latency comes from the always-on ForwardLatencyProbe
(receive-batch return → native send return), so the reported p50/p99 are
wall-clock measurements that include tick-queueing wait.

`device_rtt_ms` is the round trip of a trivial operation on the device
(a launch, then `.item()`): the floor no host design removes from a tick
that reads its outputs back.
"""

from __future__ import annotations

import asyncio
import os
import socket
import threading
import time

import numpy as np
import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.models import plane


def vp8_descriptor(pid: int, tl0: int, tid: int, sbit: bool, keyframe: bool) -> bytes:
    """Minimal VP8 payload descriptor (X, I 15-bit pid, L, T) + the first
    payload byte whose P bit conveys keyframe-ness."""
    return bytes(
        [0x80 | (0x10 if sbit else 0), 0xE0, 0x80 | ((pid >> 8) & 0x7F),
         pid & 0xFF, tl0 & 0xFF, ((tid & 0x3) << 6) | 0x20,
         0x00 if keyframe else 0x01]
    )


def stage_frames(frames: list) -> tuple:
    """frames → (blob, offs int64, lens int32) in native send_raw layout."""
    lens = np.array([len(f) for f in frames], np.int32)
    offs = np.zeros(len(frames), np.int64)
    if len(frames) > 1:
        np.cumsum(lens[:-1].astype(np.int64), out=offs[1:])
    return np.frombuffer(b"".join(frames), np.uint8), offs, lens


def build_traffic_lib(ssrcs, tick_ms: int, n_ticks: int, video_kbps: float):
    """A cyclable library of per-tick publisher datagram batches.

    Each tick entry: a writable blob + per-datagram (offset, length,
    stream index, built-in SN/TS). On every reuse cycle the publisher
    patches SN/TS in place (vectorized big-endian writes) so streams stay
    continuous forever — SNs advance by each stream's per-cycle packet
    count, TS by the library's wall span.
    """
    v_pps = video_kbps * 125.0 / 1200.0          # 1200-byte video packets
    kf_every = max(1, 200 // tick_ms)            # keyframe each ~200 ms
    a_every = max(1, 20 // tick_ms)              # Opus: one packet / 20 ms
    sn_next = {i: 0 for i in range(len(ssrcs))}
    lib = []
    for tick in range(n_ticks):
        dgrams, sidx, sns, tss = [], [], [], []
        for i, (r, t, is_video, ssrc) in enumerate(ssrcs):
            if is_video:
                n = int((tick + 1) * v_pps * tick_ms / 1000.0) - int(
                    tick * v_pps * tick_ms / 1000.0
                )
                ts = (tick * 90 * tick_ms) & 0xFFFFFFFF
            else:
                n = 1 if tick % a_every == 0 else 0
                ts = (tick * 48 * tick_ms) & 0xFFFFFFFF
            for k in range(n):
                sn = sn_next[i]
                sn_next[i] += 1
                hdr = bytearray(12)
                hdr[0] = 0x80
                hdr[1] = (0x80 if k == n - 1 else 0) | (96 if is_video else 111)
                hdr[2:4] = (sn & 0xFFFF).to_bytes(2, "big")
                hdr[4:8] = ts.to_bytes(4, "big")
                hdr[8:12] = ssrc.to_bytes(4, "big")
                if is_video:
                    payload = vp8_descriptor(
                        tick & 0x7FFF, tick & 0xFF, k % 2, sbit=k == 0,
                        keyframe=tick % kf_every == 0 and k == 0,
                    ) + bytes(1100)
                else:
                    payload = bytes(80)
                dgrams.append(bytes(hdr) + payload)
                sidx.append(i)
                sns.append(sn)
                tss.append(ts)
        blob, offs, lens = stage_frames(dgrams)
        lib.append({
            "blob": blob.copy(),
            "offs": offs, "lens": lens,
            "sidx": np.array(sidx, np.int64),
            "sn0": np.array(sns, np.int64),
            "ts0": np.array(tss, np.int64),
        })
    sn_per_cycle = np.array([sn_next[i] for i in range(len(ssrcs))], np.int64)
    ts_per_cycle = np.array(
        [n_ticks * (90 if v else 48) * tick_ms for (_, _, v, _) in ssrcs],
        np.int64,
    )
    return lib, sn_per_cycle, ts_per_cycle


def patch_tick(entry, cycle: int, sn_pc, ts_pc) -> None:
    """Advance one library tick's SN/TS fields for reuse cycle `cycle`."""
    if cycle == 0 or not len(entry["offs"]):
        return
    blob, offs = entry["blob"], entry["offs"]
    s = entry["sidx"]
    sn = (entry["sn0"] + cycle * sn_pc[s]) & 0xFFFF
    ts = (entry["ts0"] + cycle * ts_pc[s]) & 0xFFFFFFFF
    blob[offs + 2] = sn >> 8
    blob[offs + 3] = sn & 0xFF
    blob[offs + 4] = ts >> 24
    blob[offs + 5] = (ts >> 16) & 0xFF
    blob[offs + 6] = (ts >> 8) & 0xFF
    blob[offs + 7] = ts & 0xFF


def device_rtt_ms(dev: torch.device, n: int = 3) -> float:
    """Median round trip of a trivial operation on `dev`: one launch and
    the `.item()` that waits for it and reads it back (the first call,
    which loads the kernel, is not counted)."""
    one = torch.zeros((), dtype=torch.int32, device=dev)
    (one + 1).item()
    rtts = []
    for _ in range(n):
        t0 = time.perf_counter()
        (one + 1).item()
        rtts.append(time.perf_counter() - t0)
    return round(float(np.median(rtts)) * 1000.0, 2)


async def wire_bench(
    dims: plane.PlaneDims,
    tick_ms: int = 5,
    duration_s: float = 8.0,
    warm_ticks: int = 30,
    video_tracks: int = 4,
    audio_tracks: int = 4,
    video_kbps: float = 3000.0,
    ack_ms: float = 25.0,
    n_slices: int = 4,
    warm_timeout_s: float = 120.0,
    low_latency: bool = False,
    egress_shards: int = 0,
    express_max_subs: int = 0,
    device="cuda",
) -> dict:
    """Real-time serving-loop measurement (module docstring): publisher →
    kernel → recvmmsg → parse/stage → device tick → egress build/seal →
    kernel send, on this process's real loopback sockets."""
    from livekit_server_tpu_torch import native
    from livekit_server_tpu_torch.runtime import PlaneRuntime
    from livekit_server_tpu_torch.runtime.crypto import (
        MediaCryptoClient,
        MediaCryptoRegistry,
    )
    from livekit_server_tpu_torch.runtime.udp import (
        build_remb,
        build_twcc_feedback,
        start_udp_transport,
    )

    dev = resolve(device)
    native_egress = native.egress
    if native_egress is None:
        raise RuntimeError("native egress library unavailable")
    rtt_ms = device_rtt_ms(dev)

    runtime = PlaneRuntime(dims, tick_ms=tick_ms, low_latency=low_latency,
                           egress_shards=egress_shards,
                           express_max_subs=express_max_subs,
                           express_max_rooms=dims.rooms, device=dev)
    reg = MediaCryptoRegistry()
    udp = await start_udp_transport(
        runtime.ingest, host="127.0.0.1", port=0, crypto=reg
    )
    # The serving wiring of RoomManager.attach_udp: the sharded egress
    # plane, the sampled arrival→wire stage split, the express lane.
    udp.attach_egress_plane(runtime.egress_plane)
    udp.wire_stages = runtime.wire_stages
    udp.mixer_device = dev
    if runtime.express is not None:
        udp.attach_express(runtime.express)
    srv_addr = udp.transport.get_extra_info("sockname")
    srv_ip, srv_port = 0x7F000001, srv_addr[1]

    def mk_sock():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.setblocking(False)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        return s

    pub_sock = mk_sock()    # all publisher streams
    ack_sock = mk_sock()    # sealed cohort sink + TWCC feedback source
    sink_sock = mk_sock()   # legacy cohort sink (never read) + REMB source

    nv = min(video_tracks, dims.tracks)
    used = min(nv + audio_tracks, dims.tracks)
    ssrcs = []
    acked = []   # (room, sub, session, client, media_ssrc)
    remb_subs = []
    for r in range(dims.rooms):
        for t in range(used):
            is_video = t < nv
            ssrc = udp.assign_ssrc(r, t, is_video)
            runtime.set_track(r, t, published=True, is_video=is_video)
            ssrcs.append((r, t, is_video, ssrc))
        for s in range(dims.subs):
            for t in range(used):
                runtime.set_subscription(r, t, s, subscribed=True)
            if s == 0:
                # Modern client: sealed egress (TWCC counters on the wire).
                sess = reg.mint()
                udp.bind_sub_session(r, s, sess)
                udp.register_subscriber(r, s, ack_sock.getsockname())
                client = MediaCryptoClient(sess.key_id, sess.key)
                acked.append([r, s, sess, client, 0])
            else:
                udp.register_subscriber(r, s, sink_sock.getsockname())
                remb_subs.append((r, s))
    # The sealed cohort announces itself (client_active latch → fb_enabled);
    # a tiny sealed RTCP RR is the hello real SDK clients send first.
    hello = bytes([0x80, 201, 0, 1]) + (0x1234).to_bytes(4, "big")
    for ent in acked:
        ack_sock.sendto(ent[3].seal(hello), ("127.0.0.1", srv_port))
    await asyncio.sleep(0.1)
    for ent in acked:
        ent[4] = udp.subscriber_ssrc(ent[0], ent[1], 0)
    kid_to_ent = {ent[2].key_id: ent for ent in acked}

    # Publisher library: 1 s of traffic, cycled with in-place SN/TS patch.
    lib, sn_pc, ts_pc = build_traffic_lib(
        ssrcs, tick_ms, max(1, 1000 // tick_ms), video_kbps
    )
    for e in lib:
        n = len(e["offs"])
        e["ips"] = np.full(n, srv_ip, np.uint32)
        e["ports"] = np.full(n, srv_port, np.uint16)
        # Slice bounds for sub-tick arrival spreading.
        e["cuts"] = np.linspace(0, n, n_slices + 1).astype(np.int64)

    # REMB blob (legacy cohort estimate channel): the frames are
    # stateless; one send_raw per interval from the sink socket.
    est_bps = 1.25 * 1000.0 * (video_tracks * video_kbps + audio_tracks * 64.0)
    remb_frames = [
        build_remb(0x42, est_bps, [udp.subscriber_ssrc(r, s, 0)])
        for (r, s) in remb_subs
    ]
    remb_blob, remb_offs, remb_lens = stage_frames(remb_frames)
    remb_ips = np.full(len(remb_frames), srv_ip, np.uint32)
    remb_ports = np.full(len(remb_frames), srv_port, np.uint16)

    # Device wall time (per in-loop call) + per-tick host work.
    dev_s = [0.0]
    orig_step = runtime._device_step

    def timed_step(*a, **kw):
        t0 = time.perf_counter()
        out = orig_step(*a, **kw)
        dev_s[0] += time.perf_counter() - t0
        return out

    runtime._device_step = timed_step
    tick_acc = [0, 0.0]  # ticks seen, Σ tick_s
    # Late-tick cause: for each deadline miss, which pipeline term
    # dominated the tick — the wake-edge overshoot, staging, the device
    # step, or fan-out (recent_ticks[-1] is this tick's record).
    late_cause = {"edge": 0, "stage": 0, "device": 0, "fanout": 0}

    def on_tick(res):
        udp.send_egress_batch(res.egress_batch, pacer_allowed=res.pacer_allowed)
        tick_acc[0] += 1
        tick_acc[1] += res.tick_s
        rec = runtime.recent_ticks[-1] if runtime.recent_ticks else None
        if rec and rec.get("late"):
            parts = {
                "edge": rec.get("edge_overshoot_us", 0.0) / 1000.0,
                "stage": rec.get("stage_ms", 0.0),
                "device": rec.get("device_ms", 0.0),
                "fanout": rec.get("fanout_ms", 0.0),
            }
            late_cause[max(parts, key=parts.get)] += 1

    runtime.on_tick(on_tick)

    stop = asyncio.Event()
    stop_thr = threading.Event()
    pub_stats = {"sent": 0, "skipped_ticks": 0}

    def publisher_thread():
        """Real-time load generator in its own OS thread: the event loop's
        long synchronous spans (receive callbacks, staging, fan-out) would
        starve a task-based pacer. Behind-schedule slices are sent in a
        burst; if the generator falls >0.5 s behind (an overloaded host),
        whole ticks are skipped and counted rather than building an
        unbounded backlog."""
        period = tick_ms / 1000.0
        slice_p = period / n_slices
        i, cycle = 0, 0
        next_at = time.perf_counter() + slice_p
        pf = pub_sock.fileno()
        while not stop_thr.is_set():
            behind = time.perf_counter() - next_at
            if behind > 0.5:
                n_skip = int(behind / period)
                pub_stats["skipped_ticks"] += n_skip
                for _ in range(n_skip):
                    next_at += period
                    i += 1
                    if i == len(lib):
                        i, cycle = 0, cycle + 1
                continue
            e = lib[i]
            patch_tick(e, cycle, sn_pc, ts_pc)
            cuts = e["cuts"]
            for sl in range(n_slices):
                lag = next_at - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
                lo, hi = int(cuts[sl]), int(cuts[sl + 1])
                if hi > lo:
                    pub_stats["sent"] += native_egress.send_raw(
                        pf, e["blob"], e["offs"][lo:hi], e["lens"][lo:hi],
                        e["ips"][lo:hi], e["ports"][lo:hi],
                    )
                next_at += slice_p
            i += 1
            if i == len(lib):
                i, cycle = 0, cycle + 1

    async def acker():
        """Sealed-cohort reader: drain egress, ack counters as RTPFB
        fmt-15 through the server's real RTCP path."""
        MAXN, MAXD = 2048, 2048
        scratch = np.zeros(MAXN * MAXD, np.uint8)
        offs = np.zeros(MAXN, np.int32)
        lens = np.zeros(MAXN, np.int32)
        ips = np.zeros(MAXN, np.uint32)
        ports = np.zeros(MAXN, np.uint16)
        af = ack_sock.fileno()
        while not stop.is_set():
            await asyncio.sleep(ack_ms / 1000.0)
            frames = []
            while True:
                nn = native_egress.rx_batch(af, scratch, offs, lens, ips, ports, MAXD)
                if nn <= 0:
                    break
                now_us = int(time.perf_counter() * 1e6)
                o = offs[:nn].astype(np.int64)
                sealed = scratch[o] == 0x01
                if sealed.any():
                    so = o[sealed]
                    kid = (
                        (scratch[so + 1].astype(np.int64) << 24)
                        | (scratch[so + 2].astype(np.int64) << 16)
                        | (scratch[so + 3].astype(np.int64) << 8)
                        | scratch[so + 4]
                    )
                    ctr = np.zeros(len(so), np.int64)
                    for b in range(8):
                        ctr = (ctr << 8) | scratch[so + 6 + b].astype(np.int64)
                    for k in np.unique(kid):
                        ent = kid_to_ent.get(int(k))
                        if ent is None:
                            continue
                        sel = np.sort(ctr[kid == k])
                        # Counters in one feedback frame must span < 2^16
                        # (ctr_off is u16): a kernel-drop gap can exceed
                        # that — split at the discontinuity.
                        lo = 0
                        while lo < len(sel):
                            hi = int(np.searchsorted(sel, sel[lo] + 0xFFFF))
                            frames.append(build_twcc_feedback(
                                0x42, ent[4],
                                [(int(c), now_us) for c in sel[lo:hi]],
                            ))
                            lo = hi
                if nn < MAXN:
                    break
            if frames:
                fb_blob, fb_offs, fb_lens = stage_frames(frames)
                native_egress.send_raw(
                    af, fb_blob, fb_offs, fb_lens,
                    np.full(len(frames), srv_ip, np.uint32),
                    np.full(len(frames), srv_port, np.uint16),
                )

    async def remb_pump():
        while not stop.is_set():
            native_egress.send_raw(
                sink_sock.fileno(), remb_blob, remb_offs, remb_lens,
                remb_ips, remb_ports,
            )
            await asyncio.sleep(0.2)

    task_errors: list[str] = []

    async def guarded(coro, name):
        """A helper task dying mid-window must surface in the record, not
        silently degrade the measurement."""
        try:
            await coro
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            task_errors.append(f"{name}: {type(e).__name__}: {e}")

    tasks = [
        asyncio.ensure_future(guarded(acker(), "acker")),
        asyncio.ensure_future(guarded(remb_pump(), "remb")),
    ]
    pub_thr = threading.Thread(target=publisher_thread, daemon=True)
    pub_thr.start()
    try:
        runtime.start()

        # Warm-up: the first ticks pay kernel loads and first launches at
        # each shape; wait for steady state.
        t0 = time.perf_counter()
        while (
            runtime.stats["ticks"] < warm_ticks
            and time.perf_counter() - t0 < warm_timeout_s
        ):
            await asyncio.sleep(0.05)

        # The build ledger's watermark: entries during the measurement
        # window below are steady-state rebuilds (reported; should be 0).
        runtime.mark_warm()
        # Measurement window: reset every counter the report reads.
        udp.fwd_latency.reset()
        udp.fwd_latency_express.reset()
        if runtime.wire_stages is not None:
            # Warm-up samples (a slow first device step) would poison the
            # stage percentiles.
            runtime.wire_stages.reset()
        dev_s[0] = 0.0
        tick_acc[0], tick_acc[1] = 0, 0.0
        for key in late_cause:
            late_cause[key] = 0
        base = {
            "ticks": runtime.stats["ticks"],
            "late": runtime.stats["late_ticks"],
            "rx": udp.stats["rx"],
            "tx": udp.stats["tx"],
            "twcc": udp.stats.get("twcc_rx", 0),
            "dropped": runtime.ingest.dropped,
            "fwd": runtime.stats["fwd_packets"],
            # Per-stage pipeline accounting (three-stage tick loop).
            "stage_s": runtime.stats.get("stage_s", 0.0),
            "device_s": runtime.stats.get("device_s", 0.0),
            "fanout_s": runtime.stats.get("fanout_s", 0.0),
            "stalls": runtime.stats.get("pipeline_stalls", 0),
        }
        t_meas = time.perf_counter()
        await asyncio.sleep(duration_s)
        wall = time.perf_counter() - t_meas
        probe = udp.fwd_latency.summary()
        probe_ex = udp.fwd_latency_express.summary()
        ticks = runtime.stats["ticks"] - base["ticks"]
        tx = udp.stats["tx"] - base["tx"]
        host_busy_s = max(tick_acc[1] - dev_s[0], 1e-9)
    finally:
        # The publisher floods the loopback: it must stop even when the
        # measurement throws, or every later bench section is corrupted.
        stop.set()
        stop_thr.set()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        pub_thr.join(timeout=2.0)
        await runtime.stop()
        runtime._device_step = orig_step
        udp.transport.close()
        pub_sock.close()
        ack_sock.close()
        sink_sock.close()

    rx = udp.stats["rx"] - base["rx"]
    dropped = runtime.ingest.dropped - base["dropped"]
    n_ticks = max(ticks, 1)

    def stage_ms(key: str) -> float:
        """Measurement-window per-tick mean of one pipeline stage."""
        return round(
            (runtime.stats.get(key, 0.0) - base[key]) / n_ticks * 1000.0, 3
        )

    out = {
        "tick_ms": tick_ms,
        "p50_wire_ms": probe["p50_ms"],
        "p99_wire_ms": probe["p99_ms"],
        "p999_wire_ms": probe["p999_ms"],
        "mean_wire_ms": probe["mean_ms"],
        "max_wire_ms": probe["max_ms"],
        "lat_samples": probe["n"],
        "late_cause": dict(late_cause),
        "sleep_bias_us": round(max(runtime._sleep_bias, 0.0) * 1e6, 1),
        "device_rtt_ms": rtt_ms,
        "ticks": ticks,
        "achieved_tick_hz": round(ticks / wall, 1) if wall else 0.0,
        "late_ticks": runtime.stats["late_ticks"] - base["late"],
        "wire_in_pps": round(rx / wall, 1),
        "wire_out_pps": round(tx / wall, 1),
        "pub_sent": pub_stats["sent"],
        "host_ms_per_tick": round(host_busy_s / max(ticks, 1) * 1000.0, 3),
        "dev_ms_per_tick": round(dev_s[0] / max(ticks, 1) * 1000.0, 3),
        # Per-stage pipeline split (runtime.stats deltas).
        "stage_ms_per_tick": stage_ms("stage_s"),
        "device_ms_per_tick": stage_ms("device_s"),
        "fanout_ms_per_tick": stage_ms("fanout_s"),
        "pipeline_depth": 0 if runtime.low_latency else 1,
        "pipeline_stalls": runtime.stats.get("pipeline_stalls", 0) - base["stalls"],
        "host_egress_pps": round(tx / host_busy_s, 1) if tx else 0.0,
        # The sharded plane's view of the same window: EMA of entries
        # over the per-tick critical-path (max-shard) send time, and the
        # share of entries served from a staged canonical.
        "plane_pps": runtime.egress_plane.observe()["host_egress_pps"],
        "plane_shards": runtime.egress_plane.shards,
        "grouped_pct": round(
            100.0 * runtime.egress_plane.stats["grouped_entries"]
            / max(runtime.egress_plane.stats["entries"], 1), 1
        ),
        "twcc_acks": udp.stats.get("twcc_rx", 0) - base["twcc"],
        "ingest_dropped_pct": round(100.0 * dropped / max(rx, 1), 2),
        "fwd_packets": runtime.stats["fwd_packets"] - base["fwd"],
        "pub_skipped_ticks": pub_stats["skipped_ticks"],
        # Sampled per-stage wire-latency decomposition (runtime/trace.py
        # LatencyAttribution): staging wait vs device step vs egress.
        "stages": (runtime.wire_stages.summary()
                   if runtime.wire_stages is not None else {}),
        # The build ledger over the run: all entries of the process, and
        # those after this runtime's mark_warm (should be 0).
        "kernel_builds_total": runtime.compile_ledger.total,
        "kernel_builds_post_warmup": runtime.post_warm_builds,
        "kernel_warmup_build_ms": round(runtime.compile_ledger.warmup_ms, 1),
        **({"task_errors": task_errors} if task_errors else {}),
    }
    trace_out = os.environ.get("BENCH_TRACE_OUT")
    if trace_out and runtime.trace is not None:
        # Perfetto-loadable dump of the tick-span ring of this run (the
        # format of /debug/trace; `trace_export --validate` checks it).
        from livekit_server_tpu_torch.telemetry import trace_export

        with open(trace_out, "w", encoding="utf-8") as fh:
            fh.write(trace_export.export_json(runtime.trace.snapshot(), tick_ms))
    if runtime.express is not None:
        # Express-tier wire latency (arrival-driven sends; no tick-queue
        # wait) beside the batched tier's, and the lane's own counters.
        out.update({
            "p50_wire_express_ms": probe_ex["p50_ms"],
            "p90_wire_express_ms": probe_ex["p90_ms"],
            "p99_wire_express_ms": probe_ex["p99_ms"],
            "p999_wire_express_ms": probe_ex["p999_ms"],
            "express_samples": probe_ex["n"],
            "express": runtime.express.debug(),
        })
    return out
