#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (livekit_server_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--profile]

Every launch check below takes its expected counts from `dense_launches`
and `paged_launches`: each stock tick launches B1 (decide_rooms), B2
(allocate_budget_rooms) and the RTP-stats kernel (rtpstats_rooms) once, and
a paged live step B3 (paged_kernel) and B2 once.

Phases (any failure exits non-zero; about fifteen minutes on an H100):

  1. build    — compile every CUDA kernel with nvcc (one process per
                source, in parallel); print each kernel's registers and
                spills (ptxas -v) and the card's name and power limit;
  2. parity   — each dense-tick kernel against its plain PyTorch version on
                the card, seeded inputs, at PlaneDims(4, 4, 8, 40),
                (1024, 10, 8, 10) and (10240, 8, 16, 50); then the live-page
                kernel (decide_pages, mix_pages, decide_mix_pages, mix
                blocks of MIX_N samples) at page geometries (P, TP, K, SP)
                (16, 2, 4, 4) with padded duplicate live rows, (64, 8, 8,
                32) (mask bit 31) and the full 65536-page pool of
                PAGED_TIMING_DIMS filled from the room-size mix; integers,
                bools and floats (the float32 budget, the mix) must be equal
                bit for bit; at the full pool, the mix entries' device time
                (a CUDA graph of MIX_GRAPH_LAUNCHES kernel launches) and
                call time beside their byte bounds;
  3. runtime  — a PlaneRuntime at PlaneDims(1024, 10, 8, 10) (1k rooms ×
                10 participants, 2 VP9-SVC video + 2 Opus tracks per room)
                fed RUNTIME_TICKS ticks of seeded traffic through
                IngestBuffer.push_batch; forwarded packets must be > 0,
                each dense kernel's launch count must equal the tick count,
                and the first CHECK_TICKS ticks of rooms 0..7 must equal a
                CPU run of the port at PlaneDims(8, 10, 8, 10) fed the same
                packets (integers exact; floats within
                plane.float_tolerance of each leaf);
  4. paged    — a PagedPlaneRuntime (live-extent tick, kernel on) at
     runtime    PAGED_RUNTIME_DIMS, rooms admitted from bench.py's size mix
                (80 % 2–4, 15 % 5–10, 5 % 50 participants; each publishes
                one track, the first two VP9-SVC video, and subscribes to
                all others) until the pool refuses, PAGED_TICKS ticks, every
                other room released and the pool compacted at
                PAGED_RELEASE_TICK; forwarded packets > 0, the launch counts
                as stated in `paged_runtime_phase`, and the first
                CHECK_TICKS ticks of rooms 0..7 equal to a CPU
                PagedPlaneRuntime in LOGICAL form;
  5. serving  — the serving path through the layers that need no aiohttp,
                msgpack or PyYAML: a Config() with the port overlay,
                RoomManager on the card, rtc rooms and the pipelined loop
                (RoomManager.start → PlaneRuntime._run). Dense: the
                runtime phase's PlaneDims(1024, 10, 8, 10), 10,240
                participants joined through RoomManager.start_session
                with MessageChannel sinks, 2 VP9-SVC video + 2 Opus
                publishers a room (add_track over the signal channel, the
                track bound as a first media frame binds it), everyone
                auto-subscribed, a feeder task pushing one seeded synth
                tick into runtime.ingest per loop tick, SERVING_SECONDS of
                loop. Paged: PAGED_RUNTIME_DIMS, rooms from the size mix,
                each participant publishing one track, at least
                SERVING_PAGED_TICKS loop ticks. Checks: the kernels
                launched once per loop tick (the paged dead-page key adds
                its 1-page stock tick), every Opus packet of the first
                SAMPLE_ROOMS rooms whose tick completed reaches every
                other participant's media queue exactly once with
                consecutive munged sns and never its publisher, and every
                media frame decodes with the port's codec into the fields
                `_attach_media_queue` writes. Reports ticks, late ticks,
                pipeline stalls, stage/device/fan-out/send ms and the
                whole tick's ms, their sum (median, p90), the loop's wall
                time per tick, forwarded packets and the join time;
  5b. udp    — the reference's default media wire: each native library
                (native/csrc/*.cpp) built with g++ and loaded (the build
                lines, which libcrypto was mapped, whether media is sealed
                are printed; a library that did not load fails the run);
                a RoomManager on the card with the UDP transport on an
                ephemeral loopback port (RoomManager.attach_udp), its
                participants joined through start_session, publishers
                bound by `add_track` with `transport: udp`, subscribers
                latched by sealed punches from a few sink sockets, every
                media datagram sealed when the process has an AEAD backend.
                Dense at the runtime phase's PlaneDims(1024, 10, 8, 10):
                UDP_LOCK_TICKS lockstep ticks (step_once) against a CPU
                RoomManager of rooms 0..7 fed the same seeded RTP (VP9-SVC
                with a dependency descriptor, Opus with an audio level),
                every opened egress datagram of those rooms equal byte for
                byte (the SSRC, random per node, through the subscriber and
                track it names), retransmissions of subscriber NACKs and
                probe padding included; then the pipelined loop for
                UDP_SECONDS with a publisher process sending one seeded
                synth tick of sealed datagrams per loop tick. Paged: the
                size mix at PAGED_RUNTIME_DIMS for at least UDP_PAGED_TICKS
                loop ticks. Checks the launches (B1 and B2 once per dense
                tick; B3 once per paged tick, B2 once more per dead-page
                key); reports the loop's wall ms per tick, ticks/s, the
                late share, median and p90 of each piece, forward latency
                (the transport's packet-in → wire-out probe), datagrams sent
                by the publishers, received by the server, sent (`tx`,
                `tx_drop`) and received at the sinks, and the egress shards;
  5c. express — the express lane (runtime/express.py) and the media relay
     and relay  (runtime/relay.py), both off by default: two RoomManagers on
                the card at cfg4's PlaneDims(1024, 10, 8, 10) with their
                UDP transports on loopback, one with the lane on
                (express_max_subs EXPRESS_MAX_SUBS, express_max_rooms
                EXPRESS_MAX_ROOMS) and its media relay started, one with
                the lane off; EXPRESS_ROOMS seeded rooms of 2–4
                participants, p0 publishing VP8 simulcast (VP8_LAYERS
                SSRCs) and p1 Opus over `transport: udp`, everyone
                subscribed over UDP; on the lane's node the publishers of
                RELAY_ROOMS reach it only through the relay, with tokens
                their `request_relay` minted. EXPRESS_LOCK_TICKS lockstep
                ticks (step_once on both, one room pinned to the batched
                tier for a few ticks): every subscriber's opened datagrams
                equal on both nodes byte for byte but the SSRC, B1 and B2
                launched once per tick on each node, at least one
                promotion; then the lane's node's real-time loop for
                EXPRESS_SECONDS, launches once per tick. Reports the
                promotions, demotions and express datagrams, the selector
                mirror read's ms, forward latency p50/p99 of the express
                tier beside the batched tier's from the same loop, and the
                relay's allocations, forwarded datagrams and drops. Then
                the golden scans (ops/rtpmunger.py, ops/vp8.py, ops/svc.py
                dd_select_tick) on CUDA tensors against their CPU runs and
                the host munger on the same seeded packets, all equal;
  5d. gateway — the WebRTC gateway (runtime/webrtc_gateway.py, interop/):
                a RoomManager on the card at cfg4's PlaneDims(1024, 10, 8,
                10) with its UDP transport on loopback, media sealed as in
                5b; GATEWAY_ROOMS rooms joined through start_session, each
                with a stock publisher and a stock subscriber built from
                the port's interop modules (their own certificates, ICE
                credentials, the OpenSSL DTLS client role, RFC 7714 SRTP)
                whose SDP offers (`offer` over the signal channel) go
                through the gateway, and a sealed UDP subscriber; the
                publisher offers Opus and VP8, simulcast (a=ssrc-group:SIM
                of VP8_LAYERS SSRCs) in the first GATEWAY_SIM_ROOMS rooms.
                Every answer must be ICE-lite and every subscriber answer
                must declare the SSRCs the node sends it; all 16 STUN +
                DTLS handshakes must complete; then the real-time loop for
                GATEWAY_TICKS ticks with seeded SRTP media (a VP8 gap at
                GATEWAY_GAP_TICK for an upstream NACK, SRTCP receiver
                reports from the subscribers). Checks: per room, the
                gateway subscriber's SRTP-opened RTP equal to the sealed
                subscriber's AEAD-opened RTP byte for byte but the SSRC,
                which must be the declared one; srtp_bad, stun_bad and
                plaintext_drop 0; every SRTCP report opened; each
                publisher opens SRTCP from the node; B1 and B2 once per
                tick; after the leaves, no peer, binding or SRTP
                subscriber left. Reports handshake ms and the gateway's
                handle_datagram ms a handshake, srtp_rx, srtp_tx,
                srtcp_rx, host µs per protect and unprotect, and forward
                latency (publisher send → subscriber receive, on the
                host's clock) of the gateway lane beside the sealed
                lane's from the same run. Before the phases, the
                `libraries` line names libssl.so.3, libcrypto.so.3 and
                libopus.so.0 as mapped, the OpenSSL version and
                `cryptography`'s; without libssl.so.3 the run fails;
  5e. mixer   — the MCU seat's device programs (ops/mix.py decode_tick and
                encode_ulaw, runtime/mixer.py _device_mix) on the card,
                each held to the same function on a CPU copy of the same
                seeded inputs, bit for bit: decode_tick on every byte under
                each codec and on a seeded [1000, 4, 960] payload of mixed
                codec ids; encode_ulaw on seeded PCM carrying every µ-law
                segment edge ±1 LSB and ±full scale, then decode_tick of
                its bytes; _device_mix at bench.py's audio_mix_1kroom
                shape MIXER_SHAPE (seed 3, tracks present with p 0.8,
                exclusions in 0..T), rounded, clipped and cast to int16,
                equal to the numpy int32 sum with self-exclusion. Reports
                each one's device ms (a CUDA graph, as the kernels), call
                ms with its operands' copies both ways, and its byte bound.
                The Opus seat: without libopus.so.0 the transport's
                enable_audio_mixer must raise OpusError, as the
                reference's does, and the line says "not run: libopus.so.0
                absent"; with it, an AudioMixer on MIXER_OPUS_ROOMS rooms
                takes the device path and must emit the datagrams of the
                host path byte for byte. The services (agents, egress,
                ingress, SIP, ioinfo) import aiohttp, which the card's
                machine lacks: no phase runs them, as none runs the server;
  5f. shard   — room and page shards (parallel/mesh.py) on the one card:
                SHARD_N = 8 shards of cuda:0 (and N = 1) at the north star,
                SHARD_CHECK_TICKS seeded ticks against the unsharded device
                step (integers and bools equal, floats within
                plane.float_tolerance; whether they were bit-equal too is
                reported), the sharded plane's snapshot frame against the
                unsharded one and restored onto a fresh mesh that ticks on
                equal, B1 and B2 timed at the shard launch shapes
                [1280, 8, 16, 50] and [1280, 50, 8], and the three device
                steps timed (median, p90); a cfg4 RoomManager over 8 room
                shards and an unsharded one in lockstep for
                SHARD_LOCK_TICKS ticks (every egress column equal; B1 and B2
                launched SHARD_N times a tick); the stock pooled step at
                PAGED_RUNTIME_DIMS over 8 page shards against the unsharded
                stock step, with its cross-shard page copies counted. The
                line carries the card and torch.cuda.device_count();
  5g. twin    — the traffic twin (runtime/traffic_twin.py) on nodes of
                the port's node stack (service/stack.py: no HTTP, no media
                port) at cfg4's width, TWIN_PLANE (1024 rooms, 10 tracks,
                8 packets, 10 subscribers, 10 ms ticks), stepped in virtual
                time. (a) The flash-crowd drill of tests/test_twin_drills.py
                (seed 29, 80 ticks, one node) on the card and on this
                machine's CPU: both SLO dicts (`deterministic_dict`) and
                governor transitions equal to each other and to the JAX
                package's (TWIN_FLASH_REFERENCE), the ladder one rung at a
                time to L4 and back, joins refused with `overload`, no
                audio gap, no duplicate, a finite recovery. (b) bench.py
                fleet_twin's sweep through `capacity_curve`:
                Scenario.standard(TWIN_SEED, TWIN_TICKS) on TWIN_NODES
                nodes in this process over a port BusServer on loopback,
                loads TWIN_LOADS, a fresh cluster a load; per load no
                duplicate and no gap, every migration a commit with no
                rollback or timeout, the drained node empty, no recovery of
                -1, joins admitted. B1 and B2 launch once per step of every
                node in both. (c) The trace export's self-test on the card
                and the tick-span ring of a sweep node, both valid.
                Reports each load's SLO dict, the capacity knee, wall s,
                step_once ms per node (median, p90) and the drain's ticks;
  5h. tooling — the port's own tooling (livekit_server_tpu_torch/analysis,
                native/poolcheck.py): (a) the native egress pool on the
                card's host, POOL_STRESS_CALLS build-only calls for each
                shard-count sequence 2; 3; 3,2; 2,3, each under a
                POOL_WATCHDOG_S watchdog: every call's `sent` equal to its
                entries and every shard's `built` to its range (C12);
                (b) every registered device entry once on the card at the
                canonical dims (devicecheck.canonical_dims) through its
                hand kernels: output shapes and dtypes equal to the
                committed analysis/devicecheck_baseline.json, the in-place
                contract held with the card's storages, and each of the
                four kernels launched;
  5i. bench   — the port's bench and profiling tools
                (livekit_server_tpu_torch/tools/, the egress plane's
                microbench): (a) the bench's device window
                (tools/bench_device.py: unpack → media_plane_tick →
                pack_tick_outputs over a pool of packed inputs on the
                device, counters summed there) at bench.py's default
                PlaneDims(128, 8, 16, 16) for BENCH_WINDOW_TICKS ticks on
                the card through the hand kernels and on this machine's
                CPU through the plain path from the same seed: forwarded
                writes, evaluated pairs and the integer checksum of the
                packed outputs equal, the float words' sum within
                BENCH_FLOAT_RTOL, B1 and B2 launched once a tick; then
                `device_bench` (writes/s, ms a tick) at the default dims,
                cfg4 and the north star; (b) `profile_tick.profile` at
                cfg4 and the north star: each block's ms (graph or event
                time, per block), the blocks' sum beside the full tick;
                (c) `bench_plane` clear 1100 B, sealed 1100 B and sealed
                160 B on the bench's wire-shaped batch and
                `bench_plane_scaling` (every shard of every point built
                entries; the pool's size beside each point); (d)
                `wire_bench` at PlaneDims(32, 8, 8, 6) at a 5 ms tick and
                at a 2 ms tick with the express lane, BENCH_WIRE_SECONDS
                each: no helper task error, latency samples (the express
                tier's in the second, where every room is in the lane), 0
                ledger entries after its mark_warm; (e) `python -m
                livekit_server_tpu_torch.tools.bench --quick` as a child:
                its last line JSON with the primary metric, value > 0 and
                no `*_error` key; (f) `trace_export --selftest --device
                cuda`;
  6. timing   — the dense runtime's device step (plane.device_tick: upload,
                tick, fetch) at the north-star PlaneDims(10240, 8, 16, 50),
                median and p90 of TIMED_TICKS ticks after warm-up; the paged
                runtime's live-extent device step (paged.live_step) at
                PAGED_TIMING_DIMS at full occupancy and after releasing half
                the rooms; each kernel's own time beside its byte bound and
                its plain version's time, at every launch shape of each
                path: decide_rooms, allocate_budget_rooms and
                rtpstats_rooms on the north-star tick's operands,
                paged_kernel on a live step's
                at full and at half occupancy (65536 and 32768 grid steps),
                allocate_budget_rooms ([65536, 8, 64]) on the full-pool
                live step's (each first held equal to its plain version), and
                decide_rooms, allocate_budget_rooms and rtpstats_rooms at
                the dead-page key's one-page shape (each first held equal
                to its plain version). A
                kernel's `ms` is device time: a
                CUDA graph of GRAPH_LAUNCHES launches of the wrapper, inputs
                captured from a real tick, replayed between a CUDA event
                pair, so the wrapper's host work (checks, allocation, the
                ctypes call) is not in it; `call_ms` is one wrapper call
                between an event pair, host work included;
  7. failure  — the failure and overload plane: `integrity.audit_plane`
                on the card held to the same function on a CPU copy
                (mask, counts and new mirror equal) on the north-star
                state (clean, then one room corrupted per rule: nonfinite,
                range, cursor regression beside a legitimate reset, ctrl,
                bounds), on the cfg4 drill state, and on a paged pool at
                PAGED_RUNTIME_DIMS with `map_audit_mask` and a corrupted
                page-table row (BIT_TABLE, the row repaired); the audit's
                device time at the north star, cfg4 and the 65536-page pool
                beside its byte bound and the device step it rides on; a
                checkpoint round (snapshot, encode, decode, restore) at
                cfg4 and the north star, the restore bit-equal to the
                snapshot; the bitflip drill (exactly the flipped room
                quarantined and repaired, 0 escalations, the next audit
                clean) and the stall drill (restarts = stalls, cause
                `stall`, ticks advancing, the abandoned steps committing
                nothing) on a cfg4 RoomManager's loop; and the WS cfg4 (≥
                DEFAULT_CFG4_TICKS) and paged (≥ DEFAULT_PAGED_TICKS, or
                until the supervisor gives up, DEFAULT_LOOP_CAP_S at most)
                loops under the reference's default config (supervisor,
                integrity and governor on), every subscriber sending a
                receiver estimate each tick (a clean state: no
                `integrity` restart and no violation may occur), reporting
                restarts and causes, `gave_up`, integrity escalations, the
                governor's level and transitions, audits and their share of
                the wall, and checkpoint ms. The serving and UDP
                phases above keep those three subsystems off, so their
                numbers compare with earlier runs;
  8. migration — the multi-node plane (`migration_phase`): a port
                BusServer on loopback and three nodes, each its own
                process on the card, a KVRouter on a TCPBusClient and a
                cfg4 RoomManager under the reference's default config
                (supervisor, integrity, migration and fleet on, kv.kind
                tcp; the governor off, see `migration_config`), joined
                through start_session, fed one seeded synth tick and
                every subscriber's receiver estimate per loop tick. Node A
                hosts 128 rooms, B 128. Live migration of 8 rooms A → B
                one at a time (each moved row on B bit-equal to A's freeze
                snapshot, every leaf and the munger lanes; every Opus
                packet of those rooms delivered once to every other
                participant with consecutive munged SNs across the
                cutover; A's rows released); B SIGKILLed and its 136 rooms
                restored on A from its KV checkpoints (every room once,
                each row equal to the checkpoint generation it decoded;
                a room that came back without its state fails); node C
                joins, runs the reference's default governor on its loop
                for a while (its ladder, and whether a PREPARE is NACKed),
                and A is drained into it (every room moves, A refuses
                admissions meanwhile and ends with no room and no row).
                Reports PREPARE→COMMIT and freeze-window ms, bridged
                packets, timeouts, retries, rollbacks, the time to recover
                beside kv.lease_ttl_s + kv.failover_interval_s, the
                drain's time and rooms per second, and per node the
                checkpoint rounds (ms, bytes, rounds past the interval),
                lease refresh lateness, event-loop lag, self-fencing,
                restarts by cause and the loop's wall ms per tick. Each
                node's B1 and B2 launches equal its steps plus the steps
                in flight (at most 2).

Output: JSON lines per phase (the serving phase's under "serving", the
UDP phase's under "udp", phase 5c's under "express" and "golden_scans",
the gateway's under "gateway" (the libraries under "libraries"),
phase 5e's under "mixer", phase 5f's under "shard", phase 5g's under "twin",
the tooling's under "tooling", phase 5i's under "bench", the failure
phase's under "failure", the multi-node plane's under "migration"), the
build ledger under
"build_ledger" (runtime/compile_ledger.py: nvcc and g++ builds and new
kernel launch shapes with their seconds, and for every serving loop
that marks warm — the WS, UDP and default-config loops, the failure
drills, express, gateway, each twin node, each migration node and phase
5i's two wire runs — the
entries between its mark_warm and the end of its loop, which must be 0),
a
`{"kernels": [...]}` JSON line (each kernel's numbers on its own path,
`launches_by_path` its launches on every path, the serving loop's
included, its ptxas registers and spill bytes,
and under `paths` its launch shape, launches, device, call and plain
times and bound on each path that launches it — paged_kernel's
half-occupancy launch under `half` and its mix entries under `mix`;
paged_kernel's `ms` is its launch alone and `wrapper_ms` the whole
decide_pages call, whose gathers of the selector targets are torch ops),
the card line from nvidia-smi, and as the last line
`{"ok": true, "device": {...}}`.
`--profile` adds torch.profiler breakdowns (device time by kernel) of a
few north-star dense ticks and a few full-pool paged steps.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import multiprocessing
import re
import select
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from livekit_server_tpu_torch import native
from livekit_server_tpu_torch.analysis import core as graftcheck, devicecheck
from livekit_server_tpu_torch.config.config import Config, load_config, port_overlay
from livekit_server_tpu_torch.interop import dtls as dtls_mod, sdp as sdp_mod, stun as stun_mod
from livekit_server_tpu_torch.models import paged, plane, synth
from livekit_server_tpu_torch.ops import (
    allocation, bwe, cuda, pacer, paged_kernel, rtpmunger, rtpstats, selector, svc, vp8,
)
from livekit_server_tpu_torch.ops.mix import MIX_TOP_K
from livekit_server_tpu_torch.parallel import mesh as mesh_mod
from livekit_server_tpu_torch.protocol import decode_signal_response, packer
from livekit_server_tpu_torch.routing import LocalNode, LocalRouter, MessageChannel
from livekit_server_tpu_torch.runtime import PlaneRuntime, dd, integrity, traffic_twin
from livekit_server_tpu_torch.runtime import crypto as crypto_mod, udp as udp_mod
from livekit_server_tpu_torch.native import poolcheck
from livekit_server_tpu_torch.runtime.compile_ledger import LEDGER
from livekit_server_tpu_torch.runtime.ingest import PacketIn
from livekit_server_tpu_torch.runtime.munge import HostMunger
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime
from livekit_server_tpu_torch.runtime.pager import RoomPager
from livekit_server_tpu_torch.runtime.relay import BIND_ACK, BIND_REQ, RELAY_MAGIC
from livekit_server_tpu_torch.runtime.slots import CapacityError
from livekit_server_tpu_torch.service.roommanager import CHECKPOINT_TTL_S, RoomManager
from livekit_server_tpu_torch.service.store import LocalStore
from livekit_server_tpu_torch.telemetry import trace_export
from livekit_server_tpu_torch.telemetry.service import TelemetryService
from livekit_server_tpu_torch.tools import bench as bench_cli
from livekit_server_tpu_torch.tools import bench_device, bench_wire, profile_tick
from livekit_server_tpu_torch.tools.timing import (
    GRAPH_LAUNCHES, card_line, event_ms, graph_ms, percentiles, quantiles,
)
from livekit_server_tpu_torch.utils.logger import configure

SEED = 7
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (NVIDIA data sheet)
PARITY_SHAPES = (
    plane.PlaneDims(4, 4, 8, 40),
    plane.PlaneDims(1024, 10, 8, 10),
    plane.PlaneDims(10240, 8, 16, 50),
)
RUNTIME_DIMS = plane.PlaneDims(1024, 10, 8, 10)
RUNTIME_SPEC = synth.TrafficSpec(video_tracks=2, audio_tracks=2, tick_ms=20,
                                 video_kbps=1500, svc=True)
RUNTIME_TICKS = 40
CHECK_TICKS = 5
CHECK_ROOMS = 8
NORTH_STAR = plane.PlaneDims(10240, 8, 16, 50)
NORTH_STAR_SPEC = synth.TrafficSpec(video_tracks=2, audio_tracks=6, tick_ms=20,
                                    video_kbps=1500, svc=True)
TIMED_TICKS = 100
WARMUP_TICKS = 5
KERNEL_REPS = 50
MIX_GRAPH_LAUNCHES = 3             # the mix writes 2 GB a launch at the full pool
PLAIN_REPS = 5

KERNELS = {
    "decide_rooms": dict(
        source="livekit_server_tpu_torch/csrc/decide_rooms.cu",
        replaces="livekit_server_tpu/ops/selector.py:213",
    ),
    "allocate_budget_rooms": dict(
        source="livekit_server_tpu_torch/csrc/budget_rooms.cu",
        replaces="livekit_server_tpu/ops/allocation.py:174",
    ),
    "paged_kernel": dict(
        source="livekit_server_tpu_torch/csrc/paged_kernel.cu",
        replaces="livekit_server_tpu/ops/paged_kernel.py:82",
    ),
    "rtpstats_rooms": dict(
        source="livekit_server_tpu_torch/csrc/rtpstats_rooms.cu",
        replaces=None,          # XLA code in the JAX package, no Pallas kernel
    ),
}

# The kernels a stock `_room_tick` launches once each (B1, B2 and the
# RTP-stats kernel); a paged live step launches B3 and B2 alone.
DENSE_KERNELS = ("decide_rooms", "allocate_budget_rooms", "rtpstats_rooms")


def dense_launches(ticks: int) -> dict:
    """Expected `cuda.launches` after `ticks` stock ticks of the dense plane."""
    return {**dict.fromkeys(DENSE_KERNELS, ticks), "paged_kernel": 0}


def paged_launches(steps: int, keys: int) -> dict:
    """Expected `cuda.launches` after `steps` paged live steps and `keys`
    dead-page keys (each one 1-page stock tick)."""
    return {**dict.fromkeys(DENSE_KERNELS, keys), "paged_kernel": steps,
            "allocate_budget_rooms": steps + keys}

# Paged plane (the live-extent tick). Page geometries (P, TP, K, SP) of the
# kernel parity phase; the full-width pool of PAGED_TIMING_DIMS is added to
# them. SP=32 sets mask bit 31.
PAGE_GEOMS = ((16, 2, 4, 4), (64, 8, 8, 32))
MIX_N = 960                        # 20 ms of 48 kHz audio per mix block
PAGED_RUNTIME_DIMS = paged.PagedDims(rooms=2048, tracks=64, pkts=8, subs=64,
                                     tpage=4, spage=8, pool_pages=8192)
PAGED_TIMING_DIMS = paged.PagedDims(rooms=16384, tracks=64, pkts=8, subs=64,
                                    tpage=4, spage=8, pool_pages=65536)
# Up to 2 VP9-SVC video tracks per room, the rest Opus; participant t
# publishes track t. Rooms use only their first `size` tracks.
PAGED_SPEC = synth.TrafficSpec(video_tracks=2, audio_tracks=62, tick_ms=20,
                               video_kbps=1500, svc=True)
PAGED_TICKS = 40
PAGED_RELEASE_TICK = 20
PAGED_TIMED_TICKS = 30
ROOM_MIX_SEED = 9
# Serving path (RoomManager + the pipelined loop): the dense run's length,
# the paged run's least loop ticks, the rooms whose audio delivery is
# checked, and a wall-clock cap on either run.
SERVING_SECONDS = 5.0
SERVING_PAGED_TICKS = 4
SAMPLE_ROOMS = 8
SERVING_TRACE_TICKS = 4096
SERVING_WALL_CAP_S = 240.0


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# One record a serving loop that marked warm: the build-ledger entries
# between its runtime's mark_warm and the end of its loop (must be 0).
LOOP_LEDGER: list[dict] = []


def loop_ledger(name: str, rt: PlaneRuntime) -> dict:
    """Record, at the end of `rt`'s loop, the ledger entries since its
    mark_warm (the watermark is the runtime's, the ledger the process's:
    call it before the next loop's runtime builds or launches)."""
    rec = {"loop": name, "post_warm_builds": rt.post_warm_builds,
           "entries": [list(e) for e in LEDGER.since(rt.warm_builds)]}
    LOOP_LEDGER.append(rec)
    return rec


def ptxas_report(text: str) -> dict:
    """Registers a thread and spill bytes (stores + loads) of the kernel in
    one library's nvcc -Xptxas -v output (each library holds one kernel)."""
    regs = re.findall(r"Used (\d+) registers", text)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    return {"registers": int(regs[-1]) if regs else None,
            "spill_bytes": sum(int(a) + int(b) for a, b in spills) if spills else None}


# ---------------------------------------------------------------------------
# Seeded kernel inputs
# ---------------------------------------------------------------------------


def decide_args(dims: plane.PlaneDims, rng, dev):
    R, T, K, S = dims
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(-1, 4, (R, T, S))),
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(0, 4, (R, T, S))),
    )
    pkt = (i32(rng.integers(0, 3, (R, T, K))), i32(rng.integers(0, 4, (R, T, K))),
           b(0.3, (R, T, K)), b(0.5, (R, T, K)), b(0.4, (R, T, K)),
           b(0.9, (R, T, K)), i32(rng.integers(40, 1300, (R, T, K))))
    return (state, b(0.5, (R, T)), b(0.6, (R, T)), b(0.7, (R, T, S)), *pkt)


def alloc_args(dims: plane.PlaneDims, rng, dev):
    R, T, K, S = dims
    bit = (rng.random((R, T, 4, 4)) * 2e6 * (rng.random((R, T, 4, 4)) > 0.3))
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(dev)  # noqa: E731
    return (t(bit, np.float32), t(rng.integers(-1, 4, (R, S, T)), np.int32),
            t(rng.integers(-1, 4, (R, S, T)), np.int32),
            torch.from_numpy(rng.random((R, S, T)) < 0.2).to(dev),
            t(rng.random((R, S)) * 8e6, np.float32))


def rtpstats_args(dims: plane.PlaneDims, rng, dev):
    """`rtpstats.route_update_tick` operands at dims (R, T, K, S): a stats
    state with half its rows started and its 32-bit fields over their
    range, and seeded packets (layers -1..3, SNs across 16 bits, ts and
    arrival over the int32 range)."""
    R, T, K, _ = dims
    N = T * plane.MAX_LAYERS
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    full = lambda shape: i32(rng.integers(-2**31, 2**31, shape))  # noqa: E731
    state = rtpstats.StreamStats(
        b(0.5, (R, N)), i32(rng.integers(0, 65536, (R, N))),
        i32(rng.integers(0, 65536, (R, N))), i32(rng.integers(0, 4, (R, N))), full((R, N)),
        i32(rng.integers(0, 2**20, (R, N))), i32(rng.integers(0, 2**30, (R, N))),
        i32(rng.integers(0, 9, (R, N))), i32(rng.integers(0, 2**24, (R, N))), full((R, N)),
        i32(np.zeros((R, N))), i32(np.zeros((R, N))))
    pkt = (i32(rng.integers(-1, 4, (R, T, K))), i32(rng.integers(0, 65536, (R, T, K))),
           full((R, T, K)), i32(rng.integers(40, 1300, (R, T, K))), full((R, T, K)),
           b(0.8, (R, T, K)), b(0.4, (R, T, K)))
    return (state, b(0.3, (R, T)), *pkt)


def tree_equal(a, b) -> tuple[bool, float]:
    """Exact equality of two trees of tensors, and the largest absolute
    difference of their float leaves."""
    ok, err = True, 0.0
    for x, y in zip(plane.tree_leaves(a), plane.tree_leaves(b)):
        ok &= x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        if x.is_floating_point() and x.shape == y.shape:
            err = max(err, float((x - y).abs().max()) if x.numel() else 0.0)
    return ok, err


def parity_phase(dev) -> dict:
    rng = np.random.default_rng(SEED)
    errs = dict.fromkeys(KERNELS, 0.0)
    for dims in PARITY_SHAPES:
        args = decide_args(dims, rng, dev)
        ok, err = tree_equal(
            selector.decide_rooms(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES),
            selector.decide_rooms_plain(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES),
        )
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"decide_rooms kernel != plain at {tuple(dims)}")
        errs["decide_rooms"] = max(errs["decide_rooms"], err)
        del args
        args = alloc_args(dims, rng, dev)
        ok, err = tree_equal(allocation.allocate_budget_rooms(*args),
                             allocation.allocate_budget_rooms_plain(*args))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"allocate_budget_rooms kernel != plain at {tuple(dims)}")
        errs["allocate_budget_rooms"] = max(errs["allocate_budget_rooms"], err)
        del args
        args = rtpstats_args(dims, rng, dev)
        ok, err = tree_equal(rtpstats.route_update_tick(*args),
                             rtpstats.route_update_tick_plain(*args))
        torch.cuda.synchronize()
        if not ok:
            raise AssertionError(f"rtpstats_rooms kernel != plain at {tuple(dims)}")
        errs["rtpstats_rooms"] = max(errs["rtpstats_rooms"], err)
        del args
        torch.cuda.empty_cache()
        log(f"parity ok at {tuple(dims)}")
    return errs


# ---------------------------------------------------------------------------
# Runtime on the card
# ---------------------------------------------------------------------------


def setup_rooms(rt: PlaneRuntime, spec: synth.TrafficSpec) -> None:
    """Publish the spec's tracks in every room (participant t publishes
    track t) and subscribe every participant to all of them."""
    R, T, _, S = rt.dims
    nv = min(spec.video_tracks, T)
    used = min(nv + spec.audio_tracks, T)
    for r in range(R):
        for t in range(used):
            rt.set_track(r, t, published=True, is_video=t < nv,
                         is_svc=spec.svc and t < nv, pub_sub=t % S)
            for s in range(S):
                rt.set_subscription(r, t, s, subscribed=True)


def synth_packets(inp: plane.TickInputs, rng) -> dict:
    """One synth tick → push_batch arguments (valid packets in (room,
    track, k) order, with random payload bytes of the packets' sizes)."""
    r, t, k = np.nonzero(inp.valid)
    at = lambda f: np.asarray(getattr(inp, f))[r, t, k]  # noqa: E731
    size = at("size").astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(size)[:-1]]).astype(np.int64)
    return dict(
        room=r.astype(np.int64), track=t.astype(np.int64), layer=at("layer"),
        sn=at("sn"), ts=at("ts"), ts_aligned=at("ts_jump") < 0,
        temporal=at("temporal"), keyframe=at("keyframe"),
        layer_sync=at("layer_sync"), begin_pic=at("begin_pic"),
        marker=at("end_frame"), pid=at("pid"), tl0=at("tl0"),
        keyidx=at("keyidx"), size=at("size"), frame_ms=at("frame_ms"),
        audio_level=at("audio_level"), arrival_rtp=at("arrival_rtp"),
        pay_start=starts, pay_length=size,
        blob=rng.integers(0, 256, int(size.sum()), dtype=np.uint8),
    )


def rooms_below(batch: dict, n: int) -> dict:
    keep = batch["room"] < n
    out = {k: v[keep] for k, v in batch.items() if k != "blob"}
    out["blob"] = batch["blob"]
    return out


def push(rt: PlaneRuntime, batch: dict, estimate: np.ndarray) -> None:
    rt.ingest.push_batch(**batch)
    for r in range(min(rt.dims.rooms, estimate.shape[0])):
        for s in range(rt.dims.subs):
            rt.ingest.push_feedback(r, s, estimate=float(estimate[r, s]))


def compare_outputs(got: plane.TickOutputs, want: plane.TickOutputs, n: int, tick: int,
                    worst: dict) -> None:
    """GPU rows 0..n-1 against the CPU run: integers and bools equal,
    floats within the leaf's bound; `worst` keeps each float leaf's
    largest absolute difference."""
    for name, g, w in zip(plane.TickOutputs._fields, got, want):
        g = np.asarray(g)[:n]
        if g.dtype.kind == "f":
            err = float(np.abs(g.astype(np.float64) - w).max(initial=0.0))
            worst[name] = max(worst.get(name, 0.0), err)
            rtol, atol = plane.float_tolerance(name)
            if not np.allclose(g, w, rtol=rtol, atol=atol):
                raise AssertionError(f"tick {tick}: {name} GPU vs CPU beyond "
                                     f"rtol={rtol} atol={atol} (max abs err {err})")
        elif not np.array_equal(g, w):
            raise AssertionError(f"tick {tick}: {name} GPU != CPU")


def compare_egress(got, want, n: int, tick: int) -> None:
    keep = got.rooms < n
    for col in ("rooms", "tracks", "ks", "subs", "sn", "ts", "pid", "tl0", "keyidx"):
        if not np.array_equal(getattr(got, col)[keep], getattr(want, col)):
            raise AssertionError(f"tick {tick}: egress column {col} GPU != CPU")


async def runtime_phase(dev) -> dict:
    spec, dims = RUNTIME_SPEC, RUNTIME_DIMS
    rt = PlaneRuntime(dims, tick_ms=spec.tick_ms, device=dev)
    ref = PlaneRuntime(plane.PlaneDims(CHECK_ROOMS, *dims[1:]), tick_ms=spec.tick_ms,
                       device="cpu")
    setup_rooms(rt, spec)
    setup_rooms(ref, spec)
    rng = np.random.default_rng(SEED)
    traffic = synth.init_traffic(dims, spec, seed=SEED)
    batches = []
    for i in range(RUNTIME_TICKS):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=SEED)
        batches.append((synth_packets(inp, rng), np.asarray(inp.estimate)))

    fwd = 0
    tick_s = []
    worst: dict[str, float] = {}
    cuda.reset_launches()
    for i, (batch, estimate) in enumerate(batches):
        push(rt, batch, estimate)
        t0 = time.perf_counter()
        res = await rt.step_once()
        tick_s.append(time.perf_counter() - t0)
        fwd += res.fwd_packets
        if i < CHECK_TICKS:
            push(ref, rooms_below(batch, CHECK_ROOMS), estimate)
            want = await ref.step_once()
            compare_outputs(res.outputs, want.outputs, CHECK_ROOMS, i, worst)
            compare_egress(res.egress_batch, want.egress_batch, CHECK_ROOMS, i)
    launches = dict(cuda.launches)

    if fwd <= 0:
        raise AssertionError("runtime forwarded no packets")
    expected = dense_launches(RUNTIME_TICKS)
    if launches != expected:
        raise AssertionError(f"dense runtime launches {launches}, expected {expected}")
    log(f"runtime ok: {RUNTIME_TICKS} ticks at {tuple(dims)}, {fwd} packets "
        f"forwarded, launches {launches}, step_once median "
        f"{statistics.median(tick_s) * 1e3:.3f} ms (host stage + device + fan-out)")
    print(json.dumps({"runtime_gpu_vs_cpu_max_abs_err": worst}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# North-star timing
# ---------------------------------------------------------------------------


def capture_calls(wrappers, fn):
    """Call fn() with each (module, name) wrapper wrapped, recording the
    arguments, keywords and result of its last call. Returns (fn's result,
    {name: (args, kwargs, result)})."""
    seen = {}
    originals = [(mod, name, getattr(mod, name)) for mod, name in wrappers]

    def wrap(name, f):
        def g(*a, **kw):
            res = f(*a, **kw)
            seen[name] = (a, kw, res)
            return res
        return g

    for mod, name, f in originals:
        setattr(mod, name, wrap(name, f))
    try:
        out = fn()
    finally:
        for mod, name, f in originals:
            setattr(mod, name, f)
    return out, seen


def capture_kernel_args(state, wire, dims):
    """Run one dense tick with the three kernel wrappers wrapped, recording
    the arguments and results the main path hands them."""
    (state, _), seen = capture_calls(
        [(selector, "decide_rooms"), (allocation, "allocate_budget_rooms"),
         (rtpstats, "route_update_tick")],
        lambda: plane.device_tick(state, wire, dims))
    return state, seen


def nbytes(*trees) -> int:
    return sum(x.numel() * x.element_size() for t in trees for x in plane.tree_leaves(t))


def decide_rooms_bytes(a, res) -> int:
    """Bytes one decide_rooms call must move: its operands (the selector
    state's four leaves) in, its outputs (the new state's current layers)
    out."""
    st = a[0]
    return nbytes(a[1:], (st.current_spatial, st.current_temporal, st.target_spatial,
                          st.target_temporal),
                  res[1:], (res[0].current_spatial, res[0].current_temporal))


def rtpstats_rooms_bytes(a, res) -> int:
    """Bytes one route_update_tick call must move: the packet fields, the
    track flags and the stats state in (not the snapshot fields, which it
    passes through), the new state and the tracker sums out."""
    return nbytes(a[0][:10], a[1:], res[0][:10], res[1])


def decide_pages_bytes(a, res) -> int:
    """Bytes one decide_pages call must move: each live page's slice of
    every operand and the live-row index in, the outputs out."""
    sel, is_svc, is_video, base, inp, rows = a[:6]
    P = base.shape[0]
    per_page = sum(x.element_size() * x.numel() // P for x in (
        *sel, is_svc, is_video, base,
        *(getattr(inp, f) for f in ("layer", "temporal", "keyframe", "layer_sync",
                                    "end_frame", "valid", "size", "sn", "ts",
                                    "arrival_rtp", "begin_pic"))))
    out_bytes = nbytes(res.send_bits, res.drop_bits, res.switch_bits, res.sel.current_spatial,
                       res.sel.current_temporal, res.need_kf, res.pkts_sent, res.sent_bytes,
                       res.fwd_packets, res.fwd_bytes, res.st, res.tr)
    return per_page * rows.numel() + rows.numel() * rows.element_size() + out_bytes


def mix_pages_bytes(mix, rows) -> int:
    """Bytes one mix_pages launch must move: each live page's slice of
    every mix operand and the live-row index in, the [NL, SP, N] mix out."""
    pcm, sub_track = mix[0], mix[3]
    P, nl = pcm.shape[0], rows.numel()
    return (sum(x.element_size() * x.numel() // P for x in mix) * nl
            + nl * rows.element_size() + nl * sub_track.shape[1] * pcm.shape[2] * 4)


def north_star_setup(dev):
    """The north-star dense state and four ticks of seeded wires."""
    dims, spec = NORTH_STAR, NORTH_STAR_SPEC
    state = synth.make_state(dims, spec, device=dev)
    traffic = synth.init_traffic(dims, spec, seed=SEED)
    wires = []
    for i in range(4):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=SEED)
        wires.append(plane.wire_inputs(plane.pack_tick_inputs(inp)))
    return state, wires


def timing_phase(dev, profile: bool) -> tuple[dict, dict, plane.PlaneState]:
    dims = NORTH_STAR
    state, wires = north_star_setup(dev)
    for i in range(WARMUP_TICKS):
        state, _ = plane.device_tick(state, wires[i % len(wires)], dims)
    times = []
    for i in range(TIMED_TICKS):
        t0 = time.perf_counter()
        state, out = plane.device_tick(state, wires[i % len(wires)], dims)
        times.append(time.perf_counter() - t0)
    times_ms = sorted(t * 1e3 for t in times)
    tick = {
        "dims": list(dims), "ticks": TIMED_TICKS,
        "median_ms": statistics.median(times_ms),
        "p90_ms": times_ms[int(0.9 * len(times_ms)) - 1],
        "fwd_packets_last_tick": int(out.fwd_packets.sum()),
        "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
    }

    state, seen = capture_kernel_args(state, wires[0], dims)
    a, kw, res = seen["decide_rooms"]
    dec = time_kernel(selector.decide_rooms, selector.decide_rooms_plain, a, kw,
                      decide_rooms_bytes(a, res))
    dec["shape"] = list(dims)
    a2, kw2, res2 = seen["allocate_budget_rooms"]
    al = time_kernel(allocation.allocate_budget_rooms, allocation.allocate_budget_rooms_plain,
                     a2, kw2, nbytes(a2, res2))
    al["shape"] = list(a2[1].shape)
    a3, kw3, res3 = seen["route_update_tick"]
    rs = time_kernel(rtpstats.route_update_tick, rtpstats.route_update_tick_plain, a3, kw3,
                     rtpstats_rooms_bytes(a3, res3))
    rs["shape"] = list(a3[3].shape)
    if profile:
        profile_ticks(state, wires, dims)
    return tick, {"decide_rooms": dec, "allocate_budget_rooms": al, "rtpstats_rooms": rs}, state


def time_kernel(kernel, plain, a, kw, bytes_moved: int) -> dict:
    """A wrapper's device time (`graph_ms`), call time and its plain
    version's time on the captured operands, beside its byte bound."""
    return {
        "ms": graph_ms(lambda: kernel(*a, **kw), KERNEL_REPS),
        "call_ms": event_ms(lambda: kernel(*a, **kw), KERNEL_REPS),
        "plain_ms": event_ms(lambda: plain(*a, **kw), PLAIN_REPS),
        "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes": bytes_moved,
    }


def profile_ticks(state, wires, dims) -> None:
    def step(i):
        nonlocal state
        state, _ = plane.device_tick(state, wires[i % len(wires)], dims)

    profile_steps(step)


def profile_steps(step) -> None:
    """torch.profiler table (device time by kernel) of 5 calls step(i)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            step(i)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25), flush=True)


# ---------------------------------------------------------------------------
# Paged plane: kernel parity, the paged runtime, live-extent timing
# ---------------------------------------------------------------------------


def sample_room_size(rng) -> int:
    """Participants of one room, from bench.py's paged_kernel room-size
    mix: 80 % 2–4, 15 % 5–10, 5 % 50."""
    u = rng.random()
    if u < 0.80:
        return int(rng.integers(2, 5))
    if u < 0.95:
        return int(rng.integers(5, 11))
    return 50


def admit_rooms(pager: RoomPager, limit: int | None = None) -> list[int]:
    """Claim page grids for rooms drawn from the size mix (seed
    ROOM_MIX_SEED) until the pool refuses five requests or `limit` rooms
    (default: every row) are in. Room i sits on row i; returns the rooms'
    sizes."""
    rng = np.random.default_rng(ROOM_MIX_SEED)
    limit = pager.num_rooms if limit is None else limit
    sizes: list[int] = []
    misses = 0
    while misses < 5 and len(sizes) < limit:
        p = sample_room_size(rng)
        try:
            pager.alloc_room(len(sizes), tracks=p, subs=p)
        except CapacityError:
            misses += 1
            continue
        sizes.append(p)
    return sizes


def live_tables(pager: RoomPager, dev):
    """`paged.live_rows_of` the pager's current table, on the card."""
    rows, inv, n = paged.live_rows_of(pager.pg_room)
    return torch.from_numpy(rows).to(dev), torch.from_numpy(inv).to(dev), n


def page_args(page, rng, dev, rows=None, mix_n=MIX_N):
    """Seeded pooled operands of the live-page kernel at page geometry
    (P, TP, K, SP): decide operands, mix operands (three equal levels at
    the top-K boundary) and live_rows (half the pool, padded with a
    duplicate to a power of two, unless given)."""
    P, TP, K, SP = page
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(-1, 4, (P, TP, SP))),
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(0, 4, (P, TP, SP))))
    pk = lambda lo, hi: i32(rng.integers(lo, hi, (P, TP, K)))  # noqa: E731
    inp = plane.TickInputs(**dict.fromkeys(plane.TickInputs._fields))._replace(
        layer=pk(-1, 4), temporal=pk(0, 4), keyframe=b(0.3, (P, TP, K)),
        layer_sync=b(0.5, (P, TP, K)), end_frame=b(0.4, (P, TP, K)),
        valid=b(0.85, (P, TP, K)), size=pk(40, 1300), sn=pk(0, 65536),
        ts=i32(rng.integers(-2**31, 2**31, (P, TP, K), dtype=np.int64)),
        arrival_rtp=pk(0, 1 << 30), begin_pic=b(0.4, (P, TP, K)))
    decide = (state, b(0.4, (P, TP)), b(0.6, (P, TP)), b(0.7, (P, TP, SP)), inp)
    level = rng.random((P, TP)).astype(np.float32)
    level[:, : min(3, TP)] = level[:, -1:]
    mix = (torch.from_numpy(rng.standard_normal((P, TP, mix_n), np.float32) * 0.3).to(dev),
           torch.from_numpy(level).to(dev), b(0.7, (P, TP)),
           i32(rng.integers(-1, TP, (P, SP))),
           torch.from_numpy(rng.uniform(0.5, 1.5, (P, TP)).astype(np.float32)).to(dev))
    if rows is None:
        n = P // 2 + 1
        live = rng.choice(P, n, replace=False)
        nl = 1 << (n - 1).bit_length()
        rows = i32(np.concatenate([live, np.repeat(live[:1], nl - n)]))
    return decide, mix, rows


def full_pool_rows(dev):
    """The live rows of the PAGED_TIMING_DIMS pool filled from the size
    mix, on the card, and the live page count."""
    d = PAGED_TIMING_DIMS
    pager = RoomPager(d.rooms, d.tracks, d.subs, tpage=d.tpage, spage=d.spage,
                      pool_pages=d.pool_pages)
    admit_rooms(pager)
    rows, _, n_live = live_tables(pager, dev)
    return rows, n_live


def decide_launch(sel_state, is_svc, is_video, base, inp, rows, **kw):
    """decide_pages' kernel launch alone: its outputs as one tuple, without
    the wrapper's gathers of the live rows' selector targets."""
    decided, _ = paged_kernel._launch(rows, (sel_state, is_svc, is_video, base, inp), None,
                                      top_k=0, **kw)
    return tuple(decided)


def mix_launch(mix, rows):
    """mix_pages' kernel launch alone (the wrapper's tanh is another op)."""
    return paged_kernel._launch(rows, None, mix, wire_overhead=0, top_k=MIX_TOP_K)[1]


def decide_mix_launch(decide, mix, rows, kw):
    """decide_mix_pages' kernel launch alone: its outputs as one tuple."""
    decided, mixed = paged_kernel._launch(rows, decide, mix, top_k=MIX_TOP_K, **kw)
    return (*decided, mixed)


def paged_parity_phase(dev) -> tuple[float, dict]:
    """decide_pages, mix_pages and decide_mix_pages against their plain
    versions at each page geometry; every output equal, the float32 mix
    included. Returns the largest absolute difference seen (0 when exact)
    and, at the full-width pool, the mix entries' device and call times
    beside their byte bounds and the mix's plain version's time."""
    rng = np.random.default_rng(SEED)
    full_rows, n_live = full_pool_rows(dev)
    d = PAGED_TIMING_DIMS
    geoms = [(g, None) for g in PAGE_GEOMS] + [((d.pool_pages, d.tpage, d.pkts, d.spage),
                                                full_rows)]
    kw = dict(wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    err = 0.0
    for page, rows in geoms:
        decide, mix, rows = page_args(page, rng, dev, rows)
        checks = (
            ("decide_pages", paged_kernel.decide_pages(*decide, rows, **kw),
             paged_kernel.decide_pages_plain(*decide, rows, **kw)),
            ("mix_pages", paged_kernel.mix_pages(*mix, rows),
             paged_kernel.mix_pages_plain(*mix, rows)),
            ("decide_mix_pages", paged_kernel.decide_mix_pages(*decide, *mix, rows, **kw),
             (paged_kernel.decide_pages_plain(*decide, rows, **kw),
              paged_kernel.mix_pages_plain(*mix, rows))),
        )
        torch.cuda.synchronize()
        for name, got, want in checks:
            ok, e = tree_equal(got, want)
            if not ok:
                raise AssertionError(f"{name} kernel != plain at page geometry {page}")
            err = max(err, e)
        del checks
        log(f"paged parity ok at page geometry {page}, {rows.numel()} grid steps")
    log(f"full-width pool: {n_live} live pages of {d.pool_pages}")
    # The mix writes [NL, SP, N] float32 (2 GB at the full pool): its device
    # time is a graph of MIX_GRAPH_LAUNCHES kernel launches; the call times
    # are the wrappers' (the tanh included).
    mix_bytes = mix_pages_bytes(mix, rows)
    decide_bytes = decide_pages_bytes((*decide, rows),
                                      paged_kernel.decide_pages(*decide, rows, **kw))
    mix_t = {
        "mix_ms": graph_ms(lambda: mix_launch(mix, rows), KERNEL_REPS, MIX_GRAPH_LAUNCHES),
        "decide_mix_ms": graph_ms(lambda: decide_mix_launch(decide, mix, rows, kw), KERNEL_REPS,
                                  MIX_GRAPH_LAUNCHES),
        "mix_call_ms": event_ms(lambda: paged_kernel.mix_pages(*mix, rows), KERNEL_REPS),
        "decide_mix_call_ms": event_ms(
            lambda: paged_kernel.decide_mix_pages(*decide, *mix, rows, **kw), KERNEL_REPS),
        "mix_plain_ms": event_ms(lambda: paged_kernel.mix_pages_plain(*mix, rows), PLAIN_REPS),
        "mix_bound_ms": mix_bytes / HBM_BYTES_PER_S * 1e3, "mix_bytes": mix_bytes,
        "decide_mix_bound_ms": (mix_bytes + decide_bytes) / HBM_BYTES_PER_S * 1e3,
        "grid": int(rows.numel()),
    }
    del decide, mix
    torch.cuda.empty_cache()
    return err, mix_t


def mask_to_rooms(inp: plane.TickInputs, sizes: np.ndarray) -> plane.TickInputs:
    """Keep the packets of each room's own tracks (track t < its size)."""
    t = np.arange(inp.valid.shape[1])
    return inp._replace(valid=inp.valid & (t[None, :, None] < sizes[:, None, None]))


def setup_paged_room(rt: PagedPlaneRuntime, row: int, size: int) -> None:
    """Room `row` with `size` participants: participant t publishes track
    t (the first two VP9-SVC video, the rest Opus) and subscribes to
    every other track. Its page grid was claimed at the full size."""
    slots = rt.slots.alloc_room(f"room{row}")
    assert slots.row == row
    for t in range(size):
        slots.alloc_track(f"t{t}")
        slots.alloc_sub(f"p{t}")
    for t in range(size):
        video = t < PAGED_SPEC.video_tracks
        rt.set_track(row, t, published=True, is_video=video, is_svc=video, pub_sub=t)
        for s in range(size):
            if s != t:
                rt.set_subscription(row, t, s, subscribed=True)


def push_paged(rt, batch: dict, estimate: np.ndarray, sizes) -> None:
    rt.ingest.push_batch(**batch)
    for r, size in enumerate(sizes):
        for s in range(size):
            rt.ingest.push_feedback(r, s, estimate=float(estimate[r, s]))


async def paged_runtime_phase(dev) -> dict:
    """PAGED_TICKS ticks of a PagedPlaneRuntime (live-extent tick, kernel
    on) over rooms admitted from the size mix; every other room is
    released and the pool compacted at PAGED_RELEASE_TICK. Checks
    forwarding, the launch counts, and the first CHECK_TICKS ticks of
    rooms 0..CHECK_ROOMS-1 against a CPU PagedPlaneRuntime in LOGICAL
    form. Returns the launch counts."""
    dims, spec = PAGED_RUNTIME_DIMS, PAGED_SPEC
    rt = PagedPlaneRuntime(dims, tick_ms=spec.tick_ms, device=dev, paged_kernel="on")
    sizes = admit_rooms(rt.pager)
    ref_sizes = sizes[:CHECK_ROOMS]
    ref = PagedPlaneRuntime(dims._replace(rooms=CHECK_ROOMS), tick_ms=spec.tick_ms,
                            device="cpu", paged_kernel="on")
    if admit_rooms(ref.pager, CHECK_ROOMS) != ref_sizes:
        raise AssertionError("reference admission differs")
    for r, size in enumerate(sizes):
        setup_paged_room(rt, r, size)
    for r, size in enumerate(ref_sizes):
        setup_paged_room(ref, r, size)
    live_pages = rt.pager.pages_mapped
    log(f"paged runtime: {len(sizes)} rooms admitted, {live_pages} live pages of "
        f"{dims.pool_pages}")

    rng = np.random.default_rng(SEED)
    logical = plane.PlaneDims(dims.rooms, dims.tracks, dims.pkts, dims.subs)
    room_sizes = np.zeros(dims.rooms, np.int64)
    room_sizes[:len(sizes)] = sizes
    traffic = synth.init_traffic(logical, spec, seed=SEED)
    fwd = 0
    live_ticks = 0
    worst: dict[str, float] = {}
    tick_s = []
    # Count the card's dead-page computations (misses of the cache in
    # front of `paged.dead_page_outputs`).
    dead_on_card = []
    fresh = paged.dead_page_outputs

    def counted(*a, **kw):
        out = fresh(*a, **kw)
        dead_on_card.extend([1] if out.fwd_packets.device.type == "cuda" else [])
        return out

    paged.dead_page_outputs = counted
    paged.dead_page_outputs_cached.cache_clear()
    cuda.reset_launches()
    for i in range(PAGED_TICKS):
        if i == PAGED_RELEASE_TICK:
            for r in range(1, len(sizes), 2):
                rt.clear_room(r)
                rt.slots.release_room(f"room{r}")
                room_sizes[r] = 0
            moves = rt.compact()
            log(f"tick {i}: released {len(sizes) // 2} rooms, compaction queued "
                f"{moves} page moves")
        traffic, inp = synth.next_tick(traffic, logical, spec, i, seed=SEED)
        inp = mask_to_rooms(inp, room_sizes)
        batch = synth_packets(inp, rng)
        estimate = np.asarray(inp.estimate)
        push_paged(rt, batch, estimate, room_sizes)
        t0 = time.perf_counter()
        res = await rt.step_once()
        tick_s.append(time.perf_counter() - t0)
        fwd += res.fwd_packets
        live_ticks += int(rt.pager.pages_mapped > 0)
        if i < CHECK_TICKS:
            push_paged(ref, rooms_below(batch, CHECK_ROOMS), estimate, ref_sizes)
            want = await ref.step_once()
            compare_outputs(res.outputs, want.outputs, CHECK_ROOMS, i, worst)
            compare_egress(res.egress_batch, want.egress_batch, CHECK_ROOMS, i)
    launches = dict(cuda.launches)
    paged.dead_page_outputs = fresh

    # The dead-page outputs are computed once per (tick_ms, roll_quality)
    # seen — one 1-page stock tick, one launch of kernels 1 and 2 and of
    # the RTP-stats kernel — and kernel 2 runs once per live tick in phase
    # 2. A live step routes its stats in B3, so it never launches the
    # RTP-stats kernel.
    keys = len(dead_on_card)
    expected = paged_launches(live_ticks, keys)
    if fwd <= 0:
        raise AssertionError("paged runtime forwarded no packets")
    if launches != expected:
        raise AssertionError(f"paged runtime launches {launches}, expected {expected}")
    if rt.stats["page_moves"] <= 0 or rt.stats["paged_kernel_ticks"] != PAGED_TICKS:
        raise AssertionError(f"paged runtime stats {rt.stats}")
    log(f"paged runtime ok: {PAGED_TICKS} ticks, {fwd} packets forwarded, launches "
        f"{launches}, page moves {rt.stats['page_moves']}, step_once median "
        f"{statistics.median(tick_s) * 1e3:.3f} ms")
    print(json.dumps({"paged_runtime": {
        "dims": list(dims), "rooms": len(sizes), "live_pages": live_pages,
        "ticks": PAGED_TICKS, "fwd_packets": fwd, "launches": launches,
        "step_once_median_ms": statistics.median(tick_s) * 1e3,
        "paged_kernel_ms_median": statistics.median(
            r["paged_kernel_ms"] for r in rt.recent_ticks),
        "gpu_vs_cpu_max_abs_err": worst,
    }}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Serving path: RoomManager, rooms and the pipelined tick loop
# ---------------------------------------------------------------------------


def serving_config(paged_dims: paged.PagedDims | None = None,
                   dense_dims: plane.PlaneDims = RUNTIME_DIMS,
                   failure_plane: bool = False) -> Config:
    """The reference's default Config with the port overlay (every
    subsystem the port does not carry turned off), built in Python (no
    YAML parser: PyYAML need not be installed): the dense plane at `dense_dims`,
    or the paged plane at `paged_dims` (live-extent tick, kernel on), 20 ms
    ticks, a trace ring that holds every tick of the run. The supervisor,
    the integrity audit and the governor are on by default in the
    reference and in `serve`; they stay on with `failure_plane`, and are
    turned off otherwise, so that the serving and UDP phases measure the
    loop as earlier runs did."""
    p = {"tick_ms": RUNTIME_SPEC.tick_ms}
    if paged_dims is None:
        p.update(rooms=dense_dims.rooms, tracks_per_room=dense_dims.tracks,
                 pkts_per_track=dense_dims.pkts, subs_per_room=dense_dims.subs)
    else:
        p.update(rooms=paged_dims.rooms, tracks_per_room=paged_dims.tracks,
                 pkts_per_track=paged_dims.pkts, subs_per_room=paged_dims.subs,
                 pager_enabled=True, pager_tpage=paged_dims.tpage,
                 pager_spage=paged_dims.spage, pager_pool_pages=paged_dims.pool_pages,
                 paged_kernel="on")
    base = port_overlay()
    base.setdefault("plane", {}).update(p)
    base.update(development=True, trace={"ring_ticks": SERVING_TRACE_TICKS})
    if not failure_plane:
        base.update(supervisor={"enabled": False}, integrity={"enabled": False},
                    limits={"governor_enabled": False})
    return load_config(base=base, env={})


async def join_rooms(rm: RoomManager, sizes, pubs, spec: synth.TrafficSpec,
                     names: list[str] | None = None) -> tuple[dict, list, float]:
    """Room r (named names[r], by default f"room{r}") gets sizes[r]
    participants p0..p{n-1} through
    RoomManager.start_session with MessageChannel sinks; participants
    t < pubs[r] each announce one track (add_track over the signal
    channel: the first spec.video_tracks VP9-SVC video, the rest Opus) and
    bind it, in order, as a first media frame does; everyone
    auto-subscribes. Returns ({(room, identity): (request channel, session
    task)}, [room][t] → (track col, track sid), the join seconds of all
    participants)."""
    names = names or [f"room{r}" for r in range(len(sizes))]
    sessions = {}
    t0 = time.perf_counter()
    for r, size in enumerate(sizes):
        for t in range(size):
            req, resp = MessageChannel(), MessageChannel()
            init = {"identity": f"p{t}", "name": f"p{t}", "auto_subscribe": True,
                    "grants": {"video": {"roomJoin": True, "room": names[r]}}}
            task = asyncio.ensure_future(rm.start_session(names[r], init, req, resp))
            sessions[(r, f"p{t}")] = (req, task)
    want = sum(sizes)
    while sum(len(room.participants) for room in rm.rooms.values()) < want:
        failed = [t for _, t in sessions.values() if t.done()]
        if failed:
            raise AssertionError(f"{len(failed)} sessions ended during the joins")
        await asyncio.sleep(0.005)
    join_s = time.perf_counter() - t0
    for r, n_pub in enumerate(pubs):
        for t in range(n_pub):
            video = t < spec.video_tracks
            sessions[(r, f"p{t}")][0].write_message(json.dumps({"add_track": {
                "cid": f"c{t}", "name": f"c{t}", "type": int(video),
                "mime_type": "video/vp9" if video else "audio/opus"}}))
    rooms = [rm.rooms[names[r]] for r in range(len(sizes))]
    while any(len(room.participants[f"p{t}"].pending_tracks) < 1
              for room, n_pub in zip(rooms, pubs) for t in range(n_pub)):
        await asyncio.sleep(0.005)
    tracks = []
    for room, n_pub in zip(rooms, pubs):
        cols = []
        for t in range(n_pub):
            track = room.participants[f"p{t}"].publish_pending(f"c{t}")
            cols.append((track.track_col, track.info.sid))
        if [c for c, _ in cols] != list(range(n_pub)):
            raise AssertionError(f"{room.name}: track columns {cols}")
        tracks.append(cols)
    return sessions, tracks, join_s


async def serve_rooms(dev, sizes, pubs, spec: synth.TrafficSpec, cfg: Config,
                      seconds: float | None, min_ticks: int,
                      cap_s: float | None = None, estimates: bool = False) -> dict:
    """Join `sizes` (participants per room; `pubs` of them publish) into a
    RoomManager on `dev`,
    run its serving loop (RoomManager.start → PlaneRuntime._run) with a
    feeder task that pushes one seeded synth tick into runtime.ingest per
    runtime tick, for `seconds` (or until `min_ticks` loop ticks), then
    stop. Checks the launches and the audio delivery of the first
    SAMPLE_ROOMS rooms; returns the report. With `estimates` the feeder
    also pushes every subscriber's synth receiver estimate each tick,
    through the call a receiver report over UDP makes.

    With `cap_s` (the default-config runs: supervisor, integrity and
    governor on) the run also ends when the supervisor gives up or after
    `cap_s` seconds of loop, without failing, and otherwise goes on until
    the sampled audio was delivered after the last restart; the report
    adds what the failure and overload plane did. A restart rewinds tick
    indices and munger lanes, so the checks then read each run of the
    loop between restarts (a generation) on its own: launches equal
    completed ticks plus the steps whose tick a restart dropped, and every
    generation completes its ticks in order. Delivery is read in the last
    generation: exactly once and in sn order when the plane neither
    restarted nor flagged a room; otherwise (an integrity quarantine
    mutes a room's media on purpose) every delivered frame must be a
    packet pushed on its track, delivered at most once, in the order
    pushed, with rising sn, and some must arrive."""
    store = LocalStore()
    rm = RoomManager(cfg, LocalRouter(LocalNode()), store,
                     telemetry=TelemetryService(cfg), device=dev)
    rt = rm.runtime
    sup, integ, gov = rm.supervisor, rm.integrity, rm.governor
    gen = lambda: sup.restarts if sup is not None else 0  # noqa: E731
    sessions, tracks, join_s = await join_rooms(rm, sizes, pubs, spec)
    log(f"serving: {sum(sizes)} participants in {len(sizes)} rooms joined in "
        f"{join_s:.2f} s")
    R, T = rt.dims.rooms, rt.dims.tracks
    room_pubs = np.zeros(R, np.int64)
    room_pubs[:len(pubs)] = pubs
    n_sample = min(SAMPLE_ROOMS, len(sizes))
    audio = [(r, t) for r in range(n_sample) for t in range(spec.video_tracks, pubs[r])]
    # (generation, tick, payload) of every pushed packet of the sampled audio
    pushed: dict[tuple[int, int], list[tuple[int, int, bytes]]] = {rt_: [] for rt_ in audio}
    got: dict[tuple[int, str], list[tuple[int, dict]]] = {}
    done: list[tuple[int, int]] = []       # (generation, tick index) completed
    audio_sids = {tracks[r][t][1] for r, t in audio}
    heard: dict[int, int] = {}             # generation → sampled audio frames
    frame_keys = {"track_sid", "sn", "ts", "pid", "tl0", "keyidx", "payload"}
    bad_frames = []
    # (room, sub) of the synth estimate → (plane row, sub column) it feeds
    feedback = []
    if estimates:
        for r, size in enumerate(sizes):
            room = rm.rooms[f"room{r}"]
            feedback += [(r, s, room.slots.row, room.participants[f"p{s}"].sub_col)
                         for s in range(size)]

    def drain(res) -> None:
        # The WS pump's seat: empty every media queue each tick; decode
        # the sampled rooms' frames with the port's codec.
        g = gen()
        done.append((g, res.tick_index))
        for (r, ident), _ in sessions.items():
            q = rm.rooms[f"room{r}"].participants[ident].media_queue
            while not q.empty():
                data = q.get_nowait()
                if r < n_sample:
                    frame = packer.unpackb(data)
                    if set(frame) != frame_keys:
                        bad_frames.append(sorted(frame))
                    got.setdefault((r, ident), []).append((g, frame))
                    if frame.get("track_sid") in audio_sids:
                        heard[g] = heard.get(g, 0) + 1

    rt.on_tick(drain)
    logical = plane.PlaneDims(R, T, rt.dims.pkts, rt.dims.subs)
    traffic = synth.init_traffic(logical, spec, seed=SEED)
    rng = np.random.default_rng(SEED)
    stop = asyncio.Event()

    async def feeder() -> None:
        nonlocal traffic
        i = 0
        while not stop.is_set():
            traffic, inp = synth.next_tick(traffic, logical, spec, i, seed=SEED)
            batch = synth_packets(mask_to_rooms(inp, room_pubs), rng)
            k, g = rt.tick_index, gen()      # the tick whose drain takes this batch
            for j in np.nonzero(batch["room"] < n_sample)[0]:
                key = (int(batch["room"][j]), int(batch["track"][j]))
                if key in pushed:
                    s = int(batch["pay_start"][j])
                    pushed[key].append((g, k, batch["blob"][s:s + int(batch["pay_length"][j])]
                                        .tobytes()))
            rt.ingest.push_batch(**batch)
            if feedback:
                est = np.asarray(inp.estimate)
                for r, s, row, col in feedback:
                    rt.ingest.push_feedback(row, col, estimate=float(est[r, s]))
            i += 1
            while rt.tick_index == k and not stop.is_set():
                await asyncio.sleep(0.001)

    # The warm step and watermark of LivekitServer.start, then the loop.
    await rt.step_once()
    rt.mark_warm()
    base_ticks, base_fwd = rt.stats["ticks"], rt.stats["fwd_packets"]
    base_late, base_stalls = rt.stats["late_ticks"], rt.stats["pipeline_stalls"]
    base_dropped = rt.stats["dropped_steps"]
    done.clear()
    for q in got.values():
        q.clear()
    # Count the dead-page computations (misses of the cache in front of
    # `paged.dead_page_outputs`; each launches kernels 1 and 2 once).
    dead_keys = []
    fresh = paged.dead_page_outputs

    def counted(*a, **kw):
        dead_keys.append(1)
        return fresh(*a, **kw)

    paged.dead_page_outputs = counted
    paged.dead_page_outputs_cached.cache_clear()
    cuda.reset_launches()
    feed = asyncio.ensure_future(feeder())
    capped = False
    t0 = time.perf_counter()
    try:
        rm.start()
        while True:
            await asyncio.sleep(0.05)
            n = rt.stats["ticks"] - base_ticks
            if feed.done():
                feed.result()
            settled = heard.get(gen(), 0) > 0
            if ((seconds is None or time.perf_counter() - t0 >= seconds) and n >= min_ticks
                    and (cap_s is None or settled)):
                break
            if cap_s is not None and (time.perf_counter() - t0 > cap_s
                                      or (sup is not None and sup.gave_up)):
                capped = not (sup is not None and sup.gave_up)
                break
            if time.perf_counter() - t0 > SERVING_WALL_CAP_S:
                raise AssertionError(f"serving loop ran {n} ticks in "
                                     f"{SERVING_WALL_CAP_S} s")
        stop.set()
        await feed
        if sup is not None:
            await sup.stop()      # no restart may race the stop below
        await rt.stop()
        loop_ledger(f"serving {'paged' if isinstance(rt, PagedPlaneRuntime) else 'dense'}"
                    f"{' defaults' if cap_s is not None else ''}", rt)
    finally:
        paged.dead_page_outputs = fresh
    wall_s = time.perf_counter() - t0
    ticks = rt.stats["ticks"] - base_ticks
    restarts = gen()
    if not done:
        raise AssertionError(f"serving loop completed no tick in {wall_s:.1f} s")
    first_tick = done[0][1]
    records = [rec for rec in rt.trace.snapshot() if rec["tick"] >= first_tick]

    # Launches: once per loop tick, plus once per step whose tick a restart
    # dropped (the paged dead-page key adds one 1-page stock tick per key
    # the card computed). A step a restart left behind reports when its
    # thread returns: give it a moment.
    keys = len(dead_keys)

    def expected_launches() -> dict:
        steps = ticks + rt.stats["dropped_steps"] - base_dropped
        if isinstance(rt, PagedPlaneRuntime):
            return paged_launches(steps, keys)
        return dense_launches(steps)

    t_wait = time.perf_counter()
    while dict(cuda.launches) != expected_launches() and restarts \
            and time.perf_counter() - t_wait < DRILL_WAIT_S:
        await asyncio.sleep(0.05)
    launches, expected = dict(cuda.launches), expected_launches()
    if launches != expected:
        raise AssertionError(f"serving loop launches {launches}, expected {expected} "
                             f"over {ticks} ticks and {restarts} restarts")
    by_gen: dict[int, list[int]] = {}
    for g, k in done:
        by_gen.setdefault(g, []).append(k)
    if len(done) != ticks or any(ks != sorted(ks) for ks in by_gen.values()):
        raise AssertionError(f"serving loop completed {len(done)} ticks of {ticks} "
                             f"or out of order")
    if not restarts and len(records) != ticks:
        raise AssertionError(f"serving loop lost records ({len(records)} of {ticks})")

    # Audio delivery on the sampled rooms, in the last generation: without
    # restarts or flagged rooms, every pushed Opus packet whose tick
    # completed reaches every other participant exactly once, in sn order;
    # none reaches its publisher.
    if bad_frames:
        raise AssertionError(f"media frames with fields {bad_frames[:3]}")
    exact = not restarts and (integ is None or integ.violations_total == 0)
    last = by_gen.get(restarts, [])
    completed = set(last)
    checked = 0
    for (r, t) in audio:
        _col, sid = tracks[r][t]
        want = [p for g, k, p in pushed[(r, t)] if g == restarts and k in completed]
        every = {p for _g, _k, p in pushed[(r, t)]}
        for s in range(sizes[r]):
            frames = [f for g, f in got.get((r, f"p{s}"), [])
                      if g == restarts and f["track_sid"] == sid]
            if s == t:
                if frames:
                    raise AssertionError(f"room{r}: publisher p{t} got its own track")
                continue
            payloads = [f["payload"] for f in frames]
            sns = [f["sn"] for f in frames]
            if not exact:
                # After a restart the first ticks may also carry packets
                # pushed before it; a quarantine leaves gaps.
                wanted = set(want)
                kept = [p for p in payloads if p in wanted]
                it = iter(want)
                if (any(p not in every for p in payloads)
                        or len(set(payloads)) != len(payloads)
                        or not all(p in it for p in kept)
                        or any(not 0 < (b - a) & 0xFFFF < 0x8000 for a, b in zip(sns, sns[1:]))):
                    raise AssertionError(f"room{r} track {t} → p{s}: {len(payloads)} frames "
                                         f"not a rising, once-only subsequence of the pushed")
                checked += len(payloads)
                continue
            if payloads != want:
                raise AssertionError(
                    f"room{r} track {t} → p{s}: {len(payloads)} frames, "
                    f"{len(want)} pushed, first mismatch at "
                    f"{next((i for i, (a, b) in enumerate(zip(payloads, want)) if a != b), min(len(payloads), len(want)))}")
            if any((b - a) & 0xFFFF != 1 for a, b in zip(sns, sns[1:])):
                raise AssertionError(f"room{r} track {t} → p{s}: sn not consecutive")
            checked += len(payloads)

    if not checked and (exact or heard.get(restarts, 0)):
        raise AssertionError("no audio frame of the sampled rooms was delivered")
    for req, _task in sessions.values():
        req.close()
    await rm.stop()
    await asyncio.wait_for(asyncio.gather(*(task for _, task in sessions.values())), 30)

    ms = lambda key: quantiles([rec[key] * 1e3 for rec in records])  # noqa: E731
    plane_report = {}
    if cap_s is not None:
        plane_report = {"failure_plane": {
            "capped": capped, "restarts": restarts,
            "restart_causes": dict(sup.restart_causes) if sup else None,
            "gave_up": sup.gave_up if sup else None,
            "abandoned_steps": rt.stats["abandoned_steps"],
            "dropped_steps": rt.stats["dropped_steps"] - base_dropped,
            "ticks_after_last_restart": len(last), "receiver_estimates": estimates,
            "delivery_check": "exact" if exact else "subsequence",
            "integrity_escalations": integ.escalations if integ else 0,
            "rows_quarantined": integ.rows_quarantined if integ else 0,
            "rows_repaired": integ.rows_repaired if integ else 0,
            "checkpoints": sup.checkpoints if sup else 0,
            "checkpoint_fetch_ms_mean": (sup.checkpoint_fetch_s / sup.checkpoints * 1e3
                                         if sup and sup.checkpoints else None),
            "checkpoint_encode_ms_mean": (sup.checkpoint_encode_s / sup.checkpoints * 1e3
                                          if sup and sup.checkpoints else None),
            "governor_level": gov.level if gov else None,
            "governor_transitions": list(gov.transitions) if gov else None,
            "governor_rejected": dict(gov.rejected) if gov else None,
            "audits": integ.audits if integ else 0,
            "audit_s": integ.audit_s if integ else 0.0,
            "audit_share_of_wall": integ.audit_s / wall_s if integ else 0.0,
            "integrity_violations": integ.violations_total if integ else 0,
            "ingest_dropped_policed": rt.ingest.dropped_policed,
            "ingest_dropped_capacity": rt.ingest.dropped_capacity,
        }}
    return {
        **plane_report,
        "rooms": len(sizes), "participants": int(sum(sizes)), "join_s": join_s,
        "ticks": ticks, "wall_s": wall_s, "ticks_per_s": ticks / wall_s,
        "late_ticks": rt.stats["late_ticks"] - base_late,
        "pipeline_stalls": rt.stats["pipeline_stalls"] - base_stalls,
        "fwd_packets": rt.stats["fwd_packets"] - base_fwd,
        "stage_ms": ms("stage_s"), "device_ms": ms("device_s"),
        "fanout_ms": ms("fanout_s"), "send_ms": ms("send_s"),
        "tick_ms": quantiles([(rec["stage_s"] + rec["device_s"] + rec["fanout_s"]
                               + rec["send_s"]) * 1e3 for rec in records]),
        "wall_ms_per_tick": wall_s / ticks * 1e3,
        "launches": launches, "audio_frames_checked": checked,
        "ingest_dropped": rt.ingest.dropped,
    }


async def serving_phase(dev, dense_dims: plane.PlaneDims = RUNTIME_DIMS,
                        paged_dims: paged.PagedDims = PAGED_RUNTIME_DIMS,
                        seconds: float = SERVING_SECONDS,
                        paged_ticks: int = SERVING_PAGED_TICKS) -> dict:
    """The serving path on the card: RoomManager → rtc rooms → the
    pipelined PlaneRuntime loop, dense (every room RUNTIME_SPEC's 2 VP9-SVC
    video and 2 Opus publishers among its participants) for `seconds`,
    then paged (rooms from the size mix, admitted as in
    `paged_runtime_phase`, each participant publishing one track) for at
    least `paged_ticks` loop ticks. Returns both reports."""
    n_pub = RUNTIME_SPEC.video_tracks + RUNTIME_SPEC.audio_tracks
    configure("warn")     # no info line per join and leave of 20k sessions
    dense = await serve_rooms(
        dev, [dense_dims.subs] * dense_dims.rooms, [n_pub] * dense_dims.rooms, RUNTIME_SPEC,
        serving_config(dense_dims=dense_dims), seconds, 1)
    log(f"serving dense ok: {dense['ticks']} ticks in {dense['wall_s']:.1f} s, "
        f"{dense['late_ticks']} late, launches {dense['launches']}")
    scratch = RoomPager(paged_dims.rooms, paged_dims.tracks, paged_dims.subs,
                        tpage=paged_dims.tpage, spage=paged_dims.spage,
                        pool_pages=paged_dims.pool_pages)
    sizes = admit_rooms(scratch)
    paged_report = await serve_rooms(dev, sizes, sizes, PAGED_SPEC, serving_config(paged_dims),
                                     None, paged_ticks)
    log(f"serving paged ok: {paged_report['ticks']} ticks in "
        f"{paged_report['wall_s']:.1f} s, {paged_report['late_ticks']} late, launches "
        f"{paged_report['launches']}")
    return {"dense": {"dims": list(dense_dims), **dense},
            "paged": {"dims": list(paged_dims), **paged_report}}


# ---------------------------------------------------------------------------
# The UDP media wire
# ---------------------------------------------------------------------------

UDP_LOCK_TICKS = 20
UDP_NACK_TICK = 10                 # the lockstep tick after which subscribers NACK
UDP_SECONDS = 6.0
UDP_PAGED_TICKS = 4
UDP_VOID_SINKS = 8                 # sockets shared by the unchecked rooms' subscribers
UDP_SEND_CHUNK = 256               # datagrams a publisher sends between waits
UDP_WAIT_S = 60.0                  # bound on every wait for the server's receive side
# The media wire is sealed when the process has an AEAD backend (the
# `cryptography` package or libcrypto through ctypes): decided once, here.
REQUIRE_ENCRYPTION = crypto_mod.HAVE_AEAD
# VP9-SVC L3T2: one template per (spatial, temporal), one decode target
# per (spatial, temporal) that needs every frame at or below it.
SVC_LAYERS = ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))
SVC_STRUCTURE = dd.Structure(
    structure_id=0, num_decode_targets=len(SVC_LAYERS),
    templates=[dd.Template(spatial=s, temporal=t,
                           dtis=[3 if s <= ds and t <= dt else 0 for ds, dt in SVC_LAYERS],
                           fdiffs=[1] if t else [])
               for s, t in SVC_LAYERS])


def wire_packets(inp: plane.TickInputs, ssrc: np.ndarray, video: np.ndarray, rng
                 ) -> list[tuple[int, int, bytearray]]:
    """One synth tick → cleartext RTP datagrams [(room, track, datagram)]
    in (room, track, k) order, for the tracks with an SSRC (ssrc[r, t] !=
    0): VP9-SVC video (`video[r, t]`) with a dependency-descriptor
    extension (the structure on keyframes), Opus with an audio-level
    extension; payload bytes from `rng`, of the packets' sizes."""
    valid = np.asarray(inp.valid) & (ssrc != 0)[:, :, None]
    r, t, k = np.nonzero(valid)
    at = lambda f: np.asarray(getattr(inp, f))[r, t, k].tolist()  # noqa: E731
    sizes = np.asarray(inp.size)[r, t, k].astype(np.int64)
    blob = rng.integers(0, 256, int(sizes.sum()), dtype=np.uint8).tobytes()
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    out = []
    for i, (rr, tt, sn, ts, layer, temporal, kf, begin, end, pid, level, size) in enumerate(zip(
            r.tolist(), t.tolist(), at("sn"), at("ts"), at("layer"), at("temporal"),
            at("keyframe"), at("begin_pic"), at("end_frame"), at("pid"),
            at("audio_level"), sizes.tolist())):
        vid = bool(video[rr, tt])
        if vid:
            desc = dd.build(begin, end, SVC_LAYERS.index((layer, min(temporal, 1))),
                            pid & 0xFFFF, structure=SVC_STRUCTURE if kf else None)
            ext = udp_mod.build_ext_section([(udp_mod.DD_EXT_ID, desc)])
            body = bytes([(0 if kf else 0x40) | (0x08 if begin else 0)
                          | (0x04 if end else 0)]) + blob[offs[i]:offs[i] + size - 1]
            pt = udp_mod.SVC_PT | (0x80 if end else 0)
        else:
            ext = udp_mod.build_ext_section(
                [(udp_mod.AUDIO_LEVEL_EXT_ID, bytes([level & 0x7F]))])
            body = blob[offs[i]:offs[i] + size]
            pt = udp_mod.OPUS_PT
        hdr = bytes([0x90, pt]) + (sn & 0xFFFF).to_bytes(2, "big") + \
            (ts & 0xFFFFFFFF).to_bytes(4, "big") + int(ssrc[rr, tt]).to_bytes(4, "big")
        out.append((rr, tt, bytearray(hdr + ext + body)))
    return out


def udp_socket() -> "socket.socket":
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
    s.bind(("127.0.0.1", 0))
    s.setblocking(False)
    return s


async def wait_until(cond, what: str, timeout: float = UDP_WAIT_S) -> None:
    """Poll `cond` on the event loop until it holds; fail after `timeout`."""
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        await asyncio.sleep(0.001)


class UdpRig:
    """A RoomManager on `dev` with its UDP transport on loopback port 0,
    rooms joined through start_session: participants t < pubs[r] announce
    one track each over the signal channel with `transport: udp` (the
    signal handler binds it and assigns its SSRC), every participant asks
    for UDP media (`subscription` with `udp`) and latches its punch id
    from a sink socket — its own room's socket for rooms below
    `n_check`, else one of UDP_VOID_SINKS shared ones. Publishers and
    subscribers speak through one MediaCryptoClient per participant."""

    def __init__(self, rm: RoomManager, sizes, pubs, n_check: int):
        self.rm, self.udp = rm, rm.udp
        self.sizes, self.pubs, self.n_check = list(sizes), list(pubs), n_check
        self.port = self.udp.transport.get_extra_info("sockname")[1]
        self.pub_sock = udp_socket()
        self.check_socks = [udp_socket() for _ in range(n_check)]
        self.void_socks = [udp_socket() for _ in range(UDP_VOID_SINKS)]
        self.clients: dict[int, object] = {}        # key_id → MediaCryptoClient
        self.sessions: dict = {}
        self.sub_client: dict[tuple[int, int], object] = {}   # (row, sub) → client
        R, T = rm.runtime.dims.rooms, rm.runtime.dims.tracks
        self.ssrc = np.zeros((R, T), np.uint32)
        self.video = np.zeros((R, T), bool)
        self.pub_client: dict[tuple[int, int], object] = {}   # (row, col) → client
        self.counters: dict[int, set] = {}    # key_id → egress nonce counters seen
        self.sent = 0

    def sink_of(self, r: int):
        return self.check_socks[r] if r < self.n_check else self.void_socks[r % UDP_VOID_SINKS]

    def client(self, session):
        if session is None:
            return None
        c = self.clients.get(session.key_id)
        if c is None:
            c = self.clients[session.key_id] = crypto_mod.MediaCryptoClient(
                session.key_id, session.key)
        return c

    async def join(self, spec: synth.TrafficSpec) -> float:
        rm = self.rm
        sessions = self.sessions
        t0 = time.perf_counter()
        for r, size in enumerate(self.sizes):
            for t in range(size):
                req, resp = MessageChannel(), MessageChannel()
                init = {"identity": f"p{t}", "name": f"p{t}", "auto_subscribe": True,
                        "grants": {"video": {"roomJoin": True, "room": f"room{r}"}}}
                task = asyncio.ensure_future(rm.start_session(f"room{r}", init, req, resp))
                sessions[(r, f"p{t}")] = (req, task)
        want = sum(self.sizes)
        await wait_until(lambda: sum(len(x.participants) for x in rm.rooms.values()) >= want
                         or any(task.done() for _, task in sessions.values()), "the joins")
        if any(task.done() for _, task in sessions.values()):
            raise AssertionError("a session ended during the joins")
        join_s = time.perf_counter() - t0
        rooms = [rm.rooms[f"room{r}"] for r in range(len(self.sizes))]
        for r, room in enumerate(rooms):
            if room.slots.row != r:
                raise AssertionError(f"room{r} on row {room.slots.row}")
        # Tracks in column order: participant t's announce, for every room,
        # before participant t + 1's.
        for t in range(max(self.pubs, default=0)):
            video = t < spec.video_tracks
            for r, n_pub in enumerate(self.pubs):
                if t < n_pub:
                    sessions[(r, f"p{t}")][0].write_message(json.dumps({"add_track": {
                        "cid": f"c{t}", "name": f"c{t}", "type": int(video),
                        "mime_type": "video/vp9" if video else "audio/opus",
                        "transport": "udp"}}))
            await wait_until(lambda: all(len(room.tracks) > t for room, n in zip(rooms, self.pubs)
                                         if t < n), f"track {t} in every room")
        for ssrc, b in self.udp.bindings.items():
            self.ssrc[b.room, b.track] = ssrc
            self.video[b.room, b.track] = b.is_video
            self.pub_client[(b.room, b.track)] = self.client(b.session)
        for r, room in enumerate(rooms):
            for t in range(self.pubs[r]):
                col = room.participants[f"p{t}"].published
                if [tr.track_col for tr in col.values()] != [t]:
                    raise AssertionError(f"room{r}: p{t} published {list(col)}")
        # UDP media for everyone: punch ids over the signal channel, then a
        # sealed punch from each subscriber's sink socket.
        for (r, ident), (req, _task) in sessions.items():
            req.write_message(json.dumps({"subscription": {"udp": True}}))
        await wait_until(lambda: len(self.udp._punch_by_sub) >= want, "the punch ids")
        n = 0
        for r, room in enumerate(rooms):
            for p in room.participants.values():
                key = (r, p.sub_col)
                pid = self.udp._punch_by_sub[key]
                c = self.client(p.crypto_session)
                self.sub_client[key] = c
                d = udp_mod.PUNCH_REQ + pid.to_bytes(4, "big")
                self.sink_of(r).sendto(c.seal(d) if c is not None else d, ("127.0.0.1", self.port))
                n += 1
                if n % UDP_SEND_CHUNK == 0:
                    await wait_until(lambda: len(self.udp.sub_addrs) >= n, "the punches")
        await wait_until(lambda: len(self.udp.sub_addrs) >= want, "the punches")
        self.drain_checked()
        return join_s

    async def send(self, dgrams) -> None:
        """Seal each datagram under its publisher's client and send it to
        the server in chunks, waiting after each chunk until the server's
        socket has taken it (the lockstep check needs every packet in)."""
        rx0 = self.udp.stats["rx"]
        n = 0
        for r, t, d in dgrams:
            c = self.pub_client[(r, t)]
            self.pub_sock.sendto(c.seal(bytes(d)) if c is not None else bytes(d),
                                 ("127.0.0.1", self.port))
            n += 1
            if n % UDP_SEND_CHUNK == 0:
                await wait_until(lambda: self.udp.stats["rx"] >= rx0 + n, "the publishers")
        await wait_until(lambda: self.udp.stats["rx"] >= rx0 + n, "the publishers")
        self.sent += n

    def drain_checked(self, socks=None) -> dict:
        """Open every datagram waiting on `socks` (the checked rooms'
        sockets by default) → {(row, sub, track): [media datagram with its
        SSRC zeroed]}. Every sealing path of the node (batched, express,
        retransmission, RTCP) draws from one counter per session, so no
        nonce counter may repeat on a session."""
        got: dict = {}
        for sock in self.check_socks if socks is None else socks:
            while True:
                try:
                    frame = sock.recv(4096)
                except BlockingIOError:
                    break
                if frame[0] == crypto_mod.MAGIC:
                    key_id = crypto_mod.parse_key_id(frame)
                    seen = self.counters.setdefault(key_id, set())
                    if frame[6:14] in seen:
                        raise AssertionError(f"nonce counter reused on session {key_id}")
                    seen.add(frame[6:14])
                    sess = self.rm.crypto.get(key_id)
                    c = self.client(sess)
                    frame = c.open(frame) if c is not None else None
                    if frame is None:
                        raise AssertionError("a sealed egress datagram did not open")
                if frame[:8] == udp_mod.PUNCH_ACK or 192 <= frame[1] <= 223:
                    continue                     # punch acks, RTCP
                key = self.udp.egress_rev.get(int.from_bytes(frame[8:12], "big"))
                if key is None:
                    raise AssertionError("egress datagram with an unknown SSRC")
                got.setdefault(key, []).append(frame[:8] + bytes(4) + frame[12:])
        return got

    def nack(self, got: dict) -> int:
        """Each checked subscriber NACKs the last two video packets it got
        on each video track (RTCP generic NACK, sealed, from its sink);
        returns the sequence numbers NACKed."""
        n = 0
        for (row, sub, track), frames in sorted(got.items()):
            if not self.video[row, track] or len(frames) < 2:
                continue
            sns = [int.from_bytes(f[2:4], "big") for f in frames[-2:]]
            media = self.udp.subscriber_ssrc(row, sub, track)
            d = udp_mod.build_nack(0x5EED0000 + sub, media, sns)
            c = self.sub_client[(row, sub)]
            self.sink_of(row).sendto(c.seal(d) if c is not None else d,
                                     ("127.0.0.1", self.port))
            n += len(sns)
        return n

    async def close(self) -> None:
        for req, _task in self.sessions.values():
            req.close()
        await self.rm.stop()
        await asyncio.wait_for(asyncio.gather(*(task for _, task in self.sessions.values())), 60)
        self.rm.close_transports()
        for s in (self.pub_sock, *self.check_socks, *self.void_socks):
            s.close()


async def udp_room_manager(dev, cfg: Config) -> RoomManager:
    """A RoomManager on `dev` with its UDP transport started on an
    ephemeral loopback port and attached (what RoomManager.start_transports
    does on rtc.udp_port)."""
    rm = RoomManager(cfg, LocalRouter(LocalNode()), LocalStore(),
                     telemetry=TelemetryService(cfg), device=dev)
    udp = await udp_mod.start_udp_transport(
        rm.runtime.ingest, "127.0.0.1", 0, crypto=rm.crypto,
        require_encryption=cfg.rtc.require_encryption,
        nack_resolver=rm.runtime.resolve_nacks)
    rm.attach_udp(udp)
    return rm


def udp_config(paged_dims: paged.PagedDims | None = None,
               dense_dims: plane.PlaneDims = RUNTIME_DIMS) -> Config:
    cfg = serving_config(paged_dims, dense_dims)
    cfg.rtc.require_encryption = REQUIRE_ENCRYPTION
    return cfg


async def udp_lockstep(gpu: UdpRig, cpu: UdpRig, spec: synth.TrafficSpec,
                       ticks: int) -> dict:
    """Step both rigs `ticks` times through step_once with the same
    seeded publisher datagrams (the CPU rig gets the checked rooms' only)
    and hold every opened egress datagram of the checked rooms equal,
    byte for byte but the SSRC (random per node), which is compared
    through the (row, sub, track) it names. After UDP_NACK_TICK the
    checked subscribers NACK, so retransmissions join the comparison."""
    dims = gpu.rm.runtime.dims
    R = dims.rooms
    room_pubs = np.zeros(R, np.int64)
    room_pubs[:len(gpu.pubs)] = gpu.pubs
    logical = plane.PlaneDims(R, dims.tracks, dims.pkts, dims.subs)
    traffic = synth.init_traffic(logical, spec, seed=SEED)
    rng = np.random.default_rng(SEED)
    n = cpu.n_check
    compared = rtx = pads = 0
    for i in range(ticks):
        traffic, inp = synth.next_tick(traffic, logical, spec, i, seed=SEED)
        dgrams = wire_packets(mask_to_rooms(inp, room_pubs), gpu.ssrc, gpu.video, rng)
        mine = []
        for r, t, d in dgrams:
            if r < n:
                d2 = bytearray(d)
                d2[8:12] = int(cpu.ssrc[r, t]).to_bytes(4, "big")
                mine.append((r, t, d2))
        await gpu.send(dgrams)
        await cpu.send(mine)
        await gpu.rm.runtime.step_once()
        await cpu.rm.runtime.step_once()
        got_g, got_c = gpu.drain_checked(), cpu.drain_checked()
        if i == UDP_NACK_TICK:
            rtx0 = (gpu.udp.stats["rtx_tx"], cpu.udp.stats["rtx_tx"])
            nacks = (gpu.nack(got_g), cpu.nack(got_c))
            if nacks[0] != nacks[1] or not nacks[0]:
                raise AssertionError(f"lockstep: NACKs sent {nacks}")
            await wait_until(lambda: gpu.udp.stats["nacks_rx"] >= nacks[0]
                             and cpu.udp.stats["nacks_rx"] >= nacks[1], "the NACKs")
            rtx += gpu.udp.stats["rtx_tx"] - rtx0[0]
            if cpu.udp.stats["rtx_tx"] - rtx0[1] != gpu.udp.stats["rtx_tx"] - rtx0[0]:
                raise AssertionError("lockstep: retransmissions differ")
            for key, frames in gpu.drain_checked().items():
                got_g.setdefault(key, []).extend(frames)
            for key, frames in cpu.drain_checked().items():
                got_c.setdefault(key, []).extend(frames)
        if got_g.keys() != got_c.keys():
            raise AssertionError(f"lockstep tick {i}: egress streams differ "
                                 f"({len(got_g)} on the card, {len(got_c)} on the CPU)")
        for key in got_g:
            if got_g[key] != got_c[key]:
                raise AssertionError(f"lockstep tick {i}: datagrams to {key} differ")
            compared += len(got_g[key])
            pads += sum(1 for f in got_g[key] if f[0] & 0x20)
    if not compared:
        raise AssertionError("lockstep: no egress datagram of the checked rooms")
    return {"ticks": ticks, "rooms": n, "datagrams_compared": compared,
            "rtx": rtx, "padding": pads, "exact": True}


def publisher_main(sock, port: int, streams: list, counters: dict, dims: tuple,
                   spec: dict, room_pubs: list, first_tick: int, tick_count, ready,
                   stop, sent) -> None:
    """The load generator of the real-time loop, in a process of its own:
    for each serving-loop tick (`tick_count` advances), the next seeded
    synth tick's datagrams, sealed under each publisher's client (whose
    tx counters continue from `counters`), sent from `sock` (the socket
    the server latched the publishers to) to the server's port. `streams`
    holds (row, col, ssrc, video, key_id, key) per bound track. Sets
    `ready` once its first tick's datagrams are built."""
    logical = plane.PlaneDims(*dims)
    spec = synth.TrafficSpec(**spec)
    R, T = logical.rooms, logical.tracks
    ssrc = np.zeros((R, T), np.uint32)
    video = np.zeros((R, T), bool)
    clients: dict = {}
    pub = {}
    for row, col, sv, vid, key_id, key in streams:
        ssrc[row, col], video[row, col] = sv, vid
        if key_id is not None:
            c = clients.get(key_id)
            if c is None:
                c = clients[key_id] = crypto_mod.MediaCryptoClient(key_id, key)
                c.tx_counter = counters[key_id]
            pub[(row, col)] = c
    rp = np.zeros(R, np.int64)
    rp[:len(room_pubs)] = room_pubs
    traffic = synth.init_traffic(logical, spec, seed=SEED)
    for i in range(first_tick):
        traffic, _ = synth.next_tick(traffic, logical, spec, i, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    sock.setblocking(True)
    i, seen = first_tick, tick_count.value
    while not stop.is_set():
        traffic, inp = synth.next_tick(traffic, logical, spec, i, seed=SEED)
        dgrams = wire_packets(mask_to_rooms(inp, rp), ssrc, video, rng)
        ready.set()
        for r, t, d in dgrams:
            c = pub.get((r, t))
            sock.sendto(c.seal(bytes(d)) if c is not None else bytes(d), ("127.0.0.1", port))
        sent.value += len(dgrams)
        i += 1
        while tick_count.value == seen and not stop.is_set():
            time.sleep(0.0005)
        seen = tick_count.value


class SendSpans:
    """Seconds spent inside pieces of the transport's tick send, summed
    over a run: the per-downtrack sender reports (`_send_srs`), the
    per-entry extension sections (`_build_ext_sections`: dependency
    descriptors, playout delay) and the native sharded send. Installed by
    wrapping the bound methods; `restore` puts them back."""

    PIECES = (("sr", "_send_srs"), ("ext", "_build_ext_sections"))

    def __init__(self, udp):
        self.udp, self.s = udp, {"sr": 0.0, "ext": 0.0, "native_send": 0.0}
        self._orig = [(udp, attr, getattr(udp, attr)) for _, attr in self.PIECES]
        self._orig.append((native.egress, "send_sharded", native.egress.send_sharded))
        for (key, attr), (obj, _, fn) in zip((*self.PIECES, ("native_send", "")), self._orig):
            setattr(obj, attr or "send_sharded", self._timed(key, fn))

    def _timed(self, key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[key] += time.perf_counter() - t0
        return run

    def restore(self) -> None:
        for obj, attr, fn in self._orig:
            setattr(obj, attr, fn)


def sink_counter(socks, stop: threading.Event, counts: list) -> None:
    """Count the datagrams arriving on the sink sockets (a thread: the
    native batch receive releases the interpreter lock)."""
    egress = native.egress
    MAXN, MAXD = 1024, 2048
    scratch = np.zeros(MAXN * MAXD, np.uint8)
    offs, lens = np.zeros(MAXN, np.int32), np.zeros(MAXN, np.int32)
    ips, ports = np.zeros(MAXN, np.uint32), np.zeros(MAXN, np.uint16)
    while not stop.is_set():
        ready, _, _ = select.select(socks, [], [], 0.05)
        for s in ready:
            counts[0] += max(0, egress.rx_batch(s.fileno(), scratch, offs, lens, ips,
                                                ports, MAXD))


async def udp_loop(rig: UdpRig, spec: synth.TrafficSpec, seconds: float | None,
                   min_ticks: int, first_tick: int) -> dict:
    """The real-time serving loop over the wire: RoomManager.start →
    PlaneRuntime._run, each tick's egress leaving through the transport's
    native batch send; a publisher process sends one seeded synth tick of
    sealed datagrams per loop tick; a thread counts what reaches the
    sinks. Runs `seconds` (or until `min_ticks` ticks); checks the
    launches; returns the report."""
    rm, udp = rig.rm, rig.udp
    rt = rm.runtime
    dims = rt.dims
    ctx = multiprocessing.get_context("spawn")
    tick_count, sent = ctx.Value("q", 0), ctx.Value("q", 0)
    ready, stop = ctx.Event(), ctx.Event()
    streams = [(int(r), int(t), int(rig.ssrc[r, t]), bool(rig.video[r, t]),
                c.key_id if c is not None else None, c.key if c is not None else None)
               for (r, t), c in rig.pub_client.items()]
    counters = {k: c.tx_counter for k, c in rig.clients.items()}
    spec_kw = {f: getattr(spec, f) for f in ("video_tracks", "audio_tracks", "fps",
                                             "tick_ms", "video_kbps", "audio_kbps", "svc",
                                             "estimate_bps")}
    proc = ctx.Process(target=publisher_main, daemon=True, args=(
        rig.pub_sock, rig.port, streams, counters, (dims.rooms, dims.tracks, dims.pkts, dims.subs),
        spec_kw, rig.pubs, first_tick, tick_count, ready, stop, sent))

    def on_tick(_res) -> None:
        tick_count.value += 1

    # The warm step and watermark of LivekitServer.start, then the loop.
    await rt.step_once()
    rt.mark_warm()
    rt.on_tick(on_tick)
    socks = [*rig.check_socks, *rig.void_socks]
    for sock in socks:        # what the lockstep ticks left on the sinks
        while True:
            try:
                sock.recv(4096)
            except BlockingIOError:
                break
    received = [0]
    sink_stop = threading.Event()
    sink = threading.Thread(target=sink_counter, args=(socks, sink_stop, received), daemon=True)
    dead_keys = []
    fresh = paged.dead_page_outputs

    def counted(*a, **kw):
        dead_keys.append(1)
        return fresh(*a, **kw)

    base = dict(rt.stats)
    tx0 = {k: udp.stats.get(k, 0) for k in ("rx", "tx", "tx_drop", "rtx_tx")}
    eg0 = rt.egress_plane.observe()
    spans = SendSpans(udp)
    udp.fwd_latency.reset()
    proc.start()
    sink.start()
    paged.dead_page_outputs = counted
    paged.dead_page_outputs_cached.cache_clear()
    try:
        await wait_until(lambda: ready.is_set() or not proc.is_alive(), "the publisher")
        cuda.reset_launches()
        t0 = time.perf_counter()
        rm.start()
        while True:
            await asyncio.sleep(0.05)
            n = rt.stats["ticks"] - base["ticks"]
            if not proc.is_alive():
                raise AssertionError(f"publisher process exited ({proc.exitcode})")
            if (seconds is None or time.perf_counter() - t0 >= seconds) and n >= min_ticks:
                break
            if time.perf_counter() - t0 > SERVING_WALL_CAP_S:
                raise AssertionError(f"UDP loop ran {n} ticks in {SERVING_WALL_CAP_S} s")
        await rt.stop()
        loop_ledger(f"udp {'paged' if isinstance(rt, PagedPlaneRuntime) else 'dense'}", rt)
        wall_s = time.perf_counter() - t0
        launches = dict(cuda.launches)
    finally:
        paged.dead_page_outputs = fresh
        spans.restore()
        stop.set()
        proc.join(30)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
        await asyncio.sleep(0.2)       # the last sends reach the sinks
        sink_stop.set()
        sink.join(10)
    ticks = rt.stats["ticks"] - base["ticks"]
    keys = len(dead_keys)
    if isinstance(rt, PagedPlaneRuntime):
        expected = paged_launches(ticks, keys)
    else:
        expected = dense_launches(ticks)
    if launches != expected:
        raise AssertionError(f"UDP loop launches {launches}, expected {expected} "
                             f"over {ticks} ticks")
    stats = {k: udp.stats.get(k, 0) - v for k, v in tx0.items()}
    shard_sums = shard_send_sums(rt, eg0)
    if shard_sums["ticks_built_short"]:
        raise AssertionError(f"UDP loop: a shard built another call's entries (C12): "
                             f"{shard_sums}")
    if stats["tx"] <= 0 or received[0] <= 0:
        raise AssertionError(f"UDP loop: tx {stats['tx']}, {received[0]} received, "
                             f"{sent.value} sent by the publishers, {ticks} ticks, "
                             f"transport {udp.stats}")
    records = rt.trace.snapshot(ticks)
    ms = lambda key: quantiles([rec[key] * 1e3 for rec in records])  # noqa: E731
    return {
        "ticks": ticks, "wall_s": wall_s, "ticks_per_s": ticks / wall_s,
        "wall_ms_per_tick": wall_s / ticks * 1e3,
        "late_ticks": rt.stats["late_ticks"] - base["late_ticks"],
        "late_share": (rt.stats["late_ticks"] - base["late_ticks"]) / ticks,
        "pipeline_stalls": rt.stats["pipeline_stalls"] - base["pipeline_stalls"],
        "fwd_packets": rt.stats["fwd_packets"] - base["fwd_packets"],
        "stage_ms": ms("stage_s"), "device_ms": ms("device_s"),
        "fanout_ms": ms("fanout_s"), "send_ms": ms("send_s"),
        "tick_ms": quantiles([(rec["stage_s"] + rec["device_s"] + rec["fanout_s"]
                               + rec["send_s"]) * 1e3 for rec in records]),
        "forward_latency": udp.fwd_latency.summary(),
        "publisher_sent": int(sent.value), "server_rx": stats["rx"],
        "tx": stats["tx"], "tx_drop": stats["tx_drop"], "rtx_tx": stats["rtx_tx"],
        "received": received[0], "egress_shards": rt.egress_plane.shards,
        "send_pieces_ms_per_tick": {k: v / ticks * 1e3 for k, v in spans.s.items()},
        "ingest_dropped": rt.ingest.dropped, "launches": launches,
        "shard_sums": shard_sums,
    }


def shard_send_sums(rt: PlaneRuntime, before: dict) -> dict:
    """The sharded sends since `before` (an egress-plane observe()): what
    the shards built and sent, summed over shards on every tick, and the
    ticks whose built sum missed the tick's entries (a shard lost to
    another call, C12) or whose sent sum missed the built sum (datagrams
    the socket did not take)."""
    now = rt.egress_plane.observe()
    keys = ("ticks", "entries", "shard_built_sum", "shard_sent_sum", "ticks_built_short",
            "ticks_sent_short")
    return {k: now[k] - before[k] for k in keys}


def udp_summary(rep: dict) -> str:
    fl = rep["forward_latency"]
    return (f"{rep['ticks']} ticks in {rep['wall_s']:.1f} s, wall {rep['wall_ms_per_tick']:.2f} "
            f"ms/tick, send median {rep['send_ms']['median']:.2f} ms, forward latency "
            f"p50/p99 {fl['p50_ms']}/{fl['p99_ms']} ms, tx {rep['tx']} (drop "
            f"{rep['tx_drop']}), received {rep['received']}, launches {rep['launches']}, "
            f"shard sums {json.dumps(rep['shard_sums'])}")


async def udp_phase(dev, dense_dims: plane.PlaneDims = RUNTIME_DIMS,
                    paged_dims: paged.PagedDims = PAGED_RUNTIME_DIMS,
                    seconds: float = UDP_SECONDS, paged_ticks: int = UDP_PAGED_TICKS,
                    lock_ticks: int = UDP_LOCK_TICKS) -> dict:
    """The reference's default media wire on the card: RoomManager with
    the UDP transport on loopback. Dense (RUNTIME_SPEC's 2 VP9-SVC video
    and 2 Opus publishers a room): `lock_ticks` lockstep ticks against a
    CPU RoomManager of the first CHECK_ROOMS rooms, then the real-time
    loop for `seconds`. Paged (the size mix, each participant publishing
    one track): the real-time loop for at least `paged_ticks` ticks."""
    configure("warn")
    status = native.status()
    if not all(status["loaded"].values()):
        raise AssertionError(f"native libraries not loaded: {status}")
    for name, b in status["builds"].items():
        log(f"native {name}: {b['cmd']}")
    log(f"libcrypto: {status['libcrypto'] or 'none'}; media sealed: {REQUIRE_ENCRYPTION}")
    n_pub = RUNTIME_SPEC.video_tracks + RUNTIME_SPEC.audio_tracks
    n_check = min(CHECK_ROOMS, dense_dims.rooms)
    gpu = UdpRig(await udp_room_manager(dev, udp_config(dense_dims=dense_dims)),
                 [dense_dims.subs] * dense_dims.rooms, [n_pub] * dense_dims.rooms, n_check)
    cpu_dims = plane.PlaneDims(n_check, *dense_dims[1:])
    cpu = UdpRig(await udp_room_manager("cpu", udp_config(dense_dims=cpu_dims)),
                 [dense_dims.subs] * n_check, [n_pub] * n_check, n_check)
    join_s = await gpu.join(RUNTIME_SPEC)
    await cpu.join(RUNTIME_SPEC)
    log(f"udp: {sum(gpu.sizes)} participants joined and punched in {join_s:.2f} s")
    lock = await udp_lockstep(gpu, cpu, RUNTIME_SPEC, lock_ticks)
    log(f"udp lockstep exact: rooms 0..{n_check - 1}, {lock['datagrams_compared']} "
        f"datagrams over {lock_ticks} ticks ({lock['rtx']} retransmitted, "
        f"{lock['padding']} padding)")
    await cpu.close()
    dense = await udp_loop(gpu, RUNTIME_SPEC, seconds, 1, lock_ticks)
    await gpu.close()
    log(f"udp dense ok: {udp_summary(dense)}")
    scratch = RoomPager(paged_dims.rooms, paged_dims.tracks, paged_dims.subs,
                        tpage=paged_dims.tpage, spage=paged_dims.spage,
                        pool_pages=paged_dims.pool_pages)
    sizes = admit_rooms(scratch)
    prig = UdpRig(await udp_room_manager(dev, udp_config(paged_dims)), sizes, sizes, 0)
    pjoin = await prig.join(PAGED_SPEC)
    paged_report = await udp_loop(prig, PAGED_SPEC, None, paged_ticks, 0)
    await prig.close()
    log(f"udp paged ok: {udp_summary(paged_report)}")
    return {"native": status, "sealed": REQUIRE_ENCRYPTION,
            "lockstep": lock,
            "dense": {"dims": list(dense_dims), "join_s": join_s, **dense},
            "paged": {"dims": list(paged_dims), "join_s": pjoin, **paged_report}}


# ---------------------------------------------------------------------------
# The express lane and the media relay (phase 5c)
# ---------------------------------------------------------------------------

EXPRESS_DIMS = RUNTIME_DIMS        # cfg4's plane
EXPRESS_ROOMS = 64                 # rooms of 2–4 participants
EXPRESS_MAX_SUBS = 4
EXPRESS_MAX_ROOMS = 16             # the reference's default cap
EXPRESS_LOCK_TICKS = 30
EXPRESS_PIN = (12, 18, 3)          # room 3 pinned to the batched tier for ticks 12..17
EXPRESS_SECONDS = 5.0
EXPRESS_KEYFRAME_EVERY = 10
VP8_LAYERS = 3
# Rooms whose publishers reach the lane's node through the media relay:
# four express rooms and four batched ones (the lane takes rooms 0..15).
RELAY_ROOMS = (0, 1, 2, 3, 16, 17, 18, 19)


def vp8_descriptor(pid: int, tl0: int, tid: int, keyidx: int, keyframe: bool) -> bytes:
    """A VP8 payload descriptor (X, I with a 15-bit picture id, L, T, K;
    start of partition, layer sync) and the first VP8 header byte."""
    return bytes([0x90, 0xF0, 0x80 | (pid >> 8), pid & 0xFF, tl0 & 0xFF,
                  (tid << 6) | 0x20 | (keyidx & 0x1F), 0x00 if keyframe else 0x01])


def express_datagrams(rooms: int, tick: int) -> list[tuple[int, int, int, bytes]]:
    """One tick of seeded cleartext RTP for every room: a VP8 simulcast
    frame on each of VP8_LAYERS layers (track 0; a keyframe on every
    layer each EXPRESS_KEYFRAME_EVERY ticks, temporal layers 0/1) and an
    Opus packet with an audio level (track 1). Sequence numbers, picture
    ids and TL0PICIDX start near their wraps. → [(room, track, layer,
    datagram)]; the SSRC field is filled by the rig."""
    base = np.random.default_rng(SEED).integers(0, 1 << 16, (rooms, VP8_LAYERS + 1))
    rng = np.random.default_rng((SEED, tick))
    out = []
    kf = tick % EXPRESS_KEYFRAME_EVERY == 0
    for r in range(rooms):
        for layer in range(VP8_LAYERS):
            sn = (int(base[r, layer]) + tick) & 0xFFFF
            desc = vp8_descriptor((32700 + 7 * layer + tick) & 0x7FFF, 250 + tick // 2,
                                  tick % 2, tick // EXPRESS_KEYFRAME_EVERY, kf)
            body = desc + rng.integers(0, 256, 80 + 120 * layer, dtype=np.uint8).tobytes()
            hdr = bytes([0x80, 0x80 | 96]) + sn.to_bytes(2, "big") + \
                ((3000 * tick + 90 * r) & 0xFFFFFFFF).to_bytes(4, "big") + bytes(4)
            out.append((r, 0, layer, hdr + body))
        sn = (int(base[r, VP8_LAYERS]) + tick) & 0xFFFF
        ext = udp_mod.build_ext_section([(udp_mod.AUDIO_LEVEL_EXT_ID, bytes([30]))])
        hdr = bytes([0x90, udp_mod.OPUS_PT]) + sn.to_bytes(2, "big") + \
            (960 * tick).to_bytes(4, "big") + bytes(4)
        out.append((r, 1, 0, hdr + ext + rng.integers(0, 256, 60, dtype=np.uint8).tobytes()))
    return out


def express_config(express: bool) -> Config:
    """udp_config at EXPRESS_DIMS, the express lane on or off."""
    cfg = udp_config(dense_dims=EXPRESS_DIMS)
    cfg.plane.express_max_subs = EXPRESS_MAX_SUBS if express else 0
    cfg.plane.express_max_rooms = EXPRESS_MAX_ROOMS
    return cfg


class ExpressRig(UdpRig):
    """A UdpRig (its node, publisher socket and UDP_VOID_SINKS sink
    sockets, every subscriber on one of them) with phase 5c's rooms: p0
    publishes VP8 simulcast (`transport: udp`, VP8_LAYERS layers), p1
    Opus; everyone subscribes over UDP. With `relay_rooms`, the node
    runs its media relay (RoomManager.start_relay) and those rooms'
    publishers reach it only through the relay: each asks for an
    allocation with `request_relay` over its signal channel and BINDs a
    socket of its own with the token it gets back."""

    def __init__(self, rm: RoomManager, sizes):
        super().__init__(rm, sizes, [2] * len(sizes), 0)
        self.rt = rm.runtime
        self.resps: dict = {}       # (room, identity) → response channel
        self.route: dict = {}       # (room, track) → (socket, address)
        self.layer_ssrc: dict = {}  # (room, track, layer) → ssrc

    async def join(self, relay_rooms=()) -> float:
        rm = self.rm
        t0 = time.perf_counter()
        for r, size in enumerate(self.sizes):
            for t in range(size):
                req, resp = MessageChannel(), MessageChannel()
                init = {"identity": f"p{t}", "name": f"p{t}", "auto_subscribe": True,
                        "grants": {"video": {"roomJoin": True, "room": f"room{r}"}}}
                task = asyncio.ensure_future(rm.start_session(f"room{r}", init, req, resp))
                self.sessions[(r, f"p{t}")] = (req, task)
                self.resps[(r, f"p{t}")] = resp
        want = sum(self.sizes)
        await wait_until(lambda: sum(len(x.participants) for x in rm.rooms.values()) >= want
                         or any(task.done() for _, task in self.sessions.values()), "the joins")
        if any(task.done() for _, task in self.sessions.values()):
            raise AssertionError("a session ended during the joins")
        join_s = time.perf_counter() - t0
        rooms = [rm.rooms[f"room{r}"] for r in range(len(self.sizes))]
        tracks = ({"cid": "v", "name": "v", "type": 1, "mime_type": "video/vp8",
                   "transport": "udp", "layers": [{"quality": q} for q in range(VP8_LAYERS)]},
                  {"cid": "a", "name": "a", "type": 0, "mime_type": "audio/opus",
                   "transport": "udp"})
        for t, msg in enumerate(tracks):    # video in every room, then audio
            for r in range(len(rooms)):
                self.sessions[(r, f"p{t}")][0].write_message(json.dumps({"add_track": msg}))
            await wait_until(lambda: all(len(room.tracks) > t for room in rooms),
                             f"track {t} in every room")
        for ssrc, b in self.udp.bindings.items():
            self.layer_ssrc[(b.room, b.track, b.layer)] = ssrc
            self.pub_client[(b.room, b.track)] = self.client(b.session)
            self.route[(b.room, b.track)] = (self.pub_sock, ("127.0.0.1", self.port))
        if len(self.layer_ssrc) != len(rooms) * (VP8_LAYERS + 1):
            raise AssertionError(f"{len(self.layer_ssrc)} SSRCs bound")
        for r, room in enumerate(rooms):
            for t in range(2):
                col = room.participants[f"p{t}"].published
                if [tr.track_col for tr in col.values()] != [t]:
                    raise AssertionError(f"room{r}: p{t} published {list(col)}")
        for req, _task in self.sessions.values():
            req.write_message(json.dumps({"subscription": {"udp": True}}))
        await wait_until(lambda: len(self.udp._punch_by_sub) >= want, "the punch ids")
        for r, room in enumerate(rooms):
            for p in room.participants.values():
                pid = self.udp._punch_by_sub[(r, p.sub_col)]
                c = self.sub_client[(r, p.sub_col)] = self.client(p.crypto_session)
                d = udp_mod.PUNCH_REQ + pid.to_bytes(4, "big")
                self.sink_of(r).sendto(c.seal(d) if c is not None else d,
                                       ("127.0.0.1", self.port))
        await wait_until(lambda: len(self.udp.sub_addrs) >= want, "the punches")
        for r in relay_rooms:
            for t in range(2):
                await self.via_relay(r, t)
        self.drain()
        return join_s

    async def via_relay(self, r: int, t: int) -> None:
        """Route publisher p{t} of room r through the node's media relay:
        `request_relay` over its signal channel, then a BIND from a socket
        of its own with the token it got back."""
        req, _task = self.sessions[(r, f"p{t}")]
        resp = self.resps[(r, f"p{t}")]
        while not resp._q.empty():          # what the joins left
            resp._q.get_nowait()
        req.write_message(json.dumps({"request_relay": {}}))
        info: list = []

        def answered() -> bool:
            while not resp._q.empty():
                msg = decode_signal_response(resp._q.get_nowait())
                if msg.kind == "request_response" and "relay_info" in msg.data:
                    info.append(msg.data["relay_info"])
            return bool(info)

        await wait_until(answered, "relay_info")
        if info[0] is None:
            raise AssertionError("request_relay answered without a relay")
        sock = udp_socket()
        addr = (info[0]["host"], info[0]["port"])
        sock.sendto(RELAY_MAGIC + bytes([BIND_REQ]) + bytes.fromhex(info[0]["token"]), addr)
        acks: list = []

        def acked() -> bool:
            try:
                acks.append(sock.recv(64))
            except BlockingIOError:
                pass
            return bool(acks)

        await wait_until(acked, "the relay's BIND ack")
        if acks[0][:5] != RELAY_MAGIC + bytes([BIND_ACK]):
            raise AssertionError(f"relay BIND refused: {acks[0]!r}")
        self.route[(r, t)] = (sock, addr)

    def sealed(self, dgrams):
        """(socket, address, datagram) for each (room, track, layer,
        cleartext): the node's SSRC for the layer written in, sealed under
        the publisher's client, on the publisher's route (direct or
        through the relay)."""
        for r, t, layer, d in dgrams:
            d = d[:8] + self.layer_ssrc[(r, t, layer)].to_bytes(4, "big") + d[12:]
            c = self.pub_client[(r, t)]
            sock, addr = self.route[(r, t)]
            yield sock, addr, c.seal(d) if c is not None else d

    async def send(self, dgrams) -> None:
        """Send each datagram on its route and wait until the node's
        socket has taken them all."""
        rx0 = self.udp.stats["rx"]
        n = 0
        for sock, addr, d in self.sealed(dgrams):
            sock.sendto(d, addr)
            n += 1
            if n % UDP_SEND_CHUNK == 0:
                await wait_until(lambda: self.udp.stats["rx"] >= rx0 + n, "the publishers")
        await wait_until(lambda: self.udp.stats["rx"] >= rx0 + n, "the publishers")

    def drain(self) -> dict:
        return self.drain_checked(self.void_socks)

    async def close(self) -> None:
        await super().close()
        for sock, _ in self.route.values():
            if sock is not self.pub_sock:
                sock.close()


async def express_lockstep(x: ExpressRig, b: ExpressRig, ticks: int) -> dict:
    """Step the lane's node `x` and the batched node `b` through step_once
    on the same seeded datagrams; every subscriber's opened datagrams must
    be equal on both, byte for byte but the SSRC (random per node; keyed
    through the (row, sub, track) it names). Room EXPRESS_PIN[2] is pinned
    to the batched tier on x for ticks EXPRESS_PIN[0]..[1] − 1."""
    lo, hi, pin_room = EXPRESS_PIN
    compared = 0
    lane = x.rt.express
    for i in range(ticks):
        x.rt.set_express_pin(pin_room, False if lo <= i < hi else None)
        dgrams = express_datagrams(len(x.sizes), i)
        await x.send(dgrams)
        await b.send(dgrams)
        await x.rt.step_once()
        await b.rt.step_once()
        gx, gb = x.drain(), b.drain()
        if gx.keys() != gb.keys():
            raise AssertionError(f"express lockstep tick {i}: streams differ "
                                 f"({len(gx)} with the lane, {len(gb)} batched)")
        for key in gx:
            if gx[key] != gb[key]:
                raise AssertionError(f"express lockstep tick {i}: datagrams to {key} differ "
                                     f"(express room: {bool(lane.active[key[0]])})")
            compared += len(gx[key])
        if lo <= i < hi and lane.active[pin_room]:
            raise AssertionError(f"room {pin_room} still express while pinned to batched")
    if not compared:
        raise AssertionError("express lockstep: no egress datagram")
    return {"ticks": ticks, "datagrams_compared": compared, "exact": True,
            "express_rooms": int(lane.active.sum()),
            "nonces_checked": sum(len(v) for v in x.counters.values())}


async def express_loop(x: ExpressRig, seconds: float, first_tick: int) -> dict:
    """The real-time loop on the lane's node: RoomManager.start →
    PlaneRuntime._run, a feeder task sending the next tick's datagrams on
    each loop tick; a thread counts what reaches the sinks. Checks the
    launches; reports both tiers' forward latency from this run."""
    rm, udp, rt = x.rm, x.udp, x.rt
    ticked = asyncio.Event()
    rt.on_tick(lambda _res: ticked.set())
    received = [0]
    stop = threading.Event()
    sink = threading.Thread(target=sink_counter, args=(x.void_socks, stop, received),
                            daemon=True)

    async def feeder():
        i = first_tick
        while True:
            await ticked.wait()
            ticked.clear()
            for sock, addr, d in x.sealed(express_datagrams(len(x.sizes), i)):
                sock.sendto(d, addr)
            i += 1

    x.drain()
    base = dict(rt.stats)
    lane0 = dict(rt.express.stats)
    udp.fwd_latency.reset()
    udp.fwd_latency_express.reset()
    sink.start()
    rt.mark_warm()                 # the lockstep ticks were the warm-up
    cuda.reset_launches()
    task = asyncio.ensure_future(feeder())
    t0 = time.perf_counter()
    try:
        rm.start()
        while time.perf_counter() - t0 < seconds:
            await asyncio.sleep(0.05)
            if task.done():
                task.result()
        await rt.stop()
        loop_ledger("express", rt)
        wall_s = time.perf_counter() - t0
        launches = dict(cuda.launches)
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await asyncio.sleep(0.2)
        stop.set()
        sink.join(10)
    ticks = rt.stats["ticks"] - base["ticks"]
    expected = dense_launches(ticks)
    if launches != expected:
        raise AssertionError(f"express loop launches {launches}, expected {expected}")
    lane = {k: v - lane0.get(k, 0) for k, v in rt.express.stats.items()}
    if lane["express_dgrams"] <= 0 or received[0] <= 0:
        raise AssertionError(f"express loop: lane {lane}, {received[0]} received")
    return {"ticks": ticks, "wall_s": wall_s, "wall_ms_per_tick": wall_s / ticks * 1e3,
            "late_ticks": rt.stats["late_ticks"] - base["late_ticks"],
            "lane": lane, "received": received[0], "launches": launches,
            "forward_latency_batched": udp.fwd_latency.summary(),
            "forward_latency_express": udp.fwd_latency_express.summary()}


async def express_phase(dev, rooms: int = EXPRESS_ROOMS, lock_ticks: int = EXPRESS_LOCK_TICKS,
                        seconds: float = EXPRESS_SECONDS) -> dict:
    """The express lane and the media relay on the card (see the module
    docstring, phase 5c)."""
    sizes = np.random.default_rng(SEED).integers(2, 5, rooms).tolist()
    x = ExpressRig(await udp_room_manager(dev, express_config(True)), sizes)
    b = ExpressRig(await udp_room_manager(dev, express_config(False)), sizes)
    if x.rt.express is None or b.rt.express is not None:
        raise AssertionError("express lane on/off not as configured")
    await x.rm.start_relay("127.0.0.1", 0)
    relay = x.rm.media_relay
    relay_rooms = tuple(r for r in RELAY_ROOMS if r < rooms)
    join_s = await x.join(relay_rooms)
    await b.join()
    log(f"express: {sum(sizes)} participants in {rooms} rooms joined twice "
        f"({join_s:.2f} s); {2 * len(relay_rooms)} publishers through the relay")
    cuda.reset_launches()
    lock = await express_lockstep(x, b, lock_ticks)
    launches = dict(cuda.launches)
    want = dense_launches(2 * lock_ticks)
    if launches != want:
        raise AssertionError(f"express lockstep launches {launches}, expected {want}")
    lane = dict(x.rt.express.stats)
    if lane["promotes"] < 1 or lane["express_dgrams"] <= 0:
        raise AssertionError(f"express lockstep: the lane never carried a room: {lane}")
    await b.close()
    mirrors = x.rt.stats["express_mirrors"]
    mirror_ms = x.rt.stats["express_mirror_s"] / max(mirrors, 1) * 1e3
    log(f"express lockstep exact: {lock['datagrams_compared']} datagrams over "
        f"{lock_ticks} ticks, lane {lane}, mirror read {mirror_ms:.3f} ms "
        f"({mirrors} reads), launches {launches}")
    loop = await express_loop(x, seconds, lock_ticks)
    fb, fe = loop["forward_latency_batched"], loop["forward_latency_express"]
    log(f"express loop: {loop['ticks']} ticks, wall {loop['wall_ms_per_tick']:.2f} ms/tick; "
        f"forward latency p50/p99 express {fe['p50_ms']}/{fe['p99_ms']} ms, batched "
        f"{fb['p50_ms']}/{fb['p99_ms']} ms; launches {loop['launches']}")
    relay_rep = {"allocations": len(relay.allocs), **relay.stats,
                 "publishers": 2 * len(relay_rooms), "rooms": list(relay_rooms)}
    if relay_rep["binds"] < 2 * len(relay_rooms) or relay_rep["up_fwd"] <= 0:
        raise AssertionError(f"relay: {relay_rep}")
    log(f"relay ok: {relay_rep}")
    await x.close()
    aead = crypto_mod.AESGCM.__module__.split(".")[0] if crypto_mod.HAVE_AEAD else None
    return {"dims": list(EXPRESS_DIMS), "rooms": rooms, "participants": sum(sizes),
            "sealed": REQUIRE_ENCRYPTION, "aead": aead,
            "express_max_subs": EXPRESS_MAX_SUBS, "express_max_rooms": EXPRESS_MAX_ROOMS,
            "lockstep": {**lock, "lane": lane, "launches": launches},
            "mirror_read_ms": mirror_ms, "mirror_reads": mirrors,
            "loop": loop, "relay": relay_rep}


# ---------------------------------------------------------------------------
# The WebRTC gateway (phase 5d)
# ---------------------------------------------------------------------------

GATEWAY_DIMS = RUNTIME_DIMS        # cfg4's plane
GATEWAY_ROOMS = 8
GATEWAY_SIM_ROOMS = 4              # rooms whose VP8 is simulcast (a=ssrc-group:SIM of 3)
GATEWAY_TICKS = 100
GATEWAY_GAP_TICK = 40              # every publisher skips a VP8 SN here: an upstream NACK
GATEWAY_RR_EVERY = 20              # ticks between the gateway subscribers' receiver reports
GATEWAY_WAIT_S = 30.0


def library_report() -> dict:
    """The shared libraries of the gateway lane as this process maps them
    (libssl.so.3 and libcrypto.so.3 through the gateway's own loader), the
    OpenSSL version string, `cryptography`'s version, and libopus.so.0,
    which the MCU mixer needs (None where absent)."""
    import ctypes

    rep: dict = {}
    try:
        lib = dtls_mod._Lib.get()
        lib.crypto.OpenSSL_version.restype = ctypes.c_char_p
        lib.crypto.OpenSSL_version.argtypes = [ctypes.c_int]
        rep["openssl_version"] = lib.crypto.OpenSSL_version(0).decode()
    except OSError as e:
        rep["openssl_error"] = str(e)
    try:
        ctypes.CDLL("libopus.so.0")
    except OSError:
        pass
    for stem in ("libssl", "libcrypto", "libopus"):
        rep[stem] = native.loaded_library(stem) or None
    try:
        import cryptography

        rep["cryptography"] = cryptography.__version__
    except ImportError:
        rep["cryptography"] = None
    return rep


class GatewayClient:
    """A stock WebRTC endpoint built from the port's interop modules (its
    own certificate and ICE credentials, the OpenSSL DTLS client role, RFC
    7714 SRTP), speaking only STUN, DTLS, SRTP and SDP at the server's
    media socket. A publisher offers Opus and VP8 (simulcast when `sim`),
    a subscriber two recv-only sections (audio, video)."""

    def __init__(self, room: int, publisher: bool, sim: bool = False):
        self.room, self.publisher = room, publisher
        self.sock = udp_socket()
        self.cert, self.key, self.fp = dtls_mod.generate_certificate("client")
        self.ufrag, self.pwd = f"c{room}{int(publisher)}", f"client-pwd-{room:04d}-{int(publisher)}xxxxxx"
        self.audio_ssrc = 0x1A000000 + 16 * room
        self.video_ssrcs = [0x2B000000 + 16 * room + i for i in range(VP8_LAYERS if sim else 1)]
        self.dtls = self.tx = self.rx = self.server = None

    def offer(self) -> str:
        out = ("v=0\r\no=- 1 2 IN IP4 127.0.0.1\r\ns=-\r\nt=0 0\r\na=group:BUNDLE 0 1\r\n"
               f"a=ice-ufrag:{self.ufrag}\r\na=ice-pwd:{self.pwd}\r\n"
               f"a=fingerprint:sha-256 {self.fp}\r\na=setup:actpass\r\n")
        way = "sendonly" if self.publisher else "recvonly"
        out += (f"m=audio 9 UDP/TLS/RTP/SAVPF 109\r\na=mid:0\r\na={way}\r\na=rtcp-mux\r\n"
                "a=rtpmap:109 opus/48000/2\r\n"
                f"a=extmap:{udp_mod.AUDIO_LEVEL_EXT_ID} urn:ietf:params:rtp-hdrext:ssrc-audio-level\r\n")
        if self.publisher:
            out += f"a=ssrc:{self.audio_ssrc} cname:c{self.room}\r\n"
        out += (f"m=video 9 UDP/TLS/RTP/SAVPF 120\r\na=mid:1\r\na={way}\r\na=rtcp-mux\r\n"
                "a=rtpmap:120 VP8/90000\r\n")
        if self.publisher:
            if len(self.video_ssrcs) > 1:
                out += f"a=ssrc-group:SIM {' '.join(map(str, self.video_ssrcs))}\r\n"
            out += "".join(f"a=ssrc:{s} cname:c{self.room}\r\n" for s in self.video_ssrcs)
        return out

    async def recv(self) -> bytes:
        deadline = time.perf_counter() + GATEWAY_WAIT_S
        while time.perf_counter() < deadline:
            try:
                return self.sock.recv(65536)
            except BlockingIOError:
                await asyncio.sleep(0.0005)
        raise AssertionError(f"gateway client of room {self.room}: no datagram")

    async def connect(self, answer: str) -> float:
        """STUN binding → DTLS handshake → SRTP sessions; → handshake ms."""
        ans = sdp_mod.parse_sdp(answer)
        m = ans.media[0]
        pwd = ans.media_pwd(m).encode()
        cand = [ln for ln in answer.split("\r\n") if ln.startswith("a=candidate:")][0].split()
        self.server = (cand[4], int(cand[5]))
        t0 = time.perf_counter()
        self.sock.sendto(stun_mod.build_binding_request(f"{ans.media_ufrag(m)}:{self.ufrag}", pwd),
                         self.server)
        resp = stun_mod.parse_stun(await self.recv(), integrity_key=pwd)
        if resp is None or resp.msg_type != stun_mod.BINDING_SUCCESS or not resp.integrity_ok:
            raise AssertionError(f"room {self.room}: bad STUN answer")
        self.dtls = dtls_mod.DtlsEndpoint("client", self.cert, self.key,
                                          peer_fingerprint=ans.media_fingerprint(m).split()[1])
        for d in self.dtls.pump():
            self.sock.sendto(d, self.server)
        while not self.dtls.handshake_complete:
            data = await self.recv()
            if dtls_mod.is_dtls(data):
                for d in self.dtls.feed(data):
                    self.sock.sendto(d, self.server)
        ms = (time.perf_counter() - t0) * 1e3
        from livekit_server_tpu_torch.interop.srtp import SrtpSession

        (lk, ls), (rk, rs) = self.dtls.export_srtp_keys()
        self.tx = SrtpSession(master_key=lk, master_salt=ls)
        self.rx = SrtpSession(master_key=rk, master_salt=rs)
        return ms

    def open(self, data: bytes):
        """→ ("rtcp" | "rtp", cleartext) or None."""
        if len(data) >= 2 and 192 <= data[1] <= 223:
            return "rtcp", self.rx.unprotect_rtcp(data)
        return "rtp", self.rx.unprotect_rtp(data)

    def close(self) -> None:
        if self.dtls is not None:
            self.dtls.close()
        self.sock.close()


class HostTimer:
    """Seconds and calls of bound methods, wrapped in place on their objects."""

    def __init__(self):
        self.s: dict[str, list[float]] = {}

    def wrap(self, obj, attr: str, key: str) -> None:
        fn = getattr(obj, attr)
        acc = self.s.setdefault(key, [])

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc.append(time.perf_counter() - t0)

        setattr(obj, attr, run)

    def us(self, key: str) -> dict:
        xs = sorted(self.s.get(key, []))
        if not xs:
            return {"calls": 0}
        return {"calls": len(xs), "mean_us": sum(xs) / len(xs) * 1e6,
                "p50_us": xs[len(xs) // 2] * 1e6}


def gateway_datagrams(rooms: int, tick: int) -> list[tuple[int, str, int, bytes]]:
    """express_datagrams' seeded tick for the gateway phase: (room, kind,
    layer, datagram), Opus, and VP8 on every layer in the simulcast rooms
    and on layer 0 elsewhere; layer 0's packet is left out at
    GATEWAY_GAP_TICK (upstream NACKs are video-only)."""
    out = []
    for r, t, layer, d in express_datagrams(rooms, tick):
        if t == 0 and (layer == 0 or r < GATEWAY_SIM_ROOMS):
            if not (layer == 0 and tick == GATEWAY_GAP_TICK):
                out.append((r, "video", layer, d))
        elif t == 1:
            out.append((r, "audio", 0, d))
    return out


class GatewayRig:
    """A RoomManager on the card with its UDP transport on loopback and
    GATEWAY_ROOMS rooms joined through start_session, each with a stock
    publisher ("pub"), a stock subscriber ("gsub", recv-only sections),
    both through the WebRTC gateway, and a sealed UDP subscriber ("ssub",
    a punch from a socket of its own)."""

    def __init__(self, rm: RoomManager, rooms: int):
        self.rm, self.udp, self.rt = rm, rm.udp, rm.runtime
        self.rooms = rooms
        self.pubs = [GatewayClient(r, True, sim=r < GATEWAY_SIM_ROOMS) for r in range(rooms)]
        self.gsubs = [GatewayClient(r, False) for r in range(rooms)]
        self.ssub_socks = [udp_socket() for _ in range(rooms)]
        self.sessions: dict = {}        # (room, identity) → (request, response, task)
        self.ssub_client: dict = {}
        self.declared: dict = {}        # room → {kind: the gsub SSRC its answer declared}
        self.timer = HostTimer()

    async def answer_of(self, r: int, ident: str, offer: str) -> str:
        req, resp, _task = self.sessions[(r, ident)]
        req.write_message(json.dumps({"offer": {"type": "offer", "sdp": offer}}))
        got: list = []

        def answered() -> bool:
            while not resp._q.empty():
                msg = decode_signal_response(resp._q.get_nowait())
                if msg.kind == "answer":
                    got.append(msg.data["sdp"])
            return bool(got)

        await wait_until(answered, f"room{r} {ident}'s answer", GATEWAY_WAIT_S)
        if "a=ice-lite" not in got[0]:
            raise AssertionError(f"room{r} {ident}: the answer is not ICE-lite (reflected?)")
        return got[0]

    async def join(self) -> dict:
        rm, udp = self.rm, self.udp
        for r in range(self.rooms):
            for ident in ("pub", "gsub", "ssub"):
                req, resp = MessageChannel(), MessageChannel()
                init = {"identity": ident, "name": ident, "auto_subscribe": True,
                        "grants": {"video": {"roomJoin": True, "room": f"gw{r}"}}}
                task = asyncio.ensure_future(rm.start_session(f"gw{r}", init, req, resp))
                self.sessions[(r, ident)] = (req, resp, task)
        await wait_until(lambda: all(len(rm.rooms[f"gw{r}"].participants) == 3
                                     for r in range(self.rooms) if f"gw{r}" in rm.rooms)
                         and len(rm.rooms) >= self.rooms, "the joins", GATEWAY_WAIT_S)
        gw = udp.gateway if udp.gateway is not None else udp.enable_gateway()
        self.timer.wrap(gw, "handle_datagram", "handle_datagram")
        answers = {}
        for r in range(self.rooms):
            answers[(r, "pub")] = await self.answer_of(r, "pub", self.pubs[r].offer())
        for r in range(self.rooms):
            room = rm.rooms[f"gw{r}"]
            pub = room.participants["pub"]
            kinds = {t.is_video: t.track_col for t in pub.published.values()}
            if sorted(kinds) != [False, True] or not all(t.via_gateway for t in pub.published.values()):
                raise AssertionError(f"gw{r}: the offer published {list(pub.published)}")
            bound = {s for s, b in udp.bindings.items() if b.room == room.slots.row}
            want = {self.pubs[r].audio_ssrc, *self.pubs[r].video_ssrcs}
            if bound != want:
                raise AssertionError(f"gw{r}: bound SSRCs {bound}, offered {want}")
            answers[(r, "gsub")] = ans = await self.answer_of(r, "gsub", self.gsubs[r].offer())
            gsub = room.participants["gsub"]
            parsed = sdp_mod.parse_sdp(ans)
            self.declared[r] = {}
            for m in parsed.media:
                col = kinds[m.kind == "video"]
                want = udp.subscriber_ssrc(room.slots.row, gsub.sub_col, col)
                if m.ssrcs != [want]:
                    raise AssertionError(f"gw{r}: the {m.kind} recv section declares {m.ssrcs}, "
                                         f"the node sends {want}")
                self.declared[r][m.kind] = want
        # The sealed subscribers: UDP media, a sealed punch each.
        for r in range(self.rooms):
            self.sessions[(r, "ssub")][0].write_message(json.dumps({"subscription": {"udp": True}}))
        keys = {}
        for r in range(self.rooms):
            room = rm.rooms[f"gw{r}"]
            p = room.participants["ssub"]
            keys[r] = (room.slots.row, p.sub_col)
        await wait_until(lambda: all(k in udp._punch_by_sub for k in keys.values()),
                         "the punch ids", GATEWAY_WAIT_S)
        for r, key in keys.items():
            p = rm.rooms[f"gw{r}"].participants["ssub"]
            c = None
            if p.crypto_session is not None:
                c = crypto_mod.MediaCryptoClient(p.crypto_session.key_id, p.crypto_session.key)
            self.ssub_client[r] = c
            d = udp_mod.PUNCH_REQ + udp._punch_by_sub[key].to_bytes(4, "big")
            self.ssub_socks[r].sendto(c.seal(d) if c is not None else d, ("127.0.0.1", self.port))
        await wait_until(lambda: all(k in udp.sub_addrs for k in keys.values()), "the punches",
                         GATEWAY_WAIT_S)
        for s in self.ssub_socks:
            while True:
                try:
                    s.recv(4096)
                except BlockingIOError:
                    break
        # The 16 handshakes, one at a time; the gateway's time in
        # handle_datagram is summed per handshake.
        hs_ms, hd_ms = [], []
        for r in range(self.rooms):
            for cli, ident in ((self.pubs[r], "pub"), (self.gsubs[r], "gsub")):
                n0 = len(self.timer.s["handle_datagram"])
                hs_ms.append(await cli.connect(answers[(r, ident)]))
                hd_ms.append(sum(self.timer.s["handle_datagram"][n0:]) * 1e3)
        if gw.stats["dtls_done"] != 2 * self.rooms:
            raise AssertionError(f"gateway: {gw.stats['dtls_done']} DTLS handshakes completed")
        for peer in gw.peers_by_ufrag.values():
            self.timer.wrap(peer.srtp_tx, "protect_rtp", "protect")
            self.timer.wrap(peer.srtp_tx, "protect_rtcp", "protect")
            self.timer.wrap(peer.srtp_rx, "unprotect_rtp", "unprotect")
            self.timer.wrap(peer.srtp_rx, "unprotect_rtcp", "unprotect")
        return {"handshake_ms": percentiles(hs_ms), "handle_datagram_ms_per_handshake":
                percentiles(hd_ms), "handshakes": len(hs_ms)}

    @property
    def port(self) -> int:
        return self.udp.transport.get_extra_info("sockname")[1]

    async def loop(self, ticks: int) -> dict:
        """RoomManager.start → PlaneRuntime._run; a feeder sends tick i's
        SRTP datagrams on the loop's i-th tick, a thread takes every
        datagram off the clients' and sinks' sockets with its arrival
        time. Checks the launches."""
        rm, rt = self.rm, self.rt
        ticked = asyncio.Event()
        rt.on_tick(lambda _res: ticked.set())
        sent_at: dict = {}            # (room, payload tail) → send time
        socks = ([c.sock for c in self.gsubs] + self.ssub_socks + [c.sock for c in self.pubs])
        got: list = []                # (socket index, arrival time, datagram)
        stop = threading.Event()

        def receiver():
            while not stop.is_set():
                ready, _, _ = select.select(socks, [], [], 0.05)
                for s in ready:
                    i = socks.index(s)
                    while True:
                        try:
                            d = s.recv(65536)
                        except BlockingIOError:
                            break
                        got.append((i, time.perf_counter(), d))

        fed, rrs = [0], [0]

        async def feeder():
            for i in range(ticks):
                await ticked.wait()
                ticked.clear()
                for r, kind, layer, d in gateway_datagrams(self.rooms, i):
                    pub = self.pubs[r]
                    ssrc = pub.audio_ssrc if kind == "audio" else pub.video_ssrcs[layer]
                    wire = pub.tx.protect_rtp(d[:8] + ssrc.to_bytes(4, "big") + d[12:])
                    sent_at[(r, d[-16:])] = time.perf_counter()
                    pub.sock.sendto(wire, pub.server)
                if i % GATEWAY_RR_EVERY == GATEWAY_RR_EVERY // 2:
                    for r, sub in enumerate(self.gsubs):
                        rr = udp_mod.build_rr(0x5EED0000 + r, self.declared[r]["video"], 0)
                        sub.sock.sendto(sub.tx.protect_rtcp(rr), sub.server)
                        rrs[0] += 1
                fed[0] += 1

        thread = threading.Thread(target=receiver, daemon=True)
        thread.start()
        # The warm step and watermark of LivekitServer.start, then the loop.
        await rt.step_once()
        rt.mark_warm()
        base = dict(rt.stats)
        cuda.reset_launches()
        task = asyncio.ensure_future(feeder())
        t0 = time.perf_counter()
        try:
            rm.start()
            await wait_until(lambda: task.done(), "the feeder", GATEWAY_WAIT_S + ticks * 0.1)
            task.result()
            t_fed = rt.stats["ticks"]
            await wait_until(lambda: rt.stats["ticks"] >= t_fed + 3, "the last ticks")
            await rt.stop()
            loop_ledger("gateway", rt)
            wall_s = time.perf_counter() - t0
            launches = dict(cuda.launches)
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            await asyncio.sleep(0.3)
            stop.set()
            thread.join(10)
        n_ticks = rt.stats["ticks"] - base["ticks"]
        want = dense_launches(n_ticks)
        if launches != want:
            raise AssertionError(f"gateway loop launches {launches}, expected {want}")
        return {"ticks": n_ticks, "fed": fed[0], "receiver_reports": rrs[0], "wall_s": wall_s,
                "wall_ms_per_tick": wall_s / max(n_ticks, 1) * 1e3,
                "late_ticks": rt.stats["late_ticks"] - base["late_ticks"],
                "launches": launches, "received": got, "sent_at": sent_at}

    def check(self, got: list, sent_at: dict) -> dict:
        """Open everything the clients and sinks received: per room, the
        gateway subscriber's SRTP-opened RTP equal to the sealed
        subscriber's AEAD-opened RTP byte for byte but the SSRC, the SSRC
        the one its answer declared; each publisher opened SRTCP."""
        n = self.rooms
        rtp: dict = {}                # (lane, room, kind) → [datagram with its SSRC zeroed]
        lat: dict = {"gateway": [], "sealed": []}
        srtcp_pub = [0] * n
        srtcp_sub = 0
        for i, t_rx, d in got:
            lane, r = ("gateway", "sealed", "pub")[i // n], i % n
            if lane == "pub":
                kind, clear = self.pubs[r].open(d)
                if kind != "rtcp" or clear is None:
                    raise AssertionError(f"gw{r}: the publisher got a datagram it cannot open")
                srtcp_pub[r] += 1
                continue
            if lane == "gateway":
                kind, clear = self.gsubs[r].open(d)
                if clear is None:
                    raise AssertionError(f"gw{r}: an SRTP datagram did not open")
                if kind == "rtcp":
                    srtcp_sub += 1
                    continue
                ssrc = int.from_bytes(clear[8:12], "big")
                kinds = [k for k, v in self.declared[r].items() if v == ssrc]
                if not kinds:
                    raise AssertionError(f"gw{r}: SSRC {ssrc} was not declared in the answer")
                key = kinds[0]
            else:
                c = self.ssub_client[r]
                clear = c.open(d) if c is not None else d
                if clear is None:
                    raise AssertionError(f"gw{r}: a sealed datagram did not open")
                if clear[:8] == udp_mod.PUNCH_ACK or 192 <= clear[1] <= 223:
                    continue
                rst = self.udp.egress_rev.get(int.from_bytes(clear[8:12], "big"))
                if rst is None:
                    raise AssertionError(f"gw{r}: sealed egress with an unknown SSRC")
                key = "video" if self.udp.track_kind.get((rst[0], rst[2])) else "audio"
            rtp.setdefault((lane, r, key), []).append(clear[:8] + bytes(4) + clear[12:])
            t_tx = sent_at.get((r, clear[-16:]))
            if t_tx is not None:
                lat[lane].append((t_rx - t_tx) * 1e3)
        compared = 0
        for r in range(n):
            for kind in ("audio", "video"):
                g, s = rtp.get(("gateway", r, kind), []), rtp.get(("sealed", r, kind), [])
                if not g or g != s:
                    diff = next((j for j, (a, b) in enumerate(zip(g, s)) if a != b), None)
                    raise AssertionError(f"gw{r} {kind}: {len(g)} gateway and {len(s)} sealed "
                                         f"packets, first difference at {diff}")
                compared += len(g)
        if min(srtcp_pub) < 1:
            raise AssertionError(f"publishers' opened SRTCP: {srtcp_pub}")
        return {"rtp_compared_per_lane": compared, "exact_but_ssrc": True,
                "publisher_srtcp_opened": srtcp_pub, "subscriber_srtcp_opened": srtcp_sub,
                "forward_latency_gateway": percentiles(lat["gateway"]),
                "forward_latency_sealed": percentiles(lat["sealed"])}

    async def leave(self) -> dict:
        """Every session closes; the gateway must hold no peer, binding or
        SRTP subscriber address of them afterwards."""
        udp, gw = self.udp, self.udp.gateway
        for req, _resp, _task in self.sessions.values():
            req.close()
        await asyncio.wait_for(asyncio.gather(*(t for _, _, t in self.sessions.values()),
                                              return_exceptions=True), 60)
        ssrcs = {c.audio_ssrc for c in self.pubs} | {s for c in self.pubs for s in c.video_ssrcs}
        left = {"peers": len(gw.peers_by_ufrag), "latched": len(gw.peers_by_addr),
                "tuples": len(gw.peers_by_tuple),
                "bindings": len(ssrcs & set(udp.bindings)),
                "srtp_subscribers": sum(1 for a in udp.sub_addrs.values() if a[0] == "srtp")}
        if any(left.values()):
            raise AssertionError(f"gateway state left after the leaves: {left}")
        return left

    async def close(self) -> None:
        await self.rm.stop()
        self.rm.close_transports()
        for c in (*self.pubs, *self.gsubs):
            c.close()
        for s in self.ssub_socks:
            s.close()


async def gateway_phase(dev, rooms: int = GATEWAY_ROOMS, ticks: int = GATEWAY_TICKS) -> dict:
    """The WebRTC gateway on the card (see the module docstring, phase 5d)."""
    t0 = time.perf_counter()
    cfg = udp_config(dense_dims=GATEWAY_DIMS)
    rig = GatewayRig(await udp_room_manager(dev, cfg), rooms)
    try:
        hs = await rig.join()
        log(f"gateway: {2 * rooms} handshakes, handshake ms {hs['handshake_ms']}, "
            f"handle_datagram ms a handshake {hs['handle_datagram_ms_per_handshake']}")
        loop = await rig.loop(ticks)
        got, sent_at = loop.pop("received"), loop.pop("sent_at")
        res = rig.check(got, sent_at)
        gw = rig.udp.gateway
        stats = dict(gw.stats)
        bad = {k: v for k, v in (("srtp_bad", stats["srtp_bad"]), ("stun_bad", stats["stun_bad"]),
                                 ("plaintext_drop", rig.udp.stats["plaintext_drop"])) if v}
        if bad or stats["srtcp_rx"] != loop["receiver_reports"]:
            raise AssertionError(f"gateway: {bad}, {stats['srtcp_rx']} SRTCP opened of "
                                 f"{loop['receiver_reports']} sent")
        left = await rig.leave()
    finally:
        await rig.close()
    out = {"dims": list(GATEWAY_DIMS), "rooms": rooms, "simulcast_rooms": GATEWAY_SIM_ROOMS,
           "sealed": REQUIRE_ENCRYPTION, **hs, "loop": loop, **res,
           "srtp_rx": stats["srtp_rx"], "srtp_tx": stats["srtp_tx"],
           "srtcp_rx": stats["srtcp_rx"], "gateway_stats": stats,
           "protect": rig.timer.us("protect"), "unprotect": rig.timer.us("unprotect"),
           "after_leave": left, "phase_s": time.perf_counter() - t0}
    log(f"gateway ok: {ticks} ticks, {res['rtp_compared_per_lane']} RTP a lane equal; forward "
        f"latency gateway {res['forward_latency_gateway']}, sealed "
        f"{res['forward_latency_sealed']}; protect {out['protect']}, unprotect "
        f"{out['unprotect']}")
    return out


GOLDEN_DIMS = (64, 2, 8, 10)       # rooms, tracks, packets, subscribers
GOLDEN_TICKS = 6


def golden_scan_phase(dev) -> dict:
    """The golden scans (ops/rtpmunger.py, ops/vp8.py, ops/svc.py
    dd_select_tick) on CUDA tensors against the same calls on the CPU,
    and the host munger's lane walk on the same seeded packets: every
    output and state leaf equal, over GOLDEN_TICKS ticks near the 16-,
    15- and 8-bit wraps, with drops, switches and chain breaks."""
    R, T, K, S = GOLDEN_DIMS
    rng = np.random.default_rng(SEED)
    i32 = lambda x: np.asarray(x, np.int64).astype(np.uint32).view(np.int32)  # noqa: E731

    def states(d):
        tile = lambda st: type(st)(*(x.expand(R, T, S).clone() for x in st))  # noqa: E731
        return (tile(rtpmunger.init_state(S, device=d)), tile(vp8.init_state(S, device=d)),
                tile(svc.init_dd_state(S, target_dt=2, device=d)))

    st = {d: states(d) for d in (dev, "cpu")}
    host = HostMunger(plane.PlaneDims(R, T, K, S))
    lanes = [a.reshape(-1) for a in np.meshgrid(np.arange(R), np.arange(T), np.arange(S),
                                                 indexing="ij")]
    sent = breaks = 0
    t0 = time.perf_counter()
    for tick in range(GOLDEN_TICKS):
        sn = (65530 + tick * K + np.arange(K) + rng.integers(0, 3, (R, T, K))) & 0xFFFF
        ts = rng.integers(0, 1 << 32, (R, T, 1)) + 3000 * np.arange(K)
        pid = (32760 + tick * K + np.arange(K) + np.zeros((R, T, K), np.int64)) & 0x7FFF
        tl0 = (250 + tick + np.arange(K) // 2 + np.zeros((R, T, K), np.int64)) & 0xFF
        ki = rng.integers(0, 32, (R, T, K))
        begin = rng.random((R, T, K)) < 0.5
        valid = rng.random((R, T, K)) < 0.9
        jump = np.where(rng.random((R, T, K)) < 0.4, -1, 3000)
        fwd = rng.random((R, T, K, S)) < 0.6
        drop = (rng.random((R, T, K, S)) < 0.3) & ~fwd
        switch = (rng.random((R, T, K, S)) < 0.2) & fwd
        dti = rng.integers(0, 16, (R, T, K))
        swm = rng.integers(0, 16, (R, T, K))
        frames = tick * 2 * K + np.cumsum(rng.integers(1, 3, (R, T, K)), axis=-1)
        kf = rng.random((R, T, K)) < 0.1
        outs = {}
        for d in (dev, "cpu"):
            a = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(d)  # noqa: E731
            m, v, dd_st = st[d]
            m, o_sn, o_ts, send = rtpmunger.munge_tick(
                m, a(i32(sn)), a(i32(ts)), a(valid), a(fwd), a(drop), a(switch), a(i32(jump)))
            v, o_pid, o_tl0, o_ki = vp8.munge_tick(
                v, a(i32(pid)), a(i32(tl0)), a(i32(ki)), a(begin), a(valid), a(fwd), a(drop),
                a(switch))
            dd_st, d_fwd, d_drop, broken = svc.dd_select_tick(
                dd_st, a(i32(dti)), a(i32(swm)), a(i32(frames)), a(kf), a(valid))
            st[d] = (m, v, dd_st)
            outs[d] = [x.cpu().numpy() for x in (o_sn, o_ts, send, o_pid, o_tl0, o_ki,
                                                 d_fwd, d_drop, broken, *m, *v, *dd_st)]
        torch.cuda.synchronize()
        for i, (g, c) in enumerate(zip(outs[dev], outs["cpu"])):
            if not np.array_equal(g, c):
                raise AssertionError(f"golden scans: output {i} differs on the card at tick {tick}")
        o_sn, o_ts, send, o_pid, o_tl0, o_ki = outs["cpu"][:6]
        rr, tt, ss = lanes
        lane = lambda x: x[rr, tt, :, ss]  # noqa: E731
        h = host.apply_lanes(rr, tt, ss, sn, ts, jump, pid, tl0, ki, begin, valid,
                             lane(fwd), lane(drop), lane(switch))
        sl = lane(send)
        for name, hv, sv, mask in (("sn", h[0], o_sn, 0xFFFF), ("ts", h[1], o_ts, 0xFFFFFFFF),
                                   ("pid", h[2], o_pid, 0x7FFF), ("tl0", h[3], o_tl0, 0xFF),
                                   ("keyidx", h[4], o_ki, 0x1F)):
            if not np.array_equal(hv[sl], lane(sv.astype(np.int64) & mask)[sl]):
                raise AssertionError(f"host munger {name} != the scan at tick {tick}")
        sent += int(sl.sum())
        breaks += int(outs["cpu"][8].sum())
    m, v, _ = st["cpu"]
    if not (np.array_equal(host.last_sn, m.last_sn.numpy().astype(np.int64) & 0xFFFF)
            and np.array_equal(host.pid_offset, v.pid_offset.numpy().astype(np.int64) & 0x7FFF)
            and np.array_equal(host.started, m.started.numpy())):
        raise AssertionError("host munger state != the scans' state")
    if not breaks:
        raise AssertionError("golden scans: no chain break exercised")
    return {"dims": list(GOLDEN_DIMS), "ticks": GOLDEN_TICKS, "sent_compared": sent,
            "chain_breaks": breaks, "s": time.perf_counter() - t0, "exact": True}


MIXER_SHAPE = (1000, 4, 4, 960)    # bench.py audio_mix_1kroom: rooms, tracks, subs, samples
MIXER_SEED = 3
MIXER_PRESENT_P = 0.8
MIXER_REPS = 20                    # replays of each graph; calls timed with their copies
MIXER_OPUS_ROOMS = 64              # DEVICE_MIX_MIN_ROOMS: the Opus seat's device path
MIXER_OPUS_FRAMES = 4


def ulaw_boundaries() -> np.ndarray:
    """Samples at every µ-law segment edge ±1 LSB (and inside the LSB),
    both signs, and ±full scale, zero and past full scale."""
    edges = [((1 << b) - 0x84 + d) / 32768.0 for b in range(8, 15) for d in (-1, 0, 1)]
    edges += [e + 0.25 / 32768.0 for e in edges]
    v = np.array(edges + [0.0, 1.0, 1.0 - 1 / 32768.0, 1.5, 0.5 / 32768.0], np.float32)
    return np.concatenate([v, -v])


def host_room_mix(pcm: np.ndarray, present: np.ndarray, exclude: np.ndarray) -> np.ndarray:
    """The mixer's host path arithmetic for every room at once: the int32
    sum of a room's present tracks minus the subscriber's own (column
    `exclude`; T = none), clipped to int16."""
    R, T, N = pcm.shape
    x = np.where(present[:, :, None], pcm.astype(np.int32), 0)
    padded = np.concatenate([x, np.zeros((R, 1, N), np.int32)], axis=1)
    own = np.take_along_axis(padded, exclude.astype(np.int64)[:, :, None], axis=1)
    return np.clip(x.sum(axis=1)[:, None, :] - own, -32768, 32767).astype(np.int16)


def timed_program(fn, dev_args, cpu_args, dev, in_bytes: int, out_bytes: int) -> dict:
    """Device ms of fn as a CUDA graph (as `graph_ms` times the kernels),
    call ms of one call with its operands' copies to the card and its
    result's back (host clock, median), and the byte bound at
    HBM_BYTES_PER_S with each input read and each output written once."""
    ms = graph_ms(lambda: fn(*dev_args), MIXER_REPS)
    calls = []
    for _ in range(MIXER_REPS):
        t = time.perf_counter()
        fn(*(a.to(dev) for a in cpu_args)).cpu()
        calls.append((time.perf_counter() - t) * 1e3)
    return {"ms": ms, "call_ms": statistics.median(calls),
            "bound_ms": (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes_in": in_bytes, "bytes_out": out_bytes}


class MixStub:
    """The transport surface AudioMixer uses: SSRC mint, address book and
    the `_sendto` chokepoint, whose datagrams it keeps."""

    def __init__(self):
        self.sent, self.sub_addrs, self.sub_sessions = [], {}, {}
        self.stats = {"tx": 0}
        self._ssrc = 100

    def _new_ssrc(self):
        self._ssrc += 1
        return self._ssrc

    def _sendto(self, data, addr, session):
        self.sent.append((addr, data))


def opus_seat(dev) -> dict | str:
    """UDPMediaTransport.enable_audio_mixer on the card. Without
    libopus.so.0 it must raise the reference's OpusError, and the seat is
    reported as not run; with it, an AudioMixer over MixStub on
    MIXER_OPUS_ROOMS rooms (the device path) must emit the datagrams the
    host path emits."""
    from livekit_server_tpu_torch.interop import opus
    from livekit_server_tpu_torch.runtime.ingest import IngestBuffer
    from livekit_server_tpu_torch.runtime.mixer import AudioMixer

    udp = udp_mod.UDPMediaTransport(IngestBuffer(plane.PlaneDims(2, 4, 8, 4), 20))
    udp.mixer_device = dev
    if not opus.available():
        try:
            udp.enable_audio_mixer()
        except opus.OpusError:
            return "not run: libopus.so.0 absent"
        raise AssertionError("enable_audio_mixer built a mixer without libopus")
    if udp.enable_audio_mixer().device != dev:
        raise AssertionError("the transport's mixer is not on the card")
    rng = np.random.default_rng(MIXER_SEED)
    frames = {}
    for room in range(MIXER_OPUS_ROOMS):
        for track in range(2):
            enc, f = opus.OpusEncoder(), rng.uniform(150, 2500)
            t = np.arange(960 * MIXER_OPUS_FRAMES) / 48000.0
            pcm = (np.sin(2 * np.pi * f * t) * 8000).astype(np.int16).reshape(-1, 960)
            frames[room, track] = [enc.encode(x) for x in pcm]
            enc.close()
    runs = {}
    for path, min_rooms in (("device", MIXER_OPUS_ROOMS), ("host", MIXER_OPUS_ROOMS + 1)):
        stub = MixStub()
        m = AudioMixer(stub, device=dev)
        m.device_mix_min_rooms = min_rooms
        for room in range(MIXER_OPUS_ROOMS):
            for sub, excl in ((0, 0), (1, -1)):
                stub.sub_addrs[room, sub] = ("127.0.0.1", 4000 + 2 * room + sub)
                m.enable_sub(room, sub, exclude_track=excl)
        now = 100.0
        for k in range(MIXER_OPUS_FRAMES):
            for (room, track), seq in frames.items():
                m.push(room, track, 960 * k, seq[k])
            m.tick(now)
            now += 0.02
        runs[path] = (stub.sent, dict(m.stats))
        m.close()
    if runs["device"][1]["device_mix_frames"] != MIXER_OPUS_FRAMES or runs["device"][0] != runs[
            "host"][0] or runs["host"][1]["device_mix_frames"]:
        raise AssertionError("the Opus seat's device path differs from its host path")
    return {"rooms": MIXER_OPUS_ROOMS, "frames": MIXER_OPUS_FRAMES,
            "packets_equal": len(runs["device"][0]), "stats": runs["device"][1]}


def mixer_phase(dev) -> dict:
    """Phase 5e: the MCU seat's device programs on the card (see the
    module docstring). The services (agents, egress, ingress, SIP, ioinfo)
    import aiohttp, which the card's machine lacks, so they are not run
    here, as the server is not."""
    from livekit_server_tpu_torch.ops import mix
    from livekit_server_tpu_torch.runtime.mixer import _device_mix

    t0 = time.perf_counter()
    R, T, S, N = MIXER_SHAPE
    rng = np.random.default_rng(MIXER_SEED)
    out: dict = {"shape": list(MIXER_SHAPE), "seed": MIXER_SEED}

    def exact(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        g, w = got.cpu().numpy(), want.numpy()
        if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
            raise AssertionError(f"mixer: {name} on the card differs from its CPU run")

    # decode_tick: every byte under each codec, then a seeded payload.
    every = torch.arange(256, dtype=torch.uint8).reshape(1, 1, 256)
    for codec in (mix.CODEC_PCM16, mix.CODEC_PCMU, mix.CODEC_PCMA):
        ids = torch.full((1, 1), codec, dtype=torch.int32)
        exact(f"decode_tick of every byte, codec {codec}",
              mix.decode_tick(every.to(dev), ids.to(dev)), mix.decode_tick(every, ids))
    payload = torch.from_numpy(rng.integers(0, 256, (R, T, N), dtype=np.uint8))
    codecs = torch.from_numpy(rng.integers(0, 3, (R, T)).astype(np.int32))
    pay_d, cod_d = payload.to(dev), codecs.to(dev)
    exact("decode_tick", mix.decode_tick(pay_d, cod_d), mix.decode_tick(payload, codecs))
    out["decode_tick"] = timed_program(
        mix.decode_tick, (pay_d, cod_d), (payload, codecs), dev,
        payload.numel() + codecs.numel() * 4 + 512 * 4, payload.numel() * 4)

    # encode_ulaw: seeded PCM with the segment edges, then the round trip.
    pcm = rng.uniform(-1.05, 1.05, (R, T, N)).astype(np.float32)
    edges = ulaw_boundaries()
    pcm.reshape(-1)[:edges.size] = edges
    pcm_c = torch.from_numpy(pcm)
    pcm_d = pcm_c.to(dev)
    code_d, code_c = mix.encode_ulaw(pcm_d), mix.encode_ulaw(pcm_c)
    exact("encode_ulaw", code_d, code_c)
    ulaw = torch.full((R, T), mix.CODEC_PCMU, dtype=torch.int32)
    exact("decode_tick(encode_ulaw)", mix.decode_tick(code_d, ulaw.to(dev)),
          mix.decode_tick(code_c, ulaw))
    out["encode_ulaw"] = timed_program(mix.encode_ulaw, (pcm_d,), (pcm_c,), dev,
                                       pcm_c.numel() * 4, pcm_c.numel())
    out["encode_ulaw"]["codes_used"] = int(torch.unique(code_c).numel())

    # _device_mix at bench.py's audio_mix_1kroom shape, held to the host sum.
    samples = rng.integers(-32768, 32768, (R, T, N)).astype(np.float32)
    present = rng.random((R, T)) < MIXER_PRESENT_P
    exclude = rng.integers(0, T + 1, (R, S)).astype(np.int32)
    args_c = (torch.from_numpy(samples), torch.from_numpy(present), torch.from_numpy(exclude))
    args_d = tuple(a.to(dev) for a in args_c)
    mixed = _device_mix(*args_d).cpu().numpy()
    if not np.array_equal(np.clip(np.rint(mixed), -32768, 32767).astype(np.int16),
                          host_room_mix(samples, present, exclude)):
        raise AssertionError("mixer: _device_mix on the card differs from the host int32 sum")
    exact("_device_mix", torch.from_numpy(mixed), _device_mix(*args_c))
    out["device_mix"] = timed_program(
        _device_mix, args_d, args_c, dev, sum(a.numel() * a.element_size() for a in args_c),
        R * S * N * 4)
    out["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    out["exact"] = True
    out["opus_seat"] = opus_seat(dev)
    out["phase_s"] = time.perf_counter() - t0
    log(f"mixer ok: decode_tick {out['decode_tick']['ms']:.4f} ms, encode_ulaw "
        f"{out['encode_ulaw']['ms']:.4f} ms, _device_mix {out['device_mix']['ms']:.4f} ms "
        f"(bound {out['device_mix']['bound_ms']:.4f}); opus seat: {out['opus_seat']}")
    return out


# ---------------------------------------------------------------------------
# Phase 5f: room and page shards (parallel/mesh.py) on the card
# ---------------------------------------------------------------------------

SHARD_N = 8                        # shards of cuda:0 (the machine has one GPU)
SHARD_CHECK_TICKS = 5              # seeded ticks held to the unsharded step
SHARD_TIMED_TICKS = 30
SHARD_RESTORE_TICKS = 3            # ticks after the snapshot's restore
SHARD_LOCK_TICKS = 20              # cfg4 RoomManager lockstep
SHARD_POOL_TICKS = 5


def leaves_match(got, want, names, where: str, worst: dict) -> bool:
    """Integer and bool leaves equal, float leaves within the leaf's
    bound; `worst` keeps each float leaf's largest absolute difference.
    Returns whether every float leaf was bit-equal too."""
    bit_equal = True
    for name, g, w in zip(names, got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{where}: {name} shape/dtype {g.shape} {g.dtype} "
                                 f"!= {w.shape} {w.dtype}")
        if g.dtype.kind == "f":
            err = float(np.abs(g.astype(np.float64) - w).max(initial=0.0))
            worst[name] = max(worst.get(name, 0.0), err)
            rtol, atol = plane.float_tolerance(name)
            if not np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True):
                raise AssertionError(f"{where}: {name} beyond rtol={rtol} atol={atol} "
                                     f"(max abs err {err})")
            bit_equal &= g.tobytes() == w.tobytes()
        elif g.tobytes() != w.tobytes():
            raise AssertionError(f"{where}: {name} differs")
    return bit_equal


def time_steps(step, wires) -> dict:
    """Host clock around `step(wire)` (a device step that ends in the
    device→host copy of its outputs): WARMUP_TICKS, then
    SHARD_TIMED_TICKS timed."""
    for i in range(WARMUP_TICKS):
        step(wires[i % len(wires)])
    times = []
    for i in range(SHARD_TIMED_TICKS):
        t0 = time.perf_counter()
        step(wires[i % len(wires)])
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return {"median_ms": statistics.median(times), "p90_ms": times[int(0.9 * len(times)) - 1],
            "ticks": SHARD_TIMED_TICKS}


def shard_north_star(dev, out: dict, worst: dict) -> dict:
    """N = 1 and N = SHARD_N shards of `dev` at the north star against the
    unsharded device step: SHARD_CHECK_TICKS seeded ticks, outputs and
    state; the snapshot of the sharded plane against the unsharded one,
    restored onto a fresh mesh that continues equal; then the three device
    steps timed. Returns (the shard path's kernel timings, the N = SHARD_N
    steps' kernel launches)."""
    dims, spec = NORTH_STAR, NORTH_STAR_SPEC
    traffic = synth.init_traffic(dims, spec, seed=SEED)
    packed = []
    for i in range(SHARD_CHECK_TICKS + SHARD_RESTORE_TICKS):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=SEED)
        packed.append(plane.pack_tick_inputs(inp))
    flat = [plane.wire_inputs(p) for p in packed]
    base = synth.make_state(dims, spec, device=dev)
    names = plane.leaf_names(base)
    meshes = {n: mesh_mod.make_mesh([dev] * n) for n in (1, SHARD_N)}
    ticks = {n: mesh_mod.make_sharded_tick(m, donate=False) for n, m in meshes.items()}
    sharded = {n: mesh_mod.shard_tree(base, m) for n, m in meshes.items()}
    wires = {n: [mesh_mod.shard_wires(p, m) for p in packed] for n, m in meshes.items()}
    state = base
    bit_equal = {n: True for n in meshes}
    launches = dict.fromkeys(cuda.launches, 0)      # the N = SHARD_N steps'
    for i in range(SHARD_CHECK_TICKS):
        state, want = plane.device_tick(state, flat[i], dims)
        out_bytes = sum(np.asarray(x).nbytes for x in want)
        for n in meshes:
            before = dict(cuda.launches)
            sharded[n], got = ticks[n].device_tick(sharded[n], wires[n][i], dims)
            if n == SHARD_N:
                for k in launches:
                    launches[k] += cuda.launches[k] - before[k]
            bit_equal[n] &= leaves_match(got, want, plane.TickOutputs._fields,
                                         f"N={n} tick {i} outputs", worst)
    for n in meshes:
        bit_equal[n] &= leaves_match(plane.tree_leaves(mesh_mod.gather_tree(sharded[n])),
                                     plane.tree_leaves(state), names, f"N={n} state", worst)
    expected = dense_launches(SHARD_N * SHARD_CHECK_TICKS)
    if launches != expected:
        raise AssertionError(f"north-star shard launches {launches}, expected {expected}")
    out["north_star"] = {"dims": list(dims), "ticks": SHARD_CHECK_TICKS, "launches": launches,
                         "bit_equal": {str(n): b for n, b in bit_equal.items()}}

    # The snapshot frame of the sharded plane (the runtime's full-plane
    # checkpoint format) against the unsharded plane's, and its restore
    # onto a fresh mesh (fresh tensors on every shard).
    n = SHARD_N
    snap = {"tick_index": SHARD_CHECK_TICKS,
            "arrays": plane.state_to_numpy(mesh_mod.gather_tree(sharded[n]))}
    want_arrays = plane.state_to_numpy(state)
    frame = PlaneRuntime.decode_snapshot(PlaneRuntime.encode_snapshot(snap))
    byte_equal = all(a.tobytes() == b.tobytes() for a, b in zip(frame["arrays"], want_arrays))
    leaves_match(frame["arrays"], want_arrays, names, "snapshot", worst)
    restored = mesh_mod.shard_tree(
        plane.tree_unflatten(base, [torch.from_numpy(a) for a in frame["arrays"]]), meshes[n])
    for i in range(SHARD_CHECK_TICKS, SHARD_CHECK_TICKS + SHARD_RESTORE_TICKS):
        state, want = plane.device_tick(state, flat[i], dims)
        sharded[n], got = ticks[n].device_tick(sharded[n], wires[n][i], dims)
        restored, again = ticks[n].device_tick(restored, wires[n][i], dims)
        leaves_match(got, want, plane.TickOutputs._fields, f"after restore, tick {i}", worst)
        if not all(a.tobytes() == b.tobytes() for a, b in zip(again, got)):
            raise AssertionError(f"restored mesh, tick {i}: outputs differ from the mesh's")
    if not all(torch.equal(a, b) for a, b in zip(plane.tree_leaves(restored.shards[3]),
                                                  plane.tree_leaves(sharded[n].shards[3]))):
        raise AssertionError("restored mesh: state differs from the mesh it was taken from")
    out["snapshot"] = {"leaves": len(want_arrays), "byte_equal_to_unsharded": byte_equal,
                       "restore_ticks_equal": SHARD_RESTORE_TICKS}
    del restored, sharded[1]

    # The kernels at the shard launch shapes, captured from one shard of a
    # sharded tick (the last shard's launches).
    (_, _), seen = capture_calls(
        [(selector, "decide_rooms"), (allocation, "allocate_budget_rooms")],
        lambda: ticks[n].device_tick(sharded[n], wires[n][0], dims))
    a, kw, res = seen["decide_rooms"]
    dec = time_kernel(selector.decide_rooms, selector.decide_rooms_plain, a, kw,
                      decide_rooms_bytes(a, res))
    dec["shape"] = list(a[3].shape[:2]) + list(a[4].shape[2:]) + [a[3].shape[2]]
    a2, kw2, res2 = seen["allocate_budget_rooms"]
    al = time_kernel(allocation.allocate_budget_rooms, allocation.allocate_budget_rooms_plain,
                     a2, kw2, nbytes(a2, res2))
    al["shape"] = list(a2[1].shape)

    # The device steps: unsharded, one shard, SHARD_N shards of one card.
    # A fresh unsharded state per step timing: device_tick returns new
    # tensors each tick, as the sharded steps do (donate off).
    timing = {}
    holder = {"u": state}

    def unsharded(wire):
        holder["u"], _ = plane.device_tick(holder["u"], wire, dims)

    timing["unsharded"] = time_steps(unsharded, flat)
    del holder
    for m in (1, SHARD_N):
        held = {"s": mesh_mod.shard_tree(state, meshes[m])}

        def stepped(w, m=m, held=held):
            held["s"], _ = ticks[m].device_tick(held["s"], w, dims)

        timing[f"N={m}"] = time_steps(stepped, wires[m])
    out["north_star"]["device_step"] = timing
    # The least bytes a step moves: the state read and written once, the
    # wired inputs in and the flat outputs out, at the card's memory rate.
    step_bytes = 2 * nbytes(state) + flat[0].nbytes + out_bytes
    out["north_star"]["step_bytes"] = step_bytes
    out["north_star"]["step_bound_ms"] = step_bytes / HBM_BYTES_PER_S * 1e3
    return {"decide_rooms": dec, "allocate_budget_rooms": al}, launches


async def shard_room_managers(dev, out: dict) -> dict:
    """A cfg4 RoomManager over SHARD_N room shards of `dev` and an
    unsharded one, fed the same seeded ticks for SHARD_LOCK_TICKS lockstep
    steps: every forwarded (room, sub, sn, ts) equal. Returns the meshed
    runtime's kernel launches (counted around its steps only)."""
    spec, dims = RUNTIME_SPEC, RUNTIME_DIMS
    cfg = serving_config(dense_dims=dims)
    mesh = mesh_mod.make_mesh([dev] * SHARD_N)

    def manager(**kw):
        return RoomManager(cfg, LocalRouter(LocalNode()), LocalStore(),
                           telemetry=TelemetryService(cfg), device=dev, **kw)

    meshed, flat = manager(mesh=mesh), manager()
    rts = (meshed.runtime, flat.runtime)
    if not isinstance(rts[0].state, mesh_mod.Sharded) or len(rts[0].state.shards) != SHARD_N:
        raise AssertionError("RoomManager(mesh=...) did not shard its runtime")
    for rt in rts:
        setup_rooms(rt, spec)
        # No rtc room is joined, so the managers' tick dispatch would only
        # build a Python packet per forwarded packet for WebSocket delivery
        # (~80,000 a tick, most of the phase's time in the first proof):
        # host work after the join, the same with or without shards.
        rt._on_tick.clear()
    rng = np.random.default_rng(SEED)
    traffic = synth.init_traffic(dims, spec, seed=SEED)
    launches = dict.fromkeys(cuda.launches, 0)
    fwd = 0
    for i in range(SHARD_LOCK_TICKS):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=SEED)
        batch, estimate = synth_packets(inp, rng), np.asarray(inp.estimate)
        res = []
        for rt in rts:
            push(rt, batch, estimate)
            before = dict(cuda.launches)
            res.append(await rt.step_once())
            if rt is rts[0]:
                for k in launches:
                    launches[k] += cuda.launches[k] - before[k]
        for col in ("rooms", "subs", "sn", "ts", "tracks", "ks", "pid", "tl0", "keyidx"):
            if not np.array_equal(getattr(res[0].egress_batch, col),
                                  getattr(res[1].egress_batch, col)):
                raise AssertionError(f"cfg4 lockstep tick {i}: egress {col} meshed != unsharded")
        fwd += res[0].fwd_packets
    for rt in rts:
        await rt.stop()
    if fwd <= 0:
        raise AssertionError("cfg4 lockstep: nothing forwarded")
    expected = dense_launches(SHARD_N * SHARD_LOCK_TICKS)
    if launches != expected:
        raise AssertionError(f"meshed RoomManager launches {launches}, expected {expected}")
    out["cfg4_room_managers"] = {"dims": list(dims), "shards": SHARD_N,
                                 "ticks": SHARD_LOCK_TICKS, "fwd_packets": int(fwd),
                                 "egress_equal": True, "launches": launches}
    return launches


def shard_pool_phase(dev, out: dict, worst: dict) -> None:
    """The stock pooled step at PAGED_RUNTIME_DIMS, the pool filled from
    the size mix, over SHARD_N page shards of `dev` against the unsharded
    stock step, SHARD_POOL_TICKS ticks; the cross-shard page copies
    counted."""
    dims = PAGED_RUNTIME_DIMS
    pooled = dims.pooled()
    pager = RoomPager(dims.rooms, dims.tracks, dims.subs, tpage=dims.tpage,
                      spage=dims.spage, pool_pages=dims.pool_pages)
    sizes = admit_rooms(pager)
    room_sizes = np.zeros(dims.rooms, np.int64)
    room_sizes[:len(sizes)] = sizes
    state, table = paged_pool_state(pager, sizes, dims, dev)
    wires = paged_wires(pager, dims, room_sizes, SHARD_POOL_TICKS)
    mesh = mesh_mod.make_mesh([dev] * SHARD_N)
    sh, sh_table = mesh_mod.shard_pool(state, mesh), mesh_mod.shard_pool(table, mesh)
    plan = mesh_mod.PoolPlan(mesh, pager.tmembers)
    tick = mesh_mod.ShardedPoolTick(mesh)
    bit_equal = True
    names = plane.leaf_names(state)
    for i, wire in enumerate(wires):
        state, buf = paged.stock_step(state, table, wire, dims)
        want = plane.unpack_tick_outputs(buf, pooled)
        host = tuple(x.numpy() for x in plane.unwire_inputs(torch.from_numpy(wire), pooled))
        inp = mesh_mod.upload_wires(mesh_mod.shard_wires(host, mesh), mesh, pooled)
        sh, bufs = tick.step(sh, inp, sh_table, plan)
        bit_equal &= leaves_match(mesh_mod.join_outputs(bufs, pooled), want,
                                  plane.TickOutputs._fields, f"pool tick {i}", worst)
    bit_equal &= leaves_match(plane.tree_leaves(mesh_mod.gather_tree(sh)),
                              plane.tree_leaves(state), names, "pool state", worst)
    out["pool"] = {"dims": list(dims), "rooms": len(sizes),
                   "live_pages": int((pager.pg_room >= 0).sum()), "shards": SHARD_N,
                   "ticks": SHARD_POOL_TICKS, "bit_equal": bit_equal,
                   "cross_shard_pages_per_tick": plan.copies,
                   "cross_shard_pages": tick.cross_shard_pages}


def shard_phase(dev) -> tuple[dict, dict, dict, dict]:
    """Phase 5f: room and page shards of the one card (see the module
    docstring). Returns (report, the shard path's kernel timings at the
    north star's shard shapes, their launches there, the meshed
    RoomManager's launches)."""
    t0 = time.perf_counter()
    out: dict = {"card": card_line(), "device_count": torch.cuda.device_count(),
                 "shards": SHARD_N}
    worst: dict[str, float] = {}
    timed, ns_launches = shard_north_star(dev, out, worst)
    torch.cuda.empty_cache()
    parts = {"north_star": time.perf_counter() - t0}
    rm_launches = asyncio.run(shard_room_managers(dev, out))
    parts["cfg4_room_managers"] = time.perf_counter() - t0 - sum(parts.values())
    shard_pool_phase(dev, out, worst)
    parts["pool"] = time.perf_counter() - t0 - sum(parts.values())
    out["float_max_abs_err"] = worst
    out["part_s"] = parts
    out["phase_s"] = time.perf_counter() - t0
    return out, timed, ns_launches, rm_launches


TWIN_PLANE = {"rooms": RUNTIME_DIMS.rooms, "tracks_per_room": RUNTIME_DIMS.tracks,
              "pkts_per_track": RUNTIME_DIMS.pkts, "subs_per_room": RUNTIME_DIMS.subs,
              "tick_ms": 10}                 # cfg4's width, the reference twin's 10 ms tick
TWIN_SEED = 20                     # bench.py fleet_twin's scenario: Scenario.standard(20, 60)
TWIN_TICKS = 60
TWIN_NODES = 2
TWIN_LOADS = (0.5, 1.0, 2.0, 4.0)
TWIN_DRAINED_NODE = 1              # the rolling drain's region "eu" maps onto node 1
# The JAX package's flash-crowd drill (tests/test_twin_drills.py, seed 29)
# at TWIN_PLANE, run on a CPU: its counter-derived SLOs and its governor's
# transitions. The port must give the same on the card and on the CPU.
TWIN_FLASH_REFERENCE = {
    "offered_load": 1.0, "ticks": 80, "joins_offered": 180, "joins_admitted": 133,
    "admission_rate": 0.738889, "denial_reasons": {"overload": 47}, "rooms_peak": 80,
    "audio_expected": 2006, "audio_received": 2006, "audio_continuity": 1.0,
    "audio_gaps": 0, "dup_wire_packets": 0,
    "rung_residency": {"L0": 0.4125, "L1": 0.1375, "L2": 0.1375, "L3": 0.1375, "L4": 0.175},
    "recovery_ticks": {"flash_crowd": 31}, "migrations": 0,
}
TWIN_FLASH_TRANSITIONS = [
    {"tick": 16, "from": 0, "to": 1, "reason": "cap_drops+40"},
    {"tick": 19, "from": 1, "to": 2, "reason": "cap_drops+72"},
    {"tick": 22, "from": 2, "to": 3, "reason": "cap_drops+128"},
    {"tick": 25, "from": 3, "to": 4, "reason": "cap_drops+152"},
    {"tick": 39, "from": 4, "to": 3, "reason": "recovered (dwell elapsed)"},
    {"tick": 47, "from": 3, "to": 2, "reason": "recovered (dwell elapsed)"},
    {"tick": 55, "from": 2, "to": 1, "reason": "recovered (dwell elapsed)"},
    {"tick": 63, "from": 1, "to": 0, "reason": "recovered (dwell elapsed)"},
]


def twin_flash_scenario() -> traffic_twin.Scenario:
    """tests/test_twin_drills.py's flash_crowd_scenario: 80 ticks of churn
    in one region, a flash crowd of magnitude 8 over ticks 12..29."""
    return traffic_twin.Scenario(
        seed=29,
        segments=(traffic_twin.ChurnSegment(ticks=80, join_rate=0.8, leave_rate=0.01),),
        incidents=(traffic_twin.Incident("flash_crowd", at=12, ticks=18,
                                         region="us-east", magnitude=8.0),),
        regions=(("us-east", 1.0),),
        video_room_frac=0.5,
    )


def check_twin_launches(launches: dict, debug: dict, where: str) -> None:
    """B1, B2 and the RTP-stats kernel once per step of every node (the
    warm step, the scenario's and the drain's step_once calls), B3 never
    (dense plane)."""
    steps = sum(debug["steps"])
    want = dense_launches(steps)
    if not steps or launches != want:
        raise AssertionError(f"twin {where}: launches {launches}, expected {want}")


def twin_ledger(where: str, debug: dict) -> None:
    """The build-ledger entries of each twin node since its warm step
    (service/stack.py marks it), as the twin counted them at its end."""
    for i, n in enumerate(debug["post_warm_builds"]):
        LOOP_LEDGER.append({"loop": f"{where} node {i}", "post_warm_builds": n,
                            "entries": []})


def twin_flash_drill(dev, out: dict) -> dict:
    """(a) The flash-crowd drill at cfg4 width on `dev` and on the CPU:
    both dicts and governor transitions equal to each other and to the
    JAX package's, the ladder one rung at a time up to L4 and back, joins
    refused with `overload`, no gap and no duplicate, a finite recovery.
    Returns the card run's launches."""
    runs = {}
    for device in (dev, torch.device("cpu")):
        tw = traffic_twin.TrafficTwin(twin_flash_scenario(), nodes=1, plane=TWIN_PLANE,
                                      device=device)
        cuda.reset_launches()
        t0 = time.perf_counter()
        rep = asyncio.run(tw.run(1.0))
        runs[device.type] = (tw, rep, dict(cuda.launches), time.perf_counter() - t0)
    (tw, rep, launches, wall), (tw_cpu, rep_cpu, _, wall_cpu) = runs[dev.type], runs["cpu"]
    check_twin_launches(launches, tw.debug, "flash crowd")
    twin_ledger("twin flash crowd", tw.debug)
    got, got_cpu = rep.deterministic_dict(), rep_cpu.deterministic_dict()
    trans, trans_cpu = tw.debug["governor_transitions"][0], tw_cpu.debug["governor_transitions"][0]
    if got != got_cpu or trans != trans_cpu:
        diff = {k: (got[k], got_cpu[k]) for k in got if got[k] != got_cpu[k]}
        raise AssertionError(f"twin flash crowd: card != CPU: {diff}; transitions "
                             f"{trans} vs {trans_cpu}")
    if got != TWIN_FLASH_REFERENCE or trans != TWIN_FLASH_TRANSITIONS:
        diff = {k: (got[k], TWIN_FLASH_REFERENCE[k]) for k in got
                if got[k] != TWIN_FLASH_REFERENCE.get(k)}
        raise AssertionError(f"twin flash crowd: port != JAX package: {diff}; "
                             f"transitions {trans}")
    ups = [(t["from"], t["to"]) for t in trans if t["to"] > t["from"]]
    downs = [(t["from"], t["to"]) for t in trans if t["to"] < t["from"]]
    if (ups[:4] != [(0, 1), (1, 2), (2, 3), (3, 4)] or any(b - a != 1 for a, b in ups)
            or any(a - b != 1 for a, b in downs) or not rep.denial_reasons.get("overload")
            or rep.audio_gaps or rep.dup_wire_packets or not rep.audio_expected
            or rep.recovery_ticks.get("flash_crowd", -1) < 0):
        raise AssertionError(f"twin flash crowd: drill checks failed: {got}; {trans}")
    out["flash_crowd"] = {
        "plane": TWIN_PLANE, "slo": got, "transitions": trans, "equal_cpu": True,
        "equal_reference": True, "launches": launches, "steps": tw.debug["steps"],
        "wall_s": wall, "cpu_wall_s": wall_cpu,
        "step_ms": quantiles(tw.debug["step_ms"][0]),
        "cpu_step_ms": quantiles(tw_cpu.debug["step_ms"][0]),
    }
    log(f"twin: flash crowd equal on {dev.type}, the CPU and the JAX package "
        f"({wall:.1f} s; CPU {wall_cpu:.1f} s)")
    return launches


def twin_sweep(dev, out: dict) -> tuple[dict, list]:
    """(b) bench.py fleet_twin's sweep through `capacity_curve` on `dev`:
    Scenario.standard(TWIN_SEED, TWIN_TICKS), TWIN_NODES nodes in this
    process over a port BusServer on loopback, a fresh cluster per load.
    Per load: no duplicate and no gap, every migration a commit with no
    rollback or timeout, the drained node empty, no recovery of -1, joins
    admitted, B1 and B2 once per step. Returns the launches summed over
    the loads and the last load's tick-span records of node 0."""
    runs: list[dict] = []
    total = dict.fromkeys(cuda.launches, 0)
    last_trace: list = []

    def on_run(tw, rep) -> None:
        nonlocal last_trace
        launches = dict(cuda.launches)
        check_twin_launches(launches, tw.debug, f"load {rep.offered_load}")
        twin_ledger(f"twin load x{rep.offered_load}", tw.debug)
        for k in total:
            total[k] += launches[k]
        mig = tw.debug["migration_stats"]
        commits = sum(m.get("commits", 0) for m in mig)
        bad = []
        if rep.dup_wire_packets or rep.audio_gaps:
            bad.append(f"{rep.dup_wire_packets} duplicates, {rep.audio_gaps} gaps")
        if rep.migrations != commits or any(m.get("rollbacks") or m.get("timeouts")
                                            for m in mig):
            bad.append(f"migrations {rep.migrations}, stats {mig}")
        if tw.debug["rooms_final"][TWIN_DRAINED_NODE]:
            bad.append(f"drained node holds {tw.debug['rooms_final'][TWIN_DRAINED_NODE]}")
        if -1 in rep.recovery_ticks.values() or rep.joins_admitted <= 0:
            bad.append(f"recovery {rep.recovery_ticks}, admitted {rep.joins_admitted}")
        if bad:
            raise AssertionError(f"twin sweep load {rep.offered_load}: {'; '.join(bad)}")
        runs.append({"offered_load": rep.offered_load, "wall_s": rep.wall_s,
                     "step_ms": [quantiles(ms) for ms in tw.debug["step_ms"]],
                     "drain_ticks": tw.debug["drain_ticks"], "steps": tw.debug["steps"],
                     "launches": launches, "migration_commits": commits})
        last_trace = tw.debug["trace"][0]
        log(f"twin: load x{rep.offered_load} ok in {rep.wall_s:.1f} s: "
            f"{json.dumps(runs[-1])}")
        cuda.reset_launches()

    sc = traffic_twin.Scenario.standard(seed=TWIN_SEED, ticks=TWIN_TICKS)
    cuda.reset_launches()
    curve = asyncio.run(traffic_twin.capacity_curve(
        sc, TWIN_LOADS, nodes=TWIN_NODES, plane=TWIN_PLANE, on_run=on_run, device=dev))
    out["sweep"] = {"seed": TWIN_SEED, "ticks": TWIN_TICKS, "nodes": TWIN_NODES,
                    "plane": TWIN_PLANE, "steps": curve["steps"],
                    "capacity_knee_load": curve["capacity_knee_load"], "runs": runs,
                    "drain_ticks": [r["drain_ticks"] for r in runs], "launches": total}
    return total, last_trace


def twin_phase(dev) -> tuple[dict, dict, dict]:
    """Phase 5g: the traffic twin on the card (see the module docstring).
    Returns (report, the flash drill's launches, the sweep's launches)."""
    t0 = time.perf_counter()
    out: dict = {"card": card_line(), "cuts": []}
    flash = twin_flash_drill(dev, out)
    sweep, records = twin_sweep(dev, out)
    # (c) The trace export: the self-test's plane on the card, and the
    # ring of one sweep node (node 0 at the last load) after its run.
    problems = trace_export.selftest(device=dev)
    events = trace_export.to_chrome(records, TWIN_PLANE["tick_ms"])
    problems += trace_export.validate(events)
    if problems or not records:
        raise AssertionError(f"twin trace export: {len(records)} ticks, {problems[:5]}")
    out["trace"] = {"selftest": "ok", "ring_ticks": len(records),
                    "spans": sum(1 for e in events if e["ph"] == "X"),
                    "events": len(events)}
    out["phase_s"] = time.perf_counter() - t0
    return out, flash, sweep


# ---------------------------------------------------------------------------
# The port's own tooling (phase 5h)
# ---------------------------------------------------------------------------

POOL_STRESS_CALLS = 5000           # build-only calls a shard-count sequence
POOL_WATCHDOG_S = 60.0             # a sequence that outlasts this fails the run


def tooling_phase(dev) -> dict:
    """Phase 5h (see the module docstring): the egress pool stress on the
    card's host and the device-entry contracts on the card."""
    t0 = time.perf_counter()
    out: dict = {"card": card_line()}
    stress = [poolcheck.run_sequence(seq, POOL_STRESS_CALLS, POOL_WATCHDOG_S)
              for seq in poolcheck.SEQUENCES]
    if any(r["short_calls"] or r["shard_mismatches"] for r in stress):
        raise AssertionError(f"egress pool stress: {stress}")
    out["pool_stress"] = stress
    log(f"tooling: egress pool stress clean: {json.dumps(stress)}")
    root = Path(__file__).resolve().parent
    cfg = graftcheck.load_config(root).rule("devicecheck")
    cuda.reset_launches()
    t1 = time.perf_counter()
    contracts, problems = devicecheck.compute_contracts(cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches = dict(cuda.launches)
    drift, stale = devicecheck.diff_contracts(
        contracts, devicecheck.load_baseline(root / cfg["baseline"]), shapes_only=True)
    if problems or drift or stale or not all(launches.values()):
        raise AssertionError(f"device contracts on {dev}: in-place {problems}, drift "
                             f"{[f.render() for f in drift]}, stale {stale}, launches "
                             f"{launches}")
    out["contracts"] = {"entries": sorted(contracts), "equal_baseline": True,
                        "in_place": "held", "launches": launches, "seconds": seconds,
                        "bytes": {k: c["bytes"] for k, c in contracts.items()}}
    out["phase_s"] = time.perf_counter() - t0
    log(f"tooling: {len(contracts)} device contracts equal on {dev} in {seconds:.2f} s, "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------------
# The port's bench and profiling tools (phase 5i)
# ---------------------------------------------------------------------------

BENCH_WINDOW_TICKS = 20
BENCH_FLOAT_RTOL = 1e-5            # the byte and bit-rate leaves' plane.float_tolerance
BENCH_WIRE_SECONDS = 4.0
BENCH_QUICK_TIMEOUT_S = 300.0


def bench_window_check(dev) -> tuple[dict, dict]:
    """(a) The device window on the card against the CPU plain path.
    Returns (report, the window's kernel launches)."""
    dims, spec = bench_device.DEFAULT_DIMS, bench_device.DEFAULT_SPEC
    cuda.reset_launches()
    gpu = bench_device.window_counts(dims, spec, BENCH_WINDOW_TICKS, dev, seed=SEED)
    launches = dict(cuda.launches)
    cpu = bench_device.window_counts(dims, spec, BENCH_WINDOW_TICKS, "cpu", seed=SEED)
    frel = abs(gpu["float_sum"] - cpu["float_sum"]) / max(abs(cpu["float_sum"]), 1.0)
    if ({k: gpu[k] for k in ("fwd", "evaluated", "checksum")}
            != {k: cpu[k] for k in ("fwd", "evaluated", "checksum")}
            or frel > BENCH_FLOAT_RTOL or gpu["fwd"] <= 0):
        raise AssertionError(f"bench window: card {gpu} != CPU {cpu} (float rel {frel})")
    if any(launches[k] != BENCH_WINDOW_TICKS for k in DENSE_KERNELS):
        raise AssertionError(f"bench window launches {launches} for {BENCH_WINDOW_TICKS} ticks")
    return {"dims": list(dims), "ticks": BENCH_WINDOW_TICKS, "card": gpu, "cpu": cpu,
            "float_rel_diff": frel, "launches": launches}, launches


def bench_profiles(dev) -> dict:
    """(b) The per-block profile at cfg4 and the north star."""
    out = {}
    for shape in ("cfg4", "northstar"):
        detail: dict = {}
        t0 = time.perf_counter()
        ms = profile_tick.profile(*profile_tick.SHAPES[shape], dev, 8, detail)
        if not all(np.isfinite(v) and v > 0 for v in ms.values()):
            raise AssertionError(f"profile {shape}: {ms}")
        total = profile_tick.blocks_sum(ms)
        out[shape] = {"ms": ms, "detail": detail, "blocks_sum_ms": total,
                      "full_tick_ms": ms[profile_tick.FULL],
                      "seconds": time.perf_counter() - t0}
        log(f"bench: profile {shape}: full tick {ms[profile_tick.FULL]:.3f} ms, blocks "
            f"{total:.3f} ms; " + ", ".join(f"{k.split()[0]} {v:.3f}" for k, v in ms.items()))
        torch.cuda.empty_cache()
    return out


def bench_egress() -> dict:
    """(c) The egress plane's microbench on the card's host: the bench's
    egress_plane section and its scaling curve."""
    from livekit_server_tpu_torch.runtime.egress_plane import bench_plane_scaling

    out = bench_cli.egress_plane_section()
    out["scaling"] = bench_plane_scaling(payload_len=1100, sealed=True, seconds_per_point=1.0,
                                         **bench_cli.PLANE_SHAPE)
    if "error" in out["scaling"]:
        raise AssertionError(f"bench_plane_scaling: {out['scaling']}")
    return out


async def bench_wires(dev) -> dict:
    """(d) The wire bench at the wire shape: tick 5, then tick 2 with the
    express lane; each run's ledger after its mark_warm joins LOOP_LEDGER."""
    dims = plane.PlaneDims(32, 8, 8, 6)
    out = {}
    for key, tick, express in (("tick5", 5, 0), ("tick2e", 2, dims.subs)):
        w = await bench_wire.wire_bench(dims, tick_ms=tick, duration_s=BENCH_WIRE_SECONDS,
                                        express_max_subs=express, device=dev)
        LOOP_LEDGER.append({"loop": f"bench_wire_{key}",
                            "post_warm_builds": w["kernel_builds_post_warmup"],
                            "entries": []})
        # every room of the express run is in the lane: its samples are
        # the express tier's
        samples = w.get("express_samples", 0) if express else w["lat_samples"]
        if w.get("task_errors") or not samples or not w["ticks"]:
            raise AssertionError(f"bench wire {key}: {json.dumps(w)[:2000]}")
        out[key] = w
        log(f"bench: wire {key}: p50/p99 {w['p50_wire_ms']}/{w['p99_wire_ms']} ms, express "
            f"{w.get('p50_wire_express_ms')}/{w.get('p99_wire_express_ms')} ms "
            f"({w.get('express_samples', 0)} samples), device rtt {w['device_rtt_ms']} ms, "
            f"late {w['late_ticks']}/{w['ticks']} {w['late_cause']}")
    return out


def bench_quick_child() -> dict:
    """(e) The bench CLI's --quick run as a child process."""
    t0 = time.perf_counter()
    cp = subprocess.run([sys.executable, "-m", "livekit_server_tpu_torch.tools.bench",
                         "--quick"], capture_output=True, text=True,
                        timeout=BENCH_QUICK_TIMEOUT_S, cwd=Path(__file__).resolve().parent)
    lines = cp.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, ValueError) as e:
        raise AssertionError(f"bench --quick: no JSON last line (rc {cp.returncode}): "
                             f"{cp.stdout[-2000:]} {cp.stderr[-2000:]}") from e
    errors = [k for k in last if k.endswith("_error")]
    if (cp.returncode != 0 or last.get("metric") != "sfu_pkt_sub_writes_per_sec_per_chip"
            or not last.get("value", 0) > 0 or errors):
        raise AssertionError(f"bench --quick: rc {cp.returncode}, {last}")
    return {"last_line": last, "seconds": time.perf_counter() - t0}


def bench_phase(dev) -> tuple[dict, dict]:
    """Phase 5i (see the module docstring). Returns (report, the device
    window's kernel launches)."""
    t0 = time.perf_counter()
    out: dict = {"card": card_line()}
    out["window"], launches = bench_window_check(dev)
    log(f"bench: window equal on the card and the CPU: {json.dumps(out['window'])}")
    out["device_bench"] = {
        "default": bench_device.device_bench(bench_device.DEFAULT_DIMS,
                                             bench_device.DEFAULT_SPEC, 50, 5, dev),
        "cfg4": bench_device.device_bench(
            *bench_device.LADDER["cfg4_1krooms_10p_mixed_svc"][:2], 15, 3, dev),
        "northstar": bench_device.device_bench(*bench_device.NORTH_STAR, 5, 1, dev),
    }
    log(f"bench: device_bench {json.dumps(out['device_bench'])}")
    torch.cuda.empty_cache()
    out["profile"] = bench_profiles(dev)
    out["egress_plane"] = bench_egress()
    log(f"bench: egress plane {json.dumps(out['egress_plane'])}")
    out["wire"] = asyncio.run(bench_wires(dev))
    out["quick"] = bench_quick_child()
    log(f"bench: --quick child in {out['quick']['seconds']:.1f} s: "
        f"{json.dumps(out['quick']['last_line'])}")
    rc = trace_export.main(["--selftest", "--device", str(dev)])
    if rc != 0:
        raise AssertionError(f"trace_export --selftest on {dev}: exit {rc}")
    out["trace_selftest"] = "ok"
    out["phase_s"] = time.perf_counter() - t0
    return out, launches


def paged_pool_state(pager: RoomPager, sizes, dims: paged.PagedDims, dev):
    """Device pool state and table for the pager's rooms (sizes[r]
    participants, each publishing one track and subscribed to all others),
    as `setup_paged_room` + the runtime's page-granular upload build it."""
    P, TP, SP = dims.pool_pages, dims.tpage, dims.spage
    room = pager.pg_room
    size = np.zeros(P, np.int64)
    size[room >= 0] = np.asarray(sizes)[room[room >= 0]]
    t = pager.pg_tp[:, None] * TP + np.arange(TP)[None, :]                 # [P, TP]
    s = pager.pg_sp[:, None] * SP + np.arange(SP)[None, :]                 # [P, SP]
    published = (room >= 0)[:, None] & (t < size[:, None])
    video = published & (t < PAGED_SPEC.video_tracks)
    subscribed = (published[:, :, None] & (s[:, None, :] < size[:, None, None])
                  & (s[:, None, :] != t[:, :, None]))
    state = plane.init_state(dims.pooled(), device=dev)
    on = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    state = state._replace(
        meta=state.meta._replace(is_video=on(video), published=on(published), is_svc=on(video)),
        ctrl=state.ctrl._replace(subscribed=on(subscribed)))
    table = paged.init_table(dims, dev)
    paged.apply_table_delta(table, *paged.pack_table_delta(pager, pager.drain_delta()))
    return state, table


def paged_wires(pager, dims, room_sizes, n: int):
    """`n` ticks of pooled wires for the pager's current table: seeded
    logical synth traffic, masked to each room's tracks, staged onto the
    pages as the runtime stages it."""
    logical = plane.PlaneDims(dims.rooms, dims.tracks, dims.pkts, dims.subs)
    xlate = paged.LayoutXlate(dims, pager.pg_room, pager.pg_tp, pager.pg_sp)
    traffic = synth.init_traffic(logical, PAGED_SPEC, seed=SEED)
    wires = []
    for i in range(n):
        traffic, inp = synth.next_tick(traffic, logical, PAGED_SPEC, i, seed=SEED)
        pkt, fb, tf, tick_ms, roll = plane.pack_tick_inputs(mask_to_rooms(inp, room_sizes))
        pkt_p, fb_p, tf_p = xlate.stage_inputs(pkt, fb, tf)
        wires.append(plane.wire_inputs((pkt_p.astype(np.int32), fb_p.astype(np.float32),
                                        tf_p.astype(np.float32), tick_ms, roll)))
    return wires


def time_live_steps(state, table, wires, dims, rows, inv):
    """Host clock around `paged.live_step` (the runtime's device step;
    it ends in the device→host copy of the outputs) after WARMUP_TICKS."""
    for i in range(WARMUP_TICKS):
        state, _, _ = paged.live_step(state, table, wires[i % len(wires)], dims, rows, inv)
    times = []
    spans = []
    for i in range(PAGED_TIMED_TICKS):
        t0 = time.perf_counter()
        state, _, span = paged.live_step(state, table, wires[i % len(wires)], dims, rows, inv)
        times.append((time.perf_counter() - t0) * 1e3)
        spans.append(span * 1e3)
    times.sort()
    return state, {
        "median_ms": statistics.median(times),
        "p90_ms": times[int(0.9 * len(times)) - 1],
        "decide_span_median_ms": statistics.median(spans),
        "grid": int(rows.numel()),
    }


def full_pool(dev):
    """The PAGED_TIMING_DIMS pool filled from the size mix: (pager, room
    sizes per row, device state, table, live rows, live inverse, live
    pages, two ticks of wires)."""
    dims = PAGED_TIMING_DIMS
    pager = RoomPager(dims.rooms, dims.tracks, dims.subs, tpage=dims.tpage,
                      spage=dims.spage, pool_pages=dims.pool_pages)
    sizes = admit_rooms(pager)
    room_sizes = np.zeros(dims.rooms, np.int64)
    room_sizes[:len(sizes)] = sizes
    state, table = paged_pool_state(pager, sizes, dims, dev)
    rows, inv, n_live = live_tables(pager, dev)
    wires = paged_wires(pager, dims, room_sizes, 2)
    return pager, room_sizes, state, table, rows, inv, n_live, wires


def release_half(pager, room_sizes, state, table, dev):
    """Release every other room of the full pool: the freed pages
    re-initialize and drop out of the live rows, as the runtime's page-lane
    sync does. Returns (live rows, live inverse, live pages, two ticks of
    wires); state, table and room_sizes are updated in place."""
    dims = PAGED_TIMING_DIMS
    for r in range(1, int((room_sizes > 0).sum()), 2):
        pager.release_room(r)
        room_sizes[r] = 0
    delta = pager.drain_delta()
    paged.apply_table_delta(table, *paged.pack_table_delta(pager, delta))
    paged.reinit_pages(state, delta.freed_pages, paged.page_init_template(dims, dev))
    rows, inv, n_live = live_tables(pager, dev)
    return rows, inv, n_live, paged_wires(pager, dims, room_sizes, 2)


def capture_live_step(state, table, wire, rows, inv):
    """One live step of the PAGED_TIMING_DIMS pool with phase 0's and
    phase 2's wrappers wrapped; returns (state', {name: (args, kwargs,
    result)})."""
    (state, _, _), seen = capture_calls(
        [(paged_kernel, "decide_pages"), (allocation, "allocate_budget_rooms")],
        lambda: paged.live_step(state, table, wire, PAGED_TIMING_DIMS, rows, inv))
    return state, seen


def dead_key_calls(dev) -> dict:
    """The paged path's decide_rooms, allocate_budget_rooms and
    route_update_tick launches of a dead-page key (the 1-page stock tick at
    PAGED_TIMING_DIMS' page shape): {name: (args, kwargs, result)}."""
    d = PAGED_TIMING_DIMS
    _, seen = capture_calls(
        [(selector, "decide_rooms"), (allocation, "allocate_budget_rooms"),
         (rtpstats, "route_update_tick")],
        lambda: paged.dead_page_outputs(d.tracks // d.tpage, d.tpage, d.pkts, d.spage,
                                        PAGED_SPEC.tick_ms, 0, device=dev))
    return seen


def require_exact(name: str, plain, a, kw, res, where: str) -> None:
    """Raise unless the kernel's result `res` equals plain(*a, **kw) bit
    for bit."""
    ok, err = tree_equal(res, plain(*a, **kw))
    torch.cuda.synchronize()
    if not ok:
        raise AssertionError(f"{name} kernel != plain on {where} (max abs err {err})")
    log(f"{name} exact on {where}")


def time_decide_pages(seen, where: str) -> dict:
    """The captured decide_pages launch, run again on its operands (the
    step updates the pool's selector state in place after it), held equal
    to its plain version, then timed beside its byte bound and its plain
    version's time: the kernel's launch alone and the whole wrapper."""
    a, kw, _ = seen["decide_pages"]
    res = paged_kernel.decide_pages(*a, **kw)
    require_exact("paged_kernel", paged_kernel.decide_pages_plain, a, kw, res, where)
    bytes_moved = decide_pages_bytes(a, res)
    nl = int(a[5].numel())
    out = time_kernel(paged_kernel.decide_pages, paged_kernel.decide_pages_plain, a, kw,
                      bytes_moved)
    # `ms` is the kernel's own launch; `wrapper_ms` adds the wrapper's two
    # gathers of the live rows' selector targets (torch ops).
    out["wrapper_ms"] = out["ms"]
    out["ms"] = graph_ms(lambda: decide_launch(*a, **kw), KERNEL_REPS)
    out.update(bytes_per_step=bytes_moved / nl, grid=nl,
               shape=[nl, *a[4].layer.shape[1:], a[3].shape[-1]])
    return out


def paged_timing_phase(dev, profile: bool) -> tuple[dict, dict, plane.PlaneState]:
    """The live-extent device step at PAGED_TIMING_DIMS filled from the
    size mix, at full occupancy and after releasing half the rooms; the
    phase-0 kernel's own time on operands captured from a live step at
    each occupancy and the phase-2 allocation's on the full pool's (each
    held equal to its plain version there first), beside their byte
    bounds and their plain versions' times; and the dead-page key's
    decide_rooms, allocate_budget_rooms and rtpstats_rooms launches, each
    held equal to its plain version and timed."""
    dims = PAGED_TIMING_DIMS
    pager, room_sizes, state, table, rows, inv, n_live, wires = full_pool(dev)
    sizes = room_sizes[room_sizes > 0]
    state, full = time_live_steps(state, table, wires, dims, rows, inv)
    full.update(rooms=len(sizes), live_pages=n_live)
    if profile:
        profile_steps(lambda i: paged.live_step(state, table, wires[i % 2], dims, rows, inv))

    state, seen = capture_live_step(state, table, wires[0], rows, inv)
    kernel = time_decide_pages(seen, f"the full-occupancy live step's operands ({n_live} "
                               "live pages)")
    a2, kw2, res2 = seen["allocate_budget_rooms"]
    require_exact("allocate_budget_rooms", allocation.allocate_budget_rooms_plain, a2, kw2,
                  res2, f"the paged live step's operands {list(a2[1].shape)}")
    alloc = time_kernel(allocation.allocate_budget_rooms,
                        allocation.allocate_budget_rooms_plain, a2, kw2, nbytes(a2, res2))
    alloc["shape"] = list(a2[1].shape)
    del seen, a2, kw2, res2

    # The dead-page key's launches, held to their plain versions first.
    dead_calls = dead_key_calls(dev)
    a3, kw3, res3 = dead_calls["decide_rooms"]
    st = a3[0]
    shape = list(a3[4].shape) + [st.current_spatial.shape[-1]]
    require_exact("decide_rooms", selector.decide_rooms_plain, a3, kw3, res3,
                  f"the dead-page key {shape}")
    dead = time_kernel(selector.decide_rooms, selector.decide_rooms_plain, a3, kw3,
                       decide_rooms_bytes(a3, res3))
    dead["shape"] = shape
    a4, kw4, res4 = dead_calls["allocate_budget_rooms"]
    require_exact("allocate_budget_rooms", allocation.allocate_budget_rooms_plain, a4, kw4,
                  res4, f"the dead-page key {list(a4[1].shape)}")
    alloc["dead_key"] = time_kernel(allocation.allocate_budget_rooms,
                                    allocation.allocate_budget_rooms_plain, a4, kw4,
                                    nbytes(a4, res4))
    alloc["dead_key"]["shape"] = list(a4[1].shape)
    a5, kw5, res5 = dead_calls["route_update_tick"]
    require_exact("rtpstats_rooms", rtpstats.route_update_tick_plain, a5, kw5, res5,
                  f"the dead-page key {list(a5[3].shape)}")
    dead_rs = time_kernel(rtpstats.route_update_tick, rtpstats.route_update_tick_plain, a5,
                          kw5, rtpstats_rooms_bytes(a5, res5))
    dead_rs["shape"] = list(a5[3].shape)
    del dead_calls, a3, kw3, res3, a4, kw4, res4, a5, kw5, res5
    torch.cuda.empty_cache()

    rows, inv, n_live, wires = release_half(pager, room_sizes, state, table, dev)
    state, half = time_live_steps(state, table, wires, dims, rows, inv)
    half.update(rooms=len(sizes) - len(sizes) // 2, live_pages=n_live)
    state, seen = capture_live_step(state, table, wires[0], rows, inv)
    kernel["half"] = time_decide_pages(seen, f"the half-occupancy live step's operands "
                                       f"({n_live} live pages)")
    del seen
    tick = {"dims": list(dims), "ticks": PAGED_TIMED_TICKS, "full": full, "half": half,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    return (tick, {"paged_kernel": kernel, "allocate_budget_rooms": alloc,
                   "decide_rooms": dead, "rtpstats_rooms": dead_rs}, state)


# ---------------------------------------------------------------------------
# The failure and overload plane: audit parity and time, checkpoint cost,
# drills, and the reference's default config on the serving loops
# ---------------------------------------------------------------------------

DRILL_STALL_S = 2.5            # an injected stall, longer than the 1 s tick deadline
DRILL_STALL_EVERY = 8          # device steps between injected stalls
DRILL_STALLS = 2
DRILL_BITFLIP = dict(bitflip_room=5, bitflip_leaf="ctrl.max_temporal", bitflip_bit=30,
                     bitflip_count=2)
DRILL_WAIT_S = 60.0
DEFAULT_CFG4_TICKS = 45        # past L1 of the ladder (20 pressured ticks a rung)
DEFAULT_PAGED_TICKS = 5
DEFAULT_LOOP_CAP_S = 90.0


def on_cpu(tree):
    return plane.tree_map(lambda x: x.cpu(), tree)


def audit_pair(state, mirror, where: str) -> tuple[np.ndarray, np.ndarray]:
    """`integrity.audit_plane` on the card and on a CPU copy of the same
    state and mirror: mask, counts and new mirror must be equal. Returns
    the mask and counts."""
    m, c, nm = integrity.audit_plane(state, mirror)
    cm, cc, cnm = integrity.audit_plane(on_cpu(state), on_cpu(mirror))
    if not (torch.equal(m.cpu(), cm) and torch.equal(c.cpu(), cc)
            and all(torch.equal(a.cpu(), b) for a, b in zip(nm, cnm))):
        raise AssertionError(f"audit_plane on the card != on the CPU: {where}")
    return cm.numpy(), cc.numpy()


def poison_rules(state, mirror, base: np.ndarray):
    """A clone of `state` and `mirror` with one room corrupted per audit
    rule (rooms 0..5) and one legitimate stream reset (room 6, not a
    violation); returns them with the expected mask: `base` (the clean
    state's mask) with each corrupted room's rule bit added."""
    st = plane.tree_map(torch.clone, state)
    mi = integrity.AuditMirror(*[x.clone() for x in mirror])
    st.audio_state.smoothed_level[0, 0] = float("nan")           # nonfinite
    st.temporal_bytes[1].view(-1)[0] = 1e35                      # range
    st.ctrl.max_spatial[3, 0, 0] = 7                             # ctrl
    st.sel.current_spatial[4, 0, 0] = 99                         # bounds
    st.bwe_state.ring_pos[5, 0] = -3                             # bounds
    s = st.stats
    for room, same_stream in ((2, True), (6, False)):            # cursor / reset
        s.started[room, 0], s.first_sn[room, 0] = True, 17
        s.highest_sn[room, 0], s.sn_cycles[room, 0] = 100, 0
        mi.started[room, 0], mi.ext_sn[room, 0] = True, 200       # the SN went back
        mi.first_sn[room, 0] = 17 if same_stream else 18
    want = base.copy()
    want[:6] |= (integrity.BIT_NONFINITE, integrity.BIT_RANGE, integrity.BIT_CURSOR,
                 integrity.BIT_CTRL, integrity.BIT_BOUNDS, integrity.BIT_BOUNDS)
    return st, mi, want


def rule_counts(mask: np.ndarray) -> list[int]:
    """Rooms flagged by each audit rule in a per-room mask."""
    return [int(((mask >> b) & 1).sum()) for b in range(integrity.NUM_RULES)]


def ring_cursor_rooms(state) -> np.ndarray:
    """[R] bool: rooms with a subscriber whose BWE ring write cursor has
    reached bwe.WINDOW. The BWE reads the cursor modulo WINDOW and never
    wraps it; the reference's audit holds it below WINDOW and flags these
    rooms on a clean state, the port's does not (ROADMAP C6)."""
    ring = state.bwe_state.ring_pos.cpu().numpy()
    return (ring >= bwe.WINDOW).reshape(ring.shape[0], -1).any(axis=1)


def audit_bytes(state) -> int:
    """Bytes one audit must move: the leaves it reads (every float leaf,
    the stream cursors, the ctrl caps, the selector layers, the BWE ring
    cursor) and the mirror in; the mask, counts and new mirror out."""
    s = state.stats
    read = [x for x in plane.tree_leaves(state) if x.is_floating_point()]
    read += [s.started, s.first_sn, s.highest_sn, s.sn_cycles, s.received,
             state.ctrl.max_spatial, state.ctrl.max_temporal, *state.sel,
             state.bwe_state.ring_pos]
    mirror = (s.started, s.first_sn, s.highest_sn, s.received)
    rooms = s.started.shape[0]
    return (sum(x.numel() * x.element_size() for x in read)
            + 2 * sum(x.numel() * x.element_size() for x in mirror)
            + rooms * 4 + integrity.NUM_RULES * 4)


def audit_time(state, tick_ms: float, where: str) -> dict:
    """The audit's device time (`graph_ms`) and call time on `state` with
    a mirror from a previous audit, beside its byte bound and the device
    step it rides on, after holding it equal to the CPU audit there."""
    _, _, mirror = integrity.audit_plane(state, integrity.init_mirror(state))
    mask, counts = audit_pair(state, mirror, where)
    b = audit_bytes(state)
    ms = graph_ms(lambda: integrity.audit_plane(state, mirror), KERNEL_REPS)
    return {"ms": ms, "call_ms": event_ms(lambda: integrity.audit_plane(state, mirror),
                                          KERNEL_REPS),
            "bound_ms": b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": b,
            "state_bytes": nbytes(state), "rooms": int(state.meta.is_video.shape[0]),
            "clean_state_counts": counts.tolist(),
            "tick_ms": tick_ms, "share_of_tick": ms / tick_ms,
            "share_amortized": ms / (tick_ms * Config().integrity.audit_every_ticks)}


def checkpoint_time(rt: PlaneRuntime) -> dict:
    """One checkpoint round of the supervisor's design on `rt`: snapshot
    (device → host), encode (npz + LKCK frame), decode, restore (host →
    fresh device tensors); the restored state must equal the snapshot
    leaf for leaf, bit for bit."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = rt.snapshot()
    t1 = time.perf_counter()
    blob = rt.encode_snapshot(snap)
    t2 = time.perf_counter()
    back = rt.decode_snapshot(blob)
    t3 = time.perf_counter()
    rt.restore(back)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    for i, (a, b) in enumerate(zip(snap["arrays"], plane.state_to_numpy(rt.state))):
        if a.shape != b.shape or a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"restore: leaf {i} differs from the snapshot")
    return {"snapshot_ms": (t1 - t0) * 1e3, "encode_ms": (t2 - t1) * 1e3,
            "decode_ms": (t3 - t2) * 1e3, "restore_ms": (t4 - t3) * 1e3,
            "state_bytes": nbytes(rt.state), "frame_bytes": len(blob),
            "munger_bytes": sum(a.nbytes for a in snap["munger"])}


async def wait_for(cond, what: str, timeout: float = DRILL_WAIT_S) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"drill: timed out waiting for {what}")
        await asyncio.sleep(0.01)


async def drills(dev, dims: plane.PlaneDims = RUNTIME_DIMS) -> tuple[dict, PlaneRuntime]:
    """The bitflip and stall drills on a cfg4 RoomManager's runtime through
    its serving loop, supervisor and integrity on (the reference's
    defaults), the governor off, fault injection on (FaultSpec knobs set
    per drill). Rooms are set up on the runtime directly and nothing is
    delivered (the drills read the plane, not the wire). The traffic is
    media without receiver estimates, as in the serving loops (the
    reference's audit would flag every room with them, ROADMAP C6; the
    default-config loops below carry them). Returns the report and the
    runtime (stopped)."""
    cfg = serving_config(dense_dims=dims, failure_plane=True)
    cfg.limits.governor_enabled = False
    cfg.faults.enabled = True
    rm = RoomManager(cfg, LocalRouter(LocalNode()), LocalStore(),
                     telemetry=TelemetryService(cfg), device=dev)
    rt, sup, mon, fault = rm.runtime, rm.supervisor, rm.integrity, rm.fault
    rt._on_tick.clear()
    setup_rooms(rt, RUNTIME_SPEC)
    traffic = synth.init_traffic(dims, RUNTIME_SPEC, seed=SEED)
    rng = np.random.default_rng(SEED)
    stop = asyncio.Event()

    async def feeder() -> None:
        nonlocal traffic
        i = 0
        while not stop.is_set():
            traffic, inp = synth.next_tick(traffic, dims, RUNTIME_SPEC, i, seed=SEED)
            k = rt.tick_index
            rt.ingest.push_batch(**synth_packets(inp, rng))
            i += 1
            while rt.tick_index == k and not stop.is_set():
                await asyncio.sleep(0.001)

    await rt.step_once()
    rt.mark_warm()
    feed = asyncio.ensure_future(feeder())
    rm.start()
    report: dict = {}
    try:
        await sup.checkpoint_now()            # a clean repair seed
        # Bitflip: corrupt one room's row a few ticks ahead; the audit on
        # its cadence must flag exactly that room, quarantine it, repair it
        # from the last checkpoint, and audit clean after.
        for k, v in DRILL_BITFLIP.items():
            setattr(fault.spec, k, v)
        fault.spec.bitflip_tick = rt.tick_index + 3
        flagged: set[int] = set()
        detected: list[int] = []

        def seen() -> bool:
            if mon.violations_total and not detected:
                detected.append(mon.last_audit_tick)
                flagged.update(int(r) for r in np.nonzero(mon.last_mask)[0])
            return mon.rows_repaired >= 1

        await wait_for(seen, "the bitflipped row's repair")
        audits_at_repair = mon.audits
        await wait_for(lambda: mon.audits > audits_at_repair, "the audit after the repair")
        report["bitflip"] = {
            "tick": fault.spec.bitflip_tick, "room": DRILL_BITFLIP["bitflip_room"],
            "leaf": DRILL_BITFLIP["bitflip_leaf"], "bitflips": fault.stats.bitflips,
            "flagged_rooms": sorted(flagged), "detected_at_tick": detected[0],
            "audit_every_ticks": mon.audit_every,
            "rows_quarantined": mon.rows_quarantined, "rows_repaired": mon.rows_repaired,
            "escalations": mon.escalations, "violations_by_rule": dict(mon.rule_violations),
            "next_audit_clean": not any(mon.last_mask), "quarantined_now": sorted(mon.quarantined),
        }
        fault.spec.bitflip_tick = -1
        b = report["bitflip"]
        if not (b["bitflips"] == DRILL_BITFLIP["bitflip_count"]
                and b["flagged_rooms"] == [DRILL_BITFLIP["bitflip_room"]]
                and b["rows_quarantined"] == 1 and b["rows_repaired"] == 1
                and b["escalations"] == 0 and b["next_audit_clean"]
                and not b["quarantined_now"]):
            raise AssertionError(f"bitflip drill: {b}")

        # Stall: every DRILL_STALL_EVERY-th device step sleeps DRILL_STALL_S
        # on the worker thread; each stall must cost one restart (cause
        # stall) whose loop advances, and the abandoned step commits nothing.
        restarts0, ticks_after = sup.restarts, []
        abandoned0 = rt.stats["abandoned_steps"]
        fault.spec.stall_s = DRILL_STALL_S
        fault.spec.stall_every = DRILL_STALL_EVERY
        fault._step_count = 0
        for i in range(DRILL_STALLS):
            await wait_for(lambda: sup.restarts >= restarts0 + i + 1, f"restart {i + 1}")
            if i + 1 == DRILL_STALLS:
                fault.spec.stall_every = 0
            at = rt.stats["ticks"]
            await wait_for(lambda: rt.stats["ticks"] >= at + 2, f"ticks after restart {i + 1}")
            ticks_after.append(rt.stats["ticks"] - at)
        await wait_for(lambda: rt.stats["abandoned_steps"] >= abandoned0 + DRILL_STALLS,
                       "the stalled steps' return", DRILL_STALL_S * 2 + 5)
        report["stall"] = {
            "stall_s": DRILL_STALL_S, "stalls": fault.stats.stalls,
            "restarts": sup.restarts - restarts0, "restart_causes": dict(sup.restart_causes),
            "ticks_advanced_after_each": ticks_after,
            "abandoned_steps": rt.stats["abandoned_steps"] - abandoned0,
            "gave_up": sup.gave_up, "checkpoints": sup.checkpoints,
        }
        st = report["stall"]
        if not (st["stalls"] == DRILL_STALLS == st["restarts"]
                and st["restart_causes"] == {"stall": DRILL_STALLS, "integrity": 0}
                and st["abandoned_steps"] == DRILL_STALLS and not st["gave_up"]):
            raise AssertionError(f"stall drill: {st}")
    finally:
        stop.set()
        await feed
        await rm.stop()
    loop_ledger("failure drills", rt)
    return report, rt


async def paged_audit_check(dev, dims: paged.PagedDims = PAGED_RUNTIME_DIMS) -> dict:
    """Audit parity on a PagedPlaneRuntime at PAGED_RUNTIME_DIMS (rooms
    from the size mix, two ticks of traffic): the pooled audit on the card
    against the CPU; then one page's state and one page-table row
    corrupted: `map_audit_mask` must flag the page's room, and BIT_TABLE on
    the table row's true and phantom owners, and repair the row."""
    spec = PAGED_SPEC
    rt = PagedPlaneRuntime(dims, tick_ms=spec.tick_ms, device=dev, paged_kernel="on")
    sizes = admit_rooms(rt.pager)
    for r, size in enumerate(sizes):
        setup_paged_room(rt, r, size)
    room_sizes = np.zeros(dims.rooms, np.int64)
    room_sizes[:len(sizes)] = sizes
    logical = plane.PlaneDims(dims.rooms, dims.tracks, dims.pkts, dims.subs)
    traffic = synth.init_traffic(logical, spec, seed=SEED)
    rng = np.random.default_rng(SEED)
    for i in range(2):
        traffic, inp = synth.next_tick(traffic, logical, spec, i, seed=SEED)
        push_paged(rt, synth_packets(mask_to_rooms(inp, room_sizes), rng),
                   np.asarray(inp.estimate), sizes)
        await rt.step_once()
    _, _, mirror = integrity.audit_plane(rt.state, integrity.init_mirror(rt.state))
    clean, _ = audit_pair(rt.state, mirror, "the paged pool")
    base = rt.map_audit_mask(clean)
    pages = rt.pager.pages_of_room(0)
    victim, table_page = int(pages[0]), int(rt.pager.pages_of_room(1)[0])
    rt.state.audio_state.smoothed_level[victim, 0] = float("inf")
    phantom = 2
    rt.table.pg_room[table_page] = phantom
    mask, counts = audit_pair(rt.state, mirror, "the corrupted paged pool")
    with rt._on_stream():
        room_mask = rt.map_audit_mask(mask)
    want = base.copy()
    want[0] |= integrity.BIT_NONFINITE | integrity.BIT_RANGE
    want[[1, phantom]] |= integrity.BIT_TABLE
    repaired = int(rt.table.pg_room[table_page]) == 1
    if not np.array_equal(room_mask, want) or not repaired or rt.table_repairs != 1:
        raise AssertionError(f"paged audit: rooms {np.nonzero(room_mask)[0].tolist()} "
                             f"mask {room_mask[room_mask != 0].tolist()}, table row "
                             f"repaired {repaired}")
    return {"pool_pages": dims.pool_pages, "rooms": len(sizes),
            "live_pages": int(rt.pager.pages_mapped), "clean_rooms_flagged": int(base.astype(bool).sum()),
            "flagged_rooms": [0, 1, phantom], "page_counts": counts.tolist(),
            "table_repairs": rt.table_repairs}


async def failure_phase(dev, ns_state, ns_tick: dict, pool_state, pool_tick: dict,
                        ns_dims: plane.PlaneDims = NORTH_STAR,
                        dense_dims: plane.PlaneDims = RUNTIME_DIMS,
                        paged_dims: paged.PagedDims = PAGED_RUNTIME_DIMS) -> dict:
    """The failure and overload plane on the card: `audit_plane` held to
    the CPU on the north-star state (clean, and with one room corrupted
    per rule), on the cfg4 drill runtime's state, and on the paged pool
    with `map_audit_mask` and a corrupted page-table row; the audit's
    device time at the north star, cfg4 and the 65536-page pool beside its
    byte bound and the step it rides on; a checkpoint round's cost at cfg4
    and at the north star; the bitflip and stall drills; and the WS cfg4
    and paged serving loops under the reference's default config
    (supervisor, integrity and governor on, faults off), every subscriber
    sending receiver estimates."""
    t_phase = time.perf_counter()
    out: dict = {"card": card_line()}
    _, _, mirror = integrity.audit_plane(ns_state, integrity.init_mirror(ns_state))
    base, base_counts = audit_pair(ns_state, mirror, "the north-star state")
    ring = ring_cursor_rooms(ns_state)
    if base.any():
        raise AssertionError(f"the clean north-star state flags {base_counts.tolist()}")
    st, mi, want = poison_rules(ns_state, mirror, base)
    mask, counts = audit_pair(st, mi, "the north-star state, one room per rule")
    if not np.array_equal(mask, want) or counts.tolist() != rule_counts(want):
        raise AssertionError(f"audit rules: mask {mask[:8].tolist()} counts {counts.tolist()}")
    del st, mi
    out["audit_parity"] = {
        "clean_north_star": {"counts": base_counts.tolist(),
                             "rooms_ring_cursor_past_window": int(ring.sum())},
        "poisoned_north_star": dict(zip(integrity.AUDIT_RULES, counts.tolist()))}
    out["audit_parity"]["paged"] = await paged_audit_check(dev, paged_dims)
    torch.cuda.empty_cache()

    out["drills"], drill_rt = await drills(dev, dense_dims)
    # The drill plane audits clean (no receiver estimates): each rule
    # flags exactly its room there.
    _, _, mirror = integrity.audit_plane(drill_rt.state, integrity.init_mirror(drill_rt.state))
    base, _ = audit_pair(drill_rt.state, mirror, "the cfg4 drill state")
    st, mi, want = poison_rules(drill_rt.state, mirror, base)
    mask, counts = audit_pair(st, mi, "the cfg4 drill state, one room per rule")
    if base.any() or not np.array_equal(mask, want) or counts.tolist() != [1, 1, 1, 1, 2]:
        raise AssertionError(f"audit rules on cfg4: mask {mask[:8].tolist()} "
                             f"counts {counts.tolist()}")
    out["audit_parity"]["poisoned_cfg4"] = dict(zip(integrity.AUDIT_RULES, counts.tolist()))
    del st, mi
    cfg4_tick_ms = statistics.median(r["device_ms"] for r in drill_rt.recent_ticks)
    out["audit_ms"] = {
        "north_star": audit_time(ns_state, ns_tick["median_ms"], "the north-star state"),
        "cfg4": audit_time(drill_rt.state, cfg4_tick_ms, "the cfg4 drill state"),
        "paged_pool": audit_time(pool_state, pool_tick["half"]["median_ms"],
                                 "the 65536-page pool"),
    }
    out["checkpoint"] = {"cfg4": checkpoint_time(drill_rt)}
    ns_rt = PlaneRuntime(ns_dims, tick_ms=NORTH_STAR_SPEC.tick_ms, device=dev)
    ns_rt.state = ns_state
    out["checkpoint"]["north_star"] = checkpoint_time(ns_rt)
    del ns_rt, drill_rt
    torch.cuda.empty_cache()
    log(f"failure: audit parity exact, drills ok, audit ms {json.dumps(out['audit_ms'])}")

    n_pub = RUNTIME_SPEC.video_tracks + RUNTIME_SPEC.audio_tracks
    dense = await serve_rooms(
        dev, [dense_dims.subs] * dense_dims.rooms, [n_pub] * dense_dims.rooms,
        RUNTIME_SPEC, serving_config(dense_dims=dense_dims, failure_plane=True), None,
        DEFAULT_CFG4_TICKS, cap_s=DEFAULT_LOOP_CAP_S, estimates=True)
    log(f"failure: default config, cfg4 loop: {json.dumps(dense['failure_plane'])}")
    scratch = RoomPager(paged_dims.rooms, paged_dims.tracks, paged_dims.subs,
                        tpage=paged_dims.tpage, spage=paged_dims.spage,
                        pool_pages=paged_dims.pool_pages)
    sizes = admit_rooms(scratch)
    paged_report = await serve_rooms(
        dev, sizes, sizes, PAGED_SPEC, serving_config(paged_dims, failure_plane=True), None,
        DEFAULT_PAGED_TICKS, cap_s=DEFAULT_LOOP_CAP_S, estimates=True)
    log(f"failure: default config, paged loop: {json.dumps(paged_report['failure_plane'])}")
    # Every subscriber sends receiver estimates, so every room's BWE ring
    # cursor passes bwe.WINDOW within a few ticks: a clean state the port's
    # audit must not flag (ROADMAP C6), so no integrity restart either.
    for where, rep in (("cfg4", dense), ("paged", paged_report)):
        fp = rep["failure_plane"]
        if fp["restart_causes"]["integrity"] or fp["integrity_violations"]:
            raise AssertionError(f"failure: the default-config {where} loop audited a clean "
                                 f"state as corrupt: {json.dumps(fp)}")
    keep = ("ticks", "wall_s", "wall_ms_per_tick", "fwd_packets", "late_ticks",
            "failure_plane", "join_s", "launches", "tick_ms", "stage_ms", "device_ms",
            "fanout_ms", "send_ms")
    out["default_config"] = {"dense": {k: dense[k] for k in keep},
                             "paged": {k: paged_report[k] for k in keep}}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# The multi-node plane: live migration, failover, drain
# ---------------------------------------------------------------------------

MIG_DIMS = RUNTIME_DIMS            # the cfg4 plane on every node
# A's drain moves its own rooms and B's failed-over ones (0.4-0.8 s a
# room on an H100 host): 128 on each keeps the whole run well inside its
# time limit on a slow host (256 each drained 512 rooms in 173-203 s),
# with B's failover at 136 rooms the checkpoint-TTL witness.
MIG_ROOMS = {"A": 128, "B": 128, "C": 0}
MIG_SAMPLE_ROOMS = 8               # rooms migrated A → B, one at a time
MIG_AUDIO_COLS = tuple(range(RUNTIME_SPEC.video_tracks,
                             RUNTIME_SPEC.video_tracks + RUNTIME_SPEC.audio_tracks))
MIG_AFTER_TICKS = 10               # target ticks that carry the sampled audio on
MIG_WAIT_S = 180.0                 # bound on every wait on a node
MIG_DRAIN_CAP_S = 600.0            # drains of 768 rooms took 317-414 s on an H100 host


def migration_config(bus_port: int, dims: plane.PlaneDims = MIG_DIMS) -> Config:
    """The reference's default Config (supervisor, integrity, migration
    and fleet on) with the port overlay, kv.kind tcp at the phase's bus,
    the plane at `dims` (cfg4) and 20 ms ticks; the overload governor off.

    The governor is on in the reference's defaults. The port's cfg4 loop
    takes longer than a 20 ms tick on the card, so every tick is late, the
    ladder climbs one level per governor_escalate_ticks (20) late ticks,
    and from L3 a node NACKs every inbound PREPARE (service/migration.py):
    with it on, no migration or drain of this phase could land. The phase
    measures that on node C before the drain (`MigNode.govern`) instead.

    room.empty_timeout_s is an hour: the rooms a node adopts or restores
    here hold no participants (the re-armed subscriptions stand in for
    the clients' reconnect), so the idle reaper would close them after
    the default 300 s, in the middle of the drain."""
    base = port_overlay()
    base.setdefault("plane", {}).update(
        rooms=dims.rooms, tracks_per_room=dims.tracks, pkts_per_track=dims.pkts,
        subs_per_room=dims.subs, tick_ms=RUNTIME_SPEC.tick_ms)
    base.update(development=True, trace={"ring_ticks": SERVING_TRACE_TICKS},
                kv={"kind": "tcp", "address": f"127.0.0.1:{bus_port}"},
                limits={"governor_enabled": False}, room={"empty_timeout_s": 3600})
    return load_config(base=base, env={})


def row_digests(leaves) -> list[str]:
    """A digest of each array (dtype, shape and bytes)."""
    import hashlib

    out = []
    for a in leaves:
        a = np.ascontiguousarray(np.asarray(a))
        h = hashlib.sha1(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
        out.append(h.hexdigest())
    return out


class MigNode:
    """One node of the phase's cluster, in its own process: a RoomManager
    on the card behind a KVRouter on a TCPBusClient, its pipelined loop
    fed one seeded synth tick per loop tick, driven over a pipe by the
    phase (`mig_node_main`)."""

    def __init__(self, name: str, conn, bus_port: int, dev: str, dims: plane.PlaneDims):
        self.name, self.conn, self.bus_port = name, conn, bus_port
        self.dev, self.dims = dev, dims
        self.sampled: set[str] = set()
        self.next_sn: dict[tuple[str, int], int] = {}
        self.pushed: dict[tuple[str, int], list[int]] = {}
        self.egress: list[tuple[str, int, int, int]] = []
        self.name_of_row: dict[int, str] = {}
        self.frozen: dict[str, list[str]] = {}      # room → leaf digests at freeze
        self.adopted: dict[str, list[str]] = {}     # room → leaf digests at adoption
        self.restores: list[dict] = []
        self.restore_attempts: dict[str, float] = {}   # room → when its create read the bus
        self.bridge_sn: dict[tuple[str, int], int] = {}
        self.restored_sn: dict[tuple[str, int], int] = {}
        self.mig_times: dict[str, dict] = {}
        self.lease: list[tuple[float, bool]] = []
        self.quiet: set[str] = set()
        self.stop = asyncio.Event()
        self.feed = None
        self.rm = None
        self.sessions: dict = {}
        self.lag: list[float] = []          # event-loop wake lateness, s

    # -- set-up -------------------------------------------------------------
    async def init(self) -> dict:
        from livekit_server_tpu_torch.routing import create_router, create_selector
        from livekit_server_tpu_torch.service.server import connect_bus
        from livekit_server_tpu_torch.service.store import KVStore

        t0 = time.perf_counter()
        cfg = migration_config(self.bus_port, self.dims)
        bus = await connect_bus(cfg)                 # raises when it cannot reach the bus
        node = LocalNode(region=cfg.region)
        bus.set_ident(node.node_id)
        router = create_router(node, bus, lease_ttl=cfg.kv.lease_ttl_s,
                               stats_interval=cfg.kv.stats_interval_s)
        rm = RoomManager(cfg, router, KVStore(bus), telemetry=TelemetryService(cfg),
                         device=self.dev)
        if rm.migration is None or rm.fleet is None:
            raise AssertionError("the default config built no migration or fleet plane")
        rm.migration.selector = create_selector(cfg.node_selector, cfg.region)
        self.rm, self.rt, self.cfg = rm, rm.runtime, cfg
        self.t_start, self.ticks0, self.dropped0 = time.perf_counter(), 0, 0
        self._hook()
        await self.rt.step_once()                     # the warm step of LivekitServer.start
        self.rt.mark_warm()
        return {"node_id": node.node_id, "init_s": time.perf_counter() - t0}

    def _hook(self) -> None:
        rm, rt, mig = self.rm, self.rt, self.rm.migration
        real_snapshot, real_restore = rt.snapshot_room, rt.restore_room

        def snapshot_room(row):
            snap = real_snapshot(row)
            room = rm._row_to_room.get(row)
            if room is not None:
                self.frozen[room.name] = row_digests(snap["arrays"])
                self.mig_times.setdefault(room.name, {})["snapshot_t"] = time.perf_counter()
            return snap

        def restore_room(row, snap):
            real_restore(row, snap)
            # Still under state_lock, before any step: the device row is
            # what the restore wrote (its ctrl too, until the next upload).
            got = row_digests(self.device_row(row))
            self.restores.append({"row": row, "t": time.time(),
                                  "equal": got == row_digests(snap["arrays"])})

        rt.snapshot_room, rt.restore_room = snapshot_room, restore_room
        real_maybe_restore = rm._maybe_restore_room

        async def maybe_restore_room(room) -> None:
            await real_maybe_restore(room)
            self.restore_attempts[room.name] = time.time()

        rm._maybe_restore_room = maybe_restore_room

        def on_adopt(room) -> None:
            # Migration adoption: the row as restored, every leaf and the
            # munger lanes; then the subscribers come back (the clients'
            # reconnect) with the source's subscription masks.
            row = room.slots.row
            leaves = self.device_row(row)
            self.adopted[room.name] = row_digests(leaves)
            self.name_of_row[row] = room.name
            names = plane.leaf_names(rt.state)
            sub = leaves[names.index("ctrl.subscribed")]
            for t, s in zip(*np.nonzero(sub)):
                rt.set_subscription(row, int(t), int(s), subscribed=True)
            # [tracks, layers]: an Opus track's stream is its layer 0.
            hsn = leaves[names.index("stats.highest_sn")].reshape(self.dims.tracks, -1)
            for col in MIG_AUDIO_COLS:
                self.restored_sn[(room.name, col)] = int(hsn[col, 0]) & 0xFFFF

        mig.on_adopt.append(on_adopt)
        real_bridge, real_send = mig._handle_bridge, mig._send

        async def handle_bridge(msg):
            for d in msg.get("packets", []):
                key = (msg.get("room", ""), int(d.get("track", -1)))
                self.bridge_sn[key] = max(self.bridge_sn.get(key, -1), int(d.get("sn", -1)))
            await real_bridge(msg)

        async def send(node_id, msg):
            kind = msg.get("kind")
            if kind in ("prepare", "commit"):
                times = self.mig_times.setdefault(msg.get("room", ""), {})
                times.setdefault(f"{kind}_t", time.perf_counter())
                if kind == "prepare":
                    times["prepares"] = times.get("prepares", 0) + 1
            return await real_send(node_id, msg)

        mig._handle_bridge, mig._send = handle_bridge, send
        real_lease = rm.router.on_lease

        async def on_lease(ok: bool) -> None:
            self.lease.append((time.monotonic(), ok))
            await real_lease(ok)

        rm.router.on_lease = on_lease
        rt.on_tick(self._collect)

    def device_row(self, row: int) -> list[np.ndarray]:
        leaves = [x[row].cpu().numpy() for x in plane.tree_leaves(self.rt.state)]
        return leaves + self.rt.munger.snapshot_room(row)

    def _collect(self, res) -> None:
        b = res.egress_batch
        rows = [r for r, n in self.name_of_row.items() if n in self.sampled]
        if not rows or not len(b):
            return
        keep = np.isin(b.rooms, rows) & np.isin(b.tracks, MIG_AUDIO_COLS)
        for r, t, s, sn in zip(b.rooms[keep], b.tracks[keep], b.subs[keep], b.sn[keep]):
            self.egress.append((self.name_of_row[int(r)], int(t), int(s), int(sn)))

    # -- the cluster -------------------------------------------------------
    async def join(self, names: list[str], sampled: list[str]) -> dict:
        rm, rt = self.rm, self.rt
        await rm.router.register_node()
        await rm.router.remove_dead_nodes()
        self.sampled = set(sampled)
        n_pub = RUNTIME_SPEC.video_tracks + RUNTIME_SPEC.audio_tracks
        # The session tasks stay referenced here: the loop holds tasks only
        # weakly, and a collected session would end its participant.
        self.sessions, _tracks, join_s = await join_rooms(
            rm, [self.dims.subs] * len(names), [n_pub] * len(names), RUNTIME_SPEC, names)
        for name in names:
            self.name_of_row[rm.rooms[name].slots.row] = name
            if name in self.sampled:
                for col in MIG_AUDIO_COLS:
                    self.next_sn[(name, col)] = 1000 * (col + 1)
        cuda.reset_launches()
        self.t_start, self.ticks0 = time.perf_counter(), rt.stats["ticks"]
        self.dropped0 = rt.stats["dropped_steps"]
        rm.start()
        self.feed = asyncio.ensure_future(self.feeder())
        self.probe = asyncio.ensure_future(self.lag_probe())
        return {"join_s": join_s, "rooms": len(rm.rooms)}

    async def lag_probe(self) -> None:
        """How late the event loop wakes a 50 ms sleep: the wait every
        bus round trip, lease refresh and ACK of this node pays."""
        while not self.stop.is_set():
            t = time.perf_counter()
            await asyncio.sleep(0.05)
            self.lag.append(time.perf_counter() - t - 0.05)

    async def feeder(self) -> None:
        rm, rt = self.rm, self.rt
        dims = self.dims
        traffic = synth.init_traffic(dims, RUNTIME_SPEC, seed=SEED)
        rng = np.random.default_rng(SEED)
        n_pub = RUNTIME_SPEC.video_tracks + RUNTIME_SPEC.audio_tracks
        i = 0
        while not self.stop.is_set():
            k = rt.tick_index
            traffic, inp = synth.next_tick(traffic, dims, RUNTIME_SPEC, i, seed=SEED)
            adopting = set(rm.migration._adoptions)
            pubs = np.zeros(dims.rooms, np.int64)
            hosted = []
            for name, room in list(rm.rooms.items()):
                if name in adopting:
                    continue
                pubs[room.slots.row] = n_pub
                hosted.append((name, room.slots.row))
            valid = np.array(inp.valid)
            sampled_rows = [row for name, row in hosted if name in self.sampled]
            if sampled_rows:
                valid[np.ix_(sampled_rows, MIG_AUDIO_COLS)] = False
            batch = synth_packets(mask_to_rooms(inp._replace(valid=valid), pubs), rng)
            rt.ingest.push_batch(**batch)
            est = np.asarray(inp.estimate)
            for _, row in hosted:             # every subscriber's receiver estimate
                for s in range(dims.subs):
                    rt.ingest.push_feedback(row, s, estimate=float(est[row, s]))
            for name, row in hosted:
                if name not in self.sampled or name in self.quiet:
                    continue
                for col in MIG_AUDIO_COLS:
                    key = (name, col)
                    if key not in self.next_sn:   # adopted here: carry the source's lane on
                        self.next_sn[key] = max(self.restored_sn.get(key, -1),
                                                self.bridge_sn.get(key, -1)) + 1
                    sn = self.next_sn[key]
                    rt.ingest.push(PacketIn(room=row, track=col, sn=sn, ts=960 * sn, size=60,
                                            payload=bytes([col]) * 60, audio_level=30))
                    self.pushed.setdefault(key, []).append(sn)
                    self.next_sn[key] = sn + 1
            i += 1
            while rt.tick_index == k and not self.stop.is_set():
                await asyncio.sleep(0.001)

    async def migrate(self, names: list[str], target: str) -> dict:
        rm = self.rm
        out = {}
        for name in names:
            t0 = time.perf_counter()
            self.mig_times.setdefault(name, {})["start_t"] = t0
            ok = await rm.migrate_room(name, target)
            t1 = time.perf_counter()
            times = self.mig_times.get(name, {})
            out[name] = {
                "ok": ok, "migrate_ms": (t1 - t0) * 1e3,
                "prepare_to_commit_ms": ((times["commit_t"] - times["prepare_t"]) * 1e3
                                         if "commit_t" in times and "prepare_t" in times
                                         else None),
                # From the freeze (migrate_room freezes the row at once:
                # the target is given) to the COMMIT; the settle before
                # the snapshot is part of it.
                "freeze_ms": ((times["commit_t"] - t0) * 1e3 if "commit_t" in times else None),
                "settle_ms": ((times["snapshot_t"] - t0) * 1e3
                              if "snapshot_t" in times else None),
                "prepares": times.get("prepares", 0),
            }
        return {"rooms": out, "stats": dict(rm.migration.stats),
                "rows_used": self.rt.slots.rooms_used}

    async def quiesce(self, ticks: int) -> dict:
        """Stop the sampled audio, let `ticks` more loop ticks complete,
        then return what was pushed and delivered."""
        self.quiet = set(self.sampled)
        done = self.rt.stats["ticks"] + ticks
        t0 = time.perf_counter()
        while self.rt.stats["ticks"] < done:
            if time.perf_counter() - t0 > MIG_WAIT_S:
                raise AssertionError(f"node {self.name}: {ticks} ticks not done")
            await asyncio.sleep(0.01)
        return {"pushed": {f"{n}|{c}": v for (n, c), v in self.pushed.items()},
                "egress": self.egress, "frozen": self.frozen, "adopted": self.adopted}

    async def drain(self) -> dict:
        """drain_node at the default concurrency; one second in, a join to
        a new room must be refused."""
        rm, rt = self.rm, self.rt
        late0, ticks0 = rt.stats["late_ticks"], rt.stats["ticks"]
        rooms0 = len(rm.rooms)
        t0 = time.perf_counter()
        task = asyncio.ensure_future(rm.migration.drain_node())
        await asyncio.sleep(1.0)
        denied = rm._admission_denied("room")
        req, resp = MessageChannel(), MessageChannel()
        await rm.start_session("late-join", {"identity": "late", "name": "late"}, req, resp)
        summary = await asyncio.wait_for(task, MIG_DRAIN_CAP_S)
        drain_s = time.perf_counter() - t0
        return {"summary": {**summary, "failed": len(summary.get("failed", []))},
                "failed_rooms": summary.get("failed", [])[:8],
                "rooms": rooms0, "drain_s": drain_s,
                "rooms_per_s": rooms0 / drain_s if drain_s else None,
                "denied_while_draining": denied, "late_join_refused": "late-join" not in rm.rooms,
                "late_ticks": rt.stats["late_ticks"] - late0,
                "ticks": rt.stats["ticks"] - ticks0,
                "rooms_left": len(rm.rooms), "rows_used": rt.slots.rooms_used,
                "admission_rejected": dict(rm.admission_rejected),
                "stats": dict(rm.migration.stats)}

    async def govern(self, cap_s: float) -> dict:
        """Attach the reference's default overload governor to this node's
        running loop; report its ladder and whether an inbound PREPARE is
        NACKed once it reaches L3 (the migration plane's governed
        admission); then set it back to L0 (its actuators off) and detach
        it."""
        from livekit_server_tpu_torch.runtime.governor import L_PAUSE, OverloadGovernor

        rm, rt = self.rm, self.rt
        limits = Config().limits
        gov = OverloadGovernor.from_config(rt, limits, log=rm.log)
        rm.governor = rt.governor = gov
        ticks0, t0 = rt.stats["ticks"], time.perf_counter()
        while gov.level < L_PAUSE and time.perf_counter() - t0 < cap_s:
            await asyncio.sleep(0.05)
        ticks = rt.stats["ticks"] - ticks0
        nacks = rm.migration.stats["nacks_sent"]
        await rm.migration._handle_prepare({"room": "governed-probe", "epoch": 1,
                                            "source": "governed-probe", "snapshot": ""})
        out = {"ticks": ticks, "seconds": time.perf_counter() - t0, "level": gov.level,
               "transitions": list(gov.transitions),
               "prepare_nacked_at_level": (gov.level if rm.migration.stats["nacks_sent"] > nacks
                                           else None),
               "escalate_ticks": limits.governor_escalate_ticks}
        gov._set_level(0, "probe over")
        rm.governor = rt.governor = None
        return out

    def report(self) -> dict:
        rm, rt = self.rm, self.rt
        sup, gov, integ = rm.supervisor, rm.governor, rm.integrity
        ok_t = [t for t, ok in self.lease if ok]
        gaps = [b - a - self.cfg.kv.stats_interval_s for a, b in zip(ok_t, ok_t[1:])]
        ticks = rt.stats["ticks"] - self.ticks0
        wall = time.perf_counter() - self.t_start
        ck = dict(rm.ckpt_stats)
        return {
            "node": self.name, "rooms": len(rm.rooms), "rows_used": rt.slots.rooms_used,
            "ticks": ticks, "wall_s": wall,
            "wall_ms_per_tick": wall / ticks * 1e3 if ticks else None,
            "late_ticks": rt.stats["late_ticks"], "launches": dict(cuda.launches),
            # build-ledger entries since the node's warm step (its own process)
            "post_warm_builds": rt.post_warm_builds,
            "post_warm_entries": [list(e) for e in LEDGER.since(rt.warm_builds)],
            # Steps whose tick completed or a restart dropped; the loop's
            # launches exceed them by the steps in flight (`check_launches`).
            "steps": ticks + rt.stats["dropped_steps"] - self.dropped0,
            "checkpoint_rounds": {
                **ck, "ms_per_round": (ck["gather_s"] + ck["encode_s"] + ck["publish_s"])
                / ck["rounds"] * 1e3 if ck["rounds"] else None,
                "bytes_per_round": ck["bytes"] / ck["rounds"] if ck["rounds"] else None,
                "interval_s": self.cfg.supervisor.checkpoint_interval_s},
            "lease_refresh_late_s": {"n": len(gaps), **quantiles(gaps),
                                     "max": max(gaps) if gaps else None},
            "lease_failures": sum(1 for _, ok in self.lease if not ok),
            "event_loop_lag_ms": {k: v * 1e3 if v is not None else None
                                  for k, v in {**quantiles(self.lag),
                                               "max": max(self.lag, default=None)}.items()},
            "self_fenced": rm.fleet.stats["fences"], "fleet": dict(rm.fleet.stats),
            "restarts": dict(sup.restart_causes) if sup else None,
            "governor_level": gov.level if gov else None,
            "governor_max_level": max([gov.level] + [t["to"] for t in gov.transitions])
            if gov else None,
            "integrity_violations": integ.violations_total if integ else None,
            "failover": dict(rm.fleet.orchestrator.stats),
            "ckpt_fallbacks": rm.ckpt_fallbacks,
            "ingest_dropped_capacity": rt.ingest.dropped_capacity,
        }

    def restored(self) -> dict:
        """The rooms this node hosts, and for each room a restore wrote
        into (checkpoint or snapshot), how often, when, and whether the
        row equals what was decoded."""
        rooms = {}
        for rec in self.restores:
            room = self.rm._row_to_room.get(rec["row"])
            if room is not None:
                rooms.setdefault(room.name, []).append(rec)
        return {"rooms": {n: {"count": len(v), "t": max(r["t"] for r in v),
                              "equal": all(r["equal"] for r in v)} for n, v in rooms.items()},
                "hosted": sorted(self.rm.rooms),
                "attempts": dict(self.restore_attempts),
                "ckpt_fallbacks": self.rm.ckpt_fallbacks,
                "failover": dict(self.rm.fleet.orchestrator.stats)}

    # -- the pipe ----------------------------------------------------------
    async def serve(self) -> None:
        loop = asyncio.get_running_loop()
        inbox: asyncio.Queue = asyncio.Queue()
        loop.add_reader(self.conn.fileno(), lambda: inbox.put_nowait(self.conn.recv()))
        while True:
            cmd, *args = await inbox.get()
            if cmd == "exit":
                self.conn.send({"ok": True})
                return
            try:
                if cmd == "report":
                    reply = self.report()
                elif cmd == "restored":
                    reply = self.restored()
                else:
                    reply = await getattr(self, cmd)(*args)
            except Exception as e:  # noqa: BLE001 — the phase reads it and fails
                import traceback

                reply = {"error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()}
            self.conn.send(reply)


def mig_node_main(name: str, conn, bus_port: int, dev: str, dims: tuple) -> None:
    """A node process: serve the phase's commands until "exit", then leave
    without tearing the rooms down (the phase is over; a graceful stop
    would migrate or delete every room over the bus)."""
    import os

    configure("warn")
    node = MigNode(name, conn, bus_port, dev, plane.PlaneDims(*dims))
    asyncio.run(node.serve())
    conn.close()
    os._exit(0)


async def mig_fail(nodes: dict, reports: dict, msg: str) -> None:
    """Log every live node's report, then fail the phase with `msg`."""
    for n, h in nodes.items():
        if h.proc.is_alive():
            try:
                reports[n] = await h.call("report", timeout=60)
            except (AssertionError, OSError, EOFError) as e:
                reports[n] = {"error": str(e)}
    log(f"migration: node reports at the failure: {json.dumps(reports)}")
    raise AssertionError(msg)


class NodeHandle:
    def __init__(self, ctx, name: str, bus_port: int, dev: str, dims: plane.PlaneDims):
        self.name = name
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=mig_node_main,
                                args=(name, child, bus_port, dev, tuple(dims)), daemon=True)
        self.proc.start()
        child.close()

    async def call(self, cmd: str, *args, timeout: float = MIG_WAIT_S):
        self.conn.send((cmd, *args))
        loop = asyncio.get_running_loop()
        if not await loop.run_in_executor(None, self.conn.poll, timeout):
            raise AssertionError(f"node {self.name}: no reply to {cmd!r} in {timeout} s")
        reply = self.conn.recv()
        if isinstance(reply, dict) and "error" in reply:
            raise AssertionError(f"node {self.name}: {cmd} failed: {reply['error']}\n"
                                 f"{reply.get('trace', '')}")
        return reply

    def kill(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(30)


def check_launches(rep: dict) -> None:
    """A node's kernel launches since its join: B1, B2 and the RTP-stats
    kernel once a step, so each equals the node's completed and dropped
    steps plus the steps in flight, at most 2 (the pipelined loop's device
    step and the step before it, whose fan-out has not completed); B3
    never (dense plane)."""
    lc, steps = rep["launches"], rep["steps"]
    extra = {k: lc[k] - steps for k in DENSE_KERNELS}
    if any(not 0 <= v <= 2 for v in extra.values()) or lc["paged_kernel"] or not steps:
        raise AssertionError(f"node {rep['node']}: launches {lc} over {steps} steps")


def check_continuity(sampled: list[str], parts: list[dict], subs: int) -> dict:
    """Every Opus packet of the sampled rooms, pushed on either node,
    reaches every other participant exactly once, with consecutive munged
    SNs across the cutover; none reaches its publisher (participant p{t}
    publishes track column t from subscriber column t)."""
    pushed: dict[tuple[str, int], list[int]] = {}
    got: dict[tuple[str, int, int], list[int]] = {}
    for part in parts:
        for key, sns in part["pushed"].items():
            name, col = key.split("|")
            pushed.setdefault((name, int(col)), []).extend(sns)
        for name, t, s, sn in part["egress"]:
            got.setdefault((name, t, s), []).append(sn)
    checked = 0
    for name in sampled:
        for col in MIG_AUDIO_COLS:
            sent = sorted(pushed.get((name, col), []))
            if not sent or sent != list(range(sent[0], sent[0] + len(sent))):
                gaps = [(a, b) for a, b in zip(sent, sent[1:]) if b != a + 1]
                raise AssertionError(f"{name} track {col}: pushed SNs not consecutive "
                                     f"({len(sent)} pushed, gaps {gaps[:4]})")
            for s in range(subs):
                sns = got.get((name, col, s), [])
                if s == col:
                    if sns:
                        raise AssertionError(f"{name}: publisher of track {col} got it")
                    continue
                if len(sns) != len(sent):
                    raise AssertionError(f"{name} track {col} → sub {s}: {len(sns)} delivered, "
                                         f"{len(sent)} pushed")
                if len(set(sns)) != len(sns) or any((b - a) & 0xFFFF != 1
                                                    for a, b in zip(sns, sns[1:])):
                    raise AssertionError(f"{name} track {col} → sub {s}: munged SNs not "
                                         f"consecutive once-only across the cutover")
                checked += len(sns)
    return {"packets_checked": checked}


async def migration_phase(dev, dims: plane.PlaneDims = MIG_DIMS, rooms: dict = MIG_ROOMS,
                          sample: int = MIG_SAMPLE_ROOMS,
                          after_ticks: int = MIG_AFTER_TICKS) -> dict:
    """The multi-node plane on the card: a port BusServer on loopback and
    nodes A, B and C, each its own process on the one card (a KVRouter on
    a TCPBusClient, a RoomManager on the card under the reference's
    default config but the governor: supervisor, integrity, migration and
    fleet on, kv.kind tcp), joined through start_session with MessageChannel
    sinks, a feeder pushing one seeded synth tick (and every subscriber's
    receiver estimate) per loop tick. A hosts rooms["A"] rooms, B
    rooms["B"]. Steps: `sample` rooms migrated A → B one at a time with
    migrate_room (each moved row on B bit-equal to A's freeze snapshot,
    every Opus packet of those rooms delivered once with consecutive
    munged SNs across the cutover, A's rows released); B SIGKILLed and
    its rooms restored on A from its KV checkpoints (every room once and
    with its state, each row equal to the checkpoint it decoded; the
    launches of every node held to its steps); C started and A
    drained into it (every room moves, A refuses admissions meanwhile
    and ends with no room and no row). Returns the numbers."""
    from livekit_server_tpu_torch.routing.tcpbus import BusServer

    t_phase = time.perf_counter()
    out: dict = {"card": card_line(), "dims": list(dims), "rooms": dict(rooms)}
    srv = BusServer()
    await srv.start("127.0.0.1", 0)
    ctx = multiprocessing.get_context("spawn")
    nodes = {n: NodeHandle(ctx, n, srv.port, str(dev), dims) for n in ("A", "B", "C")}
    reports: dict = {}
    try:
        inits = await asyncio.gather(*(h.call("init") for h in nodes.values()))
        ids = {n: r["node_id"] for n, r in zip(nodes, inits)}
        names_a = [f"a{r}" for r in range(rooms["A"])]
        names_b = [f"b{r}" for r in range(rooms["B"])]
        sampled = names_a[:sample]
        joins = await asyncio.gather(nodes["A"].call("join", names_a, sampled),
                                     nodes["B"].call("join", names_b, sampled))
        out["join_s"] = {"A": joins[0]["join_s"], "B": joins[1]["join_s"]}
        log(f"migration: A {rooms['A']} rooms, B {rooms['B']} rooms joined "
            f"({out['join_s']})")
        await asyncio.sleep(3.0)                  # a checkpoint round on each node

        # 1. Live migration, one room at a time, under load.
        mig = await nodes["A"].call("migrate", sampled, ids["B"])
        failed = [n for n, r in mig["rooms"].items() if not r["ok"]]
        if failed:
            raise AssertionError(f"migration: {failed} did not move")
        ms = [r["prepare_to_commit_ms"] for r in mig["rooms"].values()]
        freeze = [r["freeze_ms"] for r in mig["rooms"].values()]
        st = mig["stats"]
        rep_a = await nodes["A"].call("quiesce", 0)
        rep_b = await nodes["B"].call("quiesce", after_ticks)
        for name in sampled:
            if rep_a["frozen"].get(name) is None or rep_a["frozen"][name] != rep_b["adopted"].get(name):
                leaves = plane.leaf_names(plane.init_state(plane.PlaneDims(1, 1, 1, 1),
                                                           device="cpu"))
                bad = [i for i, (x, y) in enumerate(zip(rep_a["frozen"].get(name, []),
                                                        rep_b["adopted"].get(name, [])))
                       if x != y]
                raise AssertionError(f"migration: {name} on B differs from A's freeze "
                                     f"snapshot at leaves "
                                     f"{[leaves[i] if i < len(leaves) else f'munger {i}' for i in bad][:6]}")
        cont = check_continuity(sampled, [rep_a, rep_b], dims.subs)
        out["live_migration"] = {
            "rooms": len(sampled), "prepare_to_commit_ms": quantiles(ms),
            "freeze_ms": quantiles(freeze),
            "settle_ms": quantiles([r["settle_ms"] for r in mig["rooms"].values()]),
            "migrate_ms": quantiles([r["migrate_ms"] for r in mig["rooms"].values()]),
            "bridged_packets": st["bridged_out"], "bridge_evicted": st["bridge_dropped"],
            "ack_timeouts": st["timeouts"],
            "retries": sum(r["prepares"] - 1 for r in mig["rooms"].values()),
            "rollbacks": st["rollbacks"], "settle_timeouts": st["settle_timeouts"],
            "a_rows_used_after": mig["rows_used"],
            "rows_bit_equal": len(sampled), **cont,
        }
        if mig["rows_used"] != rooms["A"] - sample:
            raise AssertionError(f"migration: A holds {mig['rows_used']} rows")
        log(f"migration: live {json.dumps(out['live_migration'])}")

        # 2. Failover: B dies; A restores its rooms from B's checkpoints.
        # Two more of B's checkpoint rounds first: the second starts after
        # the adoptions, so every room B hosts has a checkpoint of its own.
        rounds0 = (await nodes["B"].call("report"))["checkpoint_rounds"]["rounds"]
        t0 = time.perf_counter()
        while (await nodes["B"].call("report"))["checkpoint_rounds"]["rounds"] < rounds0 + 2:
            if time.perf_counter() - t0 > MIG_WAIT_S:
                await mig_fail(nodes, reports, "failover: B wrote no checkpoint round")
            await asyncio.sleep(0.5)
        reports["B"] = await nodes["B"].call("report")
        b_rooms = set(names_b) | set(sampled)
        t_kill = time.time()
        nodes["B"].kill()
        ttl = migration_config(srv.port, dims).kv
        t0 = time.perf_counter()
        while True:
            res = await nodes["A"].call("restored")
            if b_rooms <= set(res["hosted"]) or time.perf_counter() - t0 > MIG_WAIT_S:
                break
            await asyncio.sleep(1.0)
        got = {n: r for n, r in res["rooms"].items() if n in b_rooms}
        # Hosted without a restore: no checkpoint generation of the room
        # was left to decode (they live CHECKPOINT_TTL_S after their
        # write), so it came back empty — a stream reset, as the
        # reference's restore does then; its state is lost, and the step
        # fails.
        fresh = sorted(b_rooms & set(res["hosted"]) - set(got))
        lost = sorted(b_rooms - set(res["hosted"]))
        twice = sorted(n for n, r in got.items() if r["count"] != 1)
        unequal = sorted(n for n, r in got.items() if not r["equal"])
        times = sorted(r["t"] - t_kill for r in got.values())
        tried = sorted(t - t_kill for n, t in res["attempts"].items() if n in b_rooms)
        out["failover"] = {
            "rooms": len(b_rooms), "rooms_restored": len(tried),
            "restored_from_checkpoint": len(got), "rooms_not_restored": len(lost),
            "rooms_state_lost": len(fresh), "state_lost_sample": fresh[:8],
            "restored_twice": len(twice), "rows_unequal_to_checkpoint": len(unequal),
            # From the kill to the last room hosted again, and to the first.
            "recover_s": tried[-1] if tried else None,
            "first_room_s": tried[0] if tried else None,
            "last_checkpoint_restore_s": times[-1] if times else None,
            "lease_ttl_plus_failover_interval_s": ttl.lease_ttl_s + ttl.failover_interval_s,
            # B's newest checkpoints were written before the kill, so the
            # last restore had at most this much of their TTL left.
            "checkpoint_ttl_s": CHECKPOINT_TTL_S,
            "ttl_left_at_last_restore_s": CHECKPOINT_TTL_S - tried[-1] if tried else None,
            "checkpoint_fallbacks": res["ckpt_fallbacks"],
            "generations_used": {"newest": len(got)} if res["ckpt_fallbacks"] == 0
            else {"fallbacks": res["ckpt_fallbacks"]},
            "orchestrator": res["failover"],
        }
        log(f"migration: failover {json.dumps(out['failover'])}")
        if lost or fresh or twice or unequal:
            await mig_fail(nodes, reports, f"failover: not restored {lost[:5]}, without their "
                                          f"state {fresh[:5]}, twice {twice[:5]}, unequal to "
                                          f"the checkpoint {unequal[:5]}")

        # 3. Drain A into a fresh node C (its heartbeat in the registry
        # first). B's entry stays there, and may still be offered as a
        # target: a node judges a peer's heartbeat stamp stale only
        # STATS_MAX_AGE after it first saw the stamp stop advancing; a
        # PREPARE to B finds no listener and the room rolls back and
        # moves on to the next candidate (counted in the drain's stats).
        await nodes["C"].call("join", [], [])
        # The reference's default governor on C's running loop, empty yet
        # (see migration_config); it is detached again before the drain.
        out["governed"] = await nodes["C"].call("govern", 60.0, timeout=120)
        log(f"migration: governed {json.dumps(out['governed'])}")
        drain = await nodes["A"].call("drain", timeout=MIG_DRAIN_CAP_S + 60)
        rep_c = await nodes["C"].call("report")
        out["drain"] = {**drain, "c_rooms": rep_c["rooms"]}
        log(f"migration: drain {json.dumps(out['drain'])}")
        if (drain["summary"]["failed"] or drain["rooms_left"] or drain["rows_used"]
                or drain["denied_while_draining"] != "node draining"
                or not drain["late_join_refused"] or rep_c["rooms"] != drain["rooms"]):
            await mig_fail(nodes, reports, f"drain: {json.dumps(drain)}; C holds {rep_c['rooms']}")

        reports["A"] = await nodes["A"].call("report")
        reports["C"] = await nodes["C"].call("report")
        out["nodes"] = reports
        for n, rep in reports.items():
            if rep["restarts"] and rep["restarts"].get("integrity"):
                raise AssertionError(f"node {n}: integrity restarts on a clean state")
            check_launches(rep)
            LOOP_LEDGER.append({"loop": f"migration node {n}",
                                "post_warm_builds": rep["post_warm_builds"],
                                "entries": rep["post_warm_entries"]})
        launches = {k: sum(rep["launches"][k] for rep in reports.values())
                    for k in reports["A"]["launches"]}
        out["launches"] = launches
    finally:
        for n in ("A", "C"):
            h = nodes[n]
            if h.proc.is_alive():
                try:
                    await h.call("exit", timeout=30)
                except (AssertionError, OSError, EOFError):
                    pass
            h.kill()
        nodes["B"].kill()
        srv.close()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler tables of dense and paged steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # The host libraries (g++) build while nvcc builds the kernels.
    native_build = threading.Thread(target=native.status)
    native_build.start()
    reports = cuda.build()
    native_build.join()
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"nvcc {name}: {line.strip()}")
    ptxas = {name: ptxas_report(text) for name, text in reports.items()}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    card = card_line()
    log(f"build ok in {time.perf_counter() - t0:.1f} s; card: {card}")
    libs = library_report()
    print(json.dumps({"libraries": libs}), flush=True)
    if not libs["libssl"]:
        print("chip_smoke: libssl.so.3 is missing; the WebRTC gateway cannot run",
              file=sys.stderr)
        return 3

    ends: dict[str, float] = {"build": time.perf_counter() - t0}   # s into the run

    def done(phase: str) -> None:
        ends[phase] = time.perf_counter() - t0

    errs = parity_phase(dev)
    errs["paged_kernel"], mix_t = paged_parity_phase(dev)
    done("parity")
    runtime_launches = asyncio.run(runtime_phase(dev))
    paged_runtime_launches = asyncio.run(paged_runtime_phase(dev))
    done("runtime")
    serving = asyncio.run(serving_phase(dev))
    print(json.dumps({"serving": serving}), flush=True)
    done("serving")
    udp = asyncio.run(udp_phase(dev))
    print(json.dumps({"udp": udp}), flush=True)
    done("udp")
    express = asyncio.run(express_phase(dev))
    print(json.dumps({"express": express}), flush=True)
    golden = golden_scan_phase(dev)
    log(f"golden scans exact on the card: {golden}")
    print(json.dumps({"golden_scans": golden}), flush=True)
    done("express")
    gateway = asyncio.run(gateway_phase(dev))
    print(json.dumps({"gateway": gateway}), flush=True)
    done("gateway")
    mixer = mixer_phase(dev)
    print(json.dumps({"mixer": mixer}), flush=True)
    done("mixer")
    shard, shard_t, shard_launches, shard_rm_launches = shard_phase(dev)
    print(json.dumps({"shard": shard}), flush=True)
    log(f"shards ok on {shard['card']} ({shard['device_count']} CUDA devices): north-star "
        f"device step {json.dumps(shard['north_star']['device_step'])}; pool cross-shard "
        f"pages {shard['pool']['cross_shard_pages']}")
    done("shard")
    twin, twin_flash_launches, twin_sweep_launches = twin_phase(dev)
    print(json.dumps({"twin": twin}), flush=True)
    log(f"twin ok in {twin['phase_s']:.1f} s: knee {twin['sweep']['capacity_knee_load']}, "
        f"drain ticks {twin['sweep']['drain_ticks']}, trace {json.dumps(twin['trace'])}")
    done("twin")
    tooling = tooling_phase(dev)
    print(json.dumps({"tooling": tooling}), flush=True)
    done("tooling")
    bench, bench_launches = bench_phase(dev)
    print(json.dumps({"bench": bench}), flush=True)
    log(f"bench ok in {bench['phase_s']:.1f} s")
    done("bench")
    tick, dense_t, ns_state = timing_phase(dev, args.profile)
    paged_tick, paged_t, pool_state = paged_timing_phase(dev, args.profile)
    done("timing")
    failure = asyncio.run(failure_phase(dev, ns_state, tick, pool_state, paged_tick))
    del ns_state, pool_state
    print(json.dumps({"failure": failure}), flush=True)
    done("failure")
    torch.cuda.empty_cache()
    migration = asyncio.run(migration_phase(dev))
    print(json.dumps({"migration": migration}), flush=True)
    done("migration")
    print(json.dumps({"phase_end_s": ends}), flush=True)

    # decide_rooms, allocate_budget_rooms and rtpstats_rooms belong to the
    # dense path, paged_kernel to the paged path; each kernel's top-level numbers and
    # `launches` are from its own path, and `paths` gives each path that
    # launches it: its launch shape, launches and timed numbers there (the
    # paged path's decide_rooms and rtpstats_rooms are its dead-page key's
    # launches; the paged allocation's dead-page launch is under `dead_key`).
    launches = {"dense": runtime_launches, "paged": paged_runtime_launches,
                "serving_dense": serving["dense"]["launches"],
                "serving_paged": serving["paged"]["launches"],
                "udp_dense": udp["dense"]["launches"],
                "udp_paged": udp["paged"]["launches"],
                "express_lockstep": express["lockstep"]["launches"],
                "express": express["loop"]["launches"],
                "gateway": gateway["loop"]["launches"],
                "shard": shard_launches,
                "shard_cfg4": shard_rm_launches,
                "migration": migration["launches"],
                "twin_flash": twin_flash_launches,
                "twin_sweep": twin_sweep_launches,
                "bench_window": bench_launches}
    paged_t["paged_kernel"]["mix"] = mix_t
    timed = {"dense": dense_t, "paged": paged_t, "shard": shard_t}
    own = {"decide_rooms": "dense", "allocate_budget_rooms": "dense", "paged_kernel": "paged",
           "rtpstats_rooms": "dense"}
    kernels = []
    for name, meta in KERNELS.items():
        main_t = timed[own[name]][name]
        paths = {
            path: {"launches": launches[path][name], **timed[path][name]}
            for path in ("dense", "paged", "shard") if name in timed[path]
        }
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[own[name]][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": errs[name], "ms": main_t["ms"], "call_ms": main_t["call_ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "paths": paths,
            **ptxas.get(name, {}),
        })
    print(json.dumps({"north_star_tick": tick}), flush=True)
    print(json.dumps({"paged_tick": paged_tick, "paged_kernel": paged_t["paged_kernel"],
                      "paged_allocate_budget_rooms": paged_t["allocate_budget_rooms"]}),
          flush=True)
    ledger = {**LEDGER.snapshot(), "loops": LOOP_LEDGER}
    print(json.dumps({"build_ledger": ledger}), flush=True)
    post_warm = [rec for rec in LOOP_LEDGER if rec["post_warm_builds"]]
    if post_warm or not LOOP_LEDGER:
        print(f"chip_smoke: ledger entries after mark_warm: {post_warm}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
