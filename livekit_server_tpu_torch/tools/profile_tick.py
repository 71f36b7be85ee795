"""Per-block profile of the dense media-plane tick at a given shape.

    python -m livekit_server_tpu_torch.tools.profile_tick --shape cfg4|northstar|default \
        [--device cuda|cpu] [--n 8] [--trace FILE]

Times the full tick and then each block of the phase-1 core
(`models/plane.py` `_room_tick`) and of phases 0 and 2 on its own, on the
inputs the port's `media_plane_tick` passes it, and prints each block's
ms and their sum beside the full tick. Blocks 4, 5, 10 and 11 are not in
the tick (the munger runs on the host; the compactions are the device
compaction designs measured for the record) and are left out of the sum.

Method: on the card each block is captured in a CUDA graph and replayed
(`tools.timing.graph_ms`: device time, the launches' host work not
included) when its ops can be captured, else timed with CUDA events
around each call (`event_ms`: host launches included). Block 10 is
always the latter: `torch.nonzero` reads its count back to the host,
which a capture refuses. On the CPU every block is host time
(`wall_ms`). `profile(..., detail=d)` records each block's method and
its event-timed ms beside the graph time, since the eager tick pays the
launches: the full tick's graph time against its event time is the
share of the step that is host launch work.

`--trace FILE` instead runs the eager full tick `n` times under
`torch.profiler` with the tick's block spans annotated (`record_function`
ranges `plane.<block>`, models/plane.py, utils/spans.py), writes the
profiler's Chrome trace to FILE and prints each block's median host span
a call: the launch work the served tick pays, where the device waits.
"""

from __future__ import annotations

import argparse
import math
import statistics

import numpy as np
import torch

from livekit_server_tpu_torch.device import resolve
from livekit_server_tpu_torch.models import plane, synth
from livekit_server_tpu_torch.ops import (
    allocation,
    audio,
    bwe,
    pacer,
    red,
    rtpmunger,
    rtpstats,
    selector,
    streamtracker,
    vp8,
)
from livekit_server_tpu_torch.tools.timing import event_ms, graph_ms, wall_ms
from livekit_server_tpu_torch.utils import spans

SHAPES = {
    "cfg4": (
        plane.PlaneDims(1024, 10, 8, 10),
        synth.TrafficSpec(video_tracks=2, audio_tracks=8, tick_ms=20,
                          video_kbps=1500, svc=True),
    ),
    "northstar": (
        plane.PlaneDims(10240, 8, 16, 50),
        synth.TrafficSpec(video_tracks=2, audio_tracks=6, tick_ms=20,
                          video_kbps=1500, svc=True),
    ),
    "default": (
        plane.PlaneDims(128, 8, 16, 16),
        synth.TrafficSpec(video_tracks=4, audio_tracks=4, tick_ms=20,
                          video_kbps=3000),
    ),
}

FULL = "FULL tick (packed, donated)"
# Blocks outside the tick: not summed against it.
NOT_IN_TICK = ("4. rtpmunger.munge_tick (retired from tick)",
               "5. vp8.munge_tick (retired from tick)",
               "10. egress compaction (nonzero+gather)",
               "11. compaction (cumsum+searchsorted)",
               "12a. tick, outputs UNPACKED (no donate)",
               "12b. tick, outputs packed (no donate)")
# Launches of a block captured in one graph (the full tick's allocations
# are the pool's; a few launches keep its footprint small).
GRAPH_LAUNCHES = 4


def packed_tick(dims: plane.PlaneDims, spec: synth.TrafficSpec, dev) -> list:
    """The packed inputs (pkt, fb, tf, tick_ms, roll) of one synthesized
    tick, on `dev`."""
    traffic = synth.init_traffic(dims, spec)
    _, inp_np = synth.next_tick(traffic, dims, spec, tick_index=7)
    return [torch.from_numpy(np.asarray(x)).to(dev) for x in plane.pack_tick_inputs(inp_np)]


def full_tick(dims: plane.PlaneDims, spec: synth.TrafficSpec, dev):
    """The eager full tick (unpack, tick, pack) on one tick's packed
    inputs, carrying its state from call to call, as the runtime does."""
    pkt, fb, tf, tick_ms, roll = packed_tick(dims, spec, dev)
    carried = [synth.make_state(dims, spec, device=dev)]

    def full():
        i = plane.unpack_tick_inputs(pkt, fb, tf, tick_ms, roll)
        carried[0], o = plane.media_plane_tick(carried[0], i)
        return plane.pack_tick_outputs(o)

    return full


def blocks(dims: plane.PlaneDims, spec: synth.TrafficSpec, device) -> list:
    """[(label, fn, capturable)] in the reference profile's order; each fn
    runs its block once on a fixed state and tick (the full tick carries
    its state from call to call, as the runtime does)."""
    dev = resolve(device)
    R, T, K, S = dims
    state = synth.make_state(dims, spec, device=dev)
    pkt, fb, tf, tick_ms, roll = packed_tick(dims, spec, dev)
    inp = plane.unpack_tick_inputs(pkt, fb, tf, tick_ms, roll)
    meta, ctrl = state.meta, state.ctrl
    out: list = [(FULL, full_tick(dims, spec, dev), True)]

    # ---- phase 0 on the tick's inputs; its outputs feed phases 1 and 2 ----
    base = (ctrl.subscribed & ~ctrl.sub_muted
            & (meta.published & ~meta.pub_muted)[:, :, None])

    def decide():
        return selector.decide_rooms(
            state.sel, meta.is_svc, meta.is_video, base, inp.layer, inp.temporal,
            inp.keyframe, inp.layer_sync, inp.end_frame, inp.valid, inp.size,
            wire_overhead=pacer.WIRE_OVERHEAD_BYTES)

    sel_out = decide()
    need_kf, pkts_sent, sent_bytes = sel_out[4], sel_out[5], sel_out[6]
    _, outs, bitrates = plane._room_tick(state, inp, need_kf, pkts_sent, sent_bytes,
                                         audio.AudioLevelParams(), bwe.BWEParams(), True)

    # ---- 1. rtpstats (+routing; rtpstats_rooms.cu on the card) -----------
    def stats_block():
        return rtpstats.route_update_tick(state.stats, meta.is_svc, inp.layer, inp.sn,
                                          inp.ts, inp.size, inp.arrival_rtp, inp.valid,
                                          inp.begin_pic)

    out.append(("1. rtpstats.update_tick (+routing)", stats_block, True))

    # ---- 2. streamtracker (+routing: the tracker sums of block 1) ----------
    def tracker_block():
        _, tr = stats_block()
        return streamtracker.update_tick(state.tracker, streamtracker.TrackerParams(),
                                         tr[:, 0], tr[:, 1], inp.tick_ms, frames=tr[:, 2])

    out.append(("2. streamtracker (+routing)", tracker_block, True))

    # ---- 3. the fused forward decision (B1, decide_rooms.cu) -------------
    out.append(("3. selector.decide_rooms (fused kernel)", decide, True))

    # ---- 4–5. munger + vp8 (host-side in the runtime) --------------------
    fwd = torch.ones((R, T, K, S), dtype=torch.bool, device=dev)
    drop = torch.zeros((R, T, K, S), dtype=torch.bool, device=dev)
    switch = torch.zeros((R, T, K, S), dtype=torch.bool, device=dev)
    tile = lambda tree: type(tree)(*[x.expand((R, T) + tuple(x.shape)).clone()  # noqa: E731
                                     for x in tree])
    munger_st = tile(rtpmunger.init_state(S, device=dev))
    vp8_st = tile(vp8.init_state(S, device=dev))
    out.append(("4. rtpmunger.munge_tick (retired from tick)",
                lambda: rtpmunger.munge_tick(munger_st, inp.sn, inp.ts, inp.valid, fwd,
                                             drop, switch, inp.ts_jump), True))
    out.append(("5. vp8.munge_tick (retired from tick)",
                lambda: vp8.munge_tick(vp8_st, inp.pid, inp.tl0, inp.keyidx, inp.begin_pic,
                                       inp.valid, fwd, drop, switch), True))

    # ---- 6. allocation (B2, budget_rooms.cu) -----------------------------
    video_active = meta.is_video & meta.published & ~meta.pub_muted
    alloc_muted = ~(ctrl.subscribed & video_active[:, :, None] & ~ctrl.sub_muted)
    ms_t = ctrl.max_spatial.transpose(1, 2).contiguous()
    mt_t = ctrl.max_temporal.transpose(1, 2).contiguous()
    muted_t = alloc_muted.transpose(1, 2).contiguous()
    out.append(("6. allocation.allocate_budget_batch",
                lambda: allocation.allocate_budget_rooms(bitrates, ms_t, mt_t, muted_t,
                                                         outs["committed_bps"]), True))

    # ---- 7. bwe + delay bwe + pacer --------------------------------------
    def bwe_block():
        p_sent = pkts_sent.to(torch.float32)
        b2, cong, _trend, budget = bwe.update_tick(
            state.bwe_state, bwe.BWEParams(), inp.estimate, inp.estimate_valid, p_sent,
            inp.nacks)
        d2, rate, over, act = bwe.delay_update_tick(
            state.delay_bwe, bwe.DelayBWEParams(), inp.fb_delay_ms, inp.fb_recv_bps,
            inp.fb_valid, inp.fb_enabled, p_sent, inp.tick_ms)
        budget = torch.where(act, torch.minimum(budget, rate), budget)
        p2, allowed, _backlog = pacer.update_tick(
            state.pacer_state, pacer.PacerParams(), sent_bytes.to(torch.float32), budget,
            inp.tick_ms)
        return b2, d2, p2, cong | over, budget, allowed

    out.append(("7. bwe+delay+pacer", bwe_block, True))

    # ---- 8. RED plan -----------------------------------------------------
    is_audio_pkt = inp.valid & ~meta.is_video[:, :, None]
    out.append(("8. red.encode_plan_tick",
                lambda: red.encode_plan_tick(state.red_state, inp.sn, inp.ts, inp.size,
                                             is_audio_pkt), True))

    # ---- 9. audio levels + top-k -----------------------------------------
    def audio_block():
        a2, linear, active = audio.observe_tick(
            state.audio_state, audio.AudioLevelParams(),
            torch.where(is_audio_pkt, inp.audio_level, 127), inp.frame_ms, is_audio_pkt,
            inp.tick_ms)
        lv, tr = audio.top_speakers(torch.where(active & meta.published, linear, 0.0),
                                    min(plane.SPEAKER_TOP_K, T))
        return a2, lv, tr

    out.append(("9. audio levels + top-k", audio_block, True))

    # ---- 10–11. device egress compaction designs (not in the tick) --------
    send = fwd & (torch.arange(S, device=dev)[None, None, None, :] < 4)
    cap = min(T * K * S, max(128, T * K * 4))
    osn = inp.sn[..., None].expand(R, T, K, S).reshape(R, -1)
    ots = inp.ts[..., None].expand(R, T, K, S).reshape(R, -1)

    def compact_block():
        flat = send.reshape(R, -1)
        rows, cols = torch.nonzero(flat, as_tuple=True)    # reads its count back
        rank = flat.to(torch.int32).cumsum(1)[rows, cols] - 1
        keep = rank < cap
        idx = torch.full((R, cap), -1, dtype=torch.int64, device=dev)
        idx[rows[keep], rank[keep].long()] = cols[keep]
        hit = idx >= 0
        safe = idx.clamp(min=0)
        return (idx.to(torch.int32), torch.where(hit, osn.gather(1, safe), 0),
                torch.where(hit, ots.gather(1, safe), 0))

    out.append(("10. egress compaction (nonzero+gather)", compact_block, False))

    want = torch.arange(1, cap + 1, dtype=torch.int32, device=dev).expand(R, cap).contiguous()

    def compact2_block():
        csum = send.reshape(R, -1).to(torch.int32).cumsum(1, dtype=torch.int32)
        idx = torch.searchsorted(csum, want, side="left")
        hit = want <= csum[:, -1:]
        idx = torch.where(hit, idx, -1)
        safe = idx.clamp(min=0, max=csum.shape[1] - 1)
        return (idx.to(torch.int32), torch.where(hit, osn.gather(1, safe), 0),
                torch.where(hit, ots.gather(1, safe), 0))

    out.append(("11. compaction (cumsum+searchsorted)", compact2_block, True))

    # ---- 12. the tick without and with the output packing ----------------
    def outputs_only():
        i = plane.unpack_tick_inputs(pkt, fb, tf, tick_ms, roll)
        return plane.media_plane_tick(state, i)[1]

    out.append(("12a. tick, outputs UNPACKED (no donate)", outputs_only, True))
    out.append(("12b. tick, outputs packed (no donate)",
                lambda: plane.pack_tick_outputs(outputs_only()), True))

    # ---- 13. mask merges + padding + quality (leftover algebra) ----------
    all_base = torch.ones((R, T, S), dtype=torch.bool, device=dev)

    def merge_block():
        a_fwd = inp.valid[..., None] & all_base[:, :, None, :]
        vid = meta.is_video[..., None, None]
        m_fwd = torch.where(vid, fwd & all_base[:, :, None, :], a_fwd)
        m_drop = torch.where(vid, drop & all_base[:, :, None, :], False)
        return m_fwd, m_drop, m_fwd.sum(dtype=torch.int32)

    out.append(("13. mask merges", merge_block, True))
    return out


def profile(dims: plane.PlaneDims, spec: synth.TrafficSpec, device="cuda", n: int = 8,
            detail: dict | None = None) -> dict[str, float]:
    """{label: ms} of every block (module docstring: the method of each).
    With `detail`, each label also gets {"method", "event_ms"} there, and
    a capture that failed its reason."""
    dev = resolve(device)
    res: dict[str, float] = {}
    for label, fn, capturable in blocks(dims, spec, dev):
        rec: dict = {}
        if dev.type != "cuda":
            fn()
            rec["method"] = "wall"
            res[label] = wall_ms(fn, n)
        else:
            fn()
            torch.cuda.synchronize(dev)
            rec["event_ms"] = event_ms(fn, n)
            rec["method"] = "event"
            res[label] = rec["event_ms"]
            if capturable:
                try:
                    res[label] = graph_ms(fn, n, GRAPH_LAUNCHES)
                    rec["method"] = "graph"
                except RuntimeError as e:   # an op the capture refuses
                    rec["why"] = f"capture failed: {str(e).splitlines()[0][:200]}"
                    torch.cuda.synchronize(dev)
            else:
                rec["why"] = "reads a count back to the host (torch.nonzero)"
            torch.cuda.empty_cache()
        if detail is not None:
            detail[label] = rec
    return res


def trace(dims: plane.PlaneDims, spec: synth.TrafficSpec, path: str, device="cuda",
          n: int = 8) -> dict[str, float]:
    """The eager full tick `n` times under torch.profiler, its block spans
    annotated; writes the Chrome trace to `path`. Returns {span: median
    host ms a call} (`spans.SPANS`)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    dev = resolve(device)
    full = full_tick(dims, spec, dev)
    for _ in range(2):          # kernel builds and the allocator's first blocks
        full()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    rec = spans.recorder()
    rec.annotate = True
    try:
        with torch_profile(activities=acts) as prof:
            for _ in range(n):
                full()
                sync()
    finally:
        rec.annotate = False
    prof.export_chrome_trace(path)
    return {name: statistics.median(d for _, d in rec.calls(i)[-n:]) / 1e6
            for i, name in enumerate(spans.SPANS)}


def blocks_sum(res: dict[str, float]) -> float:
    """Sum of the blocks that run inside the tick (the full tick and the
    retired and whole-tick variants left out)."""
    return sum(ms for label, ms in res.items() if label != FULL and label not in NOT_IN_TICK)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="livekit_server_tpu_torch.tools.profile_tick",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="cfg4", choices=list(SHAPES))
    ap.add_argument("--n", type=int, default=8, help="timed calls (graph replays) a block")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="FILE",
                    help="profile the eager full tick with its block spans and write the "
                         "Chrome trace here")
    args = ap.parse_args(argv)
    dims, spec = SHAPES[args.shape]
    if args.trace:
        med = trace(dims, spec, args.trace, args.device, args.n)
        print(f"shape={args.shape} dims={tuple(dims)} device={args.device} "
              f"trace={args.trace} ({args.n} ticks)")
        for name, ms in med.items():
            print(f"plane.{name:14s} {ms:9.3f} ms  (median host span a call)")
        blocks_ms = sum(ms for name, ms in med.items() if name != "tick")
        print(f"{'sum of the blocks':20s} {blocks_ms:9.3f} ms")
        return 0
    detail: dict = {}
    res = profile(dims, spec, args.device, args.n, detail)
    print(f"shape={args.shape} dims={tuple(dims)} device={args.device}")
    for label, ms in res.items():
        d = detail[label]
        extra = f"  (event {d['event_ms']:.3f} ms)" if d["method"] == "graph" else ""
        print(f"{label:42s} {ms:9.3f} ms  [{d['method']}]{extra}")
    total = blocks_sum(res)
    print(f"{'sum of the blocks in the tick':42s} {total:9.3f} ms  "
          f"({100.0 * total / res[FULL]:.1f} % of the full tick)")
    return 0 if all(math.isfinite(v) for v in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
