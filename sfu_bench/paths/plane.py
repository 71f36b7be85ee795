"""Path `plane`: the device tick alone, over an input pool on the device.

Each tick of the window is the port's production tick,
`plane.unpack_tick_inputs` → `plane.media_plane_tick` (phase 0 on
csrc/decide_rooms.cu, phase 2 on csrc/budget_rooms.cu) →
`plane.pack_tick_outputs`, on pool tick `i % n`, and ends at a
synchronize. The pool's packets were generated from the seed and packed
by the port's `pack_tick_inputs` in set-up. At each wrap of the pool the
harness advances its SN, RTP time and arrival time by one pass's span,
on the device, so replays continue every stream (no late or duplicate
packets) and carry the same work. The forward count is summed on the
device and read once after the window; so is each pass's, whose first
and last full pass in the window are printed.

The output check follows the program step by step from its own state
(the reference cannot replay a window of thousands of ticks in the time
of a run): at ticks drawn from the seed the sampled rooms' state before
the tick, the tick's outputs and the state after it are gathered on the
device, and the reference computes the tick from that state and the
tick's inputs, on the run's device. The start (the first `start_ticks`
ticks, warm-up included) is replayed in full from the reference's own
initial state, which checks the state carried from tick to tick there.
One tick of the window's first `full_within` after the start, drawn from
the seed, is compared at full width: every room's outputs (the forward
counts that `fwd_writes_per_s` sums, the send bits) and state, the
reference run over blocks of `full_block_rooms` rooms.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from sfu_bench import compare, core
from sfu_bench.gen import library, synth
from sfu_bench.reference import node as ref_node
from sfu_bench.reference import plain_mode
from sfu_bench.reference import tick as ref


def traffic_spec(config: dict, traffic: dict) -> synth.TrafficSpec:
    """The configuration's tracks and rates with the mix's estimates."""
    offered = 1000.0 * (config["video_tracks"] * config["video_kbps"]
                        + config["audio_tracks"] * config["audio_kbps"])
    return synth.TrafficSpec(
        video_tracks=config["video_tracks"], audio_tracks=config["audio_tracks"],
        fps=config["fps"], tick_ms=config["tick_ms"], video_kbps=config["video_kbps"],
        audio_kbps=config["audio_kbps"], svc=bool(config["svc"]),
        estimate_bps=traffic["estimate_factor"] * offered,
    )


def library_ticks(dims, traffic: dict) -> int:
    """Pool length: the mix's tick count, cut to its byte budget on the
    device (at least 2)."""
    R, T, K, S = dims
    per_tick = (13 * R * T * K + 8 * R * S + R * T) * 4
    return int(max(2, min(traffic["library_ticks"], traffic["library_bytes"] // per_tick)))


def roll_of(i: int, tick_ms: int) -> int:
    """Whether tick i closes the quality window (about once a second), as
    the runtime's stage decides it."""
    return int((i + 1) % max(1, 1000 // tick_ms) == 0)


def meta_ctrl(dims, spec, rooms=None):
    """TrackMeta / SubControl numpy trees of the configuration (every
    track of the spec published, every subscriber subscribed); the rows of
    `rooms` when given."""
    meta, ctrl = synth.make_meta_ctrl(dims, spec)
    if rooms is not None:
        meta = ref.TrackMeta(*[np.ascontiguousarray(x[rooms]) for x in meta])
        ctrl = ref.SubControl(*[np.ascontiguousarray(x[rooms]) for x in ctrl])
    return meta, ctrl


def ref_state(dims, spec, rooms) -> ref.PlaneState:
    """The reference's own initial state of the sampled rooms."""
    meta, ctrl = meta_ctrl(dims, spec, rooms)
    sub = ref.PlaneDims(len(rooms), dims.tracks, dims.pkts, dims.subs)
    st = ref.init_state(sub, device="cpu")
    return st._replace(
        meta=ref.TrackMeta(*[torch.from_numpy(x) for x in meta]),
        ctrl=ref.SubControl(*[torch.from_numpy(np.ascontiguousarray(x)).to(c.dtype)
                              for x, c in zip(ctrl, st.ctrl)]),
    )


class Session:
    def __init__(self, ctx: core.Ctx):
        from livekit_server_tpu_torch.models import plane as P

        self.P = P
        cfg, tr = ctx.cell.config, ctx.cell.traffic
        self.ctx, self.dims, self.dev = ctx, ctx.dims, ctx.device
        self.spec = traffic_spec(cfg, tr)
        self.tick_ms = cfg["tick_ms"]
        self.n = library_ticks(self.dims, tr)
        self.lib, self.spans = library.generate(self.dims, self.spec, self.n, ctx.seed)
        dev = self.dev
        meta, ctrl = meta_ctrl(self.dims, self.spec)
        state = P.init_state(P.PlaneDims(*self.dims), device=dev)
        self.state = state._replace(
            meta=P.TrackMeta(*[torch.from_numpy(x).to(dev) for x in meta]),
            ctrl=P.SubControl(*[torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(c.dtype)
                                for x, c in zip(ctrl, state.ctrl)]),
        )
        packed = [P.pack_tick_inputs(P.TickInputs(*t)) for t in self.lib]
        up = lambda k: torch.from_numpy(np.stack([p[k] for p in packed])).to(dev)  # noqa: E731
        self.pkt, self.fb, self.tf = up(0), up(1), up(2)
        self.pool_bytes = sum(x.numel() * x.element_size() for x in (self.pkt, self.fb, self.tf))
        self.f_sn, self.f_ts, self.f_arr = (P.PKT_FIELDS.index(f)
                                            for f in ("sn", "ts", "arrival_rtp"))
        span = lambda s: torch.from_numpy(s).to(dev)[:, :, None]  # noqa: E731
        self.span_sn, self.span_ts = span(self.spans.sn), span(self.spans.ts)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        self.tick_ms_t, self.rolls = i32(self.tick_ms), (i32(0), i32(1))
        self.tick_fn = ctx.tick_fn or P.media_plane_tick
        chk = tr["check"]
        self.rooms = core.rooms_sample(self.dims.rooms, chk["rooms"], ctx.seed)
        self.rooms_t = torch.from_numpy(self.rooms).to(dev)
        self.every, self.start = chk["every"], chk["start_ticks"]
        self.offset = core.check_offset(self.every, ctx.seed)
        self.full_at = self.start + self.offset % chk["full_within"]
        self.full_block = chk["full_block_rooms"]
        self.caps: dict = {}
        self.i = 0
        self.in_window = False
        self.span = lambda name: contextlib.nullcontext()  # noqa: E731
        self.pass_fwd: list = []
        self.win_fwd = torch.zeros((), dtype=torch.int64, device=dev)
        self.win_first = None
        for _ in range(tr["warmup_ticks"]):
            self.step()
        core.sync(dev)
        self.in_window = True

    def set_span(self, span) -> None:
        """Open `span(name)` around each tick's launches and its sync (the
        profiled stretch)."""
        self.span = span

    # -- the window ---------------------------------------------------------
    def _wants_capture(self, i: int) -> bool:
        return i < self.start or i % self.every == self.offset or i == self.full_at

    def _gather(self, tree, full: bool = False) -> list:
        if full:
            return [x.clone() for x in self.P.tree_leaves(tree)]
        return [x.index_select(0, self.rooms_t) for x in self.P.tree_leaves(tree)]

    def _advance_pool(self) -> None:
        """One pass on: SN, RTP time and arrival of every pooled slot."""
        pkt = self.pkt
        pkt[:, self.f_sn] = ((pkt[:, self.f_sn].long() + self.span_sn) & 0xFFFF).int()
        for f in (self.f_ts, self.f_arr):
            x = (pkt[:, f].long() + self.span_ts) & 0xFFFFFFFF
            pkt[:, f] = torch.where(x >= 1 << 31, x - (1 << 32), x).int()

    def step(self) -> float:
        P, i = self.P, self.i
        idx = i % self.n
        if idx == 0:
            if i > 0:
                self._advance_pool()
            self.pass_fwd.append(torch.zeros((), dtype=torch.int64, device=self.dev))
        if self.in_window and self.win_first is None:
            self.win_first = i
        cap, full = self._wants_capture(i), i == self.full_at
        before = self._gather(self.state, full) if cap else None
        t0 = time.perf_counter()
        with self.span("launch"):
            inp = P.unpack_tick_inputs(self.pkt[idx], self.fb[idx], self.tf[idx],
                                       self.tick_ms_t, self.rolls[roll_of(i, self.tick_ms)])
            self.state, out = self.tick_fn(self.state, inp)
            P.pack_tick_outputs(out)
            fwd = out.fwd_packets.sum(dtype=torch.int64)
            self.pass_fwd[-1] += fwd
            if self.in_window:
                self.win_fwd += fwd
        with self.span("sync"):
            core.sync(self.dev)
        dt = time.perf_counter() - t0
        if cap:
            self.caps[i] = (before, self._gather(out, full), self._gather(self.state, full))
        self.i += 1
        return dt

    def window_writes(self) -> int:
        self.win_last = self.i
        return int(self.win_fwd.item())

    def layer_totals(self) -> dict:
        return {}

    def report_lines(self) -> list[str]:
        passes = [int(x.item()) for x in self.pass_fwd]
        first = -(-self.win_first // self.n)
        full = [c for c in range(first, len(passes)) if (c + 1) * self.n <= self.win_last]
        lines = [f"pool: {self.n} ticks, {self.pool_bytes} bytes on the device; "
                 f"window ticks {self.win_first}..{self.win_last - 1}; "
                 f"full passes in the window: {len(full)}"]
        if full:
            a, b = full[0], full[-1]
            lines.append(f"writes per tick: first full pass ({a}) {passes[a] / self.n!r}, "
                         f"last full pass ({b}) {passes[b] / self.n!r}")
            lines.append("writes per tick of each pass from the first: "
                         + " ".join(str(x / self.n) for x in passes[:-1]))
        return lines

    def release(self) -> None:
        self.caps = {i: tuple([x.cpu() for x in part] for part in c)
                     for i, c in self.caps.items()}
        del self.state, self.pkt, self.fb, self.tf
        self.pass_fwd = [int(x.item()) for x in self.pass_fwd]
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the output check ---------------------------------------------------
    def ref_inputs(self, i: int, rooms, device="cpu") -> ref.TickInputs:
        inp = library.advance(self.lib[i % self.n], self.spans, i // self.n)
        rows = {f: np.asarray(x)[rooms] if np.ndim(x) else x
                for f, x in zip(ref.TickInputs._fields, inp)}
        rows["roll_quality"] = np.int32(roll_of(i, self.tick_ms))
        return ref_node.inputs_to_torch(ref.TickInputs(**rows), device)

    def _ref_tick(self, tally, i: int, state, rooms, out_p, after_p, s_names, o_names,
                  where: str):
        """The reference's tick i of `rooms` from `state` on the run's
        device, its outputs and new state held to the program's; returns
        (whether no integer word differed, the new state)."""
        state, out = ref.media_plane_tick(state, self.ref_inputs(i, rooms, self.dev))
        out = ref.TickOutputs(*[x.cpu() for x in out])
        ok = tally.leaves(out_p, list(out), o_names, where + "out", care=compare.care(out))
        ok &= tally.leaves(after_p, [x.cpu() for x in ref.tree_leaves(state)], s_names,
                           where + "state")
        return ok, state

    def _check_full(self, tally, i: int, s_names, o_names) -> bool:
        """Tick i at full width from the program's state before it, the
        reference over blocks of rooms."""
        before, out_p, after_p = self.caps[i]
        R, T, K, S = self.dims
        ok = True
        for lo in range(0, R, self.full_block):
            rows = np.arange(lo, min(R, lo + self.full_block))
            sl = slice(lo, lo + len(rows))
            template = ref.init_state(ref.PlaneDims(len(rows), T, K, S), device=self.dev)
            state = ref.tree_unflatten(template, [x[sl].to(self.dev) for x in before])
            good, _ = self._ref_tick(tally, i, state, rows, [x[sl] for x in out_p],
                                     [x[sl] for x in after_p], s_names, o_names,
                                     f"tick {i} rooms {lo}.. ")
            ok &= good
        return ok

    def check(self):
        """The reference on the run's device (on the card it computes each
        float as the program's plain ops do: on the CPU, a sum in another
        order can land a threshold decision on the other side)."""
        dev = self.dev
        tally = compare.Tally(self.ctx.cell.limits["float_err"])
        template = ref.tree_map(lambda x: x.to(dev), ref_state(self.dims, self.spec, self.rooms))
        s_names = ref.leaf_names(template)
        o_names = list(ref.TickOutputs._fields)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with plain_mode():
                state = template
                for i in sorted(self.caps):
                    if i == self.full_at:
                        tally.tick_done(self._check_full(tally, i, s_names, o_names))
                        tally.full.append(i)
                        continue
                    before, out_p, after_p = self.caps[i]
                    if i >= self.start:
                        state = ref.tree_unflatten(template, [x.to(dev) for x in before])
                    ok, state = self._ref_tick(tally, i, state, self.rooms, out_p, after_p,
                                               s_names, o_names, f"tick {i} ")
                    tally.tick_done(ok)
                if self.full_at not in self.caps:
                    tally.missing(f"tick {self.full_at} at full width (the window ended first)")
        finally:
            torch.set_num_threads(threads)
        self.tally = tally
        return tally.checks(self.ctx.cell.limits), tally.ticks, tally.bad_ticks
