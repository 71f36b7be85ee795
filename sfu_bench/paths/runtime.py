"""Path `runtime`: the served tick of one node, through the port's runtime.

Set-up builds `PlaneRuntime` as `serve` builds it by default (egress
shards one a core, RED and the trace ring on), publishes and subscribes
every track of the configuration as `paths/plane.py` does, sets every
subscriber's RTT, and generates a library of receive batches from the
seed (`sfu_bench/gen/runtime.py`). Each tick of the window is what a
node does with one tick of traffic: `IngestBuffer.push_batch` of the
tick's packets and a `push_feedback` estimate from each subscriber whose
turn it is, then `await step_once()` on one event loop kept for the run
(drain, reorder and dedup, pack, probe, the ctrl upload, the device tick
of models/plane.py, the native munge walk over the egress plane's room
shards, `EgressBatch` and the speaker, keyframe and congestion views).
The window's writes are the ticks' `TickResult.fwd_packets`, the unit of
`paths/plane.py`'s; every tick's egress rows are counted beside them and
the two sums must agree. At each wrap of the library, SN, RTP time,
arrival, picture id and TL0 of every pooled packet move on by one pass.

The output check follows the program from its own state, as
`paths/plane.py` does: the first `start_ticks` ticks are replayed in full
from the reference's own initial state (device state, munger lanes,
probe state); at ticks drawn from the seed, the sampled rooms' state
before the tick (device rows, munger lanes, probe state, the previous
tick's committed rates, congestion and deficits) is taken from the
program, and the reference stages the tick's packets
(`reference/staging.py`), schedules the probe (`reference/probe.py`),
runs the tick (`reference/tick.py`, on the run's device) and munges
(`reference/munge.py`); its outputs, device state, munger lanes and
probe state are held to the program's by `compare.Tally`, and its egress
rows (and probe padding) to the program's by `egress_rows`: rows whose
(room, track, slot, subscriber) key holds other values, or that one side
lacks, plus the gap between the run's forwarded writes and its egress
rows. One tick is compared at full width.

`munge_seam` plants a fault under the timed path: a function of the walk's
egress columns that returns them altered (`MUNGE_FAULTS`); None, the
benchmark's own runs, leaves the walk unwrapped.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import time

import numpy as np
import torch

from sfu_bench import compare, core
from sfu_bench.gen import runtime as gen
from sfu_bench.paths.plane import library_ticks, meta_ctrl, ref_state, roll_of, traffic_spec
from sfu_bench.reference import munge as ref_munge
from sfu_bench.reference import node as ref_node
from sfu_bench.reference import plain_mode
from sfu_bench.reference import probe as ref_probe
from sfu_bench.reference import staging as ref_staging
from sfu_bench.reference import tick as ref

PROBE_FIELDS = ref_probe.ProbeState._fields
PREV_FIELDS = ("committed_bps", "congested", "deficient")


def sn_plus_one(cols):
    """The munge fault: the tick's first egress row leaves with its SN
    one higher."""
    cols = list(cols)
    if len(cols[4]):
        cols[4] = cols[4].copy()
        cols[4][0] = (int(cols[4][0]) + 1) & 0xFFFF
    return tuple(cols)


MUNGE_FAULTS = {"sn_plus_one": sn_plus_one}
munge_seam = None


def device_step_with(tick_fn, state, wire, dims):
    """The runtime's device step with `tick_fn` in the port's tick's
    place (the control and the tick faults)."""
    from livekit_server_tpu_torch.models import plane as P

    buf = torch.from_numpy(wire).to(state.meta.is_video.device)
    state, out = tick_fn(state, P.unpack_tick_inputs(*P.unwire_inputs(buf, dims)))
    return state, P.fetch_outputs(out)


def rows_of(cols, rooms, keys) -> dict:
    """Egress rows of `rooms` (ascending) from (room, track, k, sub, sn,
    ts, pid, tl0, keyidx) columns, rooms renumbered by their place in
    `rooms`, ts as int32 two's complement."""
    cols = [np.asarray(c, np.int64) for c in cols]
    keep = np.isin(cols[0], rooms)
    out = {k: c[keep] for k, c in zip(keys, cols)}
    out["room"] = np.searchsorted(rooms, out["room"])
    out["ts"] = (out["ts"] & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    return out


def padding_rows(padding, rooms) -> dict:
    """A tick's probe padding (`TickResult.padding`) as rows of `rooms`,
    the j-th packet of a (room, subscriber)'s run in slot -j."""
    seen: dict = {}
    rows = []
    for p in padding:
        j = seen[p.room, p.sub] = seen.get((p.room, p.sub), 0) + 1
        rows.append((p.room, p.track, -j, p.sub, p.sn, p.ts, 0, 0, 0))
    return rows_of(np.asarray(rows, np.int64).reshape(-1, 9).T, rooms, ref_munge.ROW_FIELDS)


def row_mismatches(got: dict, want: dict) -> int:
    """Rows keyed by (room, track, k, sub): those whose values differ,
    plus those one side lacks or holds twice."""
    def keyed(rows):
        keys = zip(*(rows[f].tolist() for f in ("room", "track", "k", "sub")))
        vals = zip(*(rows[f].tolist() for f in ("sn", "ts", "pid", "tl0", "keyidx")))
        return dict(zip(keys, vals))

    g, w = keyed(got), keyed(want)
    bad = sum(1 for k in g.keys() & w.keys() if g[k] != w[k])
    twice = len(got["room"]) - len(g) + len(want["room"]) - len(w)
    return bad + len(g.keys() ^ w.keys()) + twice


def configure(rt, dims, spec, rtt_ms: int):
    """Publish and subscribe every track of the configuration on runtime
    `rt`, as `paths/plane.py` sets its state (the publisher of track t is
    participant t), and set every subscriber's RTT; returns the numpy
    (TrackMeta, SubControl)."""
    R, _, _, S = dims
    meta, ctrl = meta_ctrl(dims, spec)
    for r, t in zip(*np.nonzero(meta.published)):
        rt.set_track(int(r), int(t), published=True, is_video=bool(meta.is_video[r, t]),
                     is_svc=bool(meta.is_svc[r, t]), pub_sub=int(t) % S)
    for r, t, s in zip(*np.nonzero(ctrl.subscribed)):
        rt.set_subscription(int(r), int(t), int(s), subscribed=True)
    for r in range(R):
        for s in range(S):
            rt.ingest.set_rtt(r, s, rtt_ms)
    return meta, ctrl


def served_tick(inp, now_ms: int, probe, prev, pad_track, dev_leaves, munger, tick_ms: int,
                device, block: int):
    """The reference's served tick from the staged numpy inputs `inp`: the
    probe (from `probe` and the previous tick's `prev` outputs), the tick
    on `device` over blocks of `block` rooms from the state leaves
    `dev_leaves`, the munge walk and the padding from `munger` (lists in
    `FIELDS` order). Returns (outputs, state leaves, munger, probe state,
    egress rows, padding rows, the previous-tick outputs for the next)."""
    ps, pad_num = ref_probe.step(ref_probe.ProbeState(*probe), now_ms, *prev, inp.estimate,
                                 inp.estimate_valid, pad_track, tick_ms)
    inp = inp._replace(pad_num=pad_num, pad_track=pad_track)
    R = len(pad_track)
    outs, states = [], []
    for lo in range(0, R, block):
        sl = slice(lo, min(R, lo + block))
        template = ref.init_state(ref.PlaneDims(sl.stop - lo, *np.shape(inp.sn)[1:],
                                                np.shape(inp.estimate)[1]), device=device)
        st = ref.tree_unflatten(template, [x[sl].to(device) for x in dev_leaves])
        blk = inp._replace(**{f: np.asarray(getattr(inp, f))[sl] for f in ref.TickInputs._fields
                              if np.ndim(getattr(inp, f))})
        st, out = ref.media_plane_tick(st, ref_node.inputs_to_torch(blk, device))
        outs.append([x.cpu() for x in out])
        states.append([x.cpu() for x in ref.tree_leaves(st)])
    out = ref.TickOutputs(*[torch.cat(x) for x in zip(*outs)])
    m_state = dict(zip(ref_munge.FIELDS, munger))
    m_state, egress = ref_munge.munge_tick(m_state, inp, out.send_bits.numpy(),
                                           out.drop_bits.numpy(), out.switch_bits.numpy())
    m_state, pad = ref_munge.padding(m_state, pad_num, pad_track, tick_ms * 90)
    return (out, [torch.cat(x) for x in zip(*states)], [m_state[f] for f in ref_munge.FIELDS],
            list(ps), egress, pad, [np.asarray(getattr(out, f)) for f in PREV_FIELDS])


class Session:
    def __init__(self, ctx: core.Ctx):
        from livekit_server_tpu_torch.models import plane as P
        from livekit_server_tpu_torch.runtime.plane_runtime import PlaneRuntime

        self.P = P
        cfg, tr = ctx.cell.config, ctx.cell.traffic
        self.ctx, self.dims, self.dev = ctx, ctx.dims, ctx.device
        self.spec = traffic_spec(cfg, tr)
        self.tick_ms = cfg["tick_ms"]
        self.every = tr["report_every"]
        self.rtt_ms = tr["rtt_ms"]
        self.n = library_ticks(self.dims, tr)
        self.lib = gen.generate(self.dims, self.spec, self.n, ctx.seed)
        self.live = [dict(b) for b in self.lib.ticks]
        R = self.dims.rooms
        ph = gen.phase(self.dims, self.every)
        self.fb = [[(int(r), int(s)) for r, s in zip(*np.nonzero(ph == p))]
                   for p in range(self.every)]
        self.fb_flat = [np.flatnonzero(ph.reshape(-1) == p) for p in range(self.every)]
        rt = self.rt = PlaneRuntime(P.PlaneDims(*self.dims), tick_ms=self.tick_ms, device=self.dev)
        meta, ctrl = configure(rt, self.dims, self.spec, self.rtt_ms)
        self.pub_rtt = np.where(meta.published, np.float32(self.rtt_ms), np.float32(0.0))
        self.pad_track = ref_probe.pad_track(meta, ctrl)
        if ctx.tick_fn is not None:
            rt._step = functools.partial(device_step_with, ctx.tick_fn, dims=rt.dims)
        self.seam = munge_seam
        if self.seam is not None:
            walk = rt.munger.apply_columns
            rt.munger.apply_columns = lambda *a, **k: self.seam(walk(*a, **k))
        self.loop = asyncio.new_event_loop()
        chk = tr["check"]
        self.rooms = core.rooms_sample(R, chk["rooms"], ctx.seed)
        self.rooms_t = torch.from_numpy(self.rooms).to(self.dev)
        self.every_chk, self.start = chk["every"], chk["start_ticks"]
        self.offset = core.check_offset(self.every_chk, ctx.seed)
        self.full_at = self.start + self.offset % chk["full_within"]
        self.full_block = chk["full_block_rooms"]
        self.caps: dict = {}
        self.prev = None
        self.i = 0
        self.span = lambda name: contextlib.nullcontext()  # noqa: E731
        self.fwd = self.rows = self.win_fwd = self.win_rows = 0
        self.in_window = False
        self.win_first = None
        for _ in range(tr["warmup_ticks"]):
            self.step()
        core.sync(self.dev)
        self.in_window = True

    def set_span(self, span) -> None:
        """Open `span(name)` around each tick's pushes and its step (the
        profiled stretch)."""
        self.span = span

    # -- the window ---------------------------------------------------------
    def _wants_capture(self, i: int) -> bool:
        return i < self.start or i % self.every_chk == self.offset or i == self.full_at

    def _advance_pool(self) -> None:
        """One pass on: the live columns of every pooled tick."""
        self.live = [gen.advance(b, self.lib.spans, 1) for b in self.live]

    def _rows(self, i: int) -> np.ndarray:
        return np.arange(self.dims.rooms) if i == self.full_at else self.rooms

    def _host_state(self, rows) -> tuple:
        """The sampled rooms' munger lanes and probe state."""
        m, pr = self.rt.munger, self.rt.prober
        return ([getattr(m, f)[rows].copy() for f in ref_munge.FIELDS],
                [np.asarray(getattr(pr, f))[rows].copy() for f in PROBE_FIELDS])

    def _device_rows(self, i: int) -> list:
        if i == self.full_at:
            return [x.clone() for x in self.P.tree_leaves(self.rt.state)]
        return [x.index_select(0, self.rooms_t) for x in self.P.tree_leaves(self.rt.state)]

    def step(self) -> float:
        rt, i = self.rt, self.i
        idx = i % self.n
        if idx == 0 and i > 0:
            self._advance_pool()
        if self.in_window and self.win_first is None:
            self.win_first = i
        cap = self._wants_capture(i)
        rows = self._rows(i)
        # The state before: for ticks after the replayed start only.
        before = ((self._device_rows(i), *self._host_state(rows), self.prev)
                  if cap and i >= self.start else None)
        vals = self.lib.estimate[idx].reshape(-1)[self.fb_flat[i % self.every]].tolist()
        t0 = time.perf_counter()
        with self.span("push"):
            rt.ingest.push_batch(**self.live[idx], blob=self.lib.blob, t_rx=t0)
            for (r, s), v in zip(self.fb[i % self.every], vals):
                rt.ingest.push_feedback(r, s, estimate=v)
        with self.span("step"):
            res = self.loop.run_until_complete(rt.step_once())
        dt = time.perf_counter() - t0
        n_rows = len(res.egress_batch)
        self.fwd += res.fwd_packets
        self.rows += n_rows
        if self.in_window:
            self.win_fwd += res.fwd_packets
            self.win_rows += n_rows
        if cap:
            out = [np.asarray(x)[rows] for x in res.outputs]
            b = res.egress_batch
            egress = rows_of((b.rooms, b.tracks, b.ks, b.subs, b.sn, b.ts, b.pid, b.tl0,
                              b.keyidx), rows, ref_munge.ROW_FIELDS)
            pad = padding_rows(res.padding, rows)
            self.caps[i] = (before, out, self._device_rows(i), *self._host_state(rows),
                            egress, pad)
        if self._wants_capture(i + 1):
            nxt = self._rows(i + 1)
            self.prev = [np.asarray(getattr(res.outputs, f))[nxt] for f in PREV_FIELDS]
        self.i += 1
        return dt

    def window_writes(self) -> int:
        self.win_last = self.i
        return int(self.win_fwd)

    def layer_totals(self) -> dict:
        """The runtime's stage counters that exist (the readers give None
        for a counter the program lacks)."""
        st = self.rt.stats
        keys = ("push_s", "pushed_packets", "stage_s", "probe_s", "ctrl_upload_s", "device_s",
                "munge_s", "fanout_s", "egress_rows")
        return {k: float(st[k]) for k in keys if k in st}

    def report_lines(self) -> list[str]:
        st = self.rt.stats
        ticks = max(1, st["ticks"])
        per = " ".join(f"{k} {1e3 * st[k] / ticks!r}" for k in
                       ("push_s", "stage_s", "probe_s", "ctrl_upload_s", "device_s", "munge_s",
                        "fanout_s") if k in st)
        return [f"library: {self.n} ticks of {sum(len(b['room']) for b in self.lib.ticks)} "
                f"packets, blob {self.lib.blob.nbytes} bytes; window ticks {self.win_first}.."
                f"{self.win_last - 1}",
                f"writes in the window {self.win_fwd}, egress rows {self.win_rows}; "
                f"over the run {self.fwd} and {self.rows}",
                f"ms a tick over the run's {st['ticks']} ticks: {per}"]

    def release(self) -> None:
        for i, (before, out, after, *host) in list(self.caps.items()):
            if before is not None:
                before = ([x.cpu() for x in before[0]], *before[1:])
            self.caps[i] = (before, out, [x.cpu() for x in after], *host)
        self.loop.run_until_complete(self.rt.stop())
        self.loop.close()
        self.rt._executor.shutdown(wait=True)
        del self.rt, self.rooms_t
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the output check ---------------------------------------------------
    def ref_inputs(self, i: int, rows) -> ref.TickInputs:
        """The reference's staging of tick i for rooms `rows` (numpy)."""
        cols = gen.tick_columns(self.lib, i)
        keep = np.isin(cols["room"], rows)
        sub = {f: np.asarray(v)[keep] for f, v in cols.items()}
        sub["room"] = np.searchsorted(rows, sub["room"])
        est, valid = gen.reports(self.lib, self.dims, i, self.every)
        dims = ref.PlaneDims(len(rows), *self.dims[1:])
        return ref_staging.stage_tick(dims, sub, est[rows], valid[rows], self.pub_rtt[rows],
                                      self.tick_ms, bool(roll_of(i, self.tick_ms)))

    def _ref_tick(self, tally, i, rows, dev_state, munger, probe, prev, cap, where):
        """The reference's tick i of `rows` from the given state, held to
        the program's capture; returns (no integer word or row differed,
        the reference's state leaves, munger, probe state and previous-tick
        outputs after it)."""
        _, out_p, after_p, munger_p, probe_p, egress_p, pad_p = cap
        out, state, munger, probe, egress, pad, prev = served_tick(
            self.ref_inputs(i, rows), i * self.tick_ms, probe, prev, self.pad_track[rows],
            dev_state, munger, self.tick_ms, self.dev, self.full_block)
        ok = tally.leaves(out_p, list(out), list(ref.TickOutputs._fields), where + "out",
                          care=compare.care(out))
        ok &= tally.leaves(after_p, state, self.s_names, where + "state")
        ok &= tally.leaves(munger_p, munger, list(ref_munge.FIELDS), where + "munger")
        ok &= tally.leaves(probe_p, probe, list(PROBE_FIELDS), where + "probe")
        bad = row_mismatches(egress_p, egress) + row_mismatches(pad_p, pad)
        self.egress_bad += bad
        if bad:
            tally.first_int = tally.first_int or f"{where}egress rows: {bad}"
        return ok and not bad, state, munger, probe, prev

    def check(self):
        """The reference on the run's device for the tick (as `paths/plane.py`
        runs it), numpy for staging, probe and munge."""
        tally = compare.Tally(self.ctx.cell.limits["float_err"])
        self.egress_bad = abs(self.fwd - self.rows)
        own = ref_state(self.dims, self.spec, self.rooms)
        self.s_names = ref.leaf_names(own)
        _, T, _, S = self.dims
        n = len(self.rooms)
        state = [x.cpu() for x in ref.tree_leaves(own)]
        munger = list(ref_munge.init(n, T, S).values())
        probe = list(ref_probe.init(n, S))
        prev = [np.zeros((n, S), np.float32), np.zeros((n, S), bool), np.zeros((n, S), bool)]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            with plain_mode():
                for i in sorted(self.caps):
                    cap = self.caps[i]
                    if i == self.full_at or i >= self.start:
                        before = cap[0]
                        state, munger, probe, prev = before[0], before[1], before[2], before[3]
                    rows = self._rows(i)
                    ok, state, munger, probe, prev = self._ref_tick(
                        tally, i, rows, state, munger, probe, prev, cap, f"tick {i} ")
                    tally.tick_done(ok)
                    if i == self.full_at:
                        tally.full.append(i)
                if self.full_at not in self.caps:
                    tally.missing(f"tick {self.full_at} at full width (the window ended first)")
        finally:
            torch.set_num_threads(threads)
        self.tally = tally
        checks = tally.checks(self.ctx.cell.limits)
        checks.append(core.Check("egress_rows", self.egress_bad,
                                 self.ctx.cell.limits["egress_rows"]))
        return checks, tally.ticks, tally.bad_ticks
