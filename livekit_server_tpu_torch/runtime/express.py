"""Express lane: on-arrival forwarding for small interactive rooms.

The batched tick (plane_runtime._run) gives every room worst-case
batching delay — a packet arriving right after a drain waits a full
window before the device even sees it, then one more pipeline depth
before its bytes leave. For a 2-party call that delay buys nothing: the
forwarding decision for a handful of subscribers is a dozen integer ops.

The express lane runs exactly those ops on the host, per receive batch,
against a MIRROR of the device selector state:

  - Eligibility (`retier`, once per tick boundary): rooms whose
    subscriber count is within `plane.express_max_subs` (or pinned via
    the API), with no SVC tracks published, not frozen for migration,
    and not under chaos injection. The effective control tensors
    (governor shed overlay + integrity quarantine applied) drive both
    eligibility and the forwarding base, so the overload and integrity
    seams bind the express tier exactly as they bind the batched tier.
  - Decision (`on_arrivals`, on the rx path): the simulcast selection
    scan from ops/selector.py — bit for bit the same algebra the device
    kernel runs — applied to the arriving packets with the mirrored
    current/target layers. The mirror is refreshed from the committed
    device state every tick, so decisions are bounded ≤1 tick stale and
    bit-equivalent to what the device would decide for the same mirror.
  - Rewrite: HostMunger.apply_arrivals advances the SAME per-(room,
    track, sub) SN/TS/VP8 lanes the batched fan-out uses — the two
    tiers share one sequencing space, so promotion and demotion never
    break a subscriber's RTP continuity.
  - Send: the caller-provided `sender` (udp.RtpUdpServer._send_express)
    seals and ships the columns through native egress_express_send.

Rooms the lane handled during a window are masked out of that tick's
batched fan-out (sub-granular: only the lane's UDP fast-path subscriber
bits are cleared; WS/TCP/RED subscribers of the same room keep riding
the batched tier). The device still sees every packet — BWE, audio
levels, quality scoring, speaker detection, and the selector shadow all
stay authoritative on the device; the lane moves only WHERE the
forwarding decision/rewrite/send happens.

Tier handover ordering: demotion is exact (the batched tier resumes
with strictly newer packets). Promotion takes over the closing window
synchronously at the tick boundary (`takeover`), so in low-latency mode
— where each tick's fan-out completes inside its own window — the
munger lanes advance in strict arrival order across the switch. In
pipelined mode one prior window's deferred fan-out can interleave a
promotion; the worst case is a transient one-SN gap on the promoted
room's lanes (perceived loss, recovered by NACK), never corruption.

A copy of the JAX package's runtime/express.py: host code over numpy.
The mirror it decides against is the port's post-commit selector read
(PlaneRuntime._device_step, under the commit lock), and the device still
runs every packet through B1 and B2 in the batched tick.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ExpressColumns:
    """One receive batch's express sends, column-major (the same shape
    udp.send_egress_batch consumes, plus the payload locators into the
    LIVE ingest staging slab — express sends happen before the drain
    copies it)."""

    rooms: np.ndarray   # int32 [N]
    tracks: np.ndarray  # int32 [N]
    ks: np.ndarray      # int32 [N] staging slot (this window)
    subs: np.ndarray    # int32 [N]
    sn: np.ndarray      # int32 [N] munged
    ts: np.ndarray      # int32 [N] munged (uint32 bit pattern)
    pid: np.ndarray     # int32 [N] munged VP8 picture id
    tl0: np.ndarray     # int32 [N]
    keyidx: np.ndarray  # int32 [N]
    orig_sn: np.ndarray  # int32 [N] wire SN at ingest (replay-log guard)
    pay_off: np.ndarray  # int64 [N] into `slab`
    pay_len: np.ndarray  # int32 [N]
    marker: np.ndarray   # uint8 [N]
    t_arr: np.ndarray    # float64 [N] ingress perf_counter stamp
    slab: bytearray      # the ingest staging slab (borrowed, send-time only)

    def __len__(self) -> int:
        return len(self.rooms)


class ExpressLog:
    """The window's express sends, merged for the replay ring
    (HostSequencer.record duck-types on these fields). `orig_sn` lets
    the fan-out drop entries whose staging slot was permuted by the
    drain's reorder pass before they are recorded — a filtered entry is
    a replay miss (client re-NACKs), never a wrong payload."""

    __slots__ = ("rooms", "tracks", "ks", "subs", "sn", "ts", "pid",
                 "tl0", "keyidx", "orig_sn")

    def __init__(self, rooms, tracks, ks, subs, sn, ts, pid, tl0,
                 keyidx, orig_sn):
        self.rooms, self.tracks, self.ks, self.subs = rooms, tracks, ks, subs
        self.sn, self.ts, self.pid, self.tl0 = sn, ts, pid, tl0
        self.keyidx, self.orig_sn = keyidx, orig_sn

    def __len__(self) -> int:
        return len(self.rooms)

    def take(self, mask: np.ndarray) -> "ExpressLog":
        return ExpressLog(*(getattr(self, f)[mask] for f in self.__slots__))

    @classmethod
    def merge(cls, batches: list) -> "ExpressLog | None":
        if not batches:
            return None
        return cls(
            *(np.concatenate([np.asarray(getattr(b, f)) for b in batches])
              for f in cls.__slots__)
        )


class ExpressLane:
    """Host-side on-arrival forwarding tier (see module docstring)."""

    def __init__(self, runtime, max_subs: int, max_rooms: int = 16):
        self.rt = runtime
        dims = runtime.dims
        R, T, _, S = dims
        self.max_subs = int(max_subs)
        self.max_rooms = int(max_rooms)
        # Pin API: 0 = auto (eligibility), 1 = force express, -1 = force
        # batched. Forced-express rooms still must pass the hard gates
        # (SVC, freeze, chaos).
        self.pin = np.zeros(R, np.int8)
        self.desired = np.zeros(R, bool)    # eligible, pre-mirror gate
        self.active = np.zeros(R, bool)     # handled THIS window
        self.mirror_ok = np.zeros(R, bool)  # a fresh mirror has landed
        self.express_subs = np.zeros((R, S), bool)  # UDP fast-path subs
        self.base = np.zeros((R, T, S), bool)       # forwarding base
        self.words = np.zeros((R, (S + 31) // 32), np.int32)
        # Mirrored selector state (device sel, ≤1 tick stale). The lane's
        # own scan advances `cur_*` between mirrors; targets re-sync from
        # the device every tick, currents only on (re)promotion — an
        # active room's own scan IS the exact continuation.
        self.cur_sp = np.full((R, T, S), -1, np.int32)
        self.cur_tp = np.zeros((R, T, S), np.int32)
        self.tgt_sp = np.full((R, T, S), -1, np.int32)
        self.tgt_tp = np.zeros((R, T, S), np.int32)
        self._pending_mirror: tuple | None = None  # posted by device thread
        # Wired by udp.attach_express; None in runtime-only tests (all
        # subs treated as fast-path, sends collected via the log).
        self.sub_provider = None
        self.sender = None
        self._active_any = False
        self._log: list[ExpressColumns] = []
        self.stats = {
            "express_pkts": 0, "express_entries": 0, "express_dgrams": 0,
            "promotes": 0, "demotes": 0, "takeover_pkts": 0,
            "replay_drops": 0,
        }
        # Arrival hook on the ingest itself (not the UDP transport): the
        # fan-out masks active rooms' rows wholesale, so EVERY staging
        # path — UDP batch, TCP/gateway per-packet, bridge replays — must
        # hand its arrivals over or their media would silently vanish.
        runtime.ingest.on_put = self._on_put

    def _on_put(self, r_, t_, k_) -> None:
        if self._active_any:
            self.on_arrivals(np.asarray(r_), np.asarray(t_), np.asarray(k_),
                             self.rt.ingest)

    # -- control API ------------------------------------------------------
    def set_pin(self, room: int, pin: bool | None) -> None:
        """Pin one room to a tier: True = express, False = batched,
        None = automatic (subscriber-count eligibility)."""
        self.pin[room] = 0 if pin is None else (1 if pin else -1)

    def wants_mirror(self) -> bool:
        return bool(self._active_any or self.desired.any())

    def post_mirror(self, cur_sp, cur_tp, tgt_sp, tgt_tp) -> None:
        """Called from the device worker thread right after a step's
        state commit: one atomic tuple swap, consumed at the next
        retier on the event loop."""
        self._pending_mirror = (cur_sp, cur_tp, tgt_sp, tgt_tp)

    # -- tick boundary ----------------------------------------------------
    def tick_boundary(self, ingest):
        """Runs in _stage_host immediately before the drain (one atomic
        event-loop slice with it): close the ending window, re-tier, and
        take over the closing window's packets for freshly promoted
        rooms. Returns (rows, words, log) for the StagedTick — the rooms
        whose fast-path subscriber bits the batched fan-out must skip,
        and the send log for the replay ring."""
        rows, words, log_batches = self._close_window()
        newly = self._retier()
        if len(newly):
            mark = len(self._log)
            self._takeover(newly, ingest)
            log_batches.extend(self._log[mark:])
            del self._log[mark:]
            rows = np.concatenate([rows, newly.astype(np.int32)])
            words = np.vstack([words, self.words[newly]])
        return rows, words, ExpressLog.merge(log_batches)

    def _close_window(self):
        rows = np.nonzero(self.active)[0].astype(np.int32)
        words = self.words[rows].copy()
        log, self._log = self._log, []
        return rows, words, log

    def _retier(self) -> np.ndarray:
        """Recompute the express set from the effective control tensors
        (governor shed + quarantine applied — the seams bind here) and
        the freshest device mirror. Returns newly promoted room ids."""
        rt = self.rt
        mirror = self._pending_mirror
        if mirror is not None:
            self._pending_mirror = None
            m_csp, m_ctp, m_tsp, m_ttp = mirror
            # Targets: always refresh (≤1-tick staleness bound).
            self.tgt_sp[...] = m_tsp
            self.tgt_tp[...] = m_ttp
            # Currents: only rooms NOT actively scanning — the lane's own
            # scan is the exact continuation for active ones.
            inactive = ~self.active
            self.cur_sp[inactive] = m_csp[inactive]
            self.cur_tp[inactive] = m_ctp[inactive]
            self.mirror_ok[:] = True
        eff = rt._effective_ctrl()
        meta = rt.meta
        subs_count = eff.subscribed.any(axis=1).sum(axis=1)
        has_svc = (meta.is_svc & meta.published).any(axis=1)
        eligible = (
            ((subs_count > 0) & (subs_count <= self.max_subs))
            | ((self.pin > 0) & (subs_count > 0))
        ) & ~has_svc & (self.pin >= 0)
        if rt.fault is not None:
            # Chaos injection routes packets through the scalar push path
            # (no batch staging stash) — express stands down entirely.
            eligible[:] = False
        if rt.ingest.frozen_rows:
            # A frozen row is mid-migration: its lanes must stay byte-
            # for-byte at the snapshot. Arrivals are already filtered at
            # push_batch; demote so nothing re-activates under the bridge.
            eligible[list(rt.ingest.frozen_rows)] = False
        idx = np.nonzero(eligible)[0]
        if len(idx) > self.max_rooms:
            # Capacity cap: keep currently active rooms (no churn), then
            # lowest room ids.
            keep = idx[np.argsort(~self.active[idx], kind="stable")]
            eligible = np.zeros_like(eligible)
            eligible[keep[: self.max_rooms]] = True
        self.desired = eligible
        new_active = eligible & self.mirror_ok
        newly = new_active & ~self.active
        dropped = self.active & ~new_active
        # Re-promotion after a demotion waits for a FRESH mirror (posted
        # after at least one more device step) so currents re-seed.
        self.mirror_ok[dropped] = False
        n_pro = int(newly.sum())
        n_dem = int(dropped.sum())
        self.stats["promotes"] += n_pro
        self.stats["demotes"] += n_dem
        if n_pro or n_dem:
            # Tier transitions are rare (churn events) — black-box them
            # per room. The no-transition tick stays allocation-free.
            bb = getattr(rt, "blackbox", None)
            if bb is not None:
                from livekit_server_tpu_torch.runtime.trace import EV_DEMOTE, EV_PROMOTE

                for r in np.nonzero(newly)[0]:
                    bb.emit(int(r), EV_PROMOTE)
                for r in np.nonzero(dropped)[0]:
                    bb.emit(int(r), EV_DEMOTE)
        self.active = new_active
        self._active_any = bool(new_active.any())
        sub_ok = eff.subscribed.any(axis=1)  # [R, S]
        if self.sub_provider is not None:
            sub_ok = sub_ok & self.sub_provider()
        es = sub_ok & self.active[:, None]
        self.express_subs = es
        # Pack to the device mask convention (ops/bits.pack_bits: bit
        # s%32 of word s//32) so `& ~words` at fan-out clears exactly
        # these subscribers' bits.
        W = self.words.shape[1]
        S = es.shape[1]
        padded = np.zeros((es.shape[0], W * 32), bool)
        padded[:, :S] = es
        self.words = (
            padded.reshape(es.shape[0], W, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)
        ).sum(axis=2, dtype=np.uint32).view(np.int32)
        self.base = (
            eff.subscribed & ~eff.sub_muted
            & (meta.published & ~meta.pub_muted)[:, :, None]
            & es[:, None, :]
        )
        return np.nonzero(newly)[0]

    def _takeover(self, rooms: np.ndarray, ingest) -> None:
        """Process a freshly promoted room's already-staged window
        packets synchronously at the boundary, so the munger lanes
        advance in arrival order across the tier switch and the closing
        tick's batched fan-out can skip the room entirely."""
        valid = np.asarray(ingest.valid[rooms], bool)
        ri, ti, ki = np.nonzero(valid)
        if not len(ri):
            return
        n0 = self.stats["express_pkts"]
        self.on_arrivals(rooms[ri], ti, ki, ingest)
        self.stats["takeover_pkts"] += self.stats["express_pkts"] - n0

    # -- the hot path -----------------------------------------------------
    def on_arrivals(self, r_, t_, k_, ingest):
        """Decide + munge (+ send) one receive batch's packets for active
        rooms. (r_, t_, k_) are the staging coordinates push_batch just
        wrote. Returns the ExpressColumns handled, or None."""
        if not self._active_any:
            return None
        r_ = np.asarray(r_)
        m = self.active[r_]
        integ = self.rt.integrity
        if integ is not None and integ.quarantined:
            # Live quarantine check (the audit lands on the worker thread
            # mid-window; the ctrl mute only binds at the next retier).
            q = np.zeros(len(self.active), bool)
            q[[r for r in integ.quarantined if r < len(q)]] = True
            m = m & ~q[r_]
        if not m.any():
            return None
        r_ = r_[m]
        t_ = np.asarray(t_)[m]
        k_ = np.asarray(k_)[m]
        R, T, K, S = self.rt.dims
        flat = r_.astype(np.int64) * T + t_
        uniq, inv = np.unique(flat, return_inverse=True)
        G = len(uniq)
        gr = (uniq // T).astype(np.int64)
        gt = (uniq % T).astype(np.int64)
        # Arrival-order rank of each packet within its (room, track)
        # group → a dense [G, Kb] layout (Kb = largest group).
        order = np.argsort(inv, kind="stable")
        cnt = np.bincount(inv, minlength=G)
        Kb = int(cnt.max())
        starts = np.zeros(G, np.int64)
        np.cumsum(cnt[:-1], out=starts[1:])
        rank = np.arange(len(flat)) - starts[inv[order]]
        idx2d = np.zeros((G, Kb), np.int64)
        pvalid = np.zeros((G, Kb), bool)
        idx2d[inv[order], rank] = order
        pvalid[inv[order], rank] = True

        fi = flat * K + k_  # flat index into the [R, T, K] staging arrays

        def g2(arr, dtype=None):
            v = np.asarray(arr).reshape(-1)[fi][idx2d]
            return v if dtype is None else v.astype(dtype)

        sp = g2(ingest.layer, np.int32)
        tp = g2(ingest.temporal, np.int32)
        kf = g2(ingest.keyframe, bool)
        sync = g2(ingest.layer_sync, bool)
        bp = g2(ingest.begin_pic, bool)
        sn = g2(ingest.sn, np.int64)
        ts = g2(ingest.ts, np.int64)
        jump = g2(ingest.ts_jump, np.int64)
        pid = g2(ingest.pid, np.int64)
        tl0 = g2(ingest.tl0, np.int64)
        ki = g2(ingest.keyidx, np.int64)
        pvalid &= g2(ingest.valid, bool)
        self.stats["express_pkts"] += int(pvalid.sum())

        # Gathered per-lane working state ([G, S]); scattered back below.
        sim_sp = self.cur_sp[gr, gt].copy()
        sim_tp = self.cur_tp[gr, gt].copy()
        tgt_sp = self.tgt_sp[gr, gt]
        tgt_tp = self.tgt_tp[gr, gt]
        base_g = self.base[gr, gt]
        is_vid = self.rt.meta.is_video[gr, gt][:, None]
        paused = tgt_sp < 0

        fwd = np.zeros((G, Kb, S), bool)
        drp = np.zeros((G, Kb, S), bool)
        sw_out = np.zeros((G, Kb, S), bool)
        for k in range(Kb):
            valk = pvalid[:, k][:, None]
            sp_k = sp[:, k][:, None]
            tp_k = tp[:, k][:, None]
            kf_k = kf[:, k][:, None]
            sy_k = sync[:, k][:, None]
            # ops/selector.py simulcast scan, verbatim on [G, S] lanes.
            want = (tgt_sp != sim_sp) & (tgt_sp >= 0)
            sw = valk & kf_k & want & (sp_k == tgt_sp)
            c_sp = np.where(sw, tgt_sp, sim_sp)
            c_tp = np.where(sw, tgt_tp, sim_tp)
            on_cur = valk & (sp_k == c_sp) & (c_sp >= 0)
            can_up = on_cur & sy_k & (tp_k <= tgt_tp)
            c_tp = np.where(can_up & (tp_k > c_tp), tp_k, c_tp)
            c_tp = np.where(on_cur & (tgt_tp < c_tp), tgt_tp, c_tp)
            fwd_sim = on_cur & (tp_k <= c_tp) & ~paused
            drp_sim = (on_cur & ~(tp_k <= c_tp)) | (on_cur & paused)
            sim_sp = np.where(paused, -1, c_sp)
            sim_tp = c_tp
            fwd[:, k, :] = np.where(is_vid, fwd_sim, valk) & base_g
            drp[:, k, :] = np.where(is_vid, drp_sim, False) & base_g
            sw_out[:, k, :] = np.where(is_vid, sw, False) & base_g
        # Selector state advances PRE-base-merge, exactly like the kernel
        # (base only ANDs the output masks).
        self.cur_sp[gr, gt] = sim_sp
        self.cur_tp[gr, gt] = sim_tp

        o_sn, o_ts, o_pid, o_tl0, o_ki = self.rt.munger.apply_arrivals(
            gr, gt, sn, ts, jump, pid, tl0, ki, bp, pvalid, fwd, drp, sw_out,
        )
        gg, jj, ss = np.nonzero(fwd & pvalid[:, :, None])
        if not len(gg):
            return None
        ej = idx2d[gg, jj]
        cols = ExpressColumns(
            rooms=gr[gg].astype(np.int32),
            tracks=gt[gg].astype(np.int32),
            ks=k_[ej].astype(np.int32),
            subs=ss.astype(np.int32),
            sn=o_sn[gg, jj, ss].astype(np.int32),
            ts=(o_ts[gg, jj, ss] & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
            pid=o_pid[gg, jj, ss].astype(np.int32),
            tl0=o_tl0[gg, jj, ss].astype(np.int32),
            keyidx=o_ki[gg, jj, ss].astype(np.int32),
            orig_sn=(sn[gg, jj] & 0xFFFF).astype(np.int32),
            pay_off=g2(ingest.pay_off, np.int64)[gg, jj],
            pay_len=g2(ingest.pay_len, np.int32)[gg, jj],
            marker=g2(ingest.marker, np.uint8)[gg, jj],
            t_arr=g2(ingest.t_arr, np.float64)[gg, jj],
            slab=ingest._slab,
        )
        self._log.append(cols)
        self.stats["express_entries"] += len(cols)
        if self.sender is not None:
            self.stats["express_dgrams"] += int(self.sender(cols))
        return cols

    # -- migration / lifecycle --------------------------------------------
    def clear_room(self, room: int) -> None:
        """Room teardown / migration restore: tier state must not leak
        into the next tenant (or past a migration snapshot — the
        destination re-mirrors from its own device)."""
        self.pin[room] = 0
        self.desired[room] = False
        self.active[room] = False
        self.mirror_ok[room] = False
        self.express_subs[room] = False
        self.base[room] = False
        self.words[room] = 0
        self.cur_sp[room] = -1
        self.cur_tp[room] = 0
        self.tgt_sp[room] = -1
        self.tgt_tp[room] = 0
        self._active_any = bool(self.active.any())

    def debug(self) -> dict:
        return {
            "max_subs": self.max_subs,
            "max_rooms": self.max_rooms,
            "active_rooms": np.nonzero(self.active)[0].tolist(),
            "desired_rooms": np.nonzero(self.desired)[0].tolist(),
            **{k: int(v) for k, v in self.stats.items()},
        }
