"""Stress of the native egress pool across calls whose shard count changes.

`egress_plane_send` runs a call's shards on one persistent worker pool
per process. A call must see only its own shards: in build-only mode
(fd < 0, no socket; a shard's `sent` is then 0) every call's `sent`
equals its entries and each shard's `built` equals the entries of its
range (with a socket, the UDP transport holds each shard's `sent` to its
`built`: runtime/udp.py, chip_smoke.py's UDP phases). A worker of
one call that claims a shard of the next one breaks both, and when the
two calls' shard counts differ it can leave the caller waiting forever;
so each sequence runs under a watchdog.

    python -m livekit_server_tpu_torch.native.poolcheck [--calls N]

runs the shard-count sequences 2; 3; 3,2; 2,3 and exits 1 on a short
call or a shard mismatch, 2 when a sequence outlasts its watchdog (the
process exits from the watchdog thread, since the stuck call cannot be
interrupted).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

SEQUENCES = ((2,), (3,), (3, 2), (2, 3))


def batch(n_rooms: int = 5, subs: int = 4, tracks: int = 2, pkts: int = 4,
          payload_len: int = 48):
    """A destination-major synthetic batch (room, sub, track, packet) in
    the argument shape of NativeEgress.send_sharded, unsealed."""
    rng = np.random.default_rng(5)
    n = n_rooms * subs * tracks * pkts
    rr = np.repeat(np.arange(n_rooms, dtype=np.int32), subs * tracks * pkts)
    ss = np.tile(np.repeat(np.arange(subs, dtype=np.int32), tracks * pkts), n_rooms)
    tt = np.tile(np.repeat(np.arange(tracks, dtype=np.int32), pkts), n_rooms * subs)
    kk = np.tile(np.arange(pkts, dtype=np.int32), n_rooms * subs * tracks)
    n_sess = n_rooms * subs
    return dict(
        slab=rng.integers(0, 256, pkts * payload_len, np.uint8),
        pay_off=kk.astype(np.int64) * payload_len,
        pay_len=np.full(n, payload_len, np.int32),
        marker=(kk == pkts - 1).astype(np.uint8),
        pt=np.full(n, 96, np.uint8), vp8=np.zeros(n, np.uint8),
        sn=((rr.astype(np.int64) * 131 + tt * 17 + kk) & 0xFFFF).astype(np.uint16),
        ts=kk.astype(np.uint32) * 3000 + rr.astype(np.uint32),
        ssrc=(rr.astype(np.uint32) << 16) | (ss.astype(np.uint32) << 4) | tt.astype(np.uint32),
        pid=np.full(n, 77, np.int32), tl0=np.full(n, 3, np.int32),
        kidx=np.full(n, 1, np.int32), ip=np.full(n, 0x7F000001, np.uint32),
        port=np.full(n, 50555, np.uint16), seal=np.zeros(n, np.uint8),
        key_idx=(rr * subs + ss).astype(np.int32),
        keys=rng.integers(0, 256, (n_sess, 16), np.uint8),
        key_ids=np.arange(100, 100 + n_sess, dtype=np.uint32),
        counters=np.arange(n, dtype=np.uint64) % np.uint64(pkts * tracks),
        rooms=rr,
    )


def run_sequence(seq: tuple[int, ...], calls: int, watchdog_s: float | None = None) -> dict:
    """`calls` build-only sends, cycling through the shard counts of
    `seq`. Returns {"sequence", "calls", "short_calls", "shard_mismatches",
    "seconds"}. With `watchdog_s`, a thread ends the process (exit 2) if
    the sequence has not finished by then."""
    from livekit_server_tpu_torch import native
    from livekit_server_tpu_torch.runtime.egress_plane import EgressPlane

    eg = native.egress
    if eg is None:
        raise RuntimeError("native egress library unavailable")
    args = batch()
    n = len(args["pay_off"])
    plans = {s: EgressPlane(shards=s, multicast_seal=False).entry_plan(args["rooms"])
             for s in set(seq)}
    grp = np.full(n, -1, np.int32)
    done = threading.Event()
    if watchdog_s is not None:
        def watchdog() -> None:
            if not done.wait(watchdog_s):
                sys.stderr.write(f"poolcheck: shard sequence {list(seq)} still running "
                                 f"after {watchdog_s} s: a call hung in the pool\n")
                sys.stderr.flush()
                os._exit(2)
        threading.Thread(target=watchdog, daemon=True).start()
    short = mismatch = 0
    t0 = time.perf_counter()
    try:
        for i in range(calls):
            lo, hi = plans[seq[i % len(seq)]]
            *_, sent, s_sent, s_built, _ns = eg.send_sharded(
                fd=-1, shard_lo=lo, shard_hi=hi, grp=grp, grp_slots=0, **args)
            short += sent != n
            mismatch += not np.array_equal(s_built, hi - lo)
    finally:
        done.set()
    return {"sequence": list(seq), "calls": calls, "short_calls": int(short),
            "shard_mismatches": int(mismatch),
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--calls", type=int, default=3000, help="calls per sequence")
    ap.add_argument("--watchdog-s", type=float, default=60.0,
                    help="seconds a sequence may take before the run fails")
    args = ap.parse_args(argv)
    reports = [run_sequence(seq, args.calls, args.watchdog_s) for seq in SEQUENCES]
    print(json.dumps({"pool_stress": reports}))
    bad = any(r["short_calls"] or r["shard_mismatches"] for r in reports)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
