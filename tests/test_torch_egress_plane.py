"""The sharded egress plane of the port (runtime/egress_plane.py, the
native egress_plane_send and munge_walk_multi): the reference's
tests/test_egress_plane.py on the port's modules, and the stress of the
native pool across calls whose shard count changes (ROADMAP C12).

* seal parity — every sealed datagram is bit-identical to the port's
  Python seal in runtime/crypto.py, and the client opens it;
* shard determinism — the output buffer is identical across shard plans
  and with canonical grouping on or off;
* wire order — within one (room, sub, track) stream, datagrams leave in
  packet order;
* walk_multi ≡ walk — the sharded munge walker gives the same columns
  and the same evolved state as the single walk;
* the pool stress — 3,000 calls for each shard-count sequence 2; 3;
  3,2; 2,3, in a subprocess with a time limit so that a hung pool fails
  the test instead of the suite.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.native import poolcheck  # noqa: E402
from livekit_server_tpu_torch.ops import bits  # noqa: E402
from livekit_server_tpu_torch.runtime import crypto  # noqa: E402
from livekit_server_tpu_torch.runtime.egress_plane import EgressPlane  # noqa: E402
from livekit_server_tpu_torch.runtime.munge import HostMunger  # noqa: E402
from tests.test_host_munge import _random_tick  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parent.parent


def _batch(n_rooms=4, subs=3, tracks=2, pkts=3, sealed=True):
    """The reference's destination-major batch (poolcheck.batch), sealed
    or not, and its (room, sub, track, packet) columns."""
    args = poolcheck.batch(n_rooms, subs, tracks, pkts)
    args["seal"][:] = 1 if sealed else 0
    rr = args["rooms"]
    ss = np.tile(np.repeat(np.arange(subs, dtype=np.int32), tracks * pkts), n_rooms)
    tt = np.tile(np.repeat(np.arange(tracks, dtype=np.int32), pkts), n_rooms * subs)
    kk = np.tile(np.arange(pkts, dtype=np.int32), n_rooms * subs * tracks)
    return args, (rr, ss, tt, kk), args["keys"]


def _send(plane_obj, args, cols):
    rr, ss, tt, kk = cols
    tracks, pkts = int(tt.max()) + 1, int(kk.max()) + 1
    flat_rtk = rr.astype(np.int64) * (tracks * pkts) + tt * pkts + kk
    grp, grp_slots = plane_obj.group_slots(flat_rtk, tt, kk, tracks, pkts)
    if grp is None:
        grp, grp_slots = np.full(len(rr), -1, np.int32), 0
    lo, hi = plane_obj.entry_plan(rr)
    return native.egress.send_sharded(fd=-1, shard_lo=lo, shard_hi=hi, grp=grp,
                                      grp_slots=grp_slots, **args)


needs_aead = pytest.mark.skipif(not crypto.HAVE_AEAD, reason="no AEAD backend")


@needs_aead
def test_seal_parity_native_vs_python():
    args, cols, keys = _batch(sealed=True)
    out, out_off, out_len, sent, *_ = _send(EgressPlane(shards=2), args, cols)
    n = len(args["pay_off"])
    assert sent == n
    for i in range(n):
        dgram = bytes(out[out_off[i]:out_off[i] + out_len[i]])
        off = int(args["pay_off"][i])
        payload = bytes(args["slab"][off:off + int(args["pay_len"][i])])
        hdr = (bytes([0x80, int(args["pt"][i]) | (int(args["marker"][i]) << 7)])
               + int(args["sn"][i]).to_bytes(2, "big") + int(args["ts"][i]).to_bytes(4, "big")
               + int(args["ssrc"][i]).to_bytes(4, "big"))
        sess = int(args["key_idx"][i])
        expect = crypto._seal(crypto.AESGCM(bytes(keys[sess])), int(args["key_ids"][sess]),
                              crypto.DIR_S2C, int(args["counters"][i]), hdr + payload)
        assert dgram == expect, f"entry {i}: sealed frame mismatch"


@needs_aead
def test_seal_parity_client_opens():
    args, cols, keys = _batch(n_rooms=2, subs=2, sealed=True)
    out, out_off, out_len, *_ = _send(EgressPlane(shards=2), args, cols)
    clients = {s: crypto.MediaCryptoClient(int(args["key_ids"][s]), bytes(keys[s]))
               for s in range(len(keys))}
    for i in range(len(args["pay_off"])):
        clear = clients[int(args["key_idx"][i])].open(
            bytes(out[out_off[i]:out_off[i] + out_len[i]]))
        assert clear is not None, f"entry {i}: client rejected native seal"
        assert clear[2:4] == int(args["sn"][i]).to_bytes(2, "big")


@pytest.mark.parametrize("sealed", [False, True])
def test_shard_determinism(sealed):
    if sealed and not crypto.HAVE_AEAD:
        pytest.skip("no AEAD backend")
    ref = None
    for shards in (1, 2, 3):
        for multicast in (False, True):
            args, cols, _ = _batch(n_rooms=5, subs=4, pkts=4, sealed=sealed)
            ep = EgressPlane(shards=shards, multicast_seal=multicast)
            out, out_off, out_len, sent, s_sent, s_built, _ = _send(ep, args, cols)
            assert sent == len(args["pay_off"])
            assert int(s_built.sum()) == sent
            cur = (bytes(out), out_off.tobytes(), out_len.tobytes())
            if ref is None:
                ref = cur
            assert cur == ref, f"shards={shards} multicast={multicast} diverged"


def test_wire_order_preserved_per_stream():
    args, cols, _ = _batch(n_rooms=3, subs=3, tracks=2, pkts=5, sealed=False)
    rr, ss, tt, kk = cols
    out, out_off, *_ = _send(EgressPlane(shards=3), args, cols)
    for r in range(3):
        for s in range(3):
            for t in range(2):
                m = (rr == r) & (ss == s) & (tt == t)
                offs = out_off[m]
                assert (np.diff(kk[m][np.argsort(offs)]) > 0).all()
                for off, sn in zip(offs, args["sn"][m]):
                    assert bytes(out[off + 2:off + 4]) == int(sn).to_bytes(2, "big")


def test_walk_multi_matches_single_walk():
    R, T, K, S = 6, 3, 4, 37
    dims = plane.PlaneDims(R, T, K, S)
    rng = np.random.default_rng(23)
    h_one, h_multi = HostMunger(dims), HostMunger(dims)
    r_lo, r_hi = EgressPlane(shards=3).room_plan(R)
    assert len(r_lo) == 3
    for _ in range(4):
        sn, ts, ts_jump, pid, tl0, ki, begin, valid, fwd, drop, switch = _random_tick(
            rng, R, T, K, S)
        fwd &= valid[..., None]
        drop &= valid[..., None] & ~fwd
        switch &= fwd
        words = [bits.pack_bits(torch.from_numpy(m)).numpy() for m in (fwd, drop, switch)]
        a = h_one.apply_columns(sn, ts, ts_jump, pid, tl0, ki, begin, valid, *words)
        b = h_multi.apply_columns(sn, ts, ts_jump, pid, tl0, ki, begin, valid, *words,
                                  shard_plan=(r_lo, r_hi))
        for col_a, col_b in zip(a, b):
            np.testing.assert_array_equal(col_a, col_b)
        assert int(h_multi.last_shard_counts.sum()) == len(b[0])
    for f in HostMunger.FIELDS:
        np.testing.assert_array_equal(getattr(h_one, f), getattr(h_multi, f), err_msg=f)


@pytest.mark.parametrize("shards", [2, 4, 6])
def test_walk_multi_shards_claimed_and_overflow_untouched(shards):
    """The sharded walk at several shard counts, down to one room a
    shard: equal to the single walk, each shard's count and walk time
    reported; a cap one short of the tick's entries returns None with no
    munger lane changed."""
    assert native.munge is not None
    R, T, K, S = 6, 3, 4, 37
    dims = plane.PlaneDims(R, T, K, S)
    rng = np.random.default_rng(31 + shards)
    h_one, h_multi = HostMunger(dims), HostMunger(dims)
    r_lo, r_hi = EgressPlane(shards=shards).room_plan(R)
    for _ in range(3):
        sn, ts, ts_jump, pid, tl0, ki, begin, valid, fwd, drop, switch = _random_tick(
            rng, R, T, K, S)
        fwd &= valid[..., None]
        drop &= valid[..., None] & ~fwd
        switch &= fwd
        words = [bits.pack_bits(torch.from_numpy(m)).numpy() for m in (fwd, drop, switch)]
        args = (sn, ts, ts_jump, pid, tl0, ki, begin, valid, *words)
        cap = int(fwd.sum())
        before = {f: getattr(h_multi, f).copy() for f in HostMunger.FIELDS}
        assert native.munge.walk_multi(*args, h_multi, cap - 1, r_lo, r_hi) is None
        for f in HostMunger.FIELDS:
            np.testing.assert_array_equal(getattr(h_multi, f), before[f], err_msg=f)
        cols, counts, ns = native.munge.walk_multi(*args, h_multi, cap, r_lo, r_hi)
        want = native.munge.walk(*args, h_one, cap)
        for a, b in zip(want, cols):
            np.testing.assert_array_equal(a, b)
        assert len(counts) == len(r_lo) and int(counts.sum()) == cap == len(cols[0])
        assert (ns >= 0).all()
    for f in HostMunger.FIELDS:
        np.testing.assert_array_equal(getattr(h_one, f), getattr(h_multi, f), err_msg=f)


def test_pool_stress_across_shard_count_changes():
    """C12: before the fix a straggler of one call built a shard of the
    next (short `sent`, 7–35 calls in 3,000) or left the caller waiting
    for ever when the shard counts differed."""
    assert native.egress is not None
    proc = subprocess.run(
        [sys.executable, "-m", "livekit_server_tpu_torch.native.poolcheck",
         "--calls", "3000", "--watchdog-s", "60"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    reports = json.loads(proc.stdout.strip().splitlines()[-1])["pool_stress"]
    assert [r["sequence"] for r in reports] == [[2], [3], [3, 2], [2, 3]]
    for r in reports:
        assert r["calls"] == 3000 and r["short_calls"] == 0 and r["shard_mismatches"] == 0, r
