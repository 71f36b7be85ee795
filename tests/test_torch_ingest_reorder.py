"""The drain's within-tick reorder and dedup (runtime/ingest.py
`_reorder_dedup`): the native row pass (native/csrc/rtp_parser.cpp
`reorder_slots`) and its numpy form `_reorder_dedup_plain`.

* the JAX package's four ingest cases (tests/test_rtc_runtime.py:
  reorder, SN wrap, dedup, per-layer order) on the port, in both forms;
* the native pass equals the numpy form on seeded staging sets filled
  through `push` and `push_batch`: all 24 per-slot arrays, the
  duplicates and the `reorder_rows` / `reorder_moved` counters;
* after a reorder, each slot's payload, DD bytes, DD version and
  arrival stamp belong to the packet whose SN sits there;
* a library that fails to build leaves the drain on the numpy form,
  with the same output.
"""

import numpy as np
import pytest

from livekit_server_tpu_torch import native
from livekit_server_tpu_torch.models.plane import PlaneDims
from livekit_server_tpu_torch.runtime import ingest
from livekit_server_tpu_torch.runtime.ingest import IngestBuffer, PacketIn

SLOT_ARRAYS = ingest._StagingSet.SLOT_ARRAYS


@pytest.fixture(params=["native", "plain"])
def form(request, monkeypatch):
    """Run the drain on the native pass, or on the numpy form as where the
    library did not load."""
    assert native.rtp.native, "native librtp_parser.so failed to build"
    if request.param == "plain":
        monkeypatch.setattr(native, "rtp", native.PythonRTP())
    return request.param


def _sns(buf, pkts):
    for sn, layer in pkts:
        buf.push(PacketIn(room=0, track=0, sn=sn, ts=sn * 10, size=10, layer=layer,
                          payload=bytes([sn & 0xFF])))
    inp, slab = buf.drain()
    v = inp.valid[0, 0]
    return inp, slab, list(zip(inp.layer[0, 0][v].tolist(), inp.sn[0, 0][v].tolist()))


def test_reference_ingest_cases(form):
    # Out-of-order arrivals are sorted by SN; the payload follows.
    dims = PlaneDims(1, 2, 8, 2)
    _, slab, got = _sns(IngestBuffer(dims, 10), [(102, 0), (100, 0), (103, 0), (101, 0)])
    assert got == [(0, 100), (0, 101), (0, 102), (0, 103)]
    assert slab.get(0, 0, 0)[0] == bytes([100]) and slab.get(0, 0, 3)[0] == bytes([103])
    # The 16-bit ring: 65535 → 0 → 1 → 2.
    dims = PlaneDims(1, 1, 4, 1)
    _, _, got = _sns(IngestBuffer(dims, 10), [(1, 0), (65535, 0), (0, 0), (2, 0)])
    assert [sn for _, sn in got] == [65535, 0, 1, 2]
    # Same-SN copies within the tick: two dropped.
    dims = PlaneDims(1, 1, 8, 1)
    buf = IngestBuffer(dims, 10)
    inp, _, got = _sns(buf, [(100, 0), (101, 0), (101, 0), (102, 0), (101, 0)])
    assert int(inp.valid.sum()) == 3 and buf.dupes == 2
    assert got == [(0, 100), (0, 101), (0, 102)]
    assert buf.stats["reorder_rows"] == 1 and buf.stats["reorder_moved"] == 1
    # Layers keep their own SN spaces: grouped by layer, not interleaved.
    _, _, got = _sns(IngestBuffer(dims, 10), [(5000, 1), (101, 0), (5001, 1), (100, 0)])
    assert got == [(0, 100), (0, 101), (1, 5000), (1, 5001)]


def _row_packets(rng, K):
    """One (room, track)'s packets of a tick, in arrival order: interleaved
    layers -1..2 in SN spaces that may wrap, shuffled, with runs of two
    and three copies; rows of 0, 1, K and more than K packets."""
    n = int(rng.choice([0, 1, 1, 2, 3, K // 2, K - 1, K, K, K + 3]))
    layers = rng.choice([-1, 0, 1, 2], size=n, p=[0.1, 0.4, 0.25, 0.25])
    base = {l: int(rng.choice([65530, 0, rng.integers(0, 65536)])) for l in (-1, 0, 1, 2)}
    pkts, nxt = [], dict.fromkeys(base, 0)
    for l in layers.tolist():
        pkts.append((l, (base[l] + nxt[l]) & 0xFFFF))
        nxt[l] += 1
    if n and rng.random() < 0.5:
        rng.shuffle(pkts)
    if n >= 2 and rng.random() < 0.4:
        i = int(rng.integers(0, len(pkts)))
        pkts[i + 1:i + 1] = [pkts[i]] * int(rng.integers(1, 3))  # 2 or 3 copies
    return pkts


def _fill(rng, dims):
    """A staging set filled by the real producers: most packets in
    receive batches (each its own arrival stamp, DD bytes on some), the
    rest one at a time through `push`."""
    R, T, K, _ = dims
    buf = IngestBuffer(dims, 20)
    cols = {k: [] for k in ("room", "track", "layer", "sn", "dd")}
    scalar = []
    for r in range(R):
        for t in range(T):
            for layer, sn in _row_packets(rng, K):
                if rng.random() < 0.25:
                    scalar.append(PacketIn(room=r, track=t, sn=sn, ts=sn * 90, size=50 + sn % 9,
                                           payload=bytes([sn & 0xFF, layer & 0xFF]),
                                           layer=layer, pid=sn % 128, marker=bool(sn % 2)))
                    continue
                for k, v in zip(cols, (r, t, layer, sn, rng.random() < 0.5)):
                    cols[k].append(v)
    n = len(cols["sn"])
    sn = np.asarray(cols["sn"], np.int64)
    layer = np.asarray(cols["layer"], np.int32)
    pay_len = (sn % 5 + 1).astype(np.int32)
    pay_start = np.r_[0, np.cumsum(pay_len[:-1])].astype(np.int64)
    dd_len = np.where(cols["dd"], sn % 3 + 2, 0).astype(np.int32)
    dd_start = np.where(dd_len > 0, pay_start[-1] + 8 + sn % 40, -1).astype(np.int64)
    blob = rng.integers(0, 256, int(pay_start[-1]) + 64, np.uint8)
    z = np.zeros(n, np.int32)
    args = dict(
        room=np.asarray(cols["room"], np.int32), track=np.asarray(cols["track"], np.int32),
        layer=layer, sn=sn, ts=sn * 90, ts_aligned=sn % 3 == 0, temporal=(sn % 3).astype(np.int32),
        keyframe=sn % 11 == 0, layer_sync=sn % 5 == 0, begin_pic=sn % 2 == 0, marker=sn % 2 == 1,
        pid=(sn % 128).astype(np.int32), tl0=(sn % 256).astype(np.int32),
        keyidx=(sn % 32).astype(np.int32), size=(sn % 1200).astype(np.int32), frame_ms=z + 20,
        audio_level=(sn % 128).astype(np.int32), arrival_rtp=sn * 7, pay_start=pay_start,
        pay_length=pay_len, blob=blob, dd_start=dd_start, dd_length=dd_len,
        dd_version=(sn % 4).astype(np.int32), end_frame=sn % 4 == 1)
    cuts = np.sort(rng.choice(np.arange(1, n), size=3, replace=False)) if n > 4 else []
    for i, (lo, hi) in enumerate(zip(np.r_[0, cuts], np.r_[cuts, n])):
        buf.push_batch(**{k: v if k == "blob" else v[lo:hi] for k, v in args.items()},
                       t_rx=100.0 + i)
    for i, pkt in enumerate(scalar):
        buf.push(pkt, t_rx=200.0 + i)
    return buf


@pytest.mark.parametrize("K", [8, 16])
def test_native_pass_equals_numpy_form(K):
    assert native.rtp.native, "native librtp_parser.so failed to build"
    totals = np.zeros(3, np.int64)
    for seed in range(4):
        buf = _fill(np.random.default_rng(1000 * K + seed), PlaneDims(12, 6, K, 2))
        count = buf._count
        a = {f: getattr(buf, f).copy() for f in SLOT_ARRAYS}
        b = {f: getattr(buf, f).copy() for f in SLOT_ARRAYS}
        got = native.rtp.reorder_slots(count, a)
        want = ingest._reorder_dedup_plain(count, b)
        assert got == want, seed
        for f in SLOT_ARRAYS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f}, seed {seed}")
        totals += want
    rows, moved, dupes = totals
    # The sets exercised both halves: rows permuted, copies dropped.
    assert rows > moved > 0 and dupes > 0


def test_dd_bytes_and_arrival_stamp_follow_their_packet(form):
    """Each packet arrives in a receive batch of its own, with its own
    payload, DD bytes, DD version and arrival stamp; after the drain has
    reordered the row, every slot's side data is its own packet's."""
    dims = PlaneDims(2, 2, 8, 2)
    buf = IngestBuffer(dims, 20)
    arrivals = [(0, 52685), (1, 52686), (0, 52683), (2, 52687), (1, 52684),
                (0, 52683), (2, 52688)]                     # one copy of 52683
    payload = lambda sn: bytes([sn & 0xFF, 0xAA])            # noqa: E731
    dd = lambda sn: bytes([0x80, sn & 0xFF, (sn >> 8) & 0xFF])  # noqa: E731
    for i, (layer, sn) in enumerate(arrivals):
        blob = np.frombuffer(payload(sn) + dd(sn), np.uint8)
        one = lambda v, dt=np.int32: np.asarray([v], dt)    # noqa: E731
        buf.push_batch(
            room=one(1), track=one(1), layer=one(layer), sn=one(sn), ts=one(sn * 90),
            ts_aligned=one(False, bool), temporal=one(0), keyframe=one(False, bool),
            layer_sync=one(False, bool), begin_pic=one(True, bool), marker=one(True, bool),
            pid=one(0), tl0=one(0), keyidx=one(0), size=one(1000), frame_ms=one(20),
            audio_level=one(127), arrival_rtp=one(0), pay_start=one(0, np.int64),
            pay_length=one(2), blob=blob, dd_start=one(2, np.int64), dd_length=one(3),
            dd_version=one(sn % 5), t_rx=1000.0 + sn + i / 100)
    inp, slab = buf.drain()
    v = inp.valid[1, 1]
    assert list(zip(inp.layer[1, 1][v], inp.sn[1, 1][v])) == [
        (0, 52683), (0, 52685), (1, 52684), (1, 52686), (2, 52687), (2, 52688)]
    assert buf.dupes == 1 and buf.stats["reorder_moved"] == 1
    # Stable: the copy that arrived first keeps the valid slot.
    order = sorted(range(len(arrivals)), key=lambda i: (*arrivals[i], i))
    for k, i in enumerate(order):
        sn = arrivals[i][1]
        assert int(inp.sn[1, 1, k]) == sn and bool(inp.valid[1, 1, k]) == (k != 1), k
        assert slab.get(1, 1, k)[0] == payload(sn), k
        assert slab.get_dd(1, 1, k) == dd(sn), k
        assert int(slab.dd_ver[1, 1, k]) == sn % 5, k
        assert slab.t_arr[1, 1, k] == 1000.0 + sn + i / 100, k


def test_failed_build_leaves_the_drain_on_the_numpy_form(monkeypatch, tmp_path):
    def drained():
        buf = _fill(np.random.default_rng(77), PlaneDims(8, 5, 8, 2))
        inp, slab = buf.drain()
        return buf, inp, slab

    assert native.rtp.native, "native librtp_parser.so failed to build"
    n_buf, n_inp, n_slab = drained()
    monkeypatch.setattr(native, "_BUILD", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "build_log", {})
    monkeypatch.delitem(vars(native), "rtp")
    assert native.rtp.native is False and native.build_log["rtp"]["ok"] is False
    p_buf, p_inp, p_slab = drained()
    for a, b in zip(n_inp, p_inp):
        np.testing.assert_array_equal(a, b)
    for f in ("off", "length", "marker", "dd_off", "dd_len", "dd_ver", "t_arr"):
        np.testing.assert_array_equal(getattr(n_slab, f), getattr(p_slab, f), err_msg=f)
    assert n_slab.data == p_slab.data and n_buf.dupes == p_buf.dupes > 0
    for key in ("reorder_rows", "reorder_moved", "pushed_packets"):
        assert n_buf.stats[key] == p_buf.stats[key], key
    assert n_buf.stats["reorder_moved"] > 0
