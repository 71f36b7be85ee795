"""The RTP-stats kernel (csrc/rtpstats_rooms.cu, `rtpstats.route_update_tick`)
against its plain version `route_update_tick_plain` (`route_stats`, then
`update_tick`) on the card, over chained ticks of edge cases; and, on the
CPU, the wrapper's routing and operand checks, its build, and a
per-track scalar model of the kernel's algorithm held to the plain path.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no jax (skip the JAX-based conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rtpstats_kernel.py

Tests marked `cuda` need an NVIDIA GPU and `nvcc`; elsewhere they skip.
"""

import subprocess
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from torch_kernel_fixture import card  # noqa: E402, F401 (a fixture)

from livekit_server_tpu_torch.ops import cuda, rtpstats  # noqa: E402
from livekit_server_tpu_torch.runtime.compile_ledger import CompileLedger  # noqa: E402

INT_MIN = -(1 << 31)
L = rtpstats.MAX_LAYERS
TICKS = 5
# (R, T, K, offset): `offset` puts the int32 packet fields one element into a
# shared buffer, off 16-byte alignment, so the kernel reads one packet at a
# time although K is a multiple of 4. (13, 8, 16) takes the 16-byte loads;
# (1, 1, 1) has K = 1.
SHAPES = {"one": (1, 1, 1, 0), "ns-k16": (13, 8, 16, 0), "prime-k8-unaligned": (1037, 10, 8, 1)}


def wrap32(a):
    """int64 values → int32 with two's-complement wrap."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def random_state(R, N, rng) -> list:
    """StreamStats leaves as numpy: half the rows started, counters near
    the int32 wrap, 32-bit fields over their whole range."""
    full = lambda: rng.integers(INT_MIN, 1 << 31, (R, N))  # noqa: E731
    near_top = lambda: (1 << 31) - rng.integers(1, 40, (R, N))  # noqa: E731
    ints = [rng.integers(0, 65536, (R, N)), rng.integers(0, 65536, (R, N)),
            rng.integers(0, 4, (R, N)), full(), near_top(), near_top(),
            rng.integers(0, 9, (R, N)), full(), full(), full(), full()]
    return [rng.random((R, N)) < 0.5, *[x.astype(np.int32) for x in ints]]


def edge_ticks(R, T, K, seed, n=TICKS):
    """(is_svc [R, T], [n ticks of (layer, sn, ts, size, arrival_rtp, valid,
    begin_pic)]) as numpy, with: first packets mid-tick, duplicates and
    reordered SNs, SNs across 65535 → 0 and outside 16 bits, ts and
    arrival across the int32 wrap, transit steps near ±2^31 (exactly
    INT_MIN at track (0, 0)), a falling jitter after it, an SVC track
    with packets on layers 1–2, layers -1 and 5, and begin_pic set on
    invalid packets."""
    rng = np.random.default_rng(seed)
    is_svc = rng.random((R, T)) < 0.3
    is_svc[-1, -1] = True
    sn0 = np.where(rng.random((R, T)) < 0.5, 65530, rng.integers(0, 65536, (R, T)))
    ts0 = rng.integers((1 << 31) - 40000, 1 << 31, (R, T))
    arr0 = rng.integers((1 << 31) - 40000, 1 << 31, (R, T))
    shape = (R, T, K)
    ticks = []
    for i in range(n):
        step = np.arange(i * K, (i + 1) * K)
        sn = (sn0[..., None] + step + rng.choice([0, 0, 0, 0, 1, 3, -1, -2], shape)) % 65536
        sn = np.where(rng.random(shape) < 0.03, rng.integers(INT_MIN, 1 << 31, shape), sn)
        ts = wrap32(ts0[..., None] + step * 3000 + rng.integers(-5000, 5000, shape))
        arr = wrap32(arr0[..., None] + step * 3000 + rng.integers(-20000, 20000, shape))
        far = rng.choice([(1 << 31) - 1, INT_MIN, (1 << 31) - 7, INT_MIN + 7], shape)
        arr = np.where(rng.random(shape) < 0.05, wrap32(ts.astype(np.int64) + far), arr)
        layer = rng.choice([-1, 0, 0, 1, 1, 2, 2, 5], shape)
        valid = rng.random(shape) < 0.75
        if i == 0:
            valid[:, ::2, :(K + 1) // 2] = False
        begin_pic = rng.random(shape) < 0.4
        size = np.where(rng.random(shape) < 0.02, rng.integers(1 << 30, 1 << 31, shape),
                        rng.integers(0, 1500, shape))
        if i >= 2:
            layer[-1, -1] = np.arange(K) % 2 + 1
        # Track (0, 0) sends one packet a tick, in slot 0 on lane 0: transits
        # 0 then INT_MIN (a step of exactly INT_MIN), then INT_MIN held (the
        # jitter falls).
        valid[0, 0] = np.arange(K) == 0
        ts[0, 0, 0] = 0 if i < 2 else 160 * i
        arr[0, 0, 0] = wrap32(int(ts[0, 0, 0]) + (0 if i == 0 else INT_MIN))
        if i < 2:
            layer[0, 0, 0] = 0
        ticks.append((layer.astype(np.int32), sn.astype(np.int32), ts, size.astype(np.int32),
                      arr, valid, begin_pic))
    return is_svc, ticks


def to_torch(arrays, dev, offset: int = 0):
    """numpy → tensors on dev; with `offset`, the int32 arrays are views into
    one buffer, `offset` elements in."""
    if not offset:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    ints = [a for a in arrays if a.dtype == np.int32]
    buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32)]
                                          + [a.reshape(-1) for a in ints])).to(dev)
    out, at = [], offset
    for a in arrays:
        if a.dtype == np.int32:
            out.append(buf[at:at + a.size].view(a.shape))
            at += a.size
        else:
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return out


def assert_equal(got, want, where):
    (gs, gt), (ws, wt) = got, want
    for name, x, y in zip(rtpstats.StreamStats._fields, gs, ws):
        assert x.dtype == y.dtype and torch.equal(x, y), (where, name)
    assert gt.dtype == wt.dtype and torch.equal(gt, wt), (where, "tr_sums")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHAPES))
def test_kernel_matches_plain(card, case):
    """The kernel against the plain path on the same card inputs, TICKS
    chained ticks from a random state, each path carrying its own state:
    every StreamStats leaf and tr_sums exact, one launch a call."""
    R, T, K, offset = SHAPES[case]
    rng = np.random.default_rng(R + T + K)
    state = rtpstats.StreamStats(*to_torch(random_state(R, T * L, rng), card))
    is_svc, ticks = edge_ticks(R, T, K, seed=R * T * K)
    is_svc = torch.from_numpy(is_svc).to(card)
    got_state = want_state = state
    for i, tick in enumerate(ticks):
        layer, sn, ts, size, arr, valid, bp = to_torch(tick, card, offset)
        before = dict(cuda.launches)
        got = rtpstats.route_update_tick(got_state, is_svc, layer, sn, ts, size, arr,
                                         valid, bp)
        assert cuda.launches == {**before, "rtpstats_rooms": before["rtpstats_rooms"] + 1}
        want = rtpstats.route_update_tick_plain(want_state, is_svc, layer, sn, ts, size,
                                                arr, valid, bp)
        torch.cuda.synchronize()
        assert_equal(got, want, (case, i))
        got_state, want_state = got[0], want[0]


def model(state, is_svc, ticks):
    """The kernel's algorithm in scalar Python: one (room, track) at a time,
    its L rows in hand, its packets in order, every int32 result wrapped.
    Returns [(state leaves, tr)] a tick, as numpy."""
    w = lambda x: (x + (1 << 31)) % (1 << 32) - (1 << 31)  # noqa: E731
    s = [np.asarray(x).astype(np.int64) for x in state]
    R, T = is_svc.shape
    out = []
    for layer, sn, ts, size, arr, valid, bp in ticks:
        s = [x.copy() for x in s]
        started, first, hi, cyc, hts, rcv, byt, dup, jit, lt = s[:10]
        tr = np.zeros((R, 3, T * L), np.int64)
        for r in range(R):
            for t in range(T):
                for k in range(sn.shape[2]):
                    if not valid[r, t, k]:
                        continue
                    tl = min(max(int(layer[r, t, k]), 0), L - 1)
                    i = t * L + (0 if is_svc[r, t] else tl)
                    p_sn, p_ts = int(sn[r, t, k]), int(ts[r, t, k])
                    fresh = not started[r, i]
                    hi0 = p_sn if fresh else int(hi[r, i])
                    d = ((p_sn - hi0 + 0x8000) & 0xFFFF) - 0x8000
                    if fresh:
                        first[r, i] = p_sn
                    elif d <= 0:
                        dup[r, i] = w(dup[r, i] + 1)
                    if d > 0 and p_sn < hi0:
                        cyc[r, i] = w(cyc[r, i] + 1)
                    if fresh or w(p_ts - int(hts[r, i])) > 0:
                        hts[r, i] = p_ts
                    transit = w(int(arr[r, t, k]) - p_ts)
                    if not fresh:
                        dtr = w(abs(w(transit - int(lt[r, i]))))
                        x = w(w(dtr << 4) - int(jit[r, i]))
                        jit[r, i] = w(int(jit[r, i]) + (x >> 4))
                    hi[r, i] = p_sn if (d > 0 or fresh) else hi0
                    started[r, i] = 1
                    rcv[r, i] = w(rcv[r, i] + 1)
                    byt[r, i] = w(byt[r, i] + int(size[r, t, k]))
                    lt[r, i] = transit
                    j = t * L + tl
                    tr[r, :, j] += (1, int(size[r, t, k]), int(bp[r, t, k]))
        out.append((list(s), w(tr)))
    return out


@pytest.mark.parametrize("dims", [(3, 4, 8), (2, 3, 5)])
def test_scalar_model_matches_plain(dims):
    """The kernel's per-track algorithm (scalar Python, `model`) equals the
    plain path over chained edge-case ticks on the CPU, every leaf and
    tr_sums: the routing in registers and the wrapped integer steps are
    the plain code's."""
    R, T, K = dims
    rng = np.random.default_rng(sum(dims))
    leaves = random_state(R, T * L, rng)
    is_svc, ticks = edge_ticks(R, T, K, seed=K)
    want = rtpstats.StreamStats(*to_torch(leaves, "cpu"))
    svc = torch.from_numpy(is_svc)
    for i, (m_state, m_tr) in enumerate(model(leaves, is_svc, ticks)):
        want, tr = rtpstats.route_update_tick(want, svc, *to_torch(ticks[i], "cpu"))
        for name, x, y in zip(rtpstats.StreamStats._fields, m_state, want):
            assert np.array_equal(x, y.numpy().astype(np.int64)), (i, name)
        assert np.array_equal(m_tr, tr.numpy()), (i, "tr_sums")


def test_wrapper_routing_and_operand_checks():
    """CPU tensors take the plain path and launch nothing; a wrong dtype or
    shape is refused on any device, and a device that is neither the CPU
    nor a card is refused, never routed to the plain path."""
    R, T, K = 2, 3, 4
    rng = np.random.default_rng(3)
    state = rtpstats.StreamStats(*to_torch(random_state(R, T * L, rng), "cpu"))
    is_svc, ticks = edge_ticks(R, T, K, seed=3, n=1)
    args = [torch.from_numpy(is_svc), *to_torch(ticks[0], "cpu")]
    before = dict(cuda.launches)
    assert_equal(rtpstats.route_update_tick(state, *args), rtpstats.route_update_tick_plain(state, *args), "cpu")
    assert cuda.launches == before
    bad = list(args)
    bad[2] = bad[2].to(torch.int64)                                      # sn
    with pytest.raises(ValueError, match="sn is torch.int64"):
        rtpstats.route_update_tick(state, *bad)
    bad = list(args)
    bad[0] = bad[0][:, :2]                                               # is_svc
    with pytest.raises(ValueError, match=r"is_svc is torch.bool \(2, 2\)"):
        rtpstats.route_update_tick(state, *bad)
    with pytest.raises(ValueError, match="jitter_q4"):
        rtpstats.route_update_tick(state._replace(jitter_q4=state.jitter_q4[:, :-1]), *args)
    with pytest.raises(ValueError, match="unsupported device"):
        rtpstats.route_update_tick(rtpstats.StreamStats(*[x.to("meta") for x in state]),
                                   *[x.to("meta") for x in args])
    assert cuda.launches == before


def test_build_names_the_source(tmp_path, monkeypatch):
    """`cuda.build` compiles csrc/rtpstats_rooms.cu with the kernels' flags
    into a digest-named library of its own, and the wrapper's count starts
    at zero beside the other kernels'."""
    assert cuda.SOURCES["rtpstats_rooms"] == "rtpstats_rooms"
    assert (cuda.CSRC / "rtpstats_rooms.cu").is_file()
    assert "rtpstats_rooms" in cuda.launches
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, argv, **_):
            calls.append(argv)
            open(argv[argv.index("-o") + 1], "w").close()

        def communicate(self):
            return "ptxas info    : Used 40 registers", None

    ledger = CompileLedger()
    monkeypatch.setattr(cuda, "_ledger", lambda: ledger)
    monkeypatch.setattr(cuda, "BUILD", tmp_path)
    monkeypatch.setattr(cuda, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda, "subprocess", types.SimpleNamespace(
        Popen=Proc, PIPE=subprocess.PIPE, STDOUT=subprocess.STDOUT))
    reports = cuda.build(("rtpstats_rooms",))
    assert list(reports) == ["rtpstats_rooms"]
    (argv,) = calls
    assert argv[-1] == str(cuda.CSRC / "rtpstats_rooms.cu")
    assert tuple(argv[1:1 + len(cuda.NVCC_FLAGS)]) == cuda.NVCC_FLAGS
    lib = cuda.library_path("rtpstats_rooms")
    assert lib.parent == tmp_path and lib.name.startswith("librtpstats_rooms-") and lib.exists()
    assert [e[:2] for e in ledger.since(0)] == [("nvcc", lib.name)]
