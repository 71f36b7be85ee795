"""The port's native RTP libraries (livekit_server_tpu_torch/native: the
parser, the egress assembler and the munge walker, built with g++ from
the port's own csrc/ copies).

The reference's native tests (tests/test_native.py) on the port's
libraries: the C++ batch parser against the pure-Python parser (the
plain version), field for field. Then the port's libraries against the
JAX package's on the same seeded packets and masks: parse_batch,
rewrite_batch, rewrite_vp8_batch, the munge walk and the sharded walk
give equal arrays, and the walk equals the port's numpy munge path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers.
torch.set_num_threads(1)

from livekit_server_tpu import native as jax_native  # noqa: E402
from livekit_server_tpu.models import plane as jax_plane  # noqa: E402
from livekit_server_tpu.runtime.munge import HostMunger as JaxMunger  # noqa: E402
from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.models import plane  # noqa: E402
from livekit_server_tpu_torch.native import PARSED_DTYPE, PythonRTP  # noqa: E402
from livekit_server_tpu_torch.runtime.munge import HostMunger  # noqa: E402
from tests.test_native import rtp_packet, vp8_payload  # noqa: E402


class _Rtp:
    """native.rtp, resolved at first use (the build runs in a test, not
    while workers collect)."""

    def __getattr__(self, name):
        return getattr(native.rtp, name)


rtp = _Rtp()


def parse_both(datagrams, **kw):
    buf = b"".join(datagrams)
    offsets, lengths, off = [], [], 0
    for d in datagrams:
        offsets.append(off)
        lengths.append(len(d))
        off += len(d)
    offs = np.asarray(offsets, np.int32)
    lens = np.asarray(lengths, np.int32)
    a = rtp.parse_batch(buf, offs, lens, **kw)
    b = PythonRTP().parse_batch(buf, offs, lens, **kw)
    return a, b


def test_native_library_built():
    # This machine has g++: the native path must actually be in use, built
    # from the port's own sources into the port's build directory.
    assert rtp.native, "native librtp_parser.so failed to build"
    assert PARSED_DTYPE.itemsize == 52  # C struct layout match
    status = native.status()
    assert all(status["loaded"].values()), status
    for entry in status["builds"].values():
        assert "livekit_server_tpu_torch/native/csrc/" in entry["cmd"]
        assert "livekit_server_tpu_torch/_build/native/" in entry["so"]


def test_parse_basic_and_audio_level():
    pkts = [
        rtp_packet(sn=1, ts=1000, ssrc=7, audio_level=23),
        rtp_packet(sn=2, ts=2000, ssrc=7),
        rtp_packet(sn=3, ts=3000, ssrc=8, padding=4, payload=b"\xcc" * 8),
    ]
    a, b = parse_both(pkts, audio_level_ext=1)
    for out in (a, b):
        assert out["sn"].tolist() == [1, 2, 3]
        assert out["ssrc"].tolist() == [7, 7, 8]
        assert out["audio_level"].tolist() == [23, 127, 127]
        assert out["voice"].tolist() == [1, 0, 0]
        assert out["payload_len"].tolist() == [20, 20, 8]
    assert bytes(a.tobytes()) == bytes(b.tobytes())  # exact agreement


def test_parse_vp8_descriptor():
    pkts = [
        rtp_packet(pt=96, payload=vp8_payload(pid=300, tl0=9, tid=1, ysync=1, keyidx=3, keyframe=True)),
        rtp_packet(pt=96, payload=vp8_payload(pid=55, keyframe=False)),
        rtp_packet(pt=96, payload=vp8_payload(sbit=0, pid=None, keyframe=False)),
    ]
    a, b = parse_both(pkts, audio_level_ext=1, vp8_pts={96})
    for out in (a, b):
        assert out["is_vp8"].tolist() == [1, 1, 1]
        assert out["picture_id"].tolist() == [300, 55, -1]
        assert out["tl0picidx"].tolist() == [9, -1, -1]
        assert out["tid"].tolist() == [1, 0, 0]
        assert out["layer_sync"].tolist() == [1, 0, 0]
        assert out["keyframe"].tolist() == [1, 0, 0]
        assert out["begin_pic"].tolist() == [1, 1, 0]
    assert bytes(a.tobytes()) == bytes(b.tobytes())


def test_parse_garbage_rejected():
    pkts = [b"\x00" * 5, b"not rtp at all!!", rtp_packet(sn=9)]
    a, b = parse_both(pkts)
    for out in (a, b):
        assert out["payload_len"].tolist()[:2] == [-1, -1]
        assert out["sn"][2] == 9
    assert bytes(a.tobytes()) == bytes(b.tobytes())


def test_rewrite_batch():
    pkt = bytearray(rtp_packet(sn=1, ts=2, ssrc=3))
    rtp.rewrite_batch(
        pkt, np.asarray([0], np.int32), np.asarray([777], np.uint16),
        np.asarray([123456], np.uint32), np.asarray([0xDEAD], np.uint32),
    )
    out = rtp.parse_batch(bytes(pkt), np.asarray([0], np.int32), np.asarray([len(pkt)], np.int32))
    assert int(out["sn"][0]) == 777
    assert int(out["ts"][0]) == 123456
    assert int(out["ssrc"][0]) == 0xDEAD


def test_rewrite_vp8_batch_patches_descriptor():
    """The egress rewrite must patch picture-id/TL0PICIDX/KEYIDX inside the
    VP8 payload descriptor (codecmunger/vp8.go:161), preserving TID/Y bits
    and the VP8 bitstream bytes after the descriptor."""
    pay15 = vp8_payload(pid=3000, tl0=7, tid=1, ysync=1, keyidx=4)
    pay7 = vp8_payload(pid=90, tl0=8, tid=0, keyidx=5)
    pkts = [
        bytearray(rtp_packet(sn=1, ts=10, ssrc=1, pt=96, payload=pay15)),
        bytearray(rtp_packet(sn=2, ts=20, ssrc=1, pt=96, payload=pay7)),
        bytearray(rtp_packet(sn=3, ts=30, ssrc=2, pt=111)),  # audio untouched
    ]
    buf = bytearray(b"".join(pkts))
    offsets = np.asarray([0, len(pkts[0]), len(pkts[0]) + len(pkts[1])], np.int32)
    lengths = np.asarray([len(p) for p in pkts], np.int32)
    rtp.rewrite_vp8_batch(
        buf, offsets, lengths,
        np.asarray([11, 12, 13], np.uint16),
        np.asarray([110, 120, 130], np.uint32),
        np.asarray([9, 9, 9], np.uint32),
        np.asarray([4500, 21, -1], np.int32),   # new picture ids
        np.asarray([70, 80, -1], np.int32),     # new tl0
        np.asarray([1, 2, -1], np.int32),       # new keyidx
        np.asarray([1, 1, 0], np.uint8),
    )
    out = rtp.parse_batch(
        bytes(buf), offsets, lengths, audio_level_ext=1, vp8_pts={96}
    )
    # 15-bit pid slot carries the new pid; tl0/keyidx patched; tid/Y kept.
    assert int(out["sn"][0]) == 11 and int(out["ssrc"][0]) == 9
    assert int(out["picture_id"][0]) == 4500
    assert int(out["tl0picidx"][0]) == 70
    assert int(out["keyidx"][0]) == 1
    assert int(out["tid"][0]) == 1 and int(out["layer_sync"][0]) == 1
    # 7-bit slot: low 7 bits, width preserved.
    assert int(out["picture_id"][1]) == 21
    assert int(out["tl0picidx"][1]) == 80
    assert int(out["keyidx"][1]) == 2
    # VP8 bitstream bytes after the descriptor untouched (keyframe P bit).
    assert int(out["keyframe"][0]) == 1
    # Audio packet: header rewritten, payload untouched.
    assert int(out["sn"][2]) == 13
    off, ln = int(out["payload_off"][2]), int(out["payload_len"][2])
    base = int(offsets[2])
    assert bytes(buf[base + off : base + off + ln]) == b"\xaa" * 20


def test_rewrite_vp8_batch_python_native_agree():
    """Native and fallback rewriters must produce identical bytes."""
    rng = np.random.default_rng(7)
    pkts = []
    for i in range(40):
        pay = vp8_payload(
            pid=int(rng.integers(0, 0x7FFF)) if rng.random() < 0.8 else None,
            tl0=int(rng.integers(0, 255)) if rng.random() < 0.7 else None,
            tid=int(rng.integers(0, 3)) if rng.random() < 0.7 else None,
            keyidx=int(rng.integers(0, 31)) if rng.random() < 0.5 else None,
            keyframe=bool(rng.random() < 0.3),
        )
        pkts.append(rtp_packet(sn=i, ts=i * 90, ssrc=5, pt=96, payload=pay))
    offsets, lengths, off = [], [], 0
    for p in pkts:
        offsets.append(off)
        lengths.append(len(p))
        off += len(p)
    offsets = np.asarray(offsets, np.int32)
    lengths = np.asarray(lengths, np.int32)
    args = (
        np.arange(40, dtype=np.uint16),
        np.arange(40, dtype=np.uint32) * 10,
        np.full(40, 77, np.uint32),
        rng.integers(-1, 0x7FFF, 40).astype(np.int32),
        rng.integers(-1, 255, 40).astype(np.int32),
        rng.integers(-1, 31, 40).astype(np.int32),
        np.ones(40, np.uint8),
    )
    buf_a = bytearray(b"".join(pkts))
    buf_b = bytearray(b"".join(pkts))
    rtp.rewrite_vp8_batch(buf_a, offsets, lengths, *args)
    PythonRTP().rewrite_vp8_batch(buf_b, offsets, lengths, *args)
    assert bytes(buf_a) == bytes(buf_b)


def test_fuzz_agreement():
    """Random bytes: native and Python must classify identically (no
    crashes, no disagreement on validity)."""
    rng = np.random.default_rng(0)
    pkts = [bytes(rng.integers(0, 256, rng.integers(0, 60), dtype=np.uint8).tobytes()) for _ in range(100)]
    a, b = parse_both(pkts, audio_level_ext=1, vp8_pts={96})
    assert bytes(a.tobytes()) == bytes(b.tobytes())


def _seeded_packets(rng, n=60):
    pkts = []
    for i in range(n):
        if rng.random() < 0.5:
            pay = vp8_payload(
                pid=int(rng.integers(0, 0x7FFF)) if rng.random() < 0.8 else None,
                tl0=int(rng.integers(0, 255)) if rng.random() < 0.7 else None,
                tid=int(rng.integers(0, 3)) if rng.random() < 0.7 else None,
                keyidx=int(rng.integers(0, 31)) if rng.random() < 0.5 else None,
                keyframe=bool(rng.random() < 0.3))
            pkts.append(rtp_packet(sn=i, ts=i * 90, ssrc=5, pt=96, payload=pay,
                                   marker=int(rng.random() < 0.3)))
        else:
            pkts.append(rtp_packet(sn=i, ts=i * 960, ssrc=6, pt=111,
                                   audio_level=int(rng.integers(0, 127)),
                                   padding=int(rng.integers(0, 3)) * 4))
    offs = np.cumsum([0] + [len(p) for p in pkts[:-1]]).astype(np.int32)
    lens = np.asarray([len(p) for p in pkts], np.int32)
    return pkts, offs, lens


def _munge_inputs(rng, R, T, K, S):
    W = (S + 31) // 32
    valid = rng.random((R, T, K)) < 0.8
    bits = lambda p: np.where(  # noqa: E731
        valid[..., None], rng.integers(0, 1 << 31, (R, T, K, W)) & (
            rng.random((R, T, K, W)) < p), 0).astype(np.int32)
    return dict(
        sn=rng.integers(0, 1 << 16, (R, T, K)).astype(np.int32),
        ts=rng.integers(-(1 << 31), 1 << 31, (R, T, K)).astype(np.int32),
        ts_jump=np.where(rng.random((R, T, K)) < 0.5, -1, 3000).astype(np.int32),
        pid=rng.integers(0, 1 << 15, (R, T, K)).astype(np.int32),
        tl0=rng.integers(0, 256, (R, T, K)).astype(np.int32),
        keyidx=rng.integers(0, 32, (R, T, K)).astype(np.int32),
        begin_pic=rng.random((R, T, K)) < 0.5, valid=valid,
        send_bits=bits(0.7), drop_bits=bits(0.2), switch_bits=bits(0.1),
    )


def test_port_libraries_match_jax_package_libraries():
    """Same seeded packets and masks through the port's libraries and the
    JAX package's: every output array equal; the port's walker (single
    and sharded) equal to the port's numpy munge path, state included."""
    rng = np.random.default_rng(11)
    pkts, offs, lens = _seeded_packets(rng)
    blob = b"".join(pkts)
    kw = dict(audio_level_ext=1, vp8_pts={96}, dd_ext_id=8, vp9_pts={98}, h264_pts={100})
    got = rtp.parse_batch(blob, offs, lens, **kw)
    assert got.tobytes() == jax_native.rtp.parse_batch(blob, offs, lens, **kw).tobytes()
    assert got.tobytes() == PythonRTP().parse_batch(blob, offs, lens, **kw).tobytes()
    n = len(pkts)
    args = (rng.integers(0, 1 << 16, n).astype(np.uint16),
            rng.integers(0, 1 << 32, n).astype(np.uint32),
            rng.integers(0, 1 << 32, n).astype(np.uint32))
    a, b = bytearray(blob), bytearray(blob)
    rtp.rewrite_batch(a, offs, *args)
    jax_native.rtp.rewrite_batch(b, offs, *args)
    assert a == b
    vargs = (*args, rng.integers(-1, 0x7FFF, n).astype(np.int32),
             rng.integers(-1, 255, n).astype(np.int32),
             rng.integers(-1, 31, n).astype(np.int32),
             (rng.random(n) < 0.7).astype(np.uint8))
    a, b = bytearray(blob), bytearray(blob)
    rtp.rewrite_vp8_batch(a, offs, lens, *vargs)
    jax_native.rtp.rewrite_vp8_batch(b, offs, lens, *vargs)
    assert a == b

    R, T, K, S = 6, 3, 4, 37
    dims = plane.PlaneDims(R, T, K, S)
    ours, theirs, plain, sharded = (HostMunger(dims),
                                    JaxMunger(jax_plane.PlaneDims(R, T, K, S)),
                                    HostMunger(dims), HostMunger(dims))
    for tick in range(6):
        inp = _munge_inputs(rng, R, T, K, S)
        cols = list(inp.values())
        cap = int(sum(bin(int(w) & 0xFFFFFFFF).count("1")
                      for w in inp["send_bits"].ravel()))
        want = jax_native.munge.walk(*cols, theirs, cap)
        assert want is not None
        for got_cols in (native.munge.walk(*cols, ours, cap),
                         plain.apply_columns_plain(*cols),
                         native.munge.walk_multi(*cols, sharded, cap, np.array([0, 2, 5]),
                                                 np.array([2, 5, 6]))[0]):
            assert len(got_cols) == 9
            for g, w in zip(got_cols, want):
                np.testing.assert_array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))
        for name in HostMunger.FIELDS:
            for m in (ours, plain, sharded):
                np.testing.assert_array_equal(getattr(m, name), getattr(theirs, name),
                                              err_msg=f"tick {tick}: {name}")
