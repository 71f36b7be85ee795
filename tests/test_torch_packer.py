"""The port's MessagePack codec (livekit_server_tpu_torch/protocol/packer.py)
against the `msgpack` package the JAX package uses: byte-identical to
msgpack.packb(..., use_bin_type=True) on the WS media frames and the
binary signal frames, and decoding what msgpack.unpackb(raw=False)
decodes."""

import msgpack
import pytest
from hypothesis import given, settings, strategies as st

from livekit_server_tpu.protocol import models as jpm
from livekit_server_tpu.protocol import signal as jsignal
from livekit_server_tpu_torch.protocol import packer, signal as tsignal

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers.
torch.set_num_threads(1)


def _ref(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _media(payload: bytes, sn: int, ts: int, sid: str = "TR_abcDEF123456") -> dict:
    """The frame RoomManager._attach_media_queue writes."""
    return {"track_sid": sid, "sn": sn, "ts": ts, "pid": 7, "tl0": 255,
            "keyidx": 3, "payload": payload}


def test_media_frames_are_byte_identical():
    for payload, sn, ts in ((b"", 0, 0), (b"\x00" * 31, 127, 128),
                            (b"\xff" * 255, 255, 65535), (bytes(range(256)), 65535, 2**32 - 1),
                            (b"v" * 70000, 40000, 2**31)):
        frame = _media(payload, sn, ts)
        raw = packer.packb(frame)
        assert raw == _ref(frame)
        assert packer.unpackb(raw) == msgpack.unpackb(raw, raw=False) == frame


def test_binary_signal_frames_match_the_reference():
    """The port's binary signal framing (0x00 | [kind_id, data]) gives the
    JAX package's bytes and decodes them back."""
    info = jpm.TrackInfo(sid="TR_x", type=jpm.TrackType.VIDEO, name="cam",
                         layers=[jpm.SimulcastLayer(quality=jpm.VideoQuality.HIGH,
                                                    width=1280, height=720)])
    requests = [
        ("add_track", {"cid": "c1", "type": 1, "name": "cam", "mime_type": "video/vp9",
                       "layers": [{"quality": 2, "width": 1280, "height": 720}]}),
        ("mute", {"sid": "TR_x", "muted": True}),
        ("ping", {"timestamp": 1_700_000_000_123}),
        ("leave", {}),
    ]
    responses = [
        ("track_published", {"cid": "c1", "track": info.to_dict()}),
        ("speakers_changed", {"speakers": [{"sid": "PA_a", "level": 0.625, "active": True}]}),
        ("connection_quality", {"updates": [{"participant_sid": "PA_a", "quality": 2,
                                             "score": 4.3125}]}),
        ("pong", {"last_ping_timestamp": -1, "timestamp": 2**40}),
    ]
    for kind, data in requests:
        want = jsignal.encode_signal_request_bin(jsignal.SignalRequest(kind, data))
        got = tsignal.encode_signal_request_bin(tsignal.SignalRequest(kind, data))
        assert got == want
        back = tsignal.decode_signal_request_bin(want)
        assert (back.kind, back.data) == (kind, data)
    for kind, data in responses:
        want = jsignal.encode_signal_response_bin(jsignal.SignalResponse(kind, data))
        got = tsignal.encode_signal_response_bin(tsignal.SignalResponse(kind, data))
        assert got == want
        back = tsignal.decode_signal_response_bin(want)
        assert (back.kind, back.data) == (kind, data)


def test_int_encodings_at_every_width_boundary():
    for x in (0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
              -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63):
        assert packer.packb(x) == _ref(x), x
        assert packer.unpackb(_ref(x)) == x


def test_sized_headers_at_every_length_boundary():
    for n in (0, 15, 16, 31, 32, 255, 256, 65535, 65536):
        for obj in ("s" * n, b"b" * n, list(range(n)), {str(i): i for i in range(n)}):
            assert packer.packb(obj) == _ref(obj), (type(obj).__name__, n)
    assert packer.packb((1, 2)) == _ref((1, 2))      # tuples pack as arrays
    assert packer.packb(bytearray(b"ab")) == _ref(bytearray(b"ab"))


def test_decoder_reads_float32_and_refuses_bad_input():
    assert packer.unpackb(msgpack.packb(1.25, use_single_float=True)) == 1.25
    assert packer.unpackb(_ref(-0.5)) == -0.5
    for bad in (b"", b"\x91", b"\x92\x01", b"\x01\x02", b"\xc1", b"\xd9\x05ab",
                b"\x81\x01\x02", b"\xa2\xff\xfe", b"\xd4\x01\x00"):
        with pytest.raises(ValueError):
            packer.unpackb(bad)
    with pytest.raises(TypeError):
        packer.packb({"x": object()})
    with pytest.raises(OverflowError):
        packer.packb(2**64)


_leaf = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
         | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
_tree = st.recursive(
    _leaf,
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=12), kids, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None, database=None)
@given(_tree)
def test_round_trip_matches_msgpack(obj):
    raw = packer.packb(obj)
    assert raw == _ref(obj)
    assert packer.unpackb(raw) == msgpack.unpackb(raw, raw=False)
