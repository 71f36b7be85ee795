"""The native bindings the bench needs and the egress plane's microbench
(livekit_server_tpu_torch/native `send_raw`, `pool_size`,
`gather_ranges`, `native_smoke`; runtime/egress_plane.py `bench_plane`,
`bench_plane_scaling`):

* `native_smoke()` builds, loads and self-tests every native library, []
  when clean;
* `send_raw` puts the same bytes on a loopback socket;
* the native `gather_ranges` (the ingest's payload gather) equals the
  numpy form on random ranges, empty ones included;
* `bench_plane` at a tiny shape: entries a call and the grouped share
  equal the JAX package's `bench_plane` on the same arguments, pps > 0,
  every shard built;
* `bench_plane_scaling`: one point a shard count with its pool size.

(A file of its own: tests/test_torch_egress_plane.py already holds the
nine-or-fewer items a port file keeps.)
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch import native  # noqa: E402
from livekit_server_tpu_torch.runtime import ingest  # noqa: E402
from livekit_server_tpu_torch.runtime.egress_plane import (  # noqa: E402
    EgressPlane,
    bench_plane,
    bench_plane_scaling,
)

SHAPE = dict(n_rooms=4, subs_per_room=3, tracks=2, pkts=3)


def test_native_smoke_is_clean():
    assert native.native_smoke() == []
    assert native.rtp.native and native.egress is not None


def test_send_raw_delivers_the_same_bytes():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(5.0)
        tx.bind(("127.0.0.1", 0))
        port = rx.getsockname()[1]
        frames = [bytes([i]) * (20 + 37 * i) for i in range(6)]
        blob = np.frombuffer(b"".join(frames), np.uint8)
        lens = np.array([len(f) for f in frames], np.int32)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        n = native.egress.send_raw(tx.fileno(), blob, offs, lens,
                                   np.full(len(frames), 0x7F000001, np.uint32),
                                   np.full(len(frames), port, np.uint16))
        assert n == len(frames)
        got = [rx.recv(2048) for _ in frames]
        assert got == frames
        assert native.egress.send_raw(-1, blob, offs, lens, np.zeros(6, np.uint32),
                                      np.zeros(6, np.uint16)) == 0
    finally:
        rx.close()
        tx.close()


def test_gather_ranges_native_equals_numpy():
    rng = np.random.default_rng(11)
    blob = rng.integers(0, 256, 4096, np.uint8)
    for n in (0, 1, 7, 300):
        starts = rng.integers(0, 3000, n).astype(np.int64)
        lens = rng.integers(0, 90, n).astype(np.int64)
        if n:
            lens[0] = 0                                   # an empty range
        want = ingest._gather_ranges_plain(blob, starts, lens)
        assert native.rtp.gather_ranges(blob, starts, lens) == want
        assert ingest._gather_ranges(blob, starts, lens) == want
        assert want == b"".join(bytes(blob[s:s + ln]) for s, ln in zip(starts, lens))


@pytest.mark.parametrize("sealed", [False, True])
def test_bench_plane_matches_reference(sealed):
    from livekit_server_tpu.runtime.egress_plane import (
        EgressPlane as JaxPlane,
        bench_plane as jax_bench_plane,
    )

    kw = dict(payload_len=160, sealed=sealed, seconds=0.1, **SHAPE)
    got = bench_plane(EgressPlane(2), **kw)
    # One shard on the reference's side: its native pool keeps the shard
    # race the port fixed (ROADMAP C12), and the plan's shape does not
    # change what is compared.
    want = jax_bench_plane(JaxPlane(1), **kw)
    assert "error" not in got and "error" not in want, (got, want)
    for key in ("entries_per_call", "grouped_pct", "sealed", "bytes_per_dgram"):
        assert got[key] == want[key], key
    assert got["pps"] > 0 and got["datagrams"] == got["iters"] * got["entries_per_call"]
    assert len(got["shard_built"]) == 2 and all(got["shard_built"])
    assert sum(got["shard_built"]) == got["datagrams"]


def test_bench_plane_scaling_reports_each_point():
    res = bench_plane_scaling(payload_len=160, seconds_per_point=0.05, max_shards=3, **SHAPE)
    assert "error" not in res, res
    assert [p["shards"] for p in res["points"]] == [1, 2, 3]
    for p in res["points"]:
        assert p["pps"] > 0
        assert len(p["shard_built"]) == p["shards"] and all(p["shard_built"])
        assert p["pool_size"] >= p["shards"] or p["shards"] == 1
    assert res["speedup"][0] == 1.0 and res["cores"] >= 1
