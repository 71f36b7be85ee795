"""The port's trace export (livekit_server_tpu_torch/telemetry/trace_export.py)
and /debug/trace: the reference's export tests on the port's ring (schema,
span inventory, lanes, the validator rejecting broken traces, the
self-test on the CPU), the port's Chrome events equal to the JAX
package's on the same ring records, /debug/trace through the port's
aiohttp server on the CPU, its 400 on a bad `ticks` included, and the
trace CLI's `--url` fetch (`tools.trace`) against a local http.server
serving a saved export, and against a refused connection."""

import json

import aiohttp
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the planes here are small.
torch.set_num_threads(1)

from livekit_server_tpu.telemetry import trace_export as jax_export  # noqa: E402
from livekit_server_tpu_torch.config import load_config  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402
from livekit_server_tpu_torch.runtime.trace import TickTraceRing  # noqa: E402
from livekit_server_tpu_torch.service.server import create_server  # noqa: E402
from livekit_server_tpu_torch.telemetry import trace_export  # noqa: E402
from torch_trace_fixture import stage_rows  # noqa: E402


def _record(ring: TickTraceRing, idx: int, base: float = 100.0) -> int:
    """One well-formed tick record at a synthetic perf_counter base."""
    t = base + idx * 0.005
    t0, dur = stage_rows(stage=(t + 0.0001, 0.001), retier=(0.0, 0.0002),
                         upload=(t + 0.0012, 0.0003), device_step=(t + 0.0016, 0.002),
                         fanout=(t + 0.0037, 0.0008), send=(0.0, 0.0004),
                         kernel=(0.0, 0.0005 * (idx % 2)))
    return ring.record_tick(idx=idx, edge=t, t0=t0, dur=dur, wake_over_us=42.0, depth=1,
                            late=(idx % 7 == 0))


def _ring_records(n_ticks: int = 5) -> list[dict]:
    ring = TickTraceRing(cap=64)
    for i in range(n_ticks):
        slot = _record(ring, i)
        ring.set_shard(slot, 0, 0.2, 0.1)
        ring.set_shard(slot, 1, 0.15, 0.05)
    return ring.snapshot()


def _synthetic_events(n_ticks: int = 5):
    return trace_export.to_chrome(_ring_records(n_ticks), tick_ms=5)


def test_export_schema_valid_and_json_clean():
    events = _synthetic_events()
    assert trace_export.validate(events) == []
    doc = json.loads(trace_export.export_json([], 5))
    assert doc["traceEvents"] == []


def test_export_span_inventory():
    events = _synthetic_events()
    names = {e["name"] for e in events}
    for want in ("tick_edge", "stage_host", "express_retier", "ctrl_upload",
                 "device_step", "paged_kernel", "fan_out", "egress_send", "munge",
                 "send", "thread_name"):
        assert want in names, want
    # every X event carries µs ts/dur and the shared pid
    for e in events:
        if e["ph"] == "X":
            assert e["pid"] == 1 and e["ts"] >= 0 and e["dur"] >= 0


def test_export_lane_assignment():
    events = _synthetic_events()
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], set()).add(e["tid"])
    assert by_name["stage_host"] == {trace_export.TID_LOOP}
    assert by_name["device_step"] == {trace_export.TID_DEVICE}
    assert by_name["fan_out"] == {trace_export.TID_FANOUT}
    assert by_name["munge"] == {trace_export.TID_SHARD0, trace_export.TID_SHARD0 + 1}


def test_validate_rejects_broken_traces():
    assert trace_export.validate([{"ph": "X", "pid": 1, "tid": 1}])
    assert trace_export.validate(
        [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": -1.0}])
    # partial overlap on one lane is a nesting violation
    bad = [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 5.0, "dur": 10.0},
    ]
    assert any("overlaps" in p for p in trace_export.validate(bad))
    # containment is fine
    ok = [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"name": "b", "ph": "X", "pid": 1, "tid": 1, "ts": 2.0, "dur": 3.0},
    ]
    assert trace_export.validate(ok) == []


def test_selftest_end_to_end_on_the_cpu():
    assert trace_export.selftest(ticks=4, device="cpu") == []


def test_to_chrome_equal_to_reference():
    """The same ring records render to the same events in both packages;
    the empty window too."""
    records = _ring_records(9)
    assert trace_export.to_chrome(records, 5) == jax_export.to_chrome(records, 5)
    assert trace_export.export_json(records, 5) == jax_export.export_json(records, 5)
    assert trace_export.to_chrome([], 5) == jax_export.to_chrome([], 5) == []


async def test_debug_trace_route():
    """/debug/trace on the port's server: the newest `ticks` ticks of the
    ring as valid Chrome events with the wire-stage sidecar, and a 400 for
    a `ticks` that is not an integer. The server listens on an ephemeral
    port (port 0), read back from its runner."""
    cfg = load_config(base={
        "keys": {"k": "s"}, "port": 0, "bind_addresses": ["127.0.0.1"],
        "plane": {"rooms": 2, "tracks_per_room": 2, "pkts_per_track": 2,
                  "subs_per_room": 2, "tick_ms": 10},
        "rtc": {"udp_port": 0, "tcp_port": 0}, "egress": {"shards": 1},
        "limits": {"governor_enabled": False},
    }, env={})
    srv = create_server(cfg, device="cpu")
    await srv.start()
    try:
        rt = srv.room_manager.runtime
        await rt.stop()                 # step by hand: a known tick count
        rt.set_track(0, 0, published=True, is_video=False)
        rt.set_subscription(0, 0, 1, subscribed=True)
        for k in range(6):
            rt.ingest.push(PacketIn(room=0, track=0, sn=100 + k, ts=960 * k, size=8,
                                    payload=b"p" * 8))
            await rt.step_once()
        port = srv._runner.addresses[0][1]
        base = f"http://127.0.0.1:{port}/debug/trace"
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{base}?ticks=4") as r:
                assert r.status == 200
                body = await r.json()
            async with s.get(f"{base}?ticks=four") as r:
                assert r.status == 400
                assert "integer" in (await r.json())["error"]
        events = body["traceEvents"]
        assert body["displayTimeUnit"] == "ms"
        assert trace_export.validate(events) == []
        assert sorted({e["args"]["tick"] for e in events if e["name"] == "device_step"}) \
            == [r["tick"] for r in rt.trace.snapshot(4)]
        assert "wire_stages" in body["otherData"]
        assert events == trace_export.to_chrome(rt.trace.snapshot(4), rt.tick_ms)
    finally:
        await srv.stop(force=True)


def _serve_once(doc: dict):
    """A local http.server answering /debug/trace with `doc`; returns
    (server, the paths it was asked for)."""
    import http.server
    import threading

    body = json.dumps(doc).encode()
    asked: list[str] = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            asked.append(self.path)
            self.send_response(200 if self.path.startswith("/debug/trace") else 404)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, asked


def test_url_fetch_writes_the_file(tmp_path, capsys):
    from livekit_server_tpu_torch.tools import trace as trace_cli

    doc = json.loads(trace_export.export_json(_ring_records(6), 5))
    doc.setdefault("otherData", {})["wire_stages"] = {
        "device": {"p50_ms": 1.5, "p99_ms": 3.0, "n": 12}}
    srv, asked = _serve_once(doc)
    try:
        out = tmp_path / "t.json"
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        assert trace_cli.main(["--url", url, "--ticks", "6", "-o", str(out)]) == 0
    finally:
        srv.shutdown()
        srv.server_close()
    assert asked == ["/debug/trace?ticks=6"]
    assert json.loads(out.read_text()) == doc
    printed = capsys.readouterr().out
    assert f"{len(doc['traceEvents'])} events" in printed and "device" in printed
    assert trace_export.main(["--validate", str(out)]) == 0


def test_url_fetch_refused_exits_1(tmp_path):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                                # nothing listens there now
    out = tmp_path / "t.json"
    assert trace_export.main(["--url", f"http://127.0.0.1:{port}", "-o", str(out)]) == 1
    assert not out.exists()
    assert trace_export.main([]) == 2         # no action: usage
