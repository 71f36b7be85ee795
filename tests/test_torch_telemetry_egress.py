"""The egress plane's metrics in /metrics against the JAX package's: both
packages' RoomManagers, each with a TelemetryService, built, joined and
fed as in tests/test_torch_express_rm_parity.py (the express lane on,
seeded sealed VP8 simulcast and Opus, a virtual clock and seeded
`secrets`), stepped by hand for the same ticks. In the two renders of
`prometheus_text()` the `livekit_egress_*` and `livekit_host_egress_pps`
families carry the same label sets, the count-valued gauges (entries,
grouped entries, datagrams, express datagrams, sent per shard, shards)
are equal, and the ms-valued gauges and the pps are present and not
negative. Its own file: one test, one JAX tick compile.

The reference runs on its native egress library, as its served path does
(`reference_on_native_egress`): without it the JAX transport sends
through its pure-Python path, which counts no datagrams in the egress
plane, and the counts could not agree.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu import native as jnative  # noqa: E402
from livekit_server_tpu.runtime import crypto as jcrypto, udp as judp  # noqa: E402
from livekit_server_tpu.telemetry.service import TelemetryService as JTelemetry  # noqa: E402
from livekit_server_tpu_torch.runtime import crypto as tcrypto, udp as tudp  # noqa: E402
from livekit_server_tpu_torch.telemetry.service import TelemetryService as TTelemetry  # noqa: E402
from tests.test_torch_express_rm_parity import TICK_MS, Node  # noqa: E402
from tests.test_torch_udp_parity import Clock, install  # noqa: E402
from tests.torch_udp_fixture import until  # noqa: E402

TICKS = 12
COUNTS = ("livekit_egress_shards", "livekit_egress_entries_total",
          "livekit_egress_grouped_entries_total", "livekit_egress_datagrams_total",
          "livekit_egress_express_datagrams_total", "livekit_egress_shard_sent_total")
TIMES = ("livekit_host_egress_pps", "livekit_egress_send_ms_total",
         "livekit_egress_munge_ms_total", "livekit_egress_shard_busy_ms_total")


def reference_on_native_egress(monkeypatch) -> None:
    """Bind the JAX transport to its native egress (and munge) library
    where this process loaded none. On a fresh checkout parallel test
    workers build the JAX package's libraries into the same files at once,
    writing them in place; a worker that imported the package while a
    file was half written falls back to the pure-Python paths for its
    life. Load again, once the build is whole."""
    for _ in range(3):
        if judp.native_egress is not None:
            break
        lib = jnative._load_egress()
        if lib is not None:
            monkeypatch.setattr(judp, "native_egress", lib)
            monkeypatch.setattr(jnative, "egress", lib)
        else:
            time.sleep(1.0)
    assert judp.native_egress is not None, "the JAX package's native egress did not load"
    if jnative.munge is None:
        monkeypatch.setattr(jnative, "munge", jnative._load_munge())


def egress_samples(text: str) -> dict:
    """{(family, labels): value} of the egress plane's families."""
    out = {}
    for line in text.splitlines():
        if line.startswith(("livekit_egress_", "livekit_host_egress_pps")):
            key, value = line.rsplit(" ", 1)
            name, _, labels = key.partition("{")
            out[(name, labels.rstrip("}"))] = float(value)
    return out


async def test_egress_metrics_match_reference(monkeypatch):
    clock = Clock()
    reference_on_native_egress(monkeypatch)
    install(monkeypatch, judp, jcrypto, clock)
    ref = Node("jax")
    ref.rm.telemetry = JTelemetry(ref.cfg)
    await ref.start()
    install(monkeypatch, tudp, tcrypto, clock)
    port = Node("port")
    port.rm.telemetry = TTelemetry(port.cfg)
    await port.start()
    try:
        for tick in range(TICKS):
            clock.ms = float(tick * TICK_MS)
            for node in (ref, port):
                await node.publish(tick)
                await node.rt.step_once()
            await until(lambda: ref.udp.stats["tx"] == port.udp.stats["tx"], "equal tx")
        jm = egress_samples(ref.rm.telemetry.prometheus_text())
        tm = egress_samples(port.rm.telemetry.prometheus_text())
        assert tm.keys() == jm.keys()
        assert {name for name, _ in tm} == set(COUNTS + TIMES)
        for (name, labels), value in jm.items():
            if name in COUNTS:
                assert tm[(name, labels)] == value, (name, labels)
            else:
                assert tm[(name, labels)] >= 0.0 and np.isfinite(tm[(name, labels)])
        assert tm[("livekit_egress_datagrams_total", "")] > 0
        assert tm[("livekit_egress_express_datagrams_total", "")] > 0
    finally:
        await ref.close()
        await port.close()
