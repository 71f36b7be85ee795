"""The port's rtc layer over its PagedPlaneRuntime(device="cpu") against
the JAX package's over the JAX PagedPlaneRuntime: the paged run of
tests/test_torch_rtc.py (the same script, comparison and tolerances), in
a file of its own so that its JAX paged compile, the heaviest of that
file, queues last under `--dist loadfile`."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from livekit_server_tpu.models import paged as jpaged  # noqa: E402
from livekit_server_tpu.runtime.paged_runtime import PagedPlaneRuntime as JPaged  # noqa: E402
from livekit_server_tpu_torch.models import paged as tpaged  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime as TPaged  # noqa: E402
from tests.test_torch_rtc import JAX, PORT, TICK_MS, _compare, _run  # noqa: E402

PAGED = dict(rooms=2, tracks=4, pkts=4, subs=8, tpage=2, spage=4, pool_pages=16)


async def test_rtc_layer_matches_reference_paged(monkeypatch):
    jrt = JPaged(jpaged.PagedDims(**PAGED), tick_ms=TICK_MS, paged_kernel="on")
    trt = TPaged(tpaged.PagedDims(**PAGED), tick_ms=TICK_MS, paged_kernel="on", egress_shards=1,
                 device="cpu")
    _compare(await _run(JAX, jrt, monkeypatch), await _run(PORT, trt, monkeypatch))
