"""Room and page shards of the port on the card: N shards on one CUDA
device (the card's machine has one GPU) against the unsharded tick on the
same device and inputs.

This file imports neither jax nor the JAX package, so it runs on the
card's machine with the JAX-based conftest skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_parallel_card.py

Every test here is marked `cuda` and skips without a card. Integer and
bool leaves must be equal; float leaves within `plane.float_tolerance`
of the leaf (a shard's phase-1 reductions run at another batch size,
which may pick another reduction order). The CPU parity tests against the
JAX package are tests/test_torch_parallel*.py.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import asyncio  # noqa: E402

import numpy as np  # noqa: E402
from torch_kernel_fixture import card  # noqa: E402, F401 (a fixture)
from torch_paged_fixture import DIMS as PAGED_DIMS, control, inputs, table_arrays  # noqa: E402
from torch_paged_fixture import port_inputs, with_control  # noqa: E402

from livekit_server_tpu_torch.models import paged, plane, synth  # noqa: E402
from livekit_server_tpu_torch.ops import cuda  # noqa: E402
from livekit_server_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from livekit_server_tpu_torch.runtime import PlaneRuntime  # noqa: E402
from livekit_server_tpu_torch.runtime.ingest import PacketIn  # noqa: E402

DIMS = plane.PlaneDims(64, 10, 8, 10)


def _match(got, want, names, where):
    for name, a, b in zip(names, got, want):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, (where, name)
        if b.dtype.kind == "f":
            rtol, atol = plane.float_tolerance(name)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{where} {name}")
        else:
            assert np.array_equal(a, b), (where, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_tick_on_the_card(card, n):
    """N shards of cuda:0 stepped 4 ticks against the unsharded device
    step; B1 and B2 launch once per shard a tick."""
    spec = synth.TrafficSpec(video_tracks=2, audio_tracks=2, svc=True)
    state = synth.make_state(DIMS, spec, device=card)
    mesh = tmesh.make_mesh([card] * n)
    sh = tmesh.shard_tree(state, mesh)
    tick = tmesh.make_sharded_tick(mesh, donate=True)
    traffic = synth.init_traffic(DIMS, spec, seed=5)
    names = plane.leaf_names(state)
    for i in range(4):
        traffic, inp = synth.next_tick(traffic, DIMS, spec, i, seed=5)
        packed = plane.pack_tick_inputs(inp)
        state, want = plane.device_tick(state, plane.wire_inputs(packed), DIMS)
        before = dict(cuda.launches)
        sh, got = tick.device_tick(sh, tmesh.shard_wires(packed, mesh), DIMS)
        assert cuda.launches["decide_rooms"] == before["decide_rooms"] + n
        assert cuda.launches["allocate_budget_rooms"] == before["allocate_budget_rooms"] + n
        _match(got, want, plane.TickOutputs._fields, i)
    _match(plane.tree_leaves(tmesh.gather_tree(sh)), plane.tree_leaves(state), names, "state")


@pytest.mark.cuda
def test_sharded_pool_tick_on_the_card(card):
    """The stock pooled tick over 8 page shards of cuda:0 against the
    unsharded stock tick, 3 ticks; the halo pages are counted."""
    rp, tm, room, tp, sp, live, _, _ = table_arrays()
    rp = np.full((8, rp.shape[1]), -1, np.int32)
    table = paged.PageTable(*(torch.from_numpy(x).to(card) for x in (rp, tm, room, tp, sp)))
    rng = np.random.default_rng(31)
    pd = paged.PagedDims(**PAGED_DIMS)
    state = with_control(plane.init_state(pd.pooled(), device=card), control(rng, live),
                         lambda a: torch.from_numpy(a).to(card))
    mesh = tmesh.make_mesh([card] * 8)
    sh, sh_table = tmesh.shard_pool(state, mesh), tmesh.shard_pool(table, mesh)
    tick = tmesh.ShardedPoolTick(mesh)
    for t in range(3):
        inp = plane.tree_map(lambda x: x.to(card), port_inputs(inputs(rng, live)))
        state, want = paged.paged_plane_tick(state, inp, table)
        sh, got = tick(sh, tmesh.shard_pool(inp, mesh), sh_table)
        _match(got, want, plane.TickOutputs._fields, t)
    _match(plane.tree_leaves(tmesh.gather_tree(sh)), plane.tree_leaves(state),
           plane.leaf_names(state), "state")
    assert tick.cross_shard_pages == 12


@pytest.mark.cuda
def test_meshed_runtime_on_the_card(card):
    """A PlaneRuntime over 4 shards of cuda:0 forwards what the unsharded
    card runtime forwards, tick for tick; a device that is not visible
    raises instead of falling back. (asyncio.run: the file runs without
    the conftest's async support on the card's machine.)"""
    with pytest.raises(ValueError, match="not visible"):
        tmesh.make_mesh([f"cuda:{torch.cuda.device_count()}"])
    dims = plane.PlaneDims(8, 2, 4, 2)

    async def run():
        rts = [PlaneRuntime(dims, tick_ms=10, egress_shards=1,
                            mesh=tmesh.make_mesh([card] * 4)),
               PlaneRuntime(dims, tick_ms=10, egress_shards=1, device=card)]
        try:
            for rt in rts:
                for r in (0, 3, 7):
                    rt.set_track(r, 0, published=True, is_video=False)
                    rt.set_subscription(r, 0, 1, subscribed=True)
            for i in range(4):
                res = []
                for rt in rts:
                    for r in (0, 3, 7):
                        rt.ingest.push(PacketIn(room=r, track=0, sn=100 + i, ts=960 * i,
                                                size=40, payload=bytes([r]) * 40))
                    res.append(await rt.step_once())
                assert [(p.room, p.sub, p.sn) for p in res[0].egress] == \
                    [(p.room, p.sub, p.sn) for p in res[1].egress]
                assert len(res[0].egress) == 3
        finally:
            for rt in rts:
                await rt.stop()

    asyncio.run(run())
