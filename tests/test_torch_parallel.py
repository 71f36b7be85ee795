"""Room shards of the port (livekit_server_tpu_torch.parallel) against the
JAX package's mesh, on 8 CPU shards: the counterpart of
tests/test_parallel.py.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's
mesh is `[torch.device("cpu")] * 8`, eight shards on one device, which
is the same mechanism as eight cards. The same seeded inputs go into
both. Integer and bool leaves must be equal; float leaves within
`plane.float_tolerance` of the leaf (rtol=1e-5, atol=1e-2 for byte and
bit-rate leaves, 1e-6 for the rest: XLA contracts multiply-adds where
torch does not; tests/test_torch_plane.py gives the reasons). The port's
sharded tick against its own unsharded tick is held to bit equality:
the same torch ops run on the same rows.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch_paged_fixture as fx  # noqa: E402

from livekit_server_tpu.models import paged as jpaged, plane as jplane  # noqa: E402
from livekit_server_tpu.models import synth as jsynth  # noqa: E402
from livekit_server_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from livekit_server_tpu.parallel import make_sharded_tick as jmake_sharded_tick  # noqa: E402
from livekit_server_tpu.parallel import shard_tree as jshard_tree  # noqa: E402
from livekit_server_tpu.parallel.mesh import shard_pool as jshard_pool  # noqa: E402
from livekit_server_tpu_torch.models import paged as tpaged, plane as tplane  # noqa: E402
from livekit_server_tpu_torch.parallel import mesh as tmesh  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= 8, "conftest must force 8 virtual CPU devices"
    return jmake_mesh(n_devices=8)


@pytest.fixture(scope="module")
def jtick(jmesh):
    # One sharded tick for the file: it compiles once per input shape.
    return jmake_sharded_tick(jmesh, donate=False)


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh([CPU] * 8)


def _assert_match(port, ref, names, where):
    for name, p, r in zip(names, port, ref):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, (where, name)
        if r.dtype.kind == "f":
            rtol, atol = tplane.float_tolerance(name)
            np.testing.assert_allclose(p, r, rtol=rtol, atol=atol, err_msg=f"{where} {name}")
        else:
            assert np.array_equal(p, r.astype(p.dtype)), (where, name)


def _assert_equal(a, b, where):
    for x, y in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), where


def _setup(dims, spec_kw):
    """(JAX state, the port's state from the same leaves, both packages'
    traffic specs)."""
    jspec = jsynth.TrafficSpec(**spec_kw)
    js = jsynth.make_state(dims, jspec)
    ts = tplane.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)], device="cpu")
    return js, ts, jspec


def test_sharded_tick_matches_single_device(jmesh, jtick, mesh):
    """One tick at 16 rooms (2 a shard): the port's sharded tick equals
    the JAX sharded tick, and bit for bit the port's unsharded tick."""
    dims = jplane.PlaneDims(rooms=16, tracks=4, pkts=8, subs=4)
    js, ts, jspec = _setup(dims, dict(video_tracks=2, audio_tracks=2))
    traffic = jsynth.init_traffic(dims, jspec, seed=3)
    _, inp = jsynth.next_tick(traffic, dims, jspec, tick_index=5, seed=3)
    j_state, j_out = jtick(jshard_tree(js, jmesh), jshard_tree(jax.tree.map(jnp.asarray, inp),
                                                                 jmesh))
    t_inp = tplane.inputs_to_device(inp, "cpu")
    tick = tmesh.make_sharded_tick(mesh, donate=False)
    sh_in = tmesh.shard_tree(ts, mesh)
    sh_state, out = tick(sh_in, tmesh.shard_tree(t_inp, mesh))
    new_state = tmesh.gather_tree(sh_state)
    names = tplane.leaf_names(new_state)
    _assert_match(list(out), list(j_out), tplane.TickOutputs._fields, "outputs")
    _assert_match(tplane.tree_leaves(new_state), jax.tree.leaves(j_state), names, "state")
    u_state, u_out = tplane.media_plane_tick(ts, t_inp)
    _assert_equal(out, u_out, "outputs vs unsharded")
    _assert_equal(tplane.tree_leaves(new_state), tplane.tree_leaves(u_state), "state")
    # Without donate the state given is left as it was.
    _assert_equal(tplane.tree_leaves(tmesh.gather_tree(sh_in)), tplane.tree_leaves(ts), "in")
    assert int(out.fwd_packets.sum()) > 0


def test_multitick_sharded_run(jmesh, jtick, mesh):
    """Five ticks at 8 rooms (1 a shard), the port's state donated (written
    in place) and carried, each tick against the JAX sharded run and the
    port's unsharded device step (`device_tick`, the runtime's path)."""
    dims = jplane.PlaneDims(rooms=8, tracks=4, pkts=8, subs=4)
    tdims = tplane.PlaneDims(*dims)
    js, ts, jspec = _setup(dims, dict(video_tracks=2, audio_tracks=2))
    j_state = jshard_tree(js, jmesh)
    sh = tmesh.shard_tree(ts, mesh)
    leaves_before = [x.data_ptr() for x in tplane.tree_leaves(sh.shards[3])]
    tick = tmesh.make_sharded_tick(mesh, donate=True)
    traffic = jsynth.init_traffic(dims, jspec)
    total = 0
    for i in range(5):
        traffic, inp = jsynth.next_tick(traffic, dims, jspec, tick_index=i)
        j_state, j_out = jtick(j_state, jshard_tree(jax.tree.map(jnp.asarray, inp), jmesh))
        wire = tplane.wire_inputs(tplane.pack_tick_inputs(inp))
        ts, u_out = tplane.device_tick(ts, wire, tdims)
        sh, out = tick.device_tick(sh, tmesh.shard_wires(tplane.pack_tick_inputs(inp), mesh),
                                   tdims)
        _assert_match(list(out), list(j_out), tplane.TickOutputs._fields, i)
        _assert_equal(out, u_out, i)
        total += int(out.fwd_packets.sum())
    state = tmesh.gather_tree(sh)
    _assert_match(tplane.tree_leaves(state), jax.tree.leaves(j_state),
                  tplane.leaf_names(state), "state")
    _assert_equal(tplane.tree_leaves(state), tplane.tree_leaves(ts), "state vs unsharded")
    assert [x.data_ptr() for x in tplane.tree_leaves(sh.shards[3])] == leaves_before
    assert total > 0


def test_state_actually_sharded(mesh):
    """Each of the 8 shards holds its rooms' slice of every leaf on its
    device; 0-d leaves are replicated; gather_tree inverts shard_tree; an
    R that does not divide evenly raises, naming R and N."""
    dims = tplane.PlaneDims(rooms=16, tracks=2, pkts=4, subs=2)
    rng = np.random.default_rng(5)
    state = tplane.tree_map(
        lambda x: torch.as_tensor(rng.integers(0, 100, tuple(x.shape))).to(x.dtype),
        tplane.init_state(dims, device="cpu"))
    sh = tmesh.shard_tree(state, mesh)
    assert len(sh.shards) == 8 and tmesh.room_sharding(mesh, 16)[3] == (6, 8)
    for i, shard in enumerate(sh.shards):
        for whole, part in zip(tplane.tree_leaves(state), tplane.tree_leaves(shard)):
            assert part.device == mesh.devices[i] and part.shape[0] == 2
            assert torch.equal(part, whole[2 * i:2 * i + 2])
            assert part.data_ptr() != whole[2 * i:].data_ptr()   # fresh tensors
    _assert_equal(tplane.tree_leaves(tmesh.gather_tree(sh)), tplane.tree_leaves(state), "gather")
    inp = tmesh.shard_tree(tplane.inputs_to_device(
        jsynth.next_tick(jsynth.init_traffic(dims, jsynth.TrafficSpec(1, 1)), dims,
                         jsynth.TrafficSpec(1, 1), 0)[1], "cpu"), mesh)
    assert {int(s.tick_ms) for s in inp.shards} == {10}
    assert all(s.tick_ms.dim() == 0 and s.sn.shape[0] == 2 for s in inp.shards)
    for rooms in (10, 4):
        with pytest.raises(ValueError, match=f"R={rooms}, N=8"):
            tmesh.shard_tree(tplane.init_state(dims._replace(rooms=rooms), device="cpu"), mesh)
    assert tmesh.locate(sh, 13)[1] == 1 and tmesh.locate(sh, 13)[0] is sh.shards[6]


def test_tick_trees_hold_no_per_shard_scalar(mesh):
    """`shard_map`'s P() out-spec takes a 0-d output from one shard, so a
    0-d leaf that differs per shard would be lost: PlaneState and
    TickOutputs have none, and TickInputs only the tick scalars, which
    every shard gets the same copy of."""
    dims = tplane.PlaneDims(rooms=8, tracks=2, pkts=4, subs=2)
    state = tplane.init_state(dims, device="cpu")
    spec = jsynth.TrafficSpec(1, 1)
    _, inp = jsynth.next_tick(jsynth.init_traffic(jplane.PlaneDims(*dims), spec),
                              jplane.PlaneDims(*dims), spec, 0)
    t_inp = tplane.inputs_to_device(inp, "cpu")
    _, out = tplane.media_plane_tick(state, t_inp)
    assert all(x.dim() > 0 and x.shape[0] == 8 for x in tplane.tree_leaves(state))
    assert all(x.dim() > 0 and x.shape[0] == 8 for x in out)
    scalars = [n for n, x in zip(tplane.TickInputs._fields, t_inp) if x.dim() == 0]
    assert scalars == ["tick_ms", "roll_quality"]
    _, joined = tmesh.make_sharded_tick(mesh)(tmesh.shard_tree(state, mesh),
                                             tmesh.shard_tree(t_inp, mesh))
    assert all(x.shape[0] == 8 for x in joined)


def test_mesh_devices_and_no_fallback(monkeypatch, mesh):
    """make_mesh defaults to every CUDA device and raises without one; a
    CUDA device that is not visible raises; a tick refuses a state on
    another mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="not visible"):
        tmesh.make_mesh(["cuda:3"])
    assert tmesh.make_mesh([CPU] * 8, n_devices=4).size == 4
    with pytest.raises(ValueError, match="n_devices=9"):
        tmesh.make_mesh([CPU] * 8, n_devices=9)
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.Mesh([])
    dims = tplane.PlaneDims(rooms=8, tracks=2, pkts=4, subs=2)
    four = tmesh.make_mesh([CPU] * 4)
    state = tmesh.shard_tree(tplane.init_state(dims, device="cpu"), four)
    with pytest.raises(ValueError, match="state on"):
        tmesh.make_sharded_tick(mesh).device_step(state, [], dims)


def test_pooled_tick_page_sharded_matches_single_chip(jmesh, mesh):
    """The counterpart of tests/test_parallel.py's pool test: the stock
    pooled tick with every leaf's page axis split over 8 shards (2 pages a
    shard at pool=16) against the JAX GSPMD step on the same state, and
    bit for bit the port's unsharded stock tick, 3 ticks. Room 1's grid
    (pages 1-4) straddles shards 0-2, so its pages are copied across
    shards: 4 halo pages a tick."""
    rp, tm, room, tp, sp, live, _, _ = fx.table_arrays()
    # shard_pool splits every leaf, the room-indexed rooms_pages too (the
    # tick never reads it): one row per shard, as the reference's test.
    rp = np.full((8, rp.shape[1]), -1, np.int32)
    jt = jpaged.PageTable(*map(jnp.asarray, (rp, tm, room, tp, sp)))
    tt = tpaged.PageTable(*map(torch.from_numpy, (rp, tm, room, tp, sp)))
    rng = np.random.default_rng(31)
    ctrl = fx.control(rng, live)
    js = fx.with_control(jplane.init_state(jpaged.PagedDims(**fx.DIMS).pooled()), ctrl,
                         jnp.asarray)
    ts = tplane.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)], device="cpu")
    j_state, j_table = jshard_pool(js, jmesh), jshard_pool(jt, jmesh)
    sh, sh_table = tmesh.shard_pool(ts, mesh), tmesh.shard_pool(tt, mesh)
    j_tick = jax.jit(jpaged.paged_plane_tick)
    tick = tmesh.ShardedPoolTick(mesh)
    plan = tmesh.PoolPlan(mesh, tm)
    assert plan.copies == 4 and [len(h) for h in plan.halo] == [1, 2, 1, 0, 0, 0, 0, 0]
    names = tplane.leaf_names(ts)
    for t in range(3):
        fields = fx.inputs(rng, live, roll=int(t == 2))
        jin = jplane.TickInputs(**{k: jnp.asarray(v) for k, v in fields.items()})
        j_state, j_out = j_tick(j_state, jshard_pool(jin, jmesh), j_table)
        t_in = fx.port_inputs(fields)
        ts, u_out = tpaged.paged_plane_tick(ts, t_in, tt)
        # Without a plan, the tick reads the table's tmembers itself.
        sh, out = tick(sh, tmesh.shard_pool(t_in, mesh), sh_table, plan if t else None)
        _assert_match(list(out), list(j_out), tplane.TickOutputs._fields, t)
        _assert_equal(out, u_out, t)
        state = tmesh.gather_tree(sh)
        _assert_match(tplane.tree_leaves(state), jax.tree.leaves(j_state), names, t)
        _assert_equal(tplane.tree_leaves(state), tplane.tree_leaves(ts), t)
    assert tick.cross_shard_pages == 12


def test_rows_land_on_the_owning_shard(mesh):
    """split_rows, write_rows and read_rows address global rows: a write
    of rows on several shards, read back, equals the same write on the
    whole tree, and touches no other row."""
    dims = tplane.PlaneDims(rooms=16, tracks=2, pkts=4, subs=2)
    rng = np.random.default_rng(9)
    state = tplane.tree_map(
        lambda x: torch.as_tensor(rng.integers(0, 50, tuple(x.shape))).to(x.dtype),
        tplane.init_state(dims, device="cpu"))
    sh = tmesh.shard_tree(state, mesh)
    assert [(i, p.tolist(), r.tolist()) for i, p, r in tmesh.split_rows(mesh, 16, [15, 0, 3, 2])] \
        == [(0, [1], [0]), (1, [2, 3], [1, 0]), (7, [0], [1])]
    rows = [15, 0, 3, 2]
    vals = [torch.as_tensor(rng.integers(50, 99, (4,) + tuple(x.shape[1:]))).to(x.dtype)
            for x in tplane.tree_leaves(state)]
    tmesh.write_rows(sh, rows, [v.numpy() for v in vals])
    for leaf, v in zip(tplane.tree_leaves(state), vals):
        leaf[torch.as_tensor(rows)] = v
    _assert_equal(tplane.tree_leaves(tmesh.gather_tree(sh)), tplane.tree_leaves(state), "write")
    got = tmesh.read_rows(sh, [2, 15, 7])
    _assert_equal(tplane.tree_leaves(got), [x[[2, 15, 7]] for x in tplane.tree_leaves(state)],
                  "read")


def test_shard_wires_carry_each_shards_rows(mesh):
    """The per-shard wires (one host→device copy a shard) unpack to the
    shards of the whole tick's inputs, and join_outputs joins per-shard
    output buffers in room order."""
    dims = jplane.PlaneDims(rooms=16, tracks=3, pkts=4, subs=5)
    spec = jsynth.TrafficSpec(video_tracks=2, audio_tracks=1)
    _, inp = jsynth.next_tick(jsynth.init_traffic(dims, spec, seed=4), dims, spec, 2, seed=4)
    tdims = tplane.PlaneDims(*dims)
    wires = tmesh.shard_wires(tplane.pack_tick_inputs(inp), mesh)
    assert len(wires) == 8
    up = tmesh.upload_wires(wires, mesh, tdims)
    whole = tplane.inputs_to_device(inp, "cpu")
    _assert_equal(tplane.tree_leaves(tmesh.gather_tree(up)), tplane.tree_leaves(whole), "inputs")
    _, out = tplane.media_plane_tick(tplane.init_state(tdims, device="cpu"), whole)
    flat = tplane.pack_tick_outputs(out).numpy()
    parts = [tplane.pack_tick_outputs(tplane.tree_map(lambda x: x[2 * i:2 * i + 2], out)).numpy()
             for i in range(8)]
    _assert_equal(tmesh.join_outputs(parts, tdims), tplane.unpack_tick_outputs(flat, tdims),
                  "join")
