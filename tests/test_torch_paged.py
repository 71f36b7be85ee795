"""The port's paged plane (livekit_server_tpu_torch.models.paged) against
the JAX package's models/paged.py, on the hand-built page table of
tests/test_paged_kernel.py (tests/torch_paged_fixture.py).

The stock pooled tick is compared leaf by leaf, every pool row, state and
outputs: integers and bools equal, floats within `plane.float_tolerance`
of the leaf (the bounds and their reasons are in
tests/test_torch_plane.py). The layout translation and the page-table
delta lane are host/index code and must agree exactly.
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
from livekit_server_tpu.runtime.pager import RoomPager as JaxPager  # noqa: E402
from livekit_server_tpu_torch.models import paged as tpaged, plane as tplane  # noqa: E402
from livekit_server_tpu_torch.runtime.pager import RoomPager  # noqa: E402

JPD = jpaged.PagedDims(**fx.DIMS)
TPD = tpaged.PagedDims(**fx.DIMS)


def _tables():
    rp, tm, room, tp, sp, live, rows, inv = fx.table_arrays()
    jt = jpaged.PageTable(*map(jnp.asarray, (rp, tm, room, tp, sp)))
    tt = tpaged.PageTable(*map(torch.from_numpy, (rp, tm, room, tp, sp)))
    return jt, tt, live


def _states(rng, live):
    ctrl = fx.control(rng, live)
    js = fx.with_control(jplane.init_state(JPD.pooled()), ctrl, jnp.asarray)
    ts = tplane.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)], device="cpu")
    return js, ts


@pytest.mark.parametrize("red_enabled", [True, False])
def test_stock_tick_matches_reference(red_enabled):
    """Three ticks of the stock pooled tick (the third closes the quality
    window), every pool row of state and outputs."""
    rng = np.random.default_rng(7)
    jt, tt, live = _tables()
    js, ts = _states(rng, live)
    names = tplane.leaf_names(ts)
    step = jax.jit(lambda s, i: jpaged.paged_plane_tick(s, i, jt, red_enabled=red_enabled))
    for t in range(3):
        fields = fx.inputs(rng, live, roll=int(t == 2))
        js, jo = step(js, jplane.TickInputs(**{k: jnp.asarray(v) for k, v in fields.items()}))
        ts, to = tpaged.paged_plane_tick(ts, fx.port_inputs(fields), tt, red_enabled=red_enabled)
        fx.assert_leaves_match(list(to), list(jo), tplane.TickOutputs._fields, t)
        fx.assert_leaves_match(tplane.tree_leaves(ts), jax.tree.leaves(js), names, t)
    assert int(to.fwd_packets.sum()) > 0


def test_free_pages_frozen_under_stock_tick():
    """A FREE page's state stays equal to the init template after any
    number of stock ticks — the invariant the live path rests on."""
    rng = np.random.default_rng(3)
    _, tt, live = _tables()
    _, ts = _states(rng, live)
    for _ in range(3):
        ts, _ = tpaged.paged_plane_tick(ts, fx.port_inputs(fx.inputs(rng, live)), tt)
    dead = np.setdiff1d(np.arange(fx.P), live)
    tpl = tplane.init_state(TPD.pooled(), device="cpu")
    for got, want in zip(tplane.tree_leaves(ts), tplane.tree_leaves(tpl)):
        assert torch.equal(got[dead], want[dead])


def test_dead_page_outputs_match_reference():
    """The representative free page's outputs equal the reference's and
    every dead row of a stock tick."""
    rng = np.random.default_rng(5)
    jt, tt, live = _tables()
    _, ts = _states(rng, live)
    fields = fx.inputs(rng, live, tick_ms=20, roll=1)
    j_inp = jplane.TickInputs(**{k: jnp.asarray(v) for k, v in fields.items()})
    want = jpaged.dead_page_outputs(fx.MT, fx.TP, fx.K, fx.SP, j_inp)
    got = tpaged.dead_page_outputs(fx.MT, fx.TP, fx.K, fx.SP, 20, 1, device="cpu")
    fx.assert_leaves_match(list(got), list(want), tplane.TickOutputs._fields, "dead")
    _, out = tpaged.paged_plane_tick(ts, fx.port_inputs(fields), tt)
    dead = np.setdiff1d(np.arange(fx.P), live)
    for name, o, r in zip(tplane.TickOutputs._fields, out, got):
        assert torch.equal(o[dead], r.expand_as(o[dead])), name


def test_layout_xlate_state_matches_reference():
    """Pooled → logical and logical → pooled translation of a ticked
    state equal the reference's translation of the same arrays."""
    rng = np.random.default_rng(11)
    _, tt, live = _tables()
    _, ts = _states(rng, live)
    ts, _ = tpaged.paged_plane_tick(ts, fx.port_inputs(fx.inputs(rng, live)), tt)
    _, _, room, tp, sp, *_ = fx.table_arrays()
    jx, tx = jpaged.LayoutXlate(JPD, room, tp, sp), tpaged.LayoutXlate(TPD, room, tp, sp)
    pooled = tplane.tree_map(lambda x: x.numpy(), ts)
    lfill = tplane.tree_map(lambda x: x.numpy(),
                            tplane.init_state(TPD.logical, device="cpu"))
    pfill = tplane.tree_map(lambda x: x.numpy(), tplane.init_state(TPD.pooled(), device="cpu"))
    got = tx.state_to_logical(pooled, lfill)
    want = jx.state_to_logical(
        jax.tree.unflatten(jax.tree.structure(jplane.init_state(JPD.pooled())),
                           tplane.tree_leaves(pooled)),
        jplane.init_state(JPD.logical))
    for a, b in zip(tplane.tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a, np.asarray(b))
    back = tx.state_to_pooled(got, pfill)
    want_back = jx.state_to_pooled(want, jplane.init_state(JPD.pooled()))
    for a, b in zip(tplane.tree_leaves(back), jax.tree.leaves(want_back)):
        assert np.array_equal(a, np.asarray(b))


def test_layout_xlate_tick_io_matches_reference():
    """Input staging, the pooled → logical output translation (mask words,
    per-room sums, speaker merge) and the selector mirror equal the
    reference's, and a page table read back from the logical form maps
    every live page's rows."""
    rng = np.random.default_rng(13)
    _, tt, live = _tables()
    _, ts = _states(rng, live)
    fields = fx.inputs(rng, live)
    fields["audio_level"][:] = rng.integers(0, 60, fields["audio_level"].shape)
    ts, out = tpaged.paged_plane_tick(ts, fx.port_inputs(fields), tt)
    _, _, room, tp, sp, *_ = fx.table_arrays()
    jx, tx = jpaged.LayoutXlate(JPD, room, tp, sp), tpaged.LayoutXlate(TPD, room, tp, sp)
    R, T, K, S = TPD.logical
    pkt = rng.integers(0, 1000, (13, R, T, K)).astype(np.int32)
    fb = rng.random((8, R, S)).astype(np.float32)
    tf = rng.random((1, R, T)).astype(np.float32)
    for a, b in zip(tx.stage_inputs(pkt, fb, tf), jx.stage_inputs(pkt, fb, tf)):
        assert np.array_equal(a, b)
    pooled_out = tplane.TickOutputs(*[x.numpy() for x in out])
    got, want = tx.outputs_to_logical(pooled_out), jx.outputs_to_logical(pooled_out)
    for name, a, b in zip(tplane.TickOutputs._fields, got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    fill = tplane.tree_map(lambda x: x.numpy(), tplane.init_state(TPD.logical, device="cpu").sel)
    for a, b in zip(tx.sel_to_logical(tplane.tree_map(lambda x: x.numpy(), ts.sel), fill),
                    jx.sel_to_logical(tplane.tree_map(lambda x: x.numpy(), ts.sel), fill)):
        assert np.array_equal(a, b)


def test_table_delta_lane_matches_reference():
    """Pager events → table-row delta → device table, page re-init and
    compaction row moves, against the reference's appliers on the same
    deltas."""
    pagers = [cls(rooms=4, tracks=4, subs=8, tpage=2, spage=4, pool_pages=16)
              for cls in (RoomPager, JaxPager)]
    jt = jpaged.init_table(JPD)
    tt = tpaged.init_table(TPD, device="cpu")
    rng = np.random.default_rng(17)
    js = jplane.init_state(JPD.pooled())
    js = jax.tree.map(lambda x: jnp.asarray(rng.integers(0, 9, x.shape).astype(x.dtype)), js)
    ts = tplane.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)], device="cpu")
    jtpl = jpaged.page_init_template(JPD)
    ttpl = tpaged.page_init_template(TPD, device="cpu")
    for events in ([("alloc", 0, 2, 3), ("alloc", 1, 4, 8)], [("grow", 0, 4, 5)],
                   [("release", 1), ("alloc", 2, 1, 1)], [("compact",)]):
        for pager in pagers:
            for ev in events:
                if ev[0] == "alloc":
                    pager.alloc_room(ev[1], tracks=ev[2], subs=ev[3])
                elif ev[0] == "grow":
                    pager.grow_room(ev[1], tracks=ev[2], subs=ev[3])
                elif ev[0] == "release":
                    pager.release_room(ev[1])
                else:
                    pager.compact()
        tdelta, jdelta = pagers[0].drain_delta(), pagers[1].drain_delta()
        for a, b in zip(tdelta, jdelta):
            assert np.array_equal(a, b)
        trows = tpaged.pack_table_delta(pagers[0], tdelta)
        jrows = jpaged.pack_table_delta(pagers[1], jdelta)
        for a, b in zip(trows, jrows):
            assert np.array_equal(a, b)
        tpaged.apply_table_delta(tt, *trows)
        jt = jpaged.apply_table_delta(jt, *map(jnp.asarray, jrows))
        if len(jdelta.moves):
            tpaged.move_state_rows(ts, tdelta.moves[:, 0], tdelta.moves[:, 1])
            js = jpaged.move_state_rows(js, jnp.asarray(jdelta.moves[:, 0]),
                                        jnp.asarray(jdelta.moves[:, 1]))
        reinit = np.concatenate([jdelta.fresh_pages, jdelta.freed_pages]).astype(np.int32)
        if len(reinit):
            tpaged.reinit_pages(ts, reinit, ttpl)
            js = jpaged.reinit_pages(js, jnp.asarray(reinit), jtpl)
        for a, b in zip(tt, jt):
            assert np.array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tplane.tree_leaves(ts), jax.tree.leaves(js)):
            assert np.array_equal(a.numpy(), np.asarray(b))
