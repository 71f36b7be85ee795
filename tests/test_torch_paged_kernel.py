"""The plain versions of the port's live-page kernel (ops/paged_kernel.py)
and the live-extent tick (models/paged.py) against the JAX package, whose
Pallas kernel runs in interpret mode here as its own tests run it.

Decide outputs — selector state, mask words, sums and the stats/tracker
routing stacks — are integers and must be equal, padded duplicate live
rows included. The mix is float32: the reference sums the tracks with a
dot product, the port in track order (so that its CUDA kernel can match it
bit for bit), so the soft-clipped outputs, each a sum of at most TP = 8
terms of magnitude below 2, may differ by float32 rounding; they are held
to an absolute 1e-6. Ticks are compared as in tests/test_torch_paged.py
(floats within `plane.float_tolerance`).
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
from livekit_server_tpu.ops import paged_kernel as jkernel, selector as jselector  # noqa: E402
from livekit_server_tpu_torch.models import paged as tpaged, plane as tplane  # noqa: E402
from livekit_server_tpu_torch.ops import audio, bwe, pacer, paged_kernel, selector  # noqa: E402

MIX_ATOL = 1e-6
WO = pacer.WIRE_OVERHEAD_BYTES


def _decide_operands(rng, shape, live):
    """Random selector state plus the fixture's control and traffic at
    pool shape; returns (jax operands, port operands)."""
    P, TP, K, SP = shape
    vid, pub, svc, sub, mut = fx.control(rng, live, shape)
    base = sub & ~mut & pub[:, :, None]
    sel = [rng.integers(lo, hi, (P, TP, SP)).astype(np.int32)
           for lo, hi in ((-1, 3), (-1, 4), (-1, 3), (0, 4))]
    fields = fx.inputs(rng, live, shape=shape)
    fields["layer"] = rng.integers(-1, 4, (P, TP, K)).astype(np.int32)
    j = (jselector.SelectorState(*map(jnp.asarray, sel)), jnp.asarray(svc),
         jnp.asarray(vid), jnp.asarray(base),
         jplane.TickInputs(**{k: jnp.asarray(v) for k, v in fields.items()}))
    t = (selector.SelectorState(*map(torch.from_numpy, sel)), torch.from_numpy(svc),
         torch.from_numpy(vid), torch.from_numpy(base), fx.port_inputs(fields))
    return j, t


def _assert_decide_equal(got, want):
    for name, a, b in zip(paged_kernel.LiveDecide._fields, got, want):
        for x, y in zip(tplane.tree_leaves(a), jax.tree.leaves(b)):
            y = np.asarray(y)
            assert x.shape == y.shape, name
            assert np.array_equal(x.numpy(), y.astype(x.numpy().dtype)), name


@pytest.mark.parametrize("shape", [(16, 2, 4, 4), (8, 4, 3, 32)])
def test_decide_pages_plain_matches_interpret(shape):
    """decide_pages_plain against the reference kernel in interpret mode,
    routing stacks included, with padded duplicate live rows; SP=32 sets
    mask bit 31."""
    rng = np.random.default_rng(sum(shape))
    live = np.sort(rng.choice(shape[0], shape[0] // 2 - 1, replace=False)).astype(np.int32)
    rows = np.concatenate([live, np.repeat(live[:1], shape[0] // 2 - len(live))])
    j, t = _decide_operands(rng, shape, live)
    want = jkernel.decide_pages(*j, jnp.asarray(rows), wire_overhead=WO,
                                use_pallas=False, interpret=True)
    got = paged_kernel.decide_pages_plain(*t, torch.from_numpy(rows), wire_overhead=WO)
    assert want.st is not None and int(got.fwd_packets.sum()) > 0
    _assert_decide_equal(got, want)
    if shape[3] == 32:
        assert (got.send_bits < 0).any()    # bit 31 was exercised


def test_mix_pages_plain_matches_interpret():
    """The page-local top-K mix with level ties at the boundary."""
    rng = np.random.default_rng(13)
    shape = (16, 8, 1, 4)
    live = np.array([1, 4, 5, 9, 10, 11, 12, 13], np.int32)
    ops = fx.mix_operands(rng, shape, 96)
    want = jkernel.mix_pages(*ops, live, interpret=True, use_pallas=False)
    got = paged_kernel.mix_pages_plain(*map(torch.from_numpy, ops), torch.from_numpy(live))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MIX_ATOL)
    assert np.abs(np.asarray(want)).max() > 0.1


def test_decide_mix_pages_matches_interpret():
    """decide_mix_pages: both halves against the reference's single
    pallas_call."""
    rng = np.random.default_rng(17)
    shape = (16, 8, 4, 8)
    live = np.array([2, 3, 7, 11], np.int32)
    j, t = _decide_operands(rng, shape, live)
    ops = fx.mix_operands(rng, shape, 64)
    want_dec, want_mix = jkernel.decide_mix_pages(
        *j, *ops, live, wire_overhead=WO, interpret=True, use_pallas=False)
    got_dec, got_mix = paged_kernel.decide_mix_pages(
        *t, *map(torch.from_numpy, ops), torch.from_numpy(live), wire_overhead=WO)
    _assert_decide_equal(got_dec, want_dec)
    np.testing.assert_allclose(got_mix.numpy(), np.asarray(want_mix), rtol=0, atol=MIX_ATOL)


def test_fused_tick_matches_reference_stock_and_fused():
    """The port's live-extent tick (plain phase 0, compact phases 1–2,
    scatter, dead fill) against the reference's stock pooled tick and its
    fused tick in interpret mode: 3 ticks, every pool row of state and
    outputs."""
    rng = np.random.default_rng(7)
    rp, tm, room, tp, sp, live, rows, inv = fx.table_arrays()
    jt = jpaged.PageTable(*map(jnp.asarray, (rp, tm, room, tp, sp)))
    tt = tpaged.PageTable(*map(torch.from_numpy, (rp, tm, room, tp, sp)))
    ctrl = fx.control(rng, live)
    js = fx.with_control(jplane.init_state(jpaged.PagedDims(**fx.DIMS).pooled()), ctrl,
                         jnp.asarray)
    ts = tplane.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)], device="cpu")
    stock = jax.jit(lambda s, i: jpaged.paged_plane_tick(s, i, jt))
    fused = jax.jit(lambda s, i: jpaged.paged_plane_tick_fused(
        s, i, jt, rows, inv, use_pallas=False, interpret=True))
    js_f = js
    names = tplane.leaf_names(ts)
    for t in range(3):
        fields = fx.inputs(rng, live, roll=int(t == 1))
        j_inp = jplane.TickInputs(**{k: jnp.asarray(v) for k, v in fields.items()})
        js, jo = stock(js, j_inp)
        js_f, jo_f = fused(js_f, j_inp)
        ts, to = tpaged.paged_plane_tick_fused(ts, fx.port_inputs(fields), tt,
                                               torch.from_numpy(rows), torch.from_numpy(inv))
        for ref_state, ref_out in ((js, jo), (js_f, jo_f)):
            fx.assert_leaves_match(list(to), list(ref_out), tplane.TickOutputs._fields, t)
            fx.assert_leaves_match(tplane.tree_leaves(ts), jax.tree.leaves(ref_state), names, t)


def test_live_step_matches_stock_step():
    """The runtime's two device steps on the same pooled wire: the live
    step (with the cached dead outputs) and the stock step give the same
    buffer and state; with no live page the live step leaves the state
    alone and returns the dead outputs on every row."""
    rng = np.random.default_rng(19)
    rp, tm, room, tp, sp, live, rows, inv = fx.table_arrays()
    tt = tpaged.PageTable(*map(torch.from_numpy, (rp, tm, room, tp, sp)))
    pd = tpaged.PagedDims(**fx.DIMS)
    state = fx.with_control(tplane.init_state(pd.pooled(), device="cpu"),
                            fx.control(rng, live), torch.from_numpy)
    s_live = tplane.tree_map(torch.clone, state)
    rows_t, inv_t = torch.from_numpy(rows), torch.from_numpy(inv)
    names = tplane.TickOutputs._fields
    for t in range(3):
        packed = tplane.pack_tick_inputs(tplane.TickInputs(**fx.inputs(rng, live)))
        wire = tplane.wire_inputs(packed)
        state, want = tpaged.stock_step(state, tt, wire, pd)
        s_live, got, span = tpaged.live_step(s_live, tt, wire, pd, rows_t, inv_t)
        assert span >= 0.0
        fx.assert_leaves_match(list(tplane.unpack_tick_outputs(got, pd.pooled())),
                               list(tplane.unpack_tick_outputs(want, pd.pooled())), names, t)
        fx.assert_leaves_match(tplane.tree_leaves(s_live), tplane.tree_leaves(state),
                               tplane.leaf_names(state), t)
    before = [x.clone() for x in tplane.tree_leaves(s_live)]
    s_live, buf, span = tpaged.live_step(s_live, tt, wire, pd, rows_t[:0], inv_t)
    assert span == 0.0 and all(torch.equal(a, b) for a, b in
                               zip(before, tplane.tree_leaves(s_live)))
    dead = tpaged.dead_page_outputs(pd.max_tpages, pd.tpage, pd.pkts, pd.spage, 10, 0,
                                    device="cpu")
    for name, o, r in zip(names, tplane.unpack_tick_outputs(buf, pd.pooled()), dead):
        assert np.array_equal(o, np.broadcast_to(r.numpy(), o.shape)), name


def test_cached_dead_outputs_equal_fresh():
    """The live tick's cached dead-page outputs equal a fresh computation
    for every key, and a different key is a different entry."""
    tpaged.dead_page_outputs_cached.cache_clear()
    args = (2, 2, 4, 4)
    params = (audio.AudioLevelParams(), bwe.BWEParams())
    for tick_ms, roll, red in ((10, 0, True), (20, 1, True), (10, 0, False)):
        dev = torch.device("cpu")
        cached = tpaged.dead_page_outputs_cached(*args, tick_ms, roll, *params, red, dev)
        again = tpaged.dead_page_outputs_cached(*args, tick_ms, roll, *params, red, dev)
        fresh = tpaged.dead_page_outputs(*args, tick_ms, roll, *params, red, dev)
        assert again is cached
        for name, a, b in zip(tplane.TickOutputs._fields, cached, fresh):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert tpaged.dead_page_outputs_cached.cache_info().currsize == 3
