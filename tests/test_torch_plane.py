"""Tick-for-tick parity of the port's dense media-plane tick
(livekit_server_tpu_torch.models.plane.media_plane_tick) with the JAX
reference, on seeded synth traffic.

The JAX state is carried into the port ONCE (state_from_numpy); after
that each side steps its own state, and after every tick every
TickOutputs leaf and every PlaneState leaf is compared. Integers and
bools must be equal. Floats must agree within `plane.float_tolerance` of
the leaf, in its own unit: rtol=1e-5, atol=1e-2 for byte and bit-rate
leaves, rtol=atol=1e-6 for the rest (MOS, levels, fractions, ms, fps).
Each float op may differ by an ulp (XLA's CPU backend contracts
multiply-adds into FMA, torch does not; pow and sums may round
differently), the EMAs carry those ulps across ticks, and the pacer's
bucket update (tokens - allowed) cancels, leaving absolute differences of
a few ulps of the operands on byte counts of ~1e4.
`python tests/torch_leaf_errors.py` prints the largest difference seen
per float leaf.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.models import plane as jplane, synth as jsynth  # noqa: E402
from livekit_server_tpu_torch.models import plane as tplane, synth as tsynth  # noqa: E402

TICKS = 12


def assert_leaves_match(port_leaves, ref_leaves, names, tick):
    assert len(port_leaves) == len(ref_leaves)
    for name, p, r in zip(names, port_leaves, ref_leaves):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, (tick, name)
        if r.dtype.kind == "f":
            rtol, atol = tplane.float_tolerance(name)
            np.testing.assert_allclose(p, r, rtol=rtol, atol=atol,
                                       err_msg=f"tick {tick} {name}")
        else:
            assert np.array_equal(p, r.astype(p.dtype)), (tick, name)


def _ctrl_edit(meta, ctrl, rng):
    """A control edit on a numpy copy of the mirrors: mute, unsubscribe,
    cap layers, pub-mute a track."""
    meta = [np.array(m) for m in meta]
    ctrl = [np.array(c) for c in ctrl]
    R, T, S = ctrl[0].shape
    ctrl[1] |= rng.random((R, T, S)) < 0.2             # sub_muted
    ctrl[0] &= rng.random((R, T, S)) < 0.9             # subscribed
    ctrl[2] = np.minimum(ctrl[2], rng.integers(0, 3, (R, T, S))).astype(np.int32)
    ctrl[3] = np.minimum(ctrl[3], rng.integers(0, 4, (R, T, S))).astype(np.int32)
    meta[2][0, 0] = True                              # pub_muted
    return meta, ctrl


CASES = [
    (jplane.PlaneDims(4, 4, 8, 8), dict(video_tracks=2, audio_tracks=2), True),
    (jplane.PlaneDims(2, 6, 8, 40),
     dict(video_tracks=2, audio_tracks=3, svc=True, tick_ms=20), False),
    (jplane.PlaneDims(3, 4, 8, 8),
     dict(video_tracks=2, audio_tracks=2, svc=True, estimate_bps=6e5), True),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_media_plane_tick_matches_reference(case):
    dims, spec_kw, red_enabled = CASES[case]
    tdims = tplane.PlaneDims(*dims)
    jspec, tspec = jsynth.TrafficSpec(**spec_kw), tsynth.TrafficSpec(**spec_kw)
    j_state = jsynth.make_state(dims, jspec)
    t_state = tplane.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(j_state)],
                                      device="cpu")
    state_names = tplane.leaf_names(t_state)
    j_step = jax.jit(lambda s, i: jplane.media_plane_tick(s, i, red_enabled=red_enabled))
    j_delta = jax.jit(jplane.apply_ctrl_delta)
    j_traffic = jsynth.init_traffic(dims, jspec, seed=case)
    t_traffic = tsynth.init_traffic(tdims, tspec, seed=case)
    rng = np.random.default_rng(case)
    for i in range(TICKS):
        j_traffic, j_inp = jsynth.next_tick(j_traffic, dims, jspec, i, seed=case)
        t_traffic, t_inp = tsynth.next_tick(t_traffic, tdims, tspec, i, seed=case)
        if i % 5 == 4:   # close the quality window
            j_inp = j_inp._replace(roll_quality=np.int32(1))
            t_inp = t_inp._replace(roll_quality=np.int32(1))
        if i == 6:       # a dirty-row control upload mid-run
            meta, ctrl = _ctrl_edit(jax.tree.map(np.asarray, j_state.meta),
                                    jax.tree.map(np.asarray, j_state.ctrl), rng)
            rows = [0, dims.rooms - 1]
            j_state = j_delta(j_state, *map(jnp.asarray, jplane.pack_ctrl_rows(
                jplane.TrackMeta(*meta), jplane.SubControl(*ctrl), rows)))
            tplane.apply_ctrl_delta(t_state, *tplane.pack_ctrl_rows(
                tplane.TrackMeta(*meta), tplane.SubControl(*ctrl), rows))
        j_state, j_out = j_step(j_state, jax.tree.map(jnp.asarray, j_inp))
        t_state, t_out = tplane.media_plane_tick(
            t_state, tplane.inputs_to_device(t_inp, "cpu"), red_enabled=red_enabled)
        assert_leaves_match(list(t_out), list(j_out), tplane.TickOutputs._fields, i)
        assert_leaves_match(tplane.masks_to_dense(t_out, tdims),
                            jplane.masks_to_dense(j_out, dims), ("send", "drop", "switch"), i)
        assert_leaves_match(tplane.tree_leaves(t_state), jax.tree.leaves(j_state),
                            state_names, i)
    assert int(np.asarray(j_out.fwd_packets).sum()) > 0


@pytest.mark.parametrize("svc", [False, True])
def test_synth_next_tick_bit_identical(svc):
    """The port's copy of models/synth.py generates the same traffic."""
    dims = jplane.PlaneDims(3, 5, 8, 6)
    spec_kw = dict(video_tracks=2, audio_tracks=2, svc=svc)
    j_t = jsynth.init_traffic(dims, jsynth.TrafficSpec(**spec_kw), seed=3)
    t_t = tsynth.init_traffic(tplane.PlaneDims(*dims), tsynth.TrafficSpec(**spec_kw), seed=3)
    for i in (0, 1, 2, 100):
        j_t, j_inp = jsynth.next_tick(j_t, dims, jsynth.TrafficSpec(**spec_kw), i, seed=3)
        t_t, t_inp = tsynth.next_tick(t_t, tplane.PlaneDims(*dims),
                                      tsynth.TrafficSpec(**spec_kw), i, seed=3)
        for a, b in zip(list(j_inp) + list(j_t), list(t_inp) + list(t_t)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(np.asarray(a), np.asarray(b))
    j_meta, j_ctrl = jsynth.make_meta_ctrl(dims, jsynth.TrafficSpec(**spec_kw))
    t_meta, t_ctrl = tsynth.make_meta_ctrl(tplane.PlaneDims(*dims),
                                           tsynth.TrafficSpec(**spec_kw))
    for a, b in zip(list(j_meta) + list(j_ctrl), list(t_meta) + list(t_ctrl)):
        assert np.array_equal(a, b)


def test_init_state_and_numpy_round_trip():
    """init_state equals the reference's; state_to_numpy inverts
    state_from_numpy with the reference's leaf dtypes."""
    dims = jplane.PlaneDims(2, 3, 4, 5)
    j_leaves = [np.asarray(x) for x in jax.tree.leaves(jplane.init_state(dims))]
    t_state = tplane.init_state(tplane.PlaneDims(*dims), device="cpu")
    back = tplane.state_to_numpy(t_state)
    assert len(back) == len(j_leaves)
    for a, b in zip(back, j_leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    again = tplane.state_to_numpy(tplane.state_from_numpy(j_leaves, device="cpu"))
    for a, b in zip(again, j_leaves):
        assert np.array_equal(a, b)


def test_wire_packing_matches_reference():
    """pack_tick_inputs is the reference's layout; the one-buffer wire
    round-trips to the same device TickInputs; pack/unpack_tick_outputs
    share the reference's flat buffer layout."""
    dims = jplane.PlaneDims(2, 4, 8, 6)
    spec = jsynth.TrafficSpec()
    _, inp = jsynth.next_tick(jsynth.init_traffic(dims, spec), dims, spec, 0)
    for a, b in zip(jplane.pack_tick_inputs(inp), tplane.pack_tick_inputs(inp)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
    dev_inp = tplane.inputs_to_device(inp, "cpu")
    for name in tplane.PKT_FIELDS + ("estimate", "estimate_valid", "nacks",
                                     "pub_rtt_ms", "fb_valid", "sub_reset"):
        assert np.array_equal(getattr(dev_inp, name).numpy(), np.asarray(getattr(inp, name)))
    # Random outputs of the right shapes and dtypes (floats as arbitrary
    # bit patterns survive the int32 round trip).
    rng = np.random.default_rng(0)
    shapes = jplane.unpack_tick_outputs(np.zeros(1 << 16, np.int32), dims)
    out = jplane.TickOutputs(*[
        rng.random(x.shape).astype(np.float32) if x.dtype == np.float32
        else rng.random(x.shape) < 0.5 if x.dtype == bool
        else rng.integers(-2**31, 2**31, x.shape, dtype=np.int64).astype(np.int32)
        for x in shapes])
    j_buf = np.asarray(jax.jit(jplane.pack_tick_outputs)(jax.tree.map(jnp.asarray, out)))
    t_out = tplane.TickOutputs(*[torch.from_numpy(np.array(x)) for x in out])
    assert np.array_equal(tplane.pack_tick_outputs(t_out).numpy(), j_buf)
    for a, b in zip(tplane.unpack_tick_outputs(j_buf, tplane.PlaneDims(*dims)),
                    jplane.unpack_tick_outputs(j_buf, dims)):
        assert np.array_equal(a, b)
