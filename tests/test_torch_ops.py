"""Parity of the port's leaf ops (livekit_server_tpu_torch.ops) with the
JAX reference on seeded inputs: RTP sequence arithmetic, the small-int
scan, parameter defaults and plane constants here; bit packing, stream
state and congestion control in test_torch_{bits,streams,congestion}.py,
which share the helpers below.

Integers and bools must match exactly. Floats must match within
rtol=1e-6 and atol=1e-6 in the quantity's own unit: both sides run the
same float32 operations, but `jnp.power`/`torch.pow` may differ by an
ulp, XLA's CPU backend contracts multiply-add pairs into FMA where torch
rounds twice, and sums may fold in another order.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.ops import (  # noqa: E402
    audio as jaudio,
    bwe as jbwe,
    pacer as jpacer,
    red as jred,
    scanops as jscan,
    seqnum as jseq,
    streamtracker as jtrk,
)
from livekit_server_tpu_torch.models import plane as tplane  # noqa: E402
from livekit_server_tpu_torch.ops import (  # noqa: E402
    audio as taudio,
    bwe as tbwe,
    pacer as tpacer,
    red as tred,
    scanops as tscan,
    seqnum as tseq,
    streamtracker as tstrk,
)

RTOL = ATOL = 1e-6


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for sub in x for leaf in _leaves(sub)]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    return [x]


def assert_tree_match(port, ref):
    p_leaves, r_leaves = _leaves(port), _leaves(ref)
    assert len(p_leaves) == len(r_leaves)
    for i, (p, r) in enumerate(zip(p_leaves, r_leaves)):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        r = np.asarray(r)
        assert p.shape == r.shape, (i, p.shape, r.shape)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL, err_msg=str(i))
        else:
            assert np.array_equal(p, r.astype(p.dtype)), i


def both(*arrays):
    """The same numpy arrays as (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


I32 = np.iinfo(np.int32)


def _seqnum_args(rng, fn):
    if fn.endswith("16") and not fn.startswith("update"):
        a, b = rng.integers(0, 1 << 16, (2, 500)).astype(np.int32)
    else:
        a, b = rng.integers(I32.min, I32.max, (2, 500), dtype=np.int64).astype(np.int32)
        a[:8] = [I32.max, I32.min, -1, 0, 1, I32.min, I32.max, -2]
    if fn == "update_highest16":
        a &= 0xFFFF
        b &= 0xFFFF
    if fn.startswith("update"):
        return a, rng.integers(0, 5, 500).astype(np.int32), b
    return a, b


@pytest.mark.parametrize("op", ["diff", "add", "sub", "is_newer", "update_highest"])
def test_seqnum_wraparound(op):
    """Both the 16-bit (RTP SN) and 32-bit (timestamp) forms of each op."""
    rng = np.random.default_rng(1)
    for fn in (f"{op}16", f"{op}32"):
        j, t = both(*_seqnum_args(rng, fn))
        assert_tree_match(getattr(tseq, fn)(*t), getattr(jseq, fn)(*j))


def test_cumsum_small_int():
    x = np.random.default_rng(2).integers(-50, 50, (4, 6, 5)).astype(np.int32)
    j, t = both(x)
    for axis in (0, 1, -1):
        assert_tree_match(tscan.cumsum_small(t[0], axis), jscan.cumsum_small(j[0], axis))


def test_param_defaults_equal():
    """The port's parameter defaults equal the reference's, leaf for leaf
    (through params_to_numpy / params_from_numpy)."""
    pairs = [(jaudio.AudioLevelParams, taudio.AudioLevelParams),
             (jbwe.BWEParams, tbwe.BWEParams),
             (jbwe.DelayBWEParams, tbwe.DelayBWEParams),
             (jpacer.PacerParams, tpacer.PacerParams),
             (jtrk.TrackerParams, tstrk.TrackerParams)]
    for j_cls, t_cls in pairs:
        assert t_cls._fields == j_cls._fields, t_cls.__name__
        j_leaves = jax.tree.leaves(j_cls())
        assert tplane.params_to_numpy(t_cls()) == j_leaves, t_cls.__name__
        assert tplane.params_from_numpy(t_cls, j_leaves) == t_cls(), t_cls.__name__


def test_plane_constants_equal():
    for name in ("MAX_LAYERS", "MAX_TEMPORAL", "SPEAKER_TOP_K", "SLAB_WINDOW",
                 "PAD_MAX", "TEMPORAL_FRACTIONS", "PKT_FIELDS", "HOST_ONLY_PKT_FIELDS"):
        assert getattr(tplane, name) == getattr(jplane, name), name
    for cls in ("TrackMeta", "SubControl", "PlaneState", "TickInputs", "TickOutputs"):
        assert getattr(tplane, cls)._fields == getattr(jplane, cls)._fields, cls
    assert tpacer.WIRE_OVERHEAD_BYTES == jpacer.WIRE_OVERHEAD_BYTES
    assert tred.RED_DISTANCE == jred.RED_DISTANCE
