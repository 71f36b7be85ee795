"""The port's integrity audit (livekit_server_tpu_torch.runtime.integrity,
device="cpu") against the JAX package's, on seeded numpy states carried
into both packages leaf by leaf: `audit_plane`'s mask, counts and new
mirror must be equal (all integers and bools) on a clean state, on one
room corrupted per rule, on a cursor regression against a legitimate
stream reset, across an SN wrap, and on seeded random corruption; with
the BWE ring cursor past its window the reference flags the room and the
port, by design, does not (ROADMAP C5/C6): the comparison hands the
reference that state with the cursor taken modulo the window, which it
reads the same way. The paged runtime's `map_audit_mask`
with its page-table check must give the same per-room mask as the
reference's and repair the same table rows."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch_paged_fixture as fx  # noqa: E402

from livekit_server_tpu.models import paged as jpaged  # noqa: E402
from livekit_server_tpu.models import plane as jplane  # noqa: E402
from livekit_server_tpu.runtime import integrity as jinteg  # noqa: E402
from livekit_server_tpu.runtime.paged_runtime import PagedPlaneRuntime as JaxPaged  # noqa: E402
from livekit_server_tpu_torch.models import paged, plane  # noqa: E402
from livekit_server_tpu_torch.ops import bwe  # noqa: E402
from livekit_server_tpu_torch.runtime import integrity  # noqa: E402
from livekit_server_tpu_torch.runtime.paged_runtime import PagedPlaneRuntime  # noqa: E402

DIMS = plane.PlaneDims(rooms=6, tracks=4, pkts=4, subs=4)
NAMES = plane.leaf_names(plane.init_state(DIMS, device="cpu"))
# In-range values of the leaves the audit bounds (inclusive ranges).
BOUNDED = {
    "ctrl.max_spatial": (0, plane.MAX_LAYERS - 1),
    "ctrl.max_temporal": (0, plane.MAX_TEMPORAL - 1),
    "sel.current_spatial": (-1, plane.MAX_LAYERS - 1),
    "sel.target_spatial": (-1, plane.MAX_LAYERS - 1),
    "sel.current_temporal": (-1, plane.MAX_TEMPORAL - 1),
    "sel.target_temporal": (-1, plane.MAX_TEMPORAL - 1),
    "bwe_state.ring_pos": (0, bwe.WINDOW - 1),
}


def clean_leaves(seed: int) -> list[np.ndarray]:
    """A seeded state every rule passes, as numpy leaves in tree order."""
    rng = np.random.default_rng(seed)
    out = []
    for name, leaf in zip(NAMES, plane.state_to_numpy(plane.init_state(DIMS, device="cpu"))):
        if leaf.dtype == np.bool_:
            out.append(rng.random(leaf.shape) < 0.5)
        elif leaf.dtype.kind == "f":
            out.append((rng.standard_normal(leaf.shape) * 1e3).astype(leaf.dtype))
        else:
            lo, hi = BOUNDED.get(name, (0, 60000))
            out.append(rng.integers(lo, hi + 1, leaf.shape).astype(leaf.dtype))
    return out


def mirror_of(leaves) -> list[np.ndarray]:
    """The mirror an audit of `leaves` leaves behind (numpy)."""
    s = dict(zip(NAMES, leaves))
    ext = (s["stats.sn_cycles"].astype(np.int64) * 65536 + s["stats.highest_sn"]).astype(np.int32)
    return [s["stats.started"].copy(), s["stats.first_sn"].copy(), ext,
            s["stats.received"].copy()]


def jax_audit(leaves, mirror):
    """The JAX package's audit_plane on numpy leaves and mirror."""
    jstate = jax.tree.unflatten(
        jax.tree.structure(jplane.init_state(jplane.PlaneDims(*DIMS))),
        [jnp.asarray(a) for a in leaves])
    return jinteg.audit_plane(jstate, jinteg.AuditMirror(*map(jnp.asarray, mirror)))


def ring_wrapped(leaves) -> list[np.ndarray]:
    """`leaves` with every BWE ring cursor at or past bwe.WINDOW taken
    modulo WINDOW: the state on which the reference's bounds rule reads
    what the port's reads on `leaves` (the port does not flag a cursor
    past its window; nothing else reads the cursor's value)."""
    out = list(leaves)
    i = NAMES.index("bwe_state.ring_pos")
    ring = out[i]
    out[i] = np.where(ring >= bwe.WINDOW, ring % bwe.WINDOW, ring).astype(ring.dtype)
    return out


def both(leaves, mirror):
    """audit_plane of both packages on the same numpy state and mirror
    (the reference's with the ring cursor wrapped, `ring_wrapped`);
    asserts mask, counts and new mirror equal, returns (mask, counts)."""
    jm, jc, jnm = jax_audit(ring_wrapped(leaves), mirror)
    m, c, nm = integrity.audit_plane(plane.state_from_numpy(leaves, device="cpu"),
                                     integrity.AuditMirror(*map(torch.from_numpy, mirror)))
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(c.numpy(), np.asarray(jc))
    for a, b in zip(nm, jnm):
        assert np.array_equal(a.numpy(), np.asarray(b))
    return m.numpy(), c.numpy()


def put(leaves, name: str, index, value) -> None:
    leaves[NAMES.index(name)][index] = value


def test_clean_state_audits_clean_in_both():
    for seed in (0, 1, 2):
        leaves = clean_leaves(seed)
        mask, counts = both(leaves, mirror_of(leaves))
        assert not mask.any() and not counts.any()
        # A fresh mirror (the first audit after a start or a restore).
        mask, _ = both(leaves, [np.zeros_like(x) for x in mirror_of(leaves)])
        assert not mask.any()


def test_each_rule_flags_its_room_in_both():
    leaves = clean_leaves(3)
    mirror = mirror_of(leaves)
    put(leaves, "audio_state.smoothed_level", (0, 1), np.nan)
    put(leaves, "temporal_bytes", (1, 0, 0, 0), 1e35)          # finite but absurd
    put(leaves, "ctrl.max_spatial", (2, 0, 0), 7)
    put(leaves, "sel.current_spatial", (3, 1, 2), 99)
    put(leaves, "bwe_state.ring_pos", (4, 0), -3)
    put(leaves, "delay_bwe.slope_ema", (5, 3), -np.inf)        # nonfinite and range
    mask, counts = both(leaves, mirror)
    assert mask.tolist() == [integrity.BIT_NONFINITE, integrity.BIT_RANGE,
                             integrity.BIT_CTRL, integrity.BIT_BOUNDS,
                             integrity.BIT_BOUNDS,
                             integrity.BIT_NONFINITE | integrity.BIT_RANGE]
    assert counts.tolist() == [2, 2, 0, 1, 2]


def test_cursor_regression_against_a_legitimate_reset():
    leaves = clean_leaves(4)
    mirror = mirror_of(leaves)
    started = NAMES.index("stats.started")
    leaves[started][0, 0] = True
    mirror[0][0, 0] = True
    mirror[2][0, 0] = leaves[NAMES.index("stats.highest_sn")][0, 0] + 200 + (
        leaves[NAMES.index("stats.sn_cycles")][0, 0] * 65536)      # SN went backwards
    leaves[started][1, 2] = True
    mirror[0][1, 2] = True
    mirror[3][1, 2] = leaves[NAMES.index("stats.received")][1, 2] + 5  # received backwards
    mask, counts = both(leaves, mirror)
    assert mask[:2].tolist() == [integrity.BIT_CURSOR] * 2 and counts[2] == 2
    # The same regressions with a new stream identity (first_sn changed):
    # legitimate resets, no violation.
    mirror[1][0, 0] += 1
    mirror[1][1, 2] += 1
    mask, _ = both(leaves, mirror)
    assert not mask.any()


def test_sn_wrap_is_monotonic_in_both():
    leaves = clean_leaves(5)
    mirror = mirror_of(leaves)
    for name, value in (("stats.started", True), ("stats.first_sn", 3),
                        ("stats.highest_sn", 5), ("stats.sn_cycles", 1)):
        put(leaves, name, (0, 0), value)
    mirror[0][0, 0], mirror[1][0, 0], mirror[2][0, 0] = True, 3, 65530
    mask, _ = both(leaves, mirror)
    assert not mask.any()
    put(leaves, "stats.sn_cycles", (0, 0), 0)                    # the wrap undone
    mask, _ = both(leaves, mirror)
    assert mask[0] == integrity.BIT_CURSOR


def test_bwe_ring_cursor_past_its_window_flags_in_both():
    """The BWE advances its ring write cursor on every estimate sample and
    reads it modulo bwe.WINDOW. The reference's bounds rule holds it below
    WINDOW, so it flags a room once one subscriber has had WINDOW samples
    (a clean state of a session with receiver estimates: ROADMAP C6). The
    port's rule keeps only `ring_pos >= 0` and audits that state clean; a
    negative cursor stays flagged in both."""
    leaves = clean_leaves(6)
    put(leaves, "bwe_state.ring_pos", (2, 1), bwe.WINDOW)
    put(leaves, "bwe_state.ring_pos", (4, 0), 1000)
    mirror = mirror_of(leaves)
    jm, jc, _ = jax_audit(leaves, mirror)
    assert np.nonzero(np.asarray(jm))[0].tolist() == [2, 4]
    assert np.asarray(jc).tolist() == [0, 0, 0, 0, 2]
    mask, counts = both(leaves, mirror)
    assert not mask.any() and not counts.any()
    put(leaves, "bwe_state.ring_pos", (3, 2), -1)
    mask, counts = both(leaves, mirror)
    assert np.nonzero(mask)[0].tolist() == [3]
    assert counts.tolist() == [0, 0, 0, 0, 1]


@pytest.mark.parametrize("seed", range(3))
def test_seeded_random_corruption_audits_alike(seed):
    rng = np.random.default_rng(100 + seed)
    leaves = clean_leaves(200 + seed)
    mirror = mirror_of(leaves)
    for _ in range(8):
        i = int(rng.integers(len(leaves)))
        leaf = leaves[i].reshape(-1)
        j = int(rng.integers(leaf.size))
        if leaf.dtype.kind == "f":
            leaf[j] = rng.choice([np.nan, np.inf, -np.inf, 3e30, -2e38, 7.0])
        elif leaf.dtype.kind == "i":
            leaf[j] = rng.choice([-5, -1, 0, 3, 4, 9, 1 << 30])
        else:
            leaf[j] = not leaf[j]
    both(leaves, mirror)


def _paged_pair():
    """The paged fixture's rooms in both packages' PagedPlaneRuntime, page
    lane synced (no tick: the audit hooks need the uploaded table only)."""
    ref = JaxPaged(jpaged.PagedDims(**fx.DIMS), tick_ms=10)
    port = PagedPlaneRuntime(paged.PagedDims(**fx.DIMS), tick_ms=10, egress_shards=1,
                             device="cpu")
    for rt in (ref, port):
        for name, tracks, subs in (("a", 1, 2), ("b", 4, 8), ("c", 2, 5)):
            s = rt.slots.alloc_room(name)
            for i in range(tracks):
                s.alloc_track(f"t{i}")
            for i in range(subs):
                s.alloc_sub(f"p{i}")
        rt._sync_pages()
    return ref, port


def test_paged_map_audit_mask_and_page_table_check_match_reference():
    ref, port = _paged_pair()
    P = fx.DIMS["pool_pages"]
    page_mask = np.zeros(P, np.int32)
    assert np.array_equal(port.map_audit_mask(page_mask), ref.map_audit_mask(page_mask))
    # One page of room "b" flagged by the audit; one table row of room "c"
    # pointed at room "a" (an indirection corrupted on the device).
    b_page = int(port.pager.pages_of_room(1)[1])
    c_page = int(port.pager.pages_of_room(2)[0])
    assert b_page == int(ref.pager.pages_of_room(1)[1])
    page_mask[b_page] = integrity.BIT_RANGE
    ref.table = ref.table._replace(pg_room=ref.table.pg_room.at[c_page].set(0))
    port.table.pg_room[c_page] = 0
    want = ref.map_audit_mask(page_mask)
    got = port.map_audit_mask(page_mask)
    assert np.array_equal(got, want)
    assert got.tolist()[:3] == [integrity.BIT_TABLE, integrity.BIT_RANGE,
                                integrity.BIT_TABLE]
    assert port.table_repairs == ref.table_repairs == 1
    assert int(port.table.pg_room[c_page]) == int(ref.table.pg_room[c_page]) == 2
    # Repaired: the next check finds the table clean.
    assert not port.map_audit_mask(np.zeros(P, np.int32)).any()
