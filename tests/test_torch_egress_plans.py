"""The port's egress plane planning and accounting
(runtime/egress_plane.py): the room and entry plans, group slots,
`resolve_shards`, `record_send` and the config section — the plan cases
of the reference's tests/test_egress_plane.py on the port's modules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from livekit_server_tpu_torch.config.config import Config, ConfigError, _validate  # noqa: E402
from livekit_server_tpu_torch.runtime.egress_plane import EgressPlane, resolve_shards  # noqa: E402


def test_room_plan_covers_all_rooms():
    lo, hi = EgressPlane(shards=4).room_plan(10)
    assert lo[0] == 0 and hi[-1] == 10
    assert (lo[1:] == hi[:-1]).all()
    assert ((hi - lo) >= 1).all()


def test_entry_plan_is_room_aligned():
    rooms = np.repeat(np.arange(5, dtype=np.int32), [1, 7, 2, 9, 3])
    lo, hi = EgressPlane(shards=3).entry_plan(rooms)
    assert lo[0] == 0 and hi[-1] == len(rooms)
    assert (lo[1:] == hi[:-1]).all()
    for cut in lo[1:]:
        assert rooms[cut] != rooms[cut - 1]


def test_entry_plan_single_room_collapses():
    lo, hi = EgressPlane(shards=4).entry_plan(np.zeros(50, np.int32))
    assert len(lo) == 1 and lo[0] == 0 and hi[0] == 50


def test_group_slots_marks_reused_packets():
    ep = EgressPlane(shards=1, multicast_seal=True)
    tracks, pkts = 2, 2
    rr = np.array([0, 0, 1], np.int32)
    tt = np.array([0, 0, 1], np.int32)
    kk = np.array([0, 0, 0], np.int32)
    flat = rr.astype(np.int64) * (tracks * pkts) + tt * pkts + kk
    grp, slots = ep.group_slots(flat, tt, kk, tracks, pkts)
    assert slots == tracks * pkts
    assert grp[0] == grp[1] == 0
    assert grp[2] == -1
    off = EgressPlane(shards=1, multicast_seal=False)
    assert off.group_slots(flat, tt, kk, tracks, pkts) == (None, 0)


def test_resolve_shards_bounds():
    assert resolve_shards(1) == 1
    assert resolve_shards(16) == 16
    assert resolve_shards(64) == 16
    assert 1 <= resolve_shards(0) <= 8


def test_record_send_feeds_pps_observe_and_the_shard_sums():
    ep = EgressPlane(shards=2)
    lo, hi = np.array([0, 3], np.int64), np.array([3, 6], np.int64)
    ep.record_send(6, 4, 6, lo, hi, np.array([3, 3], np.int64), np.array([3, 3], np.int64),
                   np.array([1_000_000, 2_000_000], np.int64))
    obs = ep.observe()
    assert obs["entries"] == 6 and obs["datagrams"] == 6
    assert obs["grouped_entries"] == 4
    assert obs["host_egress_pps"] == pytest.approx(6 / 2e-3, rel=0.01)
    assert len(obs["last_send"]["shards"]) == 2
    assert (obs["shard_built_sum"], obs["shard_sent_sum"]) == (6, 6)
    assert (obs["ticks_built_short"], obs["ticks_sent_short"]) == (0, 0)
    # a shard short of its entries (the C12 signature) and a socket drop
    ep.record_send(6, 0, 4, lo, hi, np.array([3, 1], np.int64), np.array([3, 2], np.int64),
                   np.array([10, 10], np.int64))
    obs = ep.observe()
    assert (obs["shard_built_sum"], obs["shard_sent_sum"]) == (11, 10)
    assert (obs["ticks_built_short"], obs["ticks_sent_short"]) == (1, 1)


def test_config_egress_section():
    cfg = Config()
    assert cfg.egress.shards == 0
    assert cfg.egress.multicast_seal is True
    cfg.egress.shards = 65
    with pytest.raises(ConfigError):
        _validate(cfg)
