"""The reference's twin drills on the port, on the CPU.

Flash-crowd reconnect storm (the reference's drill A, 48-room plane): the
governor climbs its ladder one rung at a time to L4 and walks back one
rung at a time, joins at L4 are refused with the ``overload`` reason,
every admitted subscriber keeps 100 % audio continuity with no duplicate
on the wire, and the counter-derived SLOs equal the JAX package's run of
the same scenario and a second port run.

Rolling drain under churn (drill B): one of two port nodes on the port's
TCP bus drains while joins and leaves go on; every room moves off it once
(commits, no rollbacks or timeouts), joins routed at it are refused with
``draining``, and nothing reaches the wire twice through the handoff.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the planes here are small.
torch.set_num_threads(1)

from livekit_server_tpu.runtime import traffic_twin as jax_twin  # noqa: E402
from livekit_server_tpu_torch.runtime import traffic_twin as twin  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

FLASH_PLANE = {"rooms": 48, "tracks_per_room": 4, "pkts_per_track": 8,
               "subs_per_room": 4, "tick_ms": 10}


def flash_crowd_scenario(mod, seed: int = 29):
    # 18 flood ticks at escalate_ticks=3 is enough runway to climb all
    # four rungs; the 50 post-storm ticks cover four dwell windows down.
    return mod.Scenario(
        seed=seed,
        segments=(mod.ChurnSegment(ticks=80, join_rate=0.8, leave_rate=0.01),),
        incidents=(mod.Incident("flash_crowd", at=12, ticks=18,
                                region="us-east", magnitude=8.0),),
        regions=(("us-east", 1.0),),
        video_room_frac=0.5,
    )


def make_flash_twin() -> twin.TrafficTwin:
    return twin.TrafficTwin(flash_crowd_scenario(twin), nodes=1, plane=FLASH_PLANE,
                            device="cpu")


async def test_flash_crowd_storm_sheds_in_ladder_order_audio_survives():
    tw = make_flash_twin()
    rep = await tw.run(1.0)

    # The governor climbed the ladder strictly one rung at a time, in
    # order, all the way to L4.
    transitions = tw.debug["governor_transitions"][0]
    ups = [(t["from"], t["to"]) for t in transitions if t["to"] > t["from"]]
    assert ups[:4] == [(0, 1), (1, 2), (2, 3), (3, 4)], ups
    assert all(b - a == 1 for a, b in ups), f"skipped a rung: {ups}"
    assert rep.rung_residency.get("L4", 0) > 0
    # Admission refusals during the storm carry the explicit reason.
    assert rep.denial_reasons.get("overload", 0) > 0, rep.denial_reasons
    # Every admitted subscriber rode through, exactly once on the wire.
    assert rep.audio_expected > 0
    assert rep.audio_gaps == 0
    assert rep.audio_continuity == 1.0
    assert rep.dup_wire_packets == 0
    # The ladder walks back down after the storm: recovery is finite.
    assert rep.recovery_ticks.get("flash_crowd", -1) >= 0, rep.recovery_ticks
    downs = [(t["from"], t["to"]) for t in transitions if t["to"] < t["from"]]
    assert all(a - b == 1 for a, b in downs), f"skipped down: {downs}"


async def test_flash_crowd_storm_equal_to_reference():
    """The port's drill and the JAX package's, same scenario and plane:
    every counter-derived SLO and every governor transition equal."""
    tw = make_flash_twin()
    rep = await tw.run(1.0)
    ref_twin = jax_twin.TrafficTwin(flash_crowd_scenario(jax_twin), nodes=1,
                                    plane=FLASH_PLANE)
    ref = await ref_twin.run(1.0)
    assert rep.deterministic_dict() == ref.deterministic_dict()
    assert tw.debug["governor_transitions"] == ref_twin.debug["governor_transitions"]


async def test_flash_crowd_storm_deterministic_across_reruns():
    rep1 = await make_flash_twin().run(1.0)
    rep2 = await make_flash_twin().run(1.0)
    assert rep1.deterministic_dict() == rep2.deterministic_dict()


def drain_scenario(seed: int = 31) -> twin.Scenario:
    return twin.Scenario(
        seed=seed,
        segments=(twin.ChurnSegment(ticks=50, join_rate=0.6, leave_rate=0.01),),
        incidents=(twin.Incident("rolling_drain", at=20, ticks=10, region="eu"),),
        regions=(("us-east", 0.55), ("eu", 0.45)),
        video_room_frac=0.3,
    )


async def test_rolling_drain_under_churn_migrates_each_room_once():
    tw = twin.TrafficTwin(
        drain_scenario(), nodes=2,
        plane={"rooms": 24, "tracks_per_room": 4, "pkts_per_track": 8,
               "subs_per_room": 4, "tick_ms": 10},
        device="cpu",
    )
    rep = await tw.run(1.0)

    # Every room on the drained node moved exactly once: all commits, no
    # rollbacks or timeouts, and the twin's aggregate agrees.
    mig = tw.debug["migration_stats"]
    commits = sum(m.get("commits", 0) for m in mig)
    assert commits >= 1, mig
    assert sum(m.get("rollbacks", 0) for m in mig) == 0, mig
    assert sum(m.get("timeouts", 0) for m in mig) == 0, mig
    assert rep.migrations == commits
    # The drained node ends empty; the load reappears on the survivor.
    rooms_final = tw.debug["rooms_final"]
    assert rooms_final[1] == [], rooms_final
    assert len(rooms_final[0]) > 0
    # Joins routed at the draining node were refused with the reason.
    assert rep.denial_reasons.get("draining", 0) > 0, rep.denial_reasons
    # Exactly-once on the wire through the handoff.
    assert rep.dup_wire_packets == 0
    assert rep.audio_received > 0
