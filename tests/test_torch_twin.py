"""The port's traffic twin (livekit_server_tpu_torch/runtime/traffic_twin.py):
the scenario DSL and its validation, the timeline's shape, the twin.*
config knobs, and a full micro replay on the CPU: two same-seed port runs
agree on every counter-derived SLO, and they equal the JAX package's run
of the same scenario on the same plane."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the planes here are small.
torch.set_num_threads(1)

from livekit_server_tpu.runtime import traffic_twin as jax_twin  # noqa: E402
from livekit_server_tpu_torch.config import ConfigError, load_config  # noqa: E402
from livekit_server_tpu_torch.runtime import traffic_twin as twin  # noqa: E402

MICRO_PLANE = {"rooms": 8, "tracks_per_room": 4, "pkts_per_track": 8,
               "subs_per_room": 4, "tick_ms": 10}


def test_presets_validate():
    for sc in (twin.Scenario(), twin.Scenario.micro(), twin.Scenario.standard()):
        twin.validate_scenario(sc)


def _bad(case: str) -> twin.Scenario:
    good = twin.Scenario.micro()
    return {
        "no_segments": lambda: twin.Scenario(seed=1, segments=()),
        "unknown_incident": lambda: twin.Scenario(
            seed=1, segments=good.segments,
            incidents=(twin.Incident("meteor_strike", at=1, ticks=2),)),
        # Incident anchored past the end of the timeline.
        "incident_past_end": lambda: twin.Scenario(
            seed=1, segments=(twin.ChurnSegment(ticks=10, join_rate=1.0),),
            incidents=(twin.Incident("flash_crowd", at=50, ticks=2),)),
        "zero_magnitude": lambda: twin.Scenario(
            seed=1, segments=good.segments,
            incidents=(twin.Incident("flash_crowd", at=1, ticks=2, magnitude=0.0),)),
        # Size-class weights must carry probability mass.
        "weightless_size": lambda: twin.Scenario(
            seed=1, segments=good.segments, sizes=(twin.SizeClass(0.0, 1, 2),)),
    }[case]()


@pytest.mark.parametrize("case", ["no_segments", "unknown_incident", "incident_past_end",
                                  "zero_magnitude", "weightless_size"])
def test_scenario_rejects_bad_shapes(case):
    with pytest.raises(twin.ScenarioError):
        twin.validate_scenario(_bad(case))


def test_timeline_shape():
    sc = twin.Scenario.standard(seed=41, ticks=60)
    events = twin.build_timeline(sc, offered_load=1.0)
    assert events, "standard scenario produced no traffic"
    ticks = [e.tick for e in events]
    assert ticks == sorted(ticks)
    regions = {name for name, _ in sc.regions}
    kinds = {"join", "leave", "reconnect", "incident_begin", "incident_end"}
    for e in events:
        assert e.kind in kinds
        assert 0 <= e.tick < sc.total_ticks
        if e.kind == "join":
            assert e.region in regions
            assert e.participants >= 1
            # Codec mix: video rooms carry a codec, audio-only rooms opus.
            assert e.codec != "" if e.video else e.codec == "opus"
    assert any(e.kind == "incident_begin" for e in events)
    assert any(e.kind == "reconnect" for e in events)


def test_twin_config_knobs_and_validation():
    """The twin.* block through `scenario_from_config`, and the
    ConfigError fragments of the reference's test, as nested mappings
    (the port's load_config takes them without a YAML parser)."""
    keys = {"keys": {"k": "s"}}
    cfg = load_config(base={**keys, "twin": {"enabled": True, "seed": 7, "ticks": 40,
                                             "video_room_frac": 0.25}}, env={})
    assert cfg.twin.seed == 7
    sc = twin.scenario_from_config(cfg.twin)
    assert sc.seed == 7
    assert sc.total_ticks == 40
    assert sc.video_room_frac == 0.25

    for frag in (
        {"nodes": 0},
        {"ticks": -3},
        {"probe_every": 0},
        {"video_room_frac": 1.5},
        {"loads": [1.0, -2.0, 3.0, 4.0]},
        {"enabled": True, "loads": [1.0, 2.0]},
        {"no_such_knob": 1},
    ):
        with pytest.raises(ConfigError):
            load_config(base={**keys, "twin": frag}, env={})


async def test_micro_replay_deterministic_and_equal_to_reference():
    """Two port replays at one seed agree on every counter-derived SLO
    (deterministic_dict leaves the wall-clock members out by design), and
    they equal the JAX package's replay of the same scenario."""
    def make():
        return twin.TrafficTwin(twin.Scenario.micro(seed=23), nodes=1,
                                plane=MICRO_PLANE, device="cpu")

    rep1 = await make().run(1.0)
    rep2 = await make().run(1.0)
    assert rep1.deterministic_dict() == rep2.deterministic_dict()
    assert rep1.joins_offered > 0
    assert rep1.audio_expected > 0

    ref = await jax_twin.TrafficTwin(jax_twin.Scenario.micro(seed=23), nodes=1,
                                     plane=MICRO_PLANE).run(1.0)
    assert rep1.deterministic_dict() == ref.deterministic_dict()
