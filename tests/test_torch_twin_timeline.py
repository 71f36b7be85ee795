"""The twin's determinism contract across packages: the port's
`build_timeline` expands a scenario into the same events as the JAX
package's, byte for byte under `timeline_bytes`, for the bench's
`standard` shape and the `micro` smoke shape at several seeds and
offered loads; and within the port, the same seed and load give the same
bytes while another seed or load changes them."""

import pytest

from livekit_server_tpu.runtime import traffic_twin as jax_twin
from livekit_server_tpu_torch.runtime import traffic_twin as twin

SEEDS = (20, 21, 41)


def _scenario(mod, shape: str, seed: int):
    return mod.Scenario.standard(seed=seed, ticks=60) if shape == "standard" \
        else mod.Scenario.micro(seed=seed)


@pytest.mark.parametrize("load", [0.5, 1.0, 2.0, 4.0])
@pytest.mark.parametrize("shape", ["standard", "micro"])
def test_timeline_bytes_equal_to_reference(shape, load):
    for seed in SEEDS:
        got = twin.timeline_bytes(twin.build_timeline(_scenario(twin, shape, seed), load))
        want = jax_twin.timeline_bytes(
            jax_twin.build_timeline(_scenario(jax_twin, shape, seed), load))
        assert got, (shape, seed, load)
        assert got == want, (shape, seed, load)


def test_timeline_bytes_deterministic():
    sc = twin.Scenario.standard(seed=20, ticks=60)
    b1 = twin.timeline_bytes(twin.build_timeline(sc, 2.0))
    b2 = twin.timeline_bytes(twin.build_timeline(twin.Scenario.standard(seed=20, ticks=60), 2.0))
    assert b1 == b2, "same seed+load must be byte-identical"
    assert b1 != twin.timeline_bytes(
        twin.build_timeline(twin.Scenario.standard(seed=21, ticks=60), 2.0)
    ), "different seed must perturb the timeline"
    assert b1 != twin.timeline_bytes(twin.build_timeline(sc, 4.0)), \
        "offered load is part of the derivation"
