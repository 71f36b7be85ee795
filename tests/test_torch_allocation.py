"""Parity of the port's allocation algebra and phase-2 allocation
(livekit_server_tpu_torch.ops.allocation) with the JAX reference.

The JAX kernel runs in Pallas interpret mode. `target` and `deficient`
must match exactly, and so must the float32 `used` budget: both sides
apply the same float32 subtractions in the same track order, with no
multiply that could be contracted.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.ops import allocation as jal  # noqa: E402
from livekit_server_tpu_torch.ops import allocation as tal  # noqa: E402


def _exact(port, ref):
    for p, r in zip(port, ref):
        r = np.asarray(r)
        assert p.shape == r.shape
        assert np.array_equal(p.numpy(), r.astype(p.numpy().dtype))


def _random_case(seed, R, T, S):
    rng = np.random.default_rng(seed)
    bit = (rng.random((R, T, 4, 4)) * 2e6
           * (rng.random((R, T, 4, 4)) > 0.3)).astype(np.float32)
    ms = rng.integers(-1, 4, (R, S, T)).astype(np.int32)
    mt = rng.integers(-1, 4, (R, S, T)).astype(np.int32)
    mu = rng.random((R, S, T)) < 0.2
    bud = (rng.random((R, S)) * 8e6).astype(np.float32)
    return bit, ms, mt, mu, bud


def _edge_cases():
    """Zero budget, every track muted, a budget that admits every top layer
    (tests/test_allocation.py edge cases), plus caps of -1."""
    rng = np.random.default_rng(29)
    R, T, S = 3, 4, 8
    bit = (rng.random((R, T, 4, 4)) * 2e6).astype(np.float32)
    ms = np.full((R, S, T), 3, np.int32)
    mt = np.full((R, S, T), 3, np.int32)
    return [
        (bit, ms, mt, np.zeros((R, S, T), bool), np.zeros((R, S), np.float32)),
        (bit, ms, mt, np.ones((R, S, T), bool),
         (rng.random((R, S)) * 5e6).astype(np.float32)),
        (bit, ms, mt, np.zeros((R, S, T), bool), np.full((R, S), 1e9, np.float32)),
        (bit, np.full((R, S, T), -1, np.int32), mt, np.zeros((R, S, T), bool),
         np.full((R, S), 1e7, np.float32)),
    ]


_JAX_INTERPRET = jax.jit(functools.partial(jal.allocate_budget_rooms, interpret=True))
_JAX_FALLBACK = jax.jit(functools.partial(jal.allocate_budget_rooms, use_pallas=False))
CASES = [_random_case(13, 4, 5, 7), _random_case(14, 6, 4, 33)] + _edge_cases()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_allocate_budget_rooms_matches_interpret(case):
    args = CASES[case]
    ref = _JAX_INTERPRET(*map(jnp.asarray, args))
    fallback = _JAX_FALLBACK(*map(jnp.asarray, args))
    port = tal.allocate_budget_rooms(*map(torch.from_numpy, args))
    _exact(port, ref)
    _exact(port, fallback)


def _bitrates():
    b = np.zeros((2, 4, 4), np.float32)
    b[0, 0, 0], b[0, 0, 1] = 150e3, 200e3
    b[0, 1, 0], b[0, 1, 1] = 500e3, 700e3
    b[0, 2, 0], b[0, 2, 1] = 1.5e6, 2.5e6
    b[1, 0, 0] = 32e3
    return b


CHANNELS = [  # (budget bps, muted): rich, constrained, starved, muted
    (10e6, (False, False)), (800e3, (False, False)), (10e3, (False, False)),
    (10e6, (True, False)),
]


def test_allocate_budget_single_subscriber():
    """One subscriber's cooperative allocation on the rich, constrained,
    starved and muted channels of tests/test_allocation.py."""
    b = _bitrates()
    caps = np.array([3, 3], np.int32)
    for budget, muted in CHANNELS:
        mu = np.array(muted)
        ref = jal.allocate_budget(jnp.asarray(b), jnp.asarray(caps), jnp.asarray(caps),
                                  jnp.asarray(mu), jnp.float32(budget))
        port = tal.allocate_budget(torch.from_numpy(b), torch.from_numpy(caps),
                                   torch.from_numpy(caps), torch.from_numpy(mu),
                                   torch.tensor(budget, dtype=torch.float32))
        _exact(port, ref)


def test_layer_helpers_match_reference():
    """optimal/lowest layer, next_higher, distance_to_desired and the
    flat-layer split, over random caps."""
    rng = np.random.default_rng(3)
    b = (rng.random((6, 4, 4)) * 1e6 * (rng.random((6, 4, 4)) > 0.4)).astype(np.float32)
    ms = rng.integers(-1, 4, 6).astype(np.int32)
    mt = rng.integers(-1, 4, 6).astype(np.int32)
    cur = rng.integers(-1, 16, 6).astype(np.int32)
    jb, jms, jmt, jcur = map(jnp.asarray, (b, ms, mt, cur))
    tb, tms, tmt, tcur = map(torch.from_numpy, (b, ms, mt, cur))
    pairs = [
        (tal.optimal_layer(tb, tms, tmt), jal.optimal_layer(jb, jms, jmt)),
        (tal.lowest_layer(tb, tms, tmt), jal.lowest_layer(jb, jms, jmt)),
        (tal.spatial_of(tcur), jal.spatial_of(jcur)),
        (tal.temporal_of(tcur), jal.temporal_of(jcur)),
        (tal.distance_to_desired(tcur, tal.optimal_layer(tb, tms, tmt)),
         jal.distance_to_desired(jcur, jal.optimal_layer(jb, jms, jmt))),
        *zip(tal.next_higher(tb, tms, tmt, tcur), jal.next_higher(jb, jms, jmt, jcur)),
    ]
    for p, r in pairs:
        assert np.array_equal(p.numpy(), np.asarray(r))


def test_allocate_budget_batch_matches_vmap():
    bit, ms, mt, mu, bud = _random_case(21, 1, 5, 9)
    ref = jax.jit(jal.allocate_budget_batch)(
        jnp.asarray(bit[0]), jnp.asarray(ms[0]), jnp.asarray(mt[0]),
        jnp.asarray(mu[0]), jnp.asarray(bud[0]))
    port = tal.allocate_budget_batch(*map(torch.from_numpy, (bit[0], ms[0], mt[0],
                                                             mu[0], bud[0])))
    _exact(port, ref)
