"""Parity of the port's allocation at the paged phase-2 geometry with the
JAX reference: [R, S=8, T=64], with fill tracks past each room's own
pages as `models/paged.py` `_allocate` builds them. No dense-plane case
reaches T=64.

The port's plain version must equal the JAX kernel in Pallas interpret
mode and its fallback exactly, the float32 `used` budget included. The
reference unrolls its walk over all 64 tracks, so its two compiles take
most of a minute of several cores; this test has a file of its own so
that it queues last under `--dist loadfile`.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch_paged_fixture as fx  # noqa: E402

from livekit_server_tpu.ops import allocation as jal  # noqa: E402
from livekit_server_tpu_torch.ops import allocation as tal  # noqa: E402


def test_phase2_allocation_matches_interpret():
    args = fx.phase2_alloc_case(31, 12)
    port = tal.allocate_budget_rooms(*map(torch.from_numpy, args))
    for use_pallas in (True, False):
        ref = jax.jit(functools.partial(jal.allocate_budget_rooms, use_pallas=use_pallas,
                                        interpret=True))(*map(jnp.asarray, args))
        for p, r in zip(port, ref):
            assert p.shape == r.shape
            assert np.array_equal(p.numpy(), np.asarray(r).astype(p.numpy().dtype))
