"""Parity of the port's mask-word packing (livekit_server_tpu_torch.ops.bits)
with the JAX reference: bit s%32 of word s//32 is subscriber s, and bit 31
is set where a full word is. Exact."""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from livekit_server_tpu.ops import bits as jbits  # noqa: E402
from livekit_server_tpu_torch.ops import bits as tbits  # noqa: E402
from tests.test_torch_ops import assert_tree_match  # noqa: E402


@pytest.mark.parametrize("S", [1, 31, 32, 33, 40, 64, 70])
def test_pack_unpack_bits(S):
    rng = np.random.default_rng(S)
    mask = rng.random((3, 4, 5, S)) < 0.5
    mask[0, 0, 0, :] = True   # bit 31 set in full words
    port = tbits.pack_bits(torch.from_numpy(mask))
    ref = jbits.pack_bits(jnp.asarray(mask))
    assert_tree_match(port, ref)
    assert np.array_equal(tbits.unpack_bits(port.numpy(), S), mask)
    assert tbits.mask_words(S) == jbits.mask_words(S)
