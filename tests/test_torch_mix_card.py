"""The MCU seat's device programs on the card against their CPU runs:
ops/mix.py decode_tick and encode_ulaw, and runtime/mixer.py _device_mix
against the numpy int32 sum with self-exclusion, at the 64-room shape
where the mixer first takes its device path. Every output bit-equal.

This file imports neither jax nor the JAX package, so it runs on a
machine with a card and no jax (skip the JAX-based conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mix_card.py

Every test here is marked `cuda` and skips without a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_kernel_fixture import card  # noqa: E402, F401 (a fixture)

from livekit_server_tpu_torch.ops import mix  # noqa: E402
from livekit_server_tpu_torch.runtime.mixer import DEVICE_MIX_MIN_ROOMS, _device_mix  # noqa: E402

SEED = 21


def same(got: torch.Tensor, want: torch.Tensor) -> bool:
    g, w = got.cpu().numpy(), want.numpy()
    return g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


@pytest.mark.cuda
def test_decode_tick_on_the_card(card):
    rng = np.random.default_rng(SEED)
    every = torch.arange(256, dtype=torch.uint8).reshape(2, 2, 64)
    for codec in (mix.CODEC_PCM16, mix.CODEC_PCMU, mix.CODEC_PCMA):
        ids = torch.full((2, 2), codec, dtype=torch.int32)
        assert same(mix.decode_tick(every.to(card), ids.to(card)), mix.decode_tick(every, ids))
    payload = torch.from_numpy(rng.integers(0, 256, (DEVICE_MIX_MIN_ROOMS, 5, 960),
                                            dtype=np.uint8))
    ids = torch.from_numpy(rng.integers(0, 3, (DEVICE_MIX_MIN_ROOMS, 5)).astype(np.int32))
    assert same(mix.decode_tick(payload.to(card), ids.to(card)), mix.decode_tick(payload, ids))
    s16 = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    assert same(mix.decode_pcm16(s16.to(card)), mix.decode_pcm16(s16))


@pytest.mark.cuda
def test_encode_ulaw_on_the_card(card):
    rng = np.random.default_rng(SEED)
    edges = [((1 << b) - 0x84 + d) / 32768.0 for b in range(8, 15) for d in (-1, 0, 1)]
    pcm = np.concatenate([rng.uniform(-1.1, 1.1, 50000), edges, [-e for e in edges],
                          [0.0, 1.0, -1.0, np.nan, np.inf, -np.inf]]).astype(np.float32)
    x = torch.from_numpy(pcm)
    got, want = mix.encode_ulaw(x.to(card)), mix.encode_ulaw(x)
    assert same(got, want)
    ids = torch.full((1, 1), mix.CODEC_PCMU, dtype=torch.int32)
    assert same(mix.decode_tick(got.reshape(1, 1, -1), ids.to(card)),
                mix.decode_tick(want.reshape(1, 1, -1), ids))


@pytest.mark.cuda
@pytest.mark.parametrize("tracks,subs", [(4, 4), (8, 16), (2, 1)])
def test_device_mix_on_the_card(card, tracks, subs):
    rng = np.random.default_rng(SEED)
    R, N = DEVICE_MIX_MIN_ROOMS, 960
    pcm = rng.integers(-32768, 32768, (R, tracks, N)).astype(np.float32)
    pcm[0] = 32767.0                             # full scale everywhere: clips
    present = rng.random((R, tracks)) < 0.8
    exclude = rng.integers(0, tracks + 1, (R, subs)).astype(np.int32)
    args = tuple(torch.from_numpy(a) for a in (pcm, present, exclude))
    got = _device_mix(*(a.to(card) for a in args))
    assert same(got, _device_mix(*args))
    x = np.where(present[:, :, None], pcm.astype(np.int64), 0)
    own = np.take_along_axis(np.concatenate([x, np.zeros((R, 1, N), np.int64)], axis=1),
                             exclude.astype(np.int64)[:, :, None], axis=1)
    want = np.clip(x.sum(axis=1)[:, None, :] - own, -32768, 32767).astype(np.int16)
    mixed = np.clip(np.rint(got.cpu().numpy()), -32768, 32767).astype(np.int16)
    assert np.array_equal(mixed, want)
