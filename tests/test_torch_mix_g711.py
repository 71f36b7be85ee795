"""The MCU path's G.711 ops (ops/mix.py: decode_tick, decode_pcm16,
encode_ulaw) against the JAX package's on the same inputs: every byte
value under every codec, a seeded payload with mixed codec ids, every
int16 sample, seeded PCM with every µ-law segment boundary ±1 LSB, full
scale, out-of-range and non-finite samples. The tables are equal and
every output is bit-equal (tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from livekit_server_tpu.ops import mix as jmix  # noqa: E402
from livekit_server_tpu_torch.ops import mix  # noqa: E402

SEED = 5


def boundary_pcm() -> np.ndarray:
    """Samples at each segment edge of the µ-law encoder: |x|·32768
    truncated plus the 0x84 bias reaching 1 << b (b = 8..14), ±1 LSB, both
    signs; full scale, just under it, zero, -0.0 and past full scale."""
    edges = [((1 << b) - 0x84 + d) / 32768.0 for b in range(8, 15) for d in (-1, 0, 1)]
    edges += [e + 0.25 / 32768.0 for e in edges]          # inside the LSB
    special = [0.0, -0.0, 1.0, -1.0, 1.0 - 1 / 32768.0, -(1.0 - 1 / 32768.0), 1.5, -1.5,
               1e-9, -1e-9, 0.5 / 32768.0, -0.5 / 32768.0]
    v = np.array(edges + special, np.float32)
    return np.concatenate([v, -v])


def test_tables_and_codec_ids_equal():
    assert mix.ULAW_TABLE.dtype == np.float32 and mix.ALAW_TABLE.dtype == np.float32
    assert mix.ULAW_TABLE.tobytes() == jmix.ULAW_TABLE.tobytes()
    assert mix.ALAW_TABLE.tobytes() == jmix.ALAW_TABLE.tobytes()
    assert (mix.CODEC_PCM16, mix.CODEC_PCMU, mix.CODEC_PCMA) == (
        jmix.CODEC_PCM16, jmix.CODEC_PCMU, jmix.CODEC_PCMA)


@pytest.mark.parametrize("codec", [0, 1, 2])
def test_decode_tick_every_byte(codec):
    payload = np.arange(256, dtype=np.uint8).reshape(2, 2, 64)
    codecs = np.full((2, 2), codec, np.int32)
    got = mix.decode_tick(torch.from_numpy(payload), torch.from_numpy(codecs)).numpy()
    want = np.asarray(jmix.decode_tick(jnp.asarray(payload), jnp.asarray(codecs)))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_decode_tick_seeded_mixed_codecs():
    rng = np.random.default_rng(SEED)
    payload = rng.integers(0, 256, (37, 5, 240), dtype=np.uint8)
    codecs = rng.integers(0, 3, (37, 5)).astype(np.int32)
    got = mix.decode_tick(torch.from_numpy(payload), torch.from_numpy(codecs)).numpy()
    want = np.asarray(jmix.decode_tick(jnp.asarray(payload), jnp.asarray(codecs)))
    assert got.tobytes() == want.tobytes()


def test_decode_pcm16_every_sample():
    s = np.arange(-32768, 32768, dtype=np.int16)
    got = mix.decode_pcm16(torch.from_numpy(s)).numpy()
    want = np.asarray(jmix.decode_pcm16(jnp.asarray(s)))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_encode_ulaw_seeded_and_boundaries():
    rng = np.random.default_rng(SEED)
    pcm = np.concatenate([
        rng.uniform(-1.1, 1.1, 20000).astype(np.float32),
        (rng.normal(0, 0.05, 20000)).astype(np.float32),            # speech-like levels
        boundary_pcm(),
        np.array([np.nan, np.inf, -np.inf], np.float32),
    ])
    got = mix.encode_ulaw(torch.from_numpy(pcm)).numpy()
    want = np.asarray(jmix.encode_ulaw(jnp.asarray(pcm)))
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert len(np.unique(got)) == 256                              # every code reached


def test_encode_ulaw_every_int16_and_round_trip():
    """Every L16 sample through decode_pcm16 → encode_ulaw, and each µ-law
    byte through decode (PCMU) → encode, in both packages: equal, and the
    byte round trip is the identity but for the two zero codes."""
    s = np.arange(-32768, 32768, dtype=np.int16).reshape(4, 2, -1)
    got = mix.encode_ulaw(mix.decode_pcm16(torch.from_numpy(s))).numpy()
    want = np.asarray(jmix.encode_ulaw(jmix.decode_pcm16(jnp.asarray(s))))
    assert got.tobytes() == want.tobytes()
    codes = np.arange(256, dtype=np.uint8).reshape(1, 1, 256)
    ids = np.full((1, 1), mix.CODEC_PCMU, np.int32)
    back = mix.encode_ulaw(mix.decode_tick(torch.from_numpy(codes),
                                           torch.from_numpy(ids))).numpy()
    jback = np.asarray(jmix.encode_ulaw(jmix.decode_tick(jnp.asarray(codes),
                                                         jnp.asarray(ids))))
    assert back.tobytes() == jback.tobytes()
    moved = np.nonzero(back.ravel() != codes.ravel())[0]
    assert moved.tolist() == [0x7F]                                # -0 encodes as +0
