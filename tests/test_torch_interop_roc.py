"""The port's SRTP replay window and transmit ROC: the last cases of the
reference's tests/test_interop_srtp.py (SRTCP replay; the sender's ROC
across wraps with large gaps, retransmissions of pre-wrap sequence
numbers and forward jumps; a seeded lockstep fuzz of sender against
receiver).
"""

import pytest

pytest.importorskip("cryptography")

from livekit_server_tpu_torch.interop import srtp  # noqa: E402
from tests.test_torch_interop_srtp import _rtp  # noqa: E402


def test_srtcp_replay_rejected():
    """RFC 3711 §3.3.2: a replayed (authenticated) SRTCP packet must not
    decrypt twice — an on-path attacker could otherwise re-feed old
    REMB/TWCC to skew BWE."""
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rr = bytes([0x81, 201, 0, 7]) + (0xCAFE).to_bytes(4, "big") + bytes(24)
    w1, w2, w3 = (tx.protect_rtcp(rr) for _ in range(3))
    assert rx.unprotect_rtcp(w1) == rr
    assert rx.unprotect_rtcp(w2) == rr
    assert rx.unprotect_rtcp(w1) is None        # replay
    assert rx.unprotect_rtcp(w2) is None        # replay
    assert rx.unprotect_rtcp(w3) == rr          # fresh index still fine
    # Out-of-order but unseen index inside the window is accepted once.
    w4, w5 = tx.protect_rtcp(rr), tx.protect_rtcp(rr)
    assert rx.unprotect_rtcp(w5) == rr
    assert rx.unprotect_rtcp(w4) == rr
    assert rx.unprotect_rtcp(w4) is None


def test_tx_roc_wrap_with_large_gap():
    """A >4096-packet SN gap crossing the 16-bit wrap must still bump the
    sender ROC (half-range rule), or the stream permanently desyncs from
    the receiver's RFC 3711 §3.3.1 estimator."""
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    # Last pre-wrap SN far below 0xF000, first post-wrap SN far above
    # 0x1000: the old threshold heuristic missed this entirely.
    for seq in [0xE000, 0x2000, 0x2001]:
        w = tx.protect_rtp(_rtp(seq))
        assert rx.unprotect_rtp(w) == _rtp(seq), f"seq {seq:#x}"
    assert tx._tx[0x1234][0] == 1
    assert rx._rx[0x1234][0] == 1


def test_tx_roc_cross_wrap_rtx_uses_previous_roc():
    """Retransmitting a pre-wrap SN right after the wrap must protect
    under roc-1 so the receiver's estimator (which guesses roc-1 for a
    backward step across the wrap) can decrypt it."""
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    for seq in [0xFFFE, 0xFFFF, 0, 1]:
        assert rx.unprotect_rtp(tx.protect_rtp(_rtp(seq))) == _rtp(seq)
    # RTX of 0xFFFE (sent under roc=0) while the stream is at roc=1.
    w = tx.protect_rtp(_rtp(0xFFFD, payload=b"y" * 30))
    assert rx.unprotect_rtp(w) == _rtp(0xFFFD, payload=b"y" * 30)
    assert tx._tx[0x1234][0] == 1  # stream ROC state undisturbed


def test_tx_roc_large_forward_jump_stays_in_lockstep_with_rx():
    """TX protects every packet under exactly the ROC the RFC 3711
    §3.3.1 estimator guesses — so even a >2^15 forward SN jump (which a
    standard receiver half-range-decodes as roc-1) decrypts, and the two
    sides' state stays identical packet by packet."""
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    for seq in [1000, 1001]:
        assert rx.unprotect_rtp(tx.protect_rtp(_rtp(seq))) == _rtp(seq)
    # +40000 jump: both sides resolve it as roc-1 (half-range rule) — the
    # receiver then correctly REJECTS it as far behind the replay window
    # (libsrtp does the same; senders must not jump >2^15) — and neither
    # side advances its highest-SN state, so they stay in lockstep.
    for seq in [41001, 41002, 41003]:
        assert rx.unprotect_rtp(tx.protect_rtp(_rtp(seq))) is None
    assert tx._tx[0x1234][:2] == [0, 1001]
    assert rx._rx[0x1234][:2] == [0, 1001]
    # Once the stream passes the pinned SN again, state resumes advancing.
    for seq in [1002, 1003]:
        assert rx.unprotect_rtp(tx.protect_rtp(_rtp(seq))) == _rtp(seq)
    assert tx._tx[0x1234][:2] == [0, 1003]


def test_tx_rx_lockstep_fuzz():
    """Property: for ANY SN pattern a sender emits, a fresh receiver that
    sees every packet decrypts every packet (the sender mirrors the
    receiver's estimator, so divergence is impossible without loss)."""
    import random

    rng = random.Random(7)
    tx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    rx = srtp.SrtpSession(master_key=b"k" * 16, master_salt=b"s" * 12)
    seq = 60000
    seen = set()
    for _ in range(400):
        r = rng.random()
        if r < 0.70:
            seq = (seq + 1) & 0xFFFF
        elif r < 0.85:
            seq = (seq + rng.randint(2, 3000)) & 0xFFFF  # loss burst
        else:
            seq = (seq - rng.randint(1, 40)) & 0xFFFF    # RTX reach-back
        if seq in seen:
            continue  # replay window would (correctly) reject a dup
        seen.add(seq)
        w = tx.protect_rtp(_rtp(seq))
        out = rx.unprotect_rtp(w)
        # The receiver may reject packets that fall behind its 64-wide
        # replay window — but must never fail to DECRYPT one it accepts,
        # and in-window packets must round-trip.
        assert out in (None, _rtp(seq))
        if out is None:
            cur = (rx._rx[0x1234][0] << 16) | rx._rx[0x1234][1]
            idx = (srtp._estimate_roc(
                rx._rx[0x1234][0], rx._rx[0x1234][1], seq) << 16) | seq
            assert cur - idx >= 64, "rejected a packet inside the window"
    assert tx._tx[0x1234][:2] == rx._rx[0x1234][:2]
