"""Media relay: the embedded-TURN seat for UDP-hostile network paths.

Reference parity: the reference embeds a TURN server (pkg/service/turn.go:47)
so clients whose direct UDP path to the SFU is blocked — symmetric NATs,
egress firewalls that whitelist a single relay address — can still move
media over UDP. This build's wire is not ICE, so RFC 5766 itself would buy
nothing; what this module keeps is TURN's *capability*: a separately
addressable UDP hop that forwards media between a client and the SFU's
media port, admitted by credentials minted over the authenticated signal
channel (TURN's long-term credential seat).

A copy of the JAX package's runtime/relay.py: pure host code, no device
work; its retry policy is the port's own utils/backoff.py.

The relay is deliberately BLIND. Media frames are AEAD-sealed end-to-end
between client and SFU (runtime/crypto.py) — the relay never holds media
keys, so it forwards opaque datagrams verbatim in both directions. The
punch handshake (udp.py address-consent) rides through unchanged: the SFU
latches the relay's per-allocation source port as the subscriber address,
which is exactly the address media must flow to. One UDP socket is opened
per allocation so each relayed client keeps a distinct source address at
the SFU (SSRC latching and punch consent stay per-client).

Admission: a BIND datagram carrying a token minted by the SFU —

    token   = expiry_ms(8) | key_id(4) | nonce(4) | hmac16
    hmac16  = HMAC-SHA256(secret, "lk-relay" | payload)[:16]
    BIND    = "LKRL" | 0x01 | token(32)
    ACK     = "LKRL" | 0x02 | key_id(4)

key_id is the participant's media-crypto session id: one allocation per
session, so a leaked token cannot multiply allocations, and a re-BIND from
a new source address *moves* the allocation (the NAT-rebind recovery path).

Move continuity. A bare v1 BIND is replayable for its TTL: an on-path
observer who captures one can replay it from another address and re-aim
(hijack) the allocation — media stays AEAD-sealed, so the impact is a
targeted DoS of the victim's relay path, not disclosure. Clients that want
moves to be token-holder-only append a hash-chain continuity extension:

    BIND v2 = "LKRL" | 0x01 | token(32) | reveal(16) | commit(16)

The first BIND pins `commit` (reveal is ignored; send zeros). Every later
BIND from a *different* address must carry `reveal` with
SHA-256(reveal)[:16] == pinned commit, and supplies the next commit. An
observer sees only the hash (one-way) before a move and an already-spent
preimage after it, so captured (replayed) datagrams cannot re-aim the
allocation. v1 (37-byte) BINDs remain accepted for clients that opt out.

Token freshness is the recovery escape hatch. The relay remembers which
token nonces each allocation has already seen; a move whose token nonce is
*fresh* is accepted even without a chain proof (and re-pins to the BIND's
commit, or unpins for v1). Fresh tokens are mintable only over the
authenticated signal channel, so this stays token-holder-only, and it
covers two corners the chain alone cannot: (a) a client that lost its
chain state (crash) re-requests a token and recovers; (b) an on-path
attacker who wins the race against a legitimate move in flight — spending
the victim's reveal with an attacker commit — cannot lock the victim out,
because the victim mints a fresh token and takes the allocation back.
Replays still fail: an accepted BIND's nonce is spent on arrival.

Pin updates (set or rotate) happen only on origin-authorized frames —
creation, a valid reveal, or a fresh nonce — never on a replay, so a
source-spoofed replay of an old v2 BIND cannot reset the pin to a
commitment whose preimage has since been publicly spent.

Residual risk, accepted: media is AEAD-sealed end-to-end, so every attack
above is at worst a *recoverable* DoS of the victim's relay path; the
relay never learns or affects media confidentiality/integrity.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import secrets
import time

from livekit_server_tpu_torch.utils.backoff import BackoffPolicy, retry_async

RELAY_MAGIC = b"LKRL"
BIND_REQ = 0x01
BIND_ACK = 0x02
BIND_ERR = 0x03
TOKEN_LEN = 32
CONT_LEN = 16  # reveal(16) + commit(16) in the v2 continuity extension
_HMAC_CTX = b"lk-relay"


def continuity_commit(reveal: bytes) -> bytes:
    """The pin a BIND's 16-byte reveal must hash to (see module docstring)."""
    return hashlib.sha256(reveal).digest()[:CONT_LEN]


def mint_relay_token(secret: bytes, key_id: int, ttl_s: float) -> bytes:
    """Allocation credential for one media session (TURN credential seat)."""
    payload = (
        int((time.time() + ttl_s) * 1000).to_bytes(8, "big")
        + key_id.to_bytes(4, "big")
        + secrets.token_bytes(4)
    )
    mac = hmac.new(secret, _HMAC_CTX + payload, hashlib.sha256).digest()[:16]
    return payload + mac


def verify_relay_token(secret: bytes, token: bytes) -> int | None:
    """token → key_id, or None if forged/expired."""
    if len(token) != TOKEN_LEN:
        return None
    payload, mac = token[:16], token[16:]
    want = hmac.new(secret, _HMAC_CTX + payload, hashlib.sha256).digest()[:16]
    if not hmac.compare_digest(mac, want):
        return None
    if int.from_bytes(payload[:8], "big") < time.time() * 1000:
        return None
    return int.from_bytes(payload[8:12], "big")


class _Upstream(asyncio.DatagramProtocol):
    """Per-allocation socket facing the SFU media port: whatever the SFU
    sends to this allocation's source address goes back to the client."""

    def __init__(self, relay: "MediaRelay", key_id: int) -> None:
        self.relay = relay
        self.key_id = key_id
        self.transport: asyncio.DatagramTransport | None = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        alloc = self.relay.allocs.get(self.key_id)
        if alloc is None or self.relay.transport is None:
            return
        alloc.last_active = time.monotonic()
        self.relay.stats["down_fwd"] += 1
        self.relay.transport.sendto(data, alloc.client_addr)


class _Allocation:
    __slots__ = (
        "key_id", "client_addr", "upstream", "last_active", "commit",
        "seen_nonces",
    )

    MAX_SEEN_NONCES = 256

    def __init__(self, key_id: int, client_addr, upstream: _Upstream) -> None:
        self.key_id = key_id
        self.client_addr = client_addr
        self.upstream = upstream
        self.last_active = time.monotonic()
        # Continuity pin (v2 BINDs): sha256(next reveal)[:16], or None for
        # v1 clients whose moves are token-gated only.
        self.commit: bytes | None = None
        # Token nonces already accepted on this allocation → token expiry
        # (ms). A BIND reusing a seen nonce is a replay and can never move
        # the allocation or touch the pin. Eviction is expiry-aware, not
        # FIFO: an entry leaves the set only once its token has expired
        # (at which point verify_relay_token rejects the replay anyway),
        # so a spent nonce can never be replayed within its token's
        # lifetime. Over-cap with >MAX_SEEN unexpired tokens (requires the
        # server to mint >256 live tokens for one session) evicts the
        # soonest-to-expire entry — the tightest remaining replay window.
        self.seen_nonces: dict[bytes, int] = {}

    def spend_nonce(self, nonce: bytes, expiry_ms: int) -> None:
        self.seen_nonces[nonce] = expiry_ms
        if len(self.seen_nonces) > self.MAX_SEEN_NONCES:
            now_ms = time.time() * 1000
            for n, exp in list(self.seen_nonces.items()):
                if exp < now_ms:
                    del self.seen_nonces[n]
            while len(self.seen_nonces) > self.MAX_SEEN_NONCES:
                del self.seen_nonces[min(self.seen_nonces,
                                         key=self.seen_nonces.get)]


class MediaRelay(asyncio.DatagramProtocol):
    """One UDP socket facing clients; one socket per allocation facing the
    SFU. Forwards datagrams verbatim — admission only, no inspection."""

    # Upstream-bind retry budget: short, because the client is blocked on
    # the BIND ACK and will retransmit anyway.
    BIND_RETRY = BackoffPolicy(base=0.02, max_delay=0.2, max_attempts=3)

    def __init__(
        self,
        upstream_addr: tuple[str, int],
        secret: bytes,
        ttl_s: float = 30.0,
        max_allocations: int = 4096,
    ) -> None:
        self.upstream_addr = upstream_addr
        self.secret = secret
        self.ttl_s = ttl_s
        self.max_allocations = max_allocations
        self.transport: asyncio.DatagramTransport | None = None
        self.allocs: dict[int, _Allocation] = {}
        self.by_client: dict[tuple, _Allocation] = {}
        # key_ids whose upstream socket is being created: a BIND burst for
        # one session must not open one socket per datagram (the creation
        # await yields; duplicates would leak unreachable FDs).
        self._pending: set[int] = set()
        self.stats = {
            "binds": 0, "bad_bind": 0, "up_fwd": 0, "down_fwd": 0,
            "dropped": 0, "expired": 0,
        }
        self._sweeper: asyncio.Task | None = None

    # -- protocol ---------------------------------------------------------
    def connection_made(self, transport) -> None:
        self.transport = transport
        self._sweeper = asyncio.ensure_future(self._sweep())

    def datagram_received(self, data: bytes, addr) -> None:
        is_bind = (
            len(data) in (5 + TOKEN_LEN, 5 + TOKEN_LEN + 2 * CONT_LEN)
            and data[:4] == RELAY_MAGIC
        )
        alloc = self.by_client.get(addr)
        if alloc is not None and not is_bind:
            alloc.last_active = time.monotonic()
            self.stats["up_fwd"] += 1
            if alloc.upstream.transport is not None:
                alloc.upstream.transport.sendto(data)
            return
        if is_bind and data[4] == BIND_REQ:
            asyncio.ensure_future(self._bind(data[5:], addr))
            return
        self.stats["dropped"] += 1

    # -- allocation lifecycle --------------------------------------------
    def _reject(self, addr) -> None:
        self.stats["bad_bind"] += 1
        if self.transport is not None:
            self.transport.sendto(RELAY_MAGIC + bytes([BIND_ERR]), addr)

    async def _bind(self, token: bytes, addr) -> None:
        reveal = commit = None
        if len(token) == TOKEN_LEN + 2 * CONT_LEN:  # v2: continuity extension
            token, reveal, commit = (
                token[:TOKEN_LEN],
                token[TOKEN_LEN:TOKEN_LEN + CONT_LEN],
                token[TOKEN_LEN + CONT_LEN:],
            )
        key_id = verify_relay_token(self.secret, token)
        if key_id is None:
            self._reject(addr)
            return
        nonce = token[12:16]  # payload = expiry(8) | key_id(4) | nonce(4)
        expiry_ms = int.from_bytes(token[:8], "big")
        alloc = self.allocs.get(key_id)
        if alloc is None:
            if key_id in self._pending:
                return  # creation in flight; the retransmit will re-ACK
            # Count pending creations against the cap too, or a burst of
            # distinct-token BINDs in one event-loop batch overshoots it.
            if len(self.allocs) + len(self._pending) >= self.max_allocations:
                self._reject(addr)
                return
            proto = _Upstream(self, key_id)
            loop = asyncio.get_running_loop()
            self._pending.add(key_id)
            try:
                # Bounded retry (uniform BackoffPolicy): transient FD
                # pressure or a momentarily exhausted ephemeral-port range
                # clears within a few dozen ms, and one extra dial beats
                # bouncing the client to its TCP fallback.
                await retry_async(
                    lambda: loop.create_datagram_endpoint(
                        lambda: proto, remote_addr=self.upstream_addr
                    ),
                    self.BIND_RETRY,
                    retry_on=(OSError,),
                )
            except OSError:
                # Still failing after the retry budget: tell the client now
                # so it falls back to TCP instead of timing out.
                self._reject(addr)
                return
            finally:
                self._pending.discard(key_id)
            alloc = _Allocation(key_id, addr, proto)
            alloc.commit = commit  # None for v1 clients
            alloc.spend_nonce(nonce, expiry_ms)
            self.allocs[key_id] = alloc
        else:
            # Origin authorization (see module docstring): a valid chain
            # reveal proves continuity; a fresh token nonce proves access
            # to the authenticated signal channel (recovery path). A
            # replayed datagram has neither.
            proof_ok = (
                alloc.commit is not None
                and reveal is not None
                and hmac.compare_digest(continuity_commit(reveal), alloc.commit)
            )
            fresh = nonce not in alloc.seen_nonces
            if alloc.client_addr != addr:
                # NAT rebind: moves the allocation; the old client address
                # stops receiving (re-aim is revocation). Pinned
                # allocations move only for origin-authorized frames.
                if alloc.commit is not None and not (proof_ok or fresh):
                    self._reject(addr)
                    return
                # The mover chooses the next pin (None for v1: an explicit,
                # token-holder-authorized unpin) — but ONLY when origin-
                # authorized. A replayed frame may still move an UNPINNED
                # allocation (that is v1's documented risk model), yet it
                # must never plant a pin: an attacker pinning a v1 client's
                # allocation would block the victim's own re-BIND reclaim.
                if proof_ok or fresh:
                    alloc.commit = commit
                self.by_client.pop(alloc.client_addr, None)
                alloc.client_addr = addr
            elif commit is not None and (proof_ok or fresh):
                # Same-address refresh may set/rotate the pin — including
                # first-pinning an allocation a v1 BIND created — but only
                # when origin-authorized, so a source-spoofed replay of an
                # old v2 BIND cannot reset the pin to a spent commitment.
                alloc.commit = commit
            alloc.spend_nonce(nonce, expiry_ms)
        alloc.last_active = time.monotonic()
        self.by_client[addr] = alloc
        self.stats["binds"] += 1
        if self.transport is not None:
            self.transport.sendto(
                RELAY_MAGIC + bytes([BIND_ACK]) + key_id.to_bytes(4, "big"), addr
            )

    def _close_alloc(self, alloc: _Allocation) -> None:
        self.allocs.pop(alloc.key_id, None)
        if self.by_client.get(alloc.client_addr) is alloc:
            del self.by_client[alloc.client_addr]
        if alloc.upstream.transport is not None:
            alloc.upstream.transport.close()

    async def _sweep(self) -> None:
        # Idle allocations expire after ttl (TURN allocation lifetime seat);
        # any datagram in either direction refreshes, as does a re-BIND.
        try:
            while True:
                await asyncio.sleep(max(1.0, self.ttl_s / 4))
                cutoff = time.monotonic() - self.ttl_s
                for alloc in [a for a in self.allocs.values() if a.last_active < cutoff]:
                    self.stats["expired"] += 1
                    self._close_alloc(alloc)
        except asyncio.CancelledError:
            pass

    def close(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
        for alloc in list(self.allocs.values()):
            self._close_alloc(alloc)
        if self.transport is not None:
            self.transport.close()


async def start_media_relay(
    host: str,
    port: int,
    upstream_addr: tuple[str, int],
    secret: bytes,
    ttl_s: float = 30.0,
    max_allocations: int = 4096,
) -> MediaRelay:
    loop = asyncio.get_running_loop()
    # Listen-side bind, not a dial: a taken port is a config error that
    # should fail loudly at startup, not be retried into.
    _, proto = await loop.create_datagram_endpoint(  # graftcheck: disable=GC04
        lambda: MediaRelay(upstream_addr, secret, ttl_s, max_allocations),
        local_addr=(host, port),
    )
    return proto
