"""TCP media fallback: the same sealed frames, length-prefixed on a stream.

Reference parity: the transport fallback ladder — when UDP is blocked the
reference falls back to ICE-TCP and then TURN (pkg/rtc/transportmanager.go:73
onFailed → fallback candidate types; pkg/service/turn.go:47 embedded TURN
server). Here the ladder has one rung: a TCP listener speaking

    frame := len(2, big-endian) | <AEAD frame — runtime/crypto.py>

Each connection authenticates implicitly: the first frame that opens under
a registered session key binds the connection as that participant's media
sink (no punch needed — the connection itself is the validated return
path, the consent property ICE-TCP provides). Inner datagrams then flow
through the exact same dispatch as UDP (`UDPMediaTransport._dispatch_inner`),
and egress to that participant is routed by the ("tcp", key_id) pseudo
address the UDP transport's send chokepoint understands.

Encryption is mandatory on TCP: a cleartext mode on an internet-facing
fallback port has no reason to exist.

A copy of the JAX package's runtime/tcp.py.
"""

from __future__ import annotations

import asyncio

from livekit_server_tpu_torch.runtime.crypto import MediaCryptoRegistry, parse_key_id
from livekit_server_tpu_torch.runtime.udp import UDPMediaTransport

MAX_FRAME = 64 * 1024
MAX_BUFFERED = 256 * 1024  # per-connection write backlog before media drops


class TCPMediaTransport:
    """Accepts framed media connections; delegates to the UDP transport's
    dispatch + send maps so both wires share one routing brain."""

    def __init__(self, udp: UDPMediaTransport, crypto: MediaCryptoRegistry):
        self.udp = udp
        self.crypto = crypto
        self.server: asyncio.AbstractServer | None = None
        self.stats = {"conns": 0, "bad_frame": 0, "frames_rx": 0}

    async def start(self, host: str, port: int) -> None:
        self.server = await asyncio.start_server(self._handle, host, port)

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.stats["conns"] += 1
        bound_key: int | None = None
        bound_sink = None
        try:
            while True:
                hdr = await reader.readexactly(2)
                n = int.from_bytes(hdr, "big")
                if n == 0 or n > MAX_FRAME:
                    break
                frame = await reader.readexactly(n)
                key_id = parse_key_id(frame)
                session = self.crypto.get(key_id) if key_id is not None else None
                inner = session.open(frame) if session is not None else None
                if inner is None:
                    self.stats["bad_frame"] += 1
                    continue
                self.stats["frames_rx"] += 1
                session.client_active = True
                if bound_key is None:
                    # First authenticated frame binds the connection as the
                    # participant's media sink (the ICE-TCP consent analog).
                    bound_key = session.key_id

                    def sink(data: bytes) -> None:
                        if writer.is_closing():
                            return
                        # Media is loss-tolerant: a stalled receiver must
                        # not buffer unbounded frames in server memory —
                        # drop instead (the pacer/leaky-bucket stance).
                        if writer.transport.get_write_buffer_size() > MAX_BUFFERED:
                            self.stats["frames_dropped"] = (
                                self.stats.get("frames_dropped", 0) + 1
                            )
                            return
                        writer.write(len(data).to_bytes(2, "big") + data)

                    self.udp.tcp_sinks[bound_key] = sink
                    bound_sink = sink
                    if session.room >= 0 and session.sub >= 0:
                        self.udp.sub_addrs[(session.room, session.sub)] = (
                            "tcp", bound_key,
                        )
                        self.udp._touch_subs()
                        # TCP egress carries no TWCC counters; without this
                        # refresh a sub that had a UDP address would keep
                        # fb_enabled=True, never ack, and starve its BWE
                        # budget to the floor.
                        self.udp._refresh_fb_enabled(session.room, session.sub)
                self.udp._dispatch_inner(inner, ("tcp", session.key_id), session)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            # Tear down ONLY if this connection still owns the sink — a
            # reconnect may have rebound the key to a newer connection,
            # whose routing a stale close must not destroy.
            if bound_key is not None and self.udp.tcp_sinks.get(bound_key) is bound_sink:
                del self.udp.tcp_sinks[bound_key]
                for k, v in list(self.udp.sub_addrs.items()):
                    if v == ("tcp", bound_key):
                        del self.udp.sub_addrs[k]
                        self.udp._refresh_fb_enabled(*k)
                self.udp._touch_subs()
            writer.close()

    def close(self) -> None:
        if self.server is not None:
            self.server.close()


async def start_tcp_transport(
    udp: UDPMediaTransport,
    crypto: MediaCryptoRegistry,
    host: str = "0.0.0.0",
    port: int = 7881,
) -> TCPMediaTransport:
    t = TCPMediaTransport(udp, crypto)
    await t.start(host, port)
    return t
