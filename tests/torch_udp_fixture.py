"""Shared pieces of the port's UDP transport tests (tests/test_torch_udp*.py).

Every transport binds port 0 and reads its port back (a bind-close-rebind
free-port helper races under parallel workers), and every wait polls a
condition up to a deadline of seconds: no fixed sleep decides a result.
"""

import asyncio
import socket
import time

from livekit_server_tpu_torch.runtime.udp import UDPMediaTransport, start_udp_transport

HOST = "127.0.0.1"


async def until(cond, what: str = "the condition", timeout: float = 10.0) -> None:
    """Poll `cond` on the event loop until it holds; fail after `timeout`."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s waiting for {what}")
        await asyncio.sleep(0.001)


async def udp_transport(runtime, **kw):
    """The native batch-receive transport on an ephemeral port → (transport, port)."""
    transport = await start_udp_transport(runtime.ingest, HOST, 0, **kw)
    return transport, transport.transport.get_extra_info("sockname")[1]


async def endpoint_transport(runtime, **kw):
    """The asyncio per-datagram transport on an ephemeral port →
    (asyncio transport, UDPMediaTransport, port)."""
    loop = asyncio.get_running_loop()
    tr, transport = await loop.create_datagram_endpoint(
        lambda: UDPMediaTransport(runtime.ingest, **kw), local_addr=(HOST, 0))
    return tr, transport, tr.get_extra_info("sockname")[1]


def client_socket(kind=socket.SOCK_DGRAM) -> socket.socket:
    s = socket.socket(socket.AF_INET, kind)
    s.bind((HOST, 0))
    s.setblocking(False)
    return s


async def delivered(transport, n: int = 1, since: int | None = None) -> None:
    """Wait until the transport has taken `n` more datagrams than `since`
    (default: its count now, so call with the count read before sending)
    and has processed them (the per-datagram path stages on the next loop
    turn)."""
    base = transport.stats["rx"] if since is None else since
    await until(lambda: transport.stats["rx"] >= base + n and not transport._rx_scheduled,
                f"{n} datagrams at the server")


async def send(transport, sock, data: bytes, port: int) -> None:
    """Send one datagram to the server and wait until it is processed."""
    base = transport.stats["rx"]
    sock.sendto(data, (HOST, port))
    await delivered(transport, 1, base)


def drain(sock, media_only: bool = True) -> list[bytes]:
    """Every datagram waiting on `sock` (RTCP and sealed frames are kept
    unless `media_only` drops RTCP)."""
    out = []
    while True:
        try:
            d = sock.recv(4096)
        except BlockingIOError:
            return out
        if not (media_only and 192 <= d[1] <= 223):
            out.append(d)


async def recv(sock, n: int, media_only: bool = True, timeout: float = 10.0) -> list[bytes]:
    """Poll `sock` until `n` datagrams arrived (RTCP dropped when
    `media_only`); fail after `timeout`."""
    out: list[bytes] = []
    await until(lambda: len(out.__iadd__(drain(sock, media_only))) >= n,
                f"{n} datagrams at the client", timeout)
    return out
