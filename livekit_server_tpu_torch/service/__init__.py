"""Service layer: HTTP/WS APIs, room management, server assembly.

Reference parity: pkg/service (SURVEY.md §2.2) — LivekitServer (HTTP mux +
lifecycle), RTCService (/rtc WebSocket), RoomManager (per-node room
registry + session workers), RoomService (Twirp admin API), object stores,
webhooks. The media-plane difference: RoomManager owns ONE PlaneRuntime
for the node, and a tick dispatcher fans TickResults out to rooms — the
reference instead wires per-room BufferFactories into Pion
(roommanager.go:350).

Only `server`, `rtcservice` and `roomservice` need aiohttp; this package
imports none of them, so RoomManager and the stores load without it.
"""

from livekit_server_tpu_torch.service.roommanager import RoomManager
from livekit_server_tpu_torch.service.store import LocalStore, ObjectStore

__all__ = ["LocalStore", "ObjectStore", "RoomManager"]
