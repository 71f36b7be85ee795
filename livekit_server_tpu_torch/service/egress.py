"""Egress service: recording/streaming job API.

Reference parity: pkg/service/egress.go:31-262 — the livekit.Egress Twirp
API (StartRoomCompositeEgress, StartWebEgress, StartParticipantEgress,
StartTrackCompositeEgress, StartTrackEgress, UpdateLayout, UpdateStream,
ListEgress, StopEgress) plus pkg/rtc/egress.go's track-egress launcher.
The reference dispatches jobs to external egress workers over psrpc; here
jobs are published on the bus topic `egress_jobs` (a worker subscribes and
reports via `egress_updates`), state lives in the store, and lifecycle
events flow to telemetry/webhooks — the same seams, bus-for-psrpc.

Port of the JAX package's service/egress.py; its store is the port's
IOInfoService (service/ioinfo.py).
"""

from __future__ import annotations

import enum
import json
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from aiohttp import web

from livekit_server_tpu_torch.utils import ids

if TYPE_CHECKING:
    from livekit_server_tpu_torch.service.server import LivekitServer


class EgressStatus(enum.IntEnum):
    STARTING = 0
    ACTIVE = 1
    ENDING = 2
    COMPLETE = 3
    FAILED = 4
    ABORTED = 5
    LIMIT_REACHED = 6


@dataclass
class EgressInfo:
    egress_id: str = ""
    room_name: str = ""
    kind: str = ""           # room_composite | web | participant | track_composite | track
    status: EgressStatus = EgressStatus.STARTING
    started_at: int = 0
    ended_at: int = 0
    error: str = ""
    request: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dict(vars(self))
        d["status"] = int(self.status)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "EgressInfo":
        d = dict(d)
        d["status"] = EgressStatus(d.get("status", 0))
        return cls(**d)


class EgressService:
    """Twirp livekit.Egress at /twirp/livekit.Egress/<Method>."""

    PREFIX = "/twirp/livekit.Egress/"
    JOBS_TOPIC = "egress_jobs"
    UPDATES_TOPIC = "egress_updates"

    KINDS = {
        "StartRoomCompositeEgress": "room_composite",
        "StartWebEgress": "web",
        "StartParticipantEgress": "participant",
        "StartTrackCompositeEgress": "track_composite",
        "StartTrackEgress": "track",
    }

    def __init__(self, server: "LivekitServer"):
        self.server = server

    @property
    def egresses(self) -> dict:
        """Shared store owned by the IOInfoService aggregator
        (pkg/service/ioservice.go): the Twirp handlers create/delete
        entries here and the aggregator's bus worker updates them."""
        return self.server.ioinfo.egresses

    async def handle(self, request: web.Request) -> web.Response:
        from livekit_server_tpu_torch.auth import (
            TokenError,
            ensure_record_permission,
            verify_token,
        )

        method = request.path.removeprefix(self.PREFIX)
        token = request.headers.get("Authorization", "").removeprefix("Bearer ").strip()
        try:
            claims = verify_token(token, self.server.config.keys)
        except TokenError as e:
            return web.json_response({"msg": str(e)}, status=401)
        # Reference parity: egress needs the dedicated roomRecord grant
        # (egress.go EnsureRecordPermission) — roomAdmin is NOT a substitute,
        # and in this build roomAdmin is room-scoped anyway.
        if not ensure_record_permission(claims):
            return web.json_response({"msg": "requires roomRecord"}, status=403)
        try:
            body = await request.json()
        except json.JSONDecodeError:
            body = {}

        if method in self.KINDS:
            return await self._start(self.KINDS[method], body)
        if method == "ListEgress":
            items = [
                e.to_dict()
                for e in self.egresses.values()
                if not body.get("room_name") or e.room_name == body["room_name"]
            ]
            return web.json_response({"items": items})
        if method == "StopEgress":
            return await self._stop(body.get("egress_id", ""))
        if method in ("UpdateLayout", "UpdateStream"):
            e = self.egresses.get(body.get("egress_id", ""))
            if e is None:
                return web.json_response({"msg": "egress not found"}, status=404)
            await self._publish_job({"kind": method.lower(), "egress": e.to_dict(), "update": body})
            return web.json_response(e.to_dict())
        return web.json_response({"msg": f"unknown method {method}"}, status=404)

    async def _start(self, kind: str, body: dict) -> web.Response:
        info = EgressInfo(
            egress_id=ids.new_guid(ids.EGRESS_PREFIX),
            room_name=body.get("room_name", ""),
            kind=kind,
            status=EgressStatus.STARTING,
            started_at=int(time.time()),
            request=body,
        )
        self.egresses[info.egress_id] = info
        self.server.ioinfo.stamp(info.egress_id)
        dispatched = await self._publish_job({"kind": "start", "egress": info.to_dict()})
        if not dispatched:
            # No worker listening (egress.go errNoEgressWorkers analog).
            info.status = EgressStatus.ABORTED
            info.error = "no egress workers available"
            info.ended_at = int(time.time())
        return web.json_response(info.to_dict())

    async def _stop(self, egress_id: str) -> web.Response:
        info = self.egresses.get(egress_id)
        if info is None:
            return web.json_response({"msg": "egress not found"}, status=404)
        if info.status in (EgressStatus.COMPLETE, EgressStatus.FAILED, EgressStatus.ABORTED):
            return web.json_response({"msg": "egress already ended"}, status=400)
        info.status = EgressStatus.ENDING
        self.server.ioinfo.stamp(egress_id)
        await self._publish_job({"kind": "stop", "egress": info.to_dict()})
        return web.json_response(info.to_dict())

    async def _publish_job(self, job: dict) -> int:
        bus = getattr(self.server.router, "bus", None)
        if bus is None:
            return 0
        return await bus.publish(self.JOBS_TOPIC, json.dumps(job))
