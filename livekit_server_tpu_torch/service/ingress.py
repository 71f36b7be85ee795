"""Ingress service: RTMP/WHIP/URL pull ingestion API.

Reference parity: pkg/service/ingress.go:32-350 — the livekit.Ingress
Twirp API (CreateIngress, UpdateIngress, ListIngress, DeleteIngress) with
state in the store and job dispatch to external ingress workers over the
bus (`ingress_jobs` / `ingress_updates`, the psrpc seat). Stream keys are
minted server-side; an ingress worker that accepts an RTMP/WHIP session
joins the room as a publishing participant through the normal signal path.

Port of the JAX package's service/ingress.py; its store is the port's
IOInfoService (service/ioinfo.py).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from aiohttp import web

from livekit_server_tpu_torch.utils import ids

if TYPE_CHECKING:
    from livekit_server_tpu_torch.service.server import LivekitServer


class IngressInputType(enum.IntEnum):
    RTMP_INPUT = 0
    WHIP_INPUT = 1
    URL_INPUT = 2


class IngressState(enum.IntEnum):
    ENDPOINT_INACTIVE = 0
    ENDPOINT_BUFFERING = 1
    ENDPOINT_PUBLISHING = 2
    ENDPOINT_ERROR = 3
    ENDPOINT_COMPLETE = 4


@dataclass
class IngressInfo:
    ingress_id: str = ""
    name: str = ""
    stream_key: str = ""
    url: str = ""
    input_type: IngressInputType = IngressInputType.RTMP_INPUT
    room_name: str = ""
    participant_identity: str = ""
    participant_name: str = ""
    reusable: bool = False
    state: IngressState = IngressState.ENDPOINT_INACTIVE
    error: str = ""
    audio: dict = field(default_factory=dict)
    video: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dict(vars(self))
        d["input_type"] = int(self.input_type)
        d["state"] = int(self.state)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "IngressInfo":
        d = dict(d)
        d["input_type"] = IngressInputType(d.get("input_type", 0))
        d["state"] = IngressState(d.get("state", 0))
        return cls(**d)


class IngressService:
    PREFIX = "/twirp/livekit.Ingress/"
    JOBS_TOPIC = "ingress_jobs"
    UPDATES_TOPIC = "ingress_updates"

    def __init__(self, server: "LivekitServer"):
        self.server = server

    @property
    def ingresses(self) -> dict:
        """Shared store owned by the IOInfoService aggregator
        (pkg/service/ioservice.go): the Twirp handlers create/delete
        entries here and the aggregator's bus worker updates them."""
        return self.server.ioinfo.ingresses

    async def handle(self, request: web.Request) -> web.Response:
        from livekit_server_tpu_torch.auth import (
            TokenError,
            ensure_ingress_admin_permission,
            verify_token,
        )

        method = request.path.removeprefix(self.PREFIX)
        token = request.headers.get("Authorization", "").removeprefix("Bearer ").strip()
        try:
            claims = verify_token(token, self.server.config.keys)
        except TokenError as e:
            return web.json_response({"msg": str(e)}, status=401)
        # Reference parity: ingress management needs the dedicated
        # ingressAdmin grant (auth.go EnsureIngressAdminPermission) —
        # roomAdmin is room-scoped and is NOT a substitute for a
        # node-global capability.
        if not ensure_ingress_admin_permission(claims):
            return web.json_response({"msg": "requires ingressAdmin"}, status=403)
        try:
            body = await request.json()
        except json.JSONDecodeError:
            body = {}

        if method == "CreateIngress":
            info = IngressInfo(
                ingress_id=ids.new_guid(ids.INGRESS_PREFIX),
                name=body.get("name", ""),
                stream_key=ids.new_guid("SK_"),
                input_type=IngressInputType(body.get("input_type", 0)),
                room_name=body.get("room_name", ""),
                participant_identity=body.get("participant_identity", ""),
                participant_name=body.get("participant_name", ""),
                reusable=bool(body.get("reusable", False)),
                audio=body.get("audio", {}),
                video=body.get("video", {}),
            )
            self.ingresses[info.ingress_id] = info
            self.server.ioinfo.stamp(info.ingress_id)
            await self._publish({"kind": "create", "ingress": info.to_dict()})
            return web.json_response(info.to_dict())
        if method == "UpdateIngress":
            info = self.ingresses.get(body.get("ingress_id", ""))
            if info is None:
                return web.json_response({"msg": "ingress not found"}, status=404)
            for f in ("name", "room_name", "participant_identity", "participant_name"):
                if f in body:
                    setattr(info, f, body[f])
            await self._publish({"kind": "update", "ingress": info.to_dict()})
            return web.json_response(info.to_dict())
        if method == "ListIngress":
            items = [
                i.to_dict()
                for i in self.ingresses.values()
                if not body.get("room_name") or i.room_name == body["room_name"]
            ]
            return web.json_response({"items": items})
        if method == "DeleteIngress":
            info = self.ingresses.pop(body.get("ingress_id", ""), None)
            if info is None:
                return web.json_response({"msg": "ingress not found"}, status=404)
            await self._publish({"kind": "delete", "ingress": info.to_dict()})
            return web.json_response(info.to_dict())
        return web.json_response({"msg": f"unknown method {method}"}, status=404)

    async def _publish(self, job: dict) -> int:
        bus = getattr(self.server.router, "bus", None)
        if bus is None:
            return 0
        return await bus.publish(self.JOBS_TOPIC, json.dumps(job))
