"""SIP service: telephony trunk / dispatch-rule / participant API.

Reference parity: pkg/service/sip.go:30-248 — the livekit.SIP Twirp API:
trunk CRUD (CreateSIPTrunk/ListSIPTrunk/DeleteSIPTrunk), dispatch-rule
CRUD, CreateSIPParticipant (outbound call → room participant via an
external SIP worker over the bus) and TransferSIPParticipant. State in
memory + store; job dispatch on `sip_jobs` (the psrpc seat).

Port of the JAX package's service/sip.py; its call receipts are
expired by the port's IOInfoService reaper (service/ioinfo.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from aiohttp import web

from livekit_server_tpu_torch.utils import ids

if TYPE_CHECKING:
    from livekit_server_tpu_torch.service.server import LivekitServer


@dataclass
class SIPTrunk:
    sip_trunk_id: str = ""
    name: str = ""
    kind: str = "inbound"     # inbound | outbound
    numbers: list[str] = field(default_factory=list)
    allowed_addresses: list[str] = field(default_factory=list)
    allowed_numbers: list[str] = field(default_factory=list)
    auth_username: str = ""
    auth_password: str = ""
    outbound_address: str = ""

    def to_dict(self):
        return dict(vars(self))


@dataclass
class SIPDispatchRule:
    sip_dispatch_rule_id: str = ""
    name: str = ""
    trunk_ids: list[str] = field(default_factory=list)
    rule: dict = field(default_factory=dict)   # direct {room} | individual {room_prefix}
    hide_phone_number: bool = False

    def to_dict(self):
        return dict(vars(self))


class SIPService:
    PREFIX = "/twirp/livekit.SIP/"
    JOBS_TOPIC = "sip_jobs"

    def __init__(self, server: "LivekitServer"):
        self.server = server
        self.trunks: dict[str, SIPTrunk] = {}
        self.rules: dict[str, SIPDispatchRule] = {}
        self.calls: dict[str, dict] = {}

    async def handle(self, request: web.Request) -> web.Response:
        from livekit_server_tpu_torch.auth import TokenError, verify_token

        method = request.path.removeprefix(self.PREFIX)
        token = request.headers.get("Authorization", "").removeprefix("Bearer ").strip()
        try:
            claims = verify_token(token, self.server.config.keys)
        except TokenError as e:
            return web.json_response({"msg": str(e)}, status=401)
        if not claims.video.room_admin:
            return web.json_response({"msg": "requires roomAdmin"}, status=403)
        try:
            body = await request.json()
        except json.JSONDecodeError:
            body = {}
        # Scoping policy: SIP trunk/dispatch-rule management is node-global,
        # so it needs an UNscoped admin token (no `room` claim). A token
        # minted as admin of one room may only dial/transfer SIP
        # participants into that room — it must not manage trunks or reach
        # other rooms (room-scoped analog of auth.go EnsureAdminPermission).
        scoped_room = claims.video.room
        if scoped_room:
            room_targeted = method in ("CreateSIPParticipant", "TransferSIPParticipant")
            if not room_targeted or body.get("room_name", "") != scoped_room:
                return web.json_response(
                    {"msg": "token is scoped to one room; requires unscoped roomAdmin"},
                    status=403,
                )

        if method in ("CreateSIPTrunk", "CreateSIPInboundTrunk", "CreateSIPOutboundTrunk"):
            trunk = SIPTrunk(
                sip_trunk_id=ids.new_guid(ids.SIP_TRUNK_PREFIX),
                name=body.get("name", ""),
                kind="outbound" if "Outbound" in method else "inbound",
                numbers=body.get("numbers", []),
                allowed_addresses=body.get("allowed_addresses", []),
                allowed_numbers=body.get("allowed_numbers", []),
                auth_username=body.get("auth_username", ""),
                auth_password=body.get("auth_password", ""),
                outbound_address=body.get("address", ""),
            )
            self.trunks[trunk.sip_trunk_id] = trunk
            return web.json_response(trunk.to_dict())
        if method in ("ListSIPTrunk", "ListSIPInboundTrunk", "ListSIPOutboundTrunk"):
            return web.json_response({"items": [t.to_dict() for t in self.trunks.values()]})
        if method == "DeleteSIPTrunk":
            t = self.trunks.pop(body.get("sip_trunk_id", ""), None)
            if t is None:
                return web.json_response({"msg": "trunk not found"}, status=404)
            return web.json_response(t.to_dict())
        if method == "CreateSIPDispatchRule":
            rule = SIPDispatchRule(
                sip_dispatch_rule_id=ids.new_guid(ids.SIP_DISPATCH_RULE_PREFIX),
                name=body.get("name", ""),
                trunk_ids=body.get("trunk_ids", []),
                rule=body.get("rule", {}),
                hide_phone_number=bool(body.get("hide_phone_number", False)),
            )
            self.rules[rule.sip_dispatch_rule_id] = rule
            return web.json_response(rule.to_dict())
        if method == "ListSIPDispatchRule":
            return web.json_response({"items": [r.to_dict() for r in self.rules.values()]})
        if method == "DeleteSIPDispatchRule":
            r = self.rules.pop(body.get("sip_dispatch_rule_id", ""), None)
            if r is None:
                return web.json_response({"msg": "rule not found"}, status=404)
            return web.json_response(r.to_dict())
        if method == "CreateSIPParticipant":
            trunk = self.trunks.get(body.get("sip_trunk_id", ""))
            if trunk is None:
                return web.json_response({"msg": "trunk not found"}, status=404)
            call = {
                "sip_call_id": ids.new_guid(ids.SIP_CALL_PREFIX),
                "participant_identity": body.get("participant_identity", ""),
                "room_name": body.get("room_name", ""),
                "sip_call_to": body.get("sip_call_to", ""),
                "dtmf": body.get("dtmf", ""),
            }
            self.calls[call["sip_call_id"]] = call
            dispatched = await self._publish({"kind": "dial", "trunk": trunk.to_dict(), "call": call})
            if not dispatched:
                return web.json_response({"msg": "no SIP workers available"}, status=503)
            return web.json_response(call)
        if method == "TransferSIPParticipant":
            await self._publish({"kind": "transfer", "request": body})
            return web.json_response({})
        return web.json_response({"msg": f"unknown method {method}"}, status=404)

    async def _publish(self, job: dict) -> int:
        bus = getattr(self.server.router, "bus", None)
        if bus is None:
            return 0
        return await bus.publish(self.JOBS_TOPIC, json.dumps(job))
