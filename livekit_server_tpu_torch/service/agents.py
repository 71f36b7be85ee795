"""Agent service: external AI-agent worker dispatch.

Reference parity: pkg/service/agentservice.go:40-508 — the /agent
WebSocket where agent workers register (namespace + job type), report
availability/status/load, and receive job offers; RoomManager asks for a
room agent on room start and a publisher agent on track publish (the
rtc.agentclient.go seat). Protocol here is JSON frames:

  worker → server: {"register": {...}}, {"availability": {job_id, available}},
                   {"status": {...}}, {"job_update": {...}}, {"ping": {}}
  server → worker: {"registered": {...}}, {"job_offer": {job}}, {"pong": {}}

Jobs carry a room join token so the agent connects back through /rtc like
any participant (kind=agent).

Port of the JAX package's service/agents.py, copied with the port's
auth and utils.ids.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from aiohttp import WSMsgType, web

from livekit_server_tpu_torch.auth import AccessToken, VideoGrant
from livekit_server_tpu_torch.utils import ids

if TYPE_CHECKING:
    from livekit_server_tpu_torch.service.server import LivekitServer

JT_ROOM = 0        # JT_ROOM — one agent per room
JT_PUBLISHER = 1   # JT_PUBLISHER — one agent per publishing participant


@dataclass
class AgentWorker:
    worker_id: str
    ws: web.WebSocketResponse
    namespace: str = "default"
    job_type: int | None = None   # None until the register frame arrives —
    # an unregistered worker must never be offered (or counted for) jobs
    load: float = 0.0
    status: int = 0          # 0 available, 1 full
    jobs: set = field(default_factory=set)
    registered_at: float = field(default_factory=time.time)


@dataclass
class AgentJob:
    job_id: str
    job_type: int
    room_name: str
    participant_identity: str = ""
    namespace: str = "default"
    state: str = "pending"    # pending | offered | running | done | failed
    worker_id: str = ""


class AgentService:
    def __init__(self, server: "LivekitServer"):
        self.server = server
        self.workers: dict[str, AgentWorker] = {}
        self.jobs: dict[str, AgentJob] = {}

    # -- worker socket ----------------------------------------------------
    async def handle(self, request: web.Request) -> web.StreamResponse:
        from livekit_server_tpu_torch.auth import TokenError, verify_token

        token = request.query.get("access_token") or request.headers.get(
            "Authorization", ""
        ).removeprefix("Bearer ").strip()
        try:
            claims = verify_token(token, self.server.config.keys)
        except TokenError as e:
            return web.Response(status=401, text=str(e))
        if not claims.video.agent:
            return web.Response(status=401, text="token lacks agent grant")
        ws = web.WebSocketResponse(heartbeat=30)
        await ws.prepare(request)
        worker = AgentWorker(worker_id=ids.new_guid(ids.AGENT_WORKER_PREFIX), ws=ws)
        self.workers[worker.worker_id] = worker
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                try:
                    frame = json.loads(msg.data)
                except json.JSONDecodeError:
                    continue
                await self._handle_frame(worker, frame)
        finally:
            self.workers.pop(worker.worker_id, None)
            for job_id in list(worker.jobs):
                job = self.jobs.get(job_id)
                if job is None:
                    continue
                if job.state == "offered":
                    # Never answered: try the remaining workers.
                    job.state = "pending"
                    await self._dispatch(job, exclude={worker.worker_id})
                elif job.state == "running":
                    job.state = "failed"  # worker died mid-job (drain/crash)
        return ws

    async def _handle_frame(self, worker: AgentWorker, frame: dict) -> None:
        if "register" in frame:
            reg = frame["register"] or {}
            worker.namespace = reg.get("namespace", "default")
            worker.job_type = int(reg.get("job_type", JT_ROOM))
            await worker.ws.send_str(
                json.dumps({"registered": {"worker_id": worker.worker_id}})
            )
        elif "availability" in frame:
            av = frame["availability"] or {}
            job = self.jobs.get(av.get("job_id", ""))
            if job is None:
                return
            if av.get("available", False):
                job.state = "running"
                job.worker_id = worker.worker_id
                worker.jobs.add(job.job_id)
            else:
                worker.jobs.discard(job.job_id)
                job.state = "pending"   # re-dispatch to another worker
                await self._dispatch(job, exclude={worker.worker_id})
        elif "status" in frame:
            st = frame["status"] or {}
            worker.load = float(st.get("load", 0.0))
            worker.status = int(st.get("status", 0))
        elif "job_update" in frame:
            upd = frame["job_update"] or {}
            job = self.jobs.get(upd.get("job_id", ""))
            if job is not None and upd.get("state") in ("done", "failed"):
                job.state = upd["state"]
                worker.jobs.discard(job.job_id)
        elif "ping" in frame:
            await worker.ws.send_str(json.dumps({"pong": {}}))

    # -- job dispatch (agentservice.go job assignment + affinity) --------
    async def launch_room_job(self, room_name: str) -> AgentJob | None:
        return await self._launch(JT_ROOM, room_name)

    async def launch_publisher_job(self, room_name: str, identity: str) -> AgentJob | None:
        return await self._launch(JT_PUBLISHER, room_name, identity)

    async def _launch(self, job_type: int, room_name: str, identity: str = "") -> AgentJob | None:
        if not any(w.job_type == job_type for w in self.workers.values()):
            return None
        job = AgentJob(
            job_id=ids.new_guid(ids.AGENT_JOB_PREFIX),
            job_type=job_type,
            room_name=room_name,
            participant_identity=identity,
        )
        self.jobs[job.job_id] = job
        await self._dispatch(job)
        return job

    async def _dispatch(self, job: AgentJob, exclude: set | None = None) -> None:
        exclude = exclude or set()
        candidates = [
            w
            for w in self.workers.values()
            if w.job_type == job.job_type and w.status == 0 and w.worker_id not in exclude
        ]
        if not candidates:
            return
        worker = min(candidates, key=lambda w: w.load)  # least-loaded affinity
        job.state = "offered"
        # Track the offer so a worker that dies before answering triggers
        # re-dispatch from the disconnect cleanup.
        worker.jobs.add(job.job_id)
        key = next(iter(self.server.config.keys), "")
        tok = AccessToken(key, self.server.config.keys.get(key, ""))
        tok.identity = f"agent-{job.job_id}"
        tok.kind = "agent"
        tok.grant = VideoGrant(room_join=True, room=job.room_name, agent=True)
        await worker.ws.send_str(
            json.dumps(
                {
                    "job_offer": {
                        "job": vars(job),
                        "token": tok.to_jwt(),
                        "url": f"ws://127.0.0.1:{self.server.config.port}/rtc",
                    }
                }
            )
        )
