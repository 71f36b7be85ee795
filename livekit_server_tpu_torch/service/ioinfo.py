"""IOInfoService: the central egress/ingress status aggregator.

Reference parity: pkg/service/ioservice.go — workers report status over
RPC to ONE aggregator that owns the authoritative EgressInfo/IngressInfo
stores, fans lifecycle transitions into telemetry/webhooks, and serves
get/list to the Twirp APIs (CreateEgress :81, UpdateEgress :98,
UpdateIngressState :180). Here workers publish JSON updates on the
cluster bus topics; the Twirp services delegate their stores to this
service instead of each keeping a private copy.

Lifecycle reaper (pkg/service/redisstore.go:67-944 — the sorted-set
cleanup workers for egress/ingress/SIP state): every record carries a
last-update stamp; ended records expire after ENDED_TTL_S, and a
non-ended record whose worker has gone silent for STALE_ACTIVE_S (its
node crashed mid-job) is marked FAILED/ERROR — so `list_*` on every
node stays clean instead of accumulating orphans forever.

Port of the JAX package's service/ioinfo.py; lifecycle events go to
the port's TelemetryService.notify.
"""

from __future__ import annotations

import asyncio
import json
import time


class IOInfoService:

    REAP_INTERVAL_S = 30.0
    ENDED_TTL_S = 6 * 3600.0    # ended records linger for List, then expire
    # Heartbeat contract (matches the reference's egress workers, which
    # republish status periodically): a live job whose worker has been
    # silent this long is treated as node-lost. Workers must republish
    # on UPDATES_TOPIC at least every STALE_ACTIVE_S / 2.
    STALE_ACTIVE_S = 600.0
    # SIP call entries are dispatch receipts (no worker lifecycle updates
    # exist for them) — expired purely by age, one day like the
    # reference's SIP state cleanup.
    SIP_CALL_TTL_S = 24 * 3600.0

    def __init__(self, server):
        self.server = server
        self.egresses: dict[str, object] = {}    # egress_id → EgressInfo
        self.ingresses: dict[str, object] = {}   # ingress_id → IngressInfo
        self._stamp: dict[str, float] = {}       # record id → monotonic
        self._subs: list = []
        self._workers: list[asyncio.Task] = []

    async def start(self) -> None:
        bus = getattr(self.server.router, "bus", None)
        if bus is None:
            return
        from livekit_server_tpu_torch.service.egress import EgressService
        from livekit_server_tpu_torch.service.ingress import IngressService

        e_sub = bus.subscribe(EgressService.UPDATES_TOPIC)
        i_sub = bus.subscribe(IngressService.UPDATES_TOPIC)
        self._subs = [e_sub, i_sub]
        self._workers = [
            asyncio.ensure_future(self._egress_worker(e_sub)),
            asyncio.ensure_future(self._ingress_worker(i_sub)),
            asyncio.ensure_future(self._reaper()),
        ]

    async def stop(self) -> None:
        for sub in self._subs:
            sub.close()
        for w in self._workers:
            w.cancel()
        self._subs = []
        self._workers = []

    def stamp(self, record_id: str) -> None:
        """Mark a record as just-updated (Twirp create/stop paths and the
        bus workers both call this; the reaper reads it)."""
        self._stamp[record_id] = time.monotonic()

    # -- egress fan-in (ioservice.go UpdateEgress :98) --------------------
    async def _egress_worker(self, sub) -> None:
        from livekit_server_tpu_torch.service.egress import EgressInfo, EgressStatus

        async for raw in sub:
            try:
                info = EgressInfo.from_dict(json.loads(raw))
            except (ValueError, TypeError):
                continue
            prev = self.egresses.get(info.egress_id)
            self.egresses[info.egress_id] = info
            self.stamp(info.egress_id)
            if prev and prev.status != info.status:
                if info.status == EgressStatus.ACTIVE:
                    self.server.telemetry.notify(
                        "egress_started", egress=info.to_dict()
                    )
                elif info.status in (
                    EgressStatus.COMPLETE, EgressStatus.FAILED, EgressStatus.ABORTED
                ):
                    self.server.telemetry.notify(
                        "egress_ended", egress=info.to_dict()
                    )

    # -- ingress fan-in (ioservice.go UpdateIngressState :180) ------------
    async def _ingress_worker(self, sub) -> None:
        from livekit_server_tpu_torch.service.ingress import IngressInfo, IngressState

        async for raw in sub:
            try:
                info = IngressInfo.from_dict(json.loads(raw))
            except (ValueError, TypeError):
                continue
            prev = self.ingresses.get(info.ingress_id)
            self.ingresses[info.ingress_id] = info
            self.stamp(info.ingress_id)
            if prev and prev.state != info.state:
                if info.state == IngressState.ENDPOINT_PUBLISHING:
                    self.server.telemetry.notify(
                        "ingress_started", ingress=info.to_dict()
                    )
                elif info.state in (
                    IngressState.ENDPOINT_COMPLETE, IngressState.ENDPOINT_ERROR
                ):
                    self.server.telemetry.notify(
                        "ingress_ended", ingress=info.to_dict()
                    )

    # -- lifecycle reaper (redisstore.go cleanup workers) -----------------
    async def _reaper(self) -> None:
        while True:
            await asyncio.sleep(self.REAP_INTERVAL_S)
            try:
                self.reap()
            except Exception:  # noqa: BLE001 — one bad webhook/telemetry
                # call must not kill lifecycle cleanup for the process.
                import logging

                logging.getLogger("ioinfo").exception("reap pass failed")

    def reap(self, now: float | None = None) -> None:
        """One cleanup pass (synchronous, directly testable)."""
        from livekit_server_tpu_torch.service.egress import EgressStatus
        from livekit_server_tpu_torch.service.ingress import IngressState

        if now is None:
            now = time.monotonic()
        ended_eg = (
            EgressStatus.COMPLETE, EgressStatus.FAILED, EgressStatus.ABORTED,
            EgressStatus.LIMIT_REACHED,
        )
        for eid, info in list(self.egresses.items()):
            age = now - self._stamp.get(eid, now)
            if info.status in ended_eg:
                if age > self.ENDED_TTL_S:
                    del self.egresses[eid]
                    self._stamp.pop(eid, None)
            elif age > self.STALE_ACTIVE_S:
                # Its worker/node died mid-job: fail it so clients stop
                # seeing a zombie ACTIVE record, then let the ended TTL
                # expire it.
                info.status = EgressStatus.FAILED
                info.error = "egress worker lost"
                info.ended_at = int(time.time())
                self.stamp(eid)
                self.server.telemetry.notify("egress_ended", egress=info.to_dict())
        ended_in = (IngressState.ENDPOINT_COMPLETE, IngressState.ENDPOINT_ERROR)
        for iid, info in list(self.ingresses.items()):
            age = now - self._stamp.get(iid, now)
            if info.state in ended_in:
                if age > self.ENDED_TTL_S:
                    del self.ingresses[iid]
                    self._stamp.pop(iid, None)
            elif info.state == IngressState.ENDPOINT_PUBLISHING and (
                age > self.STALE_ACTIVE_S
            ):
                info.state = IngressState.ENDPOINT_ERROR
                info.error = "ingress worker lost"
                self.stamp(iid)
                self.server.telemetry.notify("ingress_ended", ingress=info.to_dict())
            # ENDPOINT_INACTIVE configs are durable (reference keeps
            # ingress configurations until deleted) — never reaped.
        sip = getattr(self.server, "sip", None)
        if sip is not None and getattr(sip, "calls", None):
            for cid in list(sip.calls):
                if self._stamp.get(cid) is None:
                    self.stamp(cid)  # adopt pre-reaper records
                elif now - self._stamp[cid] > self.SIP_CALL_TTL_S:
                    del sip.calls[cid]
                    self._stamp.pop(cid, None)
