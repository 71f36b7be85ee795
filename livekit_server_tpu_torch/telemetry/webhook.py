"""Webhook notifier: signed POSTs of lifecycle events.

Reference parity: livekit/protocol webhook notifier as configured by
config.go WebHookConfig and fed from telemetry events — each event is
POSTed to every configured URL with an Authorization JWT whose sha256
claim covers the body (the reference's webhook verification scheme).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
from typing import Any

from livekit_server_tpu_torch.auth.token import AccessToken
from livekit_server_tpu_torch.config.config import Config


class WebhookNotifier:
    def __init__(self, config: Config, client=None):
        self.urls = list(config.webhook.urls)
        self.api_key = config.webhook.api_key or (
            next(iter(config.keys)) if config.keys else ""
        )
        self.api_secret = config.keys.get(self.api_key, "")
        self._client = client  # injectable for tests; lazy aiohttp otherwise
        self._tasks: set[asyncio.Task] = set()
        self.sent = 0
        self.failed = 0

    def queue(self, event: dict[str, Any]) -> None:
        if not self.urls:
            return
        try:
            task = asyncio.ensure_future(self._send(event))
        except RuntimeError:
            return  # no running loop (sync tests): drop
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _sign(self, body: bytes) -> str:
        import base64

        tok = AccessToken(self.api_key, self.api_secret)
        tok.identity = self.api_key
        tok.ttl = 300
        # sha256 claim covers the body (livekit webhook verification)
        tok.sha256 = base64.b64encode(hashlib.sha256(body).digest()).decode()
        return tok.to_jwt()

    async def _send(self, event: dict[str, Any]) -> None:
        body = json.dumps(event).encode()
        headers = {
            "Authorization": self._sign(body),
            "Content-Type": "application/webhook+json",
        }
        for url in self.urls:
            try:
                if self._client is not None:
                    await self._client(url, body, headers)
                else:
                    import aiohttp

                    async with aiohttp.ClientSession() as s:
                        async with s.post(
                            url, data=body, headers=headers,
                            timeout=aiohttp.ClientTimeout(total=5)
                        ) as resp:
                            await resp.read()
                self.sent += 1
            except Exception:  # noqa: BLE001 — webhook failures never break the room
                self.failed += 1

    async def close(self) -> None:
        for t in list(self._tasks):
            t.cancel()
