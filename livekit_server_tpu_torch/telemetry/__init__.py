"""Telemetry: lifecycle events, metrics, webhooks.

Reference parity: pkg/telemetry (SURVEY.md §2.6) — TelemetryService event
queue (events.go:30-552), prometheus counters (prometheus/packets.go,
rooms.go, node.go), webhook notifier. Counters here are plain dicts
rendered in Prometheus text format (prometheus_client is available but a
dependency-free registry keeps the hot path allocation-free); media-plane
counters are pushed in per tick from PlaneRuntime stats.
"""

from livekit_server_tpu_torch.telemetry.service import TelemetryService
from livekit_server_tpu_torch.telemetry.webhook import WebhookNotifier

__all__ = ["TelemetryService", "WebhookNotifier"]
