"""Event fan-in + metrics registry.

Reference parity: pkg/telemetry/telemetryservice.go:29-200 (single
consumer queue of room/participant/track lifecycle events), events.go
(the ~30 event constructors), prometheus/*.go counters. Events fan out to
the webhook notifier (webhook.go) and increment counters; `prometheus_text`
renders the registry in the exposition format served at /metrics.
"""

from __future__ import annotations

import asyncio
import time
from collections import defaultdict
from typing import Any

import numpy as np

from livekit_server_tpu_torch.config.config import Config
from livekit_server_tpu_torch.telemetry.webhook import WebhookNotifier

# Event names follow the reference's webhook event strings
# (webhook.go EventRoomStarted etc.).
EVENTS = {
    "room_started",
    "room_finished",
    "participant_joined",
    "participant_left",
    "track_published",
    "track_unpublished",
    "egress_started",
    "egress_ended",
    "ingress_started",
    "ingress_ended",
}


class Histogram:
    """Prometheus histogram fed with numpy batches (the batched analog of
    prometheus/packets.go's per-packet observations)."""

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = np.asarray(buckets, np.float64)
        # One extra slot for overflow (> last finite bucket → +Inf only).
        self.counts = np.zeros(len(buckets) + 1, np.int64)
        self.sum = 0.0
        self.count = 0

    def observe(self, values) -> None:
        v = np.atleast_1d(np.asarray(values, np.float64))
        if not len(v):
            return
        self.count += len(v)
        self.sum += float(v.sum())
        idx = np.searchsorted(self.buckets, v, side="left")
        self.counts += np.bincount(idx, minlength=len(self.buckets) + 1)

    def render(self, name: str, lines: list[str],
               labels: dict[str, str] | None = None) -> None:
        # Extra labels (e.g. stage="device") precede the cumulative `le`
        # label on every series of the family.
        lbl = (
            "".join(f'{k}="{v}",' for k, v in sorted(labels.items()))
            if labels else ""
        )
        sfx = f"{{{lbl[:-1]}}}" if lbl else ""
        cum = 0
        for b, c in zip(self.buckets, self.counts[:-1]):
            cum += int(c)
            lines.append(f'{name}_bucket{{{lbl}le="{b:g}"}} {cum}')
        lines.append(f'{name}_bucket{{{lbl}le="+Inf"}} {self.count}')
        lines.append(f"{name}_sum{sfx} {self.sum:g}")
        lines.append(f"{name}_count{sfx} {self.count}")


# Bucket ladders (prometheus/packets.go + connectionquality histograms).
_HIST_SPECS = {
    "livekit_track_loss_percent": (0.0, 0.5, 1, 2, 5, 10, 20, 50, 100),
    "livekit_track_jitter_ms": (0.5, 1, 2, 5, 10, 20, 50, 100, 200),
    "livekit_track_bitrate_kbps": (16, 64, 150, 500, 1000, 2000, 4000, 8000),
    "livekit_forward_latency_ms": (1, 2, 5, 10, 20, 50, 100, 250, 1000),
    "livekit_tick_duration_ms": (0.5, 1, 2, 5, 10, 20, 50, 100, 250),
}

# Per-stage wire-latency decomposition (runtime/trace.py
# LatencyAttribution): one histogram per stage label.
_STAGE_BUCKETS = (0.5, 1, 2, 5, 10, 20, 50, 100, 250)

# One-line HELP strings per metric family (exposition-format HELP/TYPE
# headers; families not listed fall back to the family name itself).
_HELP = {
    "livekit_forward_latency_ms": "Sampled packet arrival-to-wire latency (both egress tiers)",
    "livekit_wire_latency_stage_ms": "Sampled wire latency decomposed by pipeline stage",
    "livekit_tick_duration_ms": "Media-plane tick work time (stage+device+fanout)",
    "livekit_host_egress_pps": "Host egress datagrams/s EMA over both tiers",
    "livekit_plane_sleep_bias_us": "Calibrated tick-edge coarse-sleep overshoot margin",
    "livekit_plane_edge_overshoot_us": "Last tick-edge wake overshoot",
    "livekit_events_total": "Lifecycle events by type",
}


class TelemetryService:
    def __init__(self, config: Config):
        self.config = config
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.histograms = {k: Histogram(v) for k, v in _HIST_SPECS.items()}
        # Stage-labelled wire-latency histograms (one per stage key fed
        # by observe_wire_stages); rendered as one labelled family.
        self.stage_hists: dict[str, Histogram] = {}
        self.events: list[dict[str, Any]] = []  # ring of recent events
        # Per-track analytics records (~1/s per published track — the
        # statsworker.go → analytics stream seat; ring-buffered, served at
        # /debug/analytics).
        self.track_stats: list[dict[str, Any]] = []
        self.webhook = WebhookNotifier(config)

    # -- events (events.go) ----------------------------------------------
    def notify(self, event: str, **payload: Any) -> None:
        if event not in EVENTS:
            return
        self.counters[f"livekit_events_total{{event=\"{event}\"}}"] += 1
        record = {"event": event, "created_at": int(time.time()), **payload}
        self.events.append(record)
        if len(self.events) > 1000:
            del self.events[: len(self.events) - 1000]
        self.webhook.queue(record)

    # -- counters (prometheus/packets.go naming) -------------------------
    def add(self, name: str, value: float = 1.0, **labels: str) -> None:
        self.counters[_key(name, labels)] += value

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        self.gauges[_key(name, labels)] = value

    def observe_plane(self, stats: dict[str, Any]) -> None:
        """Per-tick media-plane stats → node counters (statsworker.go)."""
        self.set_gauge("livekit_plane_ticks_total", stats.get("ticks", 0))
        self.set_gauge("livekit_packets_forwarded_total", stats.get("fwd_packets", 0))
        self.set_gauge("livekit_bytes_forwarded_total", stats.get("fwd_bytes", 0))
        self.set_gauge("livekit_plane_late_ticks_total", stats.get("late_ticks", 0))
        # Pipeline-stage seconds (three-stage tick loop) + control-upload
        # accounting — cumulative, so rates are scrape-window deltas.
        for k in ("stage_s", "device_s", "fanout_s"):
            self.set_gauge(f"livekit_plane_{k}_total", stats.get(k, 0.0))
        for k in ("pipeline_stalls", "ctrl_full_uploads", "ctrl_delta_uploads",
                  "ctrl_delta_rows", "ctrl_upload_bytes"):
            self.set_gauge(f"livekit_plane_{k}_total", stats.get(k, 0))
        # Tick-edge calibration: measured coarse-sleep bias + last wake
        # overshoot (plane_runtime._sleep_until / _calibrate_sleep).
        self.set_gauge(
            "livekit_plane_sleep_bias_us", stats.get("sleep_bias_us", 0.0)
        )
        self.set_gauge(
            "livekit_plane_edge_overshoot_us",
            stats.get("edge_overshoot_us", 0.0),
        )

    def observe_overload(self, snap: dict[str, Any]) -> None:
        """Overload-governor state (runtime/governor.py stats_dict):
        ladder level, transition counts, the split ingest drop counters,
        and admission rejections by kind and by canonical cause."""
        self.set_gauge("livekit_governor_level", snap.get("level", 0))
        self.set_gauge("livekit_governor_escalations_total", snap.get("escalations", 0))
        self.set_gauge("livekit_governor_transitions_total", snap.get("transitions_total", 0))
        for k in ("dropped_capacity", "dropped_fault", "dropped_policed"):
            self.set_gauge(f"livekit_ingest_{k}_total", snap.get(k, 0))
        for kind, n in snap.get("rejected", {}).items():
            self.set_gauge("livekit_admission_rejected_total", n, kind=str(kind))
        for reason, n in snap.get("denied_reasons", {}).items():
            self.set_gauge("livekit_admission_denied_total", n, reason=str(reason))

    def observe_integrity(self, snap: dict[str, Any]) -> None:
        """State-integrity plane (runtime/integrity.py stats_dict +
        checkpoint codec counters): audits run, violations by rule, the
        repair ladder's outcomes, and checksum verification failures."""
        from livekit_server_tpu_torch.utils.checksum import CodecStats

        self.set_gauge("livekit_integrity_audits_total", snap.get("audits", 0))
        self.set_gauge("livekit_integrity_violations_total", snap.get("violations_total", 0))
        for rule, n in snap.get("violations_by_rule", {}).items():
            self.set_gauge("livekit_integrity_rule_violations_total", n, rule=str(rule))
        for k in ("rows_quarantined", "rows_repaired", "repair_failures", "escalations"):
            self.set_gauge(f"livekit_integrity_{k}_total", snap.get(k, 0))
        self.set_gauge("livekit_integrity_quarantined_rows",
                       len(snap.get("quarantined_rows", [])))
        self.set_gauge("livekit_ckpt_checksum_failures_total", CodecStats.verify_failures)
        self.set_gauge("livekit_ckpt_generation_fallbacks_total",
                       snap.get("generation_fallbacks", 0))

    def observe_pager(self, snap: dict[str, Any]) -> None:
        """Paged room-state plane (runtime/pager.py stats()): device page
        pool occupancy, fragmentation, and churn counters. Only emitted
        when the plane runs paged — a dense plane has no pager."""
        self.set_gauge("livekit_page_pool_used", snap.get("pages_used", 0))
        self.set_gauge("livekit_page_pool_total", snap.get("pages_total", 0))
        self.set_gauge(
            "livekit_page_fragmentation_ratio",
            snap.get("fragmentation_ratio", 0.0),
        )
        self.set_gauge(
            "livekit_page_internal_slack", snap.get("internal_slack", 0)
        )
        # Mapped fraction of the pool == the paged kernel's scheduled-
        # grid fraction (ops/paged_kernel.py: one grid step per live
        # page — dead pages are never scheduled).
        self.set_gauge(
            "livekit_page_live_fraction", snap.get("page_live_fraction", 0.0)
        )
        for k in ("allocs", "frees", "grows", "compactions",
                  "alloc_failures", "table_repairs"):
            self.set_gauge(f"livekit_pager_{k}_total", snap.get(k, 0))

    def observe_queue_drops(self) -> None:
        """Bus/signal back-pressure drops (the QueueFull paths that used
        to lose messages with at most a local count): process-wide class
        counters read at scrape/tick time."""
        from livekit_server_tpu_torch.routing.kv import Subscription
        from livekit_server_tpu_torch.routing.messagechannel import MessageChannel

        self.set_gauge(
            "livekit_signal_channel_dropped_total", MessageChannel.total_dropped
        )
        self.set_gauge(
            "livekit_bus_sub_dropped_total", Subscription.total_dropped
        )

    def observe_transport(self, stats: dict[str, Any]) -> None:
        """UDP/TCP media-wire counters (prometheus/packets.go direction
        labels: rx/tx, plus NACK/PLI/RTX feedback volumes)."""
        for k in ("rx", "tx", "rtx_tx", "nacks_rx", "nacks_tx",
                  "plis_rx", "plis_tx", "bad_frame", "red_tx", "red_rx"):
            if k in stats:
                self.set_gauge(f"livekit_media_{k}_total", stats[k])

    def observe_tick_latency(self, tick_s: float) -> None:
        # Tick work time gets its own family now;
        # livekit_forward_latency_ms is fed by the attribution sampler
        # (observe_wire_stages) with true arrival→wire packet latencies.
        self.histograms["livekit_tick_duration_ms"].observe(tick_s * 1000.0)

    def observe_wire_stages(self, drained: dict[str, Any]) -> None:
        """Sampled per-stage wire-latency arrays (runtime/trace.py
        LatencyAttribution.drain()) → stage histograms, with the end-to-
        end samples also feeding livekit_forward_latency_ms ('total'
        already covers BOTH tiers — the express observer pushes each
        sample into 'express' and 'total')."""
        for stage, vals in drained.items():
            if not len(vals):
                continue
            h = self.stage_hists.get(stage)
            if h is None:
                h = self.stage_hists[stage] = Histogram(_STAGE_BUCKETS)
            h.observe(vals)
            if stage == "total":
                self.histograms["livekit_forward_latency_ms"].observe(vals)

    def observe_tracks(self, loss_pct, jitter_ms, bps) -> None:
        """Windowed per-track receive stats (device reductions) → quality
        histograms; called when the ~1 s stats window rolls."""
        self.histograms["livekit_track_loss_percent"].observe(loss_pct)
        self.histograms["livekit_track_jitter_ms"].observe(jitter_ms)
        self.histograms["livekit_track_bitrate_kbps"].observe(
            np.asarray(bps, np.float64) / 1000.0
        )

    def track_stat(self, **record: Any) -> None:
        """One per-track analytics record (statsworker.go AnalyticsStat)."""
        record["ts"] = int(time.time())
        self.track_stats.append(record)
        if len(self.track_stats) > 2000:
            del self.track_stats[: len(self.track_stats) - 2000]

    def prometheus_text(self) -> str:
        lines: list[str] = []
        seen: set[str] = set()

        def header(key: str, mtype: str) -> None:
            fam = key.split("{", 1)[0]
            if fam in seen:
                return
            seen.add(fam)
            lines.append(f"# HELP {fam} {_HELP.get(fam, fam)}")
            lines.append(f"# TYPE {fam} {mtype}")

        for key, v in sorted(self.counters.items()):
            header(key, "counter")
            lines.append(f"{key} {v:g}")
        for key, v in sorted(self.gauges.items()):
            header(key, "gauge")
            lines.append(f"{key} {v:g}")
        for name, h in sorted(self.histograms.items()):
            header(name, "histogram")
            h.render(name, lines)
        if self.stage_hists:
            header("livekit_wire_latency_stage_ms", "histogram")
            for stage, h in sorted(self.stage_hists.items()):
                h.render(
                    "livekit_wire_latency_stage_ms", lines, {"stage": stage}
                )
        return "\n".join(lines) + "\n"

    async def close(self) -> None:
        await self.webhook.close()


def _key(name: str, labels: dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"
