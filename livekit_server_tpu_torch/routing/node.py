"""Node identity + stats.

Reference parity: pkg/routing/node.go:29-47 (LocalNode: guid, IP, NumCpus,
region, state, NodeStats) and prometheus.GetUpdatedNodeStats
(pkg/telemetry/prometheus/node.go:115-245), which feeds both the health
check and node selection. Stats here come from /proc + os (Linux), with
media-plane counters pushed in by the runtime each tick.
"""

from __future__ import annotations

import enum
import os
import time
from dataclasses import dataclass, field
from typing import ClassVar

from livekit_server_tpu_torch.utils import ids

# Wall-clock tolerance for peers that predate the monotonic heartbeat
# stamp (mono_at == 0): their updated_at may be skewed by NTP steps, so
# freshness checks widen by this much instead of trusting it exactly.
SKEW_ALLOWANCE_S = 2.0


class NodeState(enum.IntEnum):
    STARTING_UP = 0
    SERVING = 1
    SHUTTING_DOWN = 2


@dataclass
class NodeStats:
    """livekit.NodeStats equivalent (node registry + selector input)."""

    updated_at: float = 0.0
    # Sender-side monotonic stamp (time.monotonic() on the PUBLISHING
    # node), refreshed with every heartbeat. Meaningless to compare
    # across machines directly — receivers only watch whether it
    # ADVANCES (LocalNode.is_available), which no clock step can fake.
    mono_at: float = 0.0
    started_at: float = field(default_factory=time.time)
    num_rooms: int = 0
    num_clients: int = 0
    num_tracks_in: int = 0
    num_tracks_out: int = 0
    bytes_in_per_sec: float = 0.0
    bytes_out_per_sec: float = 0.0
    packets_in_per_sec: float = 0.0
    packets_out_per_sec: float = 0.0
    nack_per_sec: float = 0.0
    num_cpus: int = field(default_factory=lambda: os.cpu_count() or 1)
    cpu_load: float = 0.0        # 1-min loadavg / num_cpus
    load_avg_last1min: float = 0.0
    memory_used: float = 0.0
    memory_total: float = 0.0
    # Media-plane additions: plane occupancy drives placement before CPU does.
    plane_rooms_used: int = 0
    plane_rooms_capacity: int = 0
    # Paged plane: device page-pool headroom (0/0 on a dense plane). The
    # selector's room-count signal saturates long before a paged pool
    # does, so placement reads pages when they're reported.
    plane_pages_used: int = 0
    plane_pages_capacity: int = 0


def sample_system_stats(stats: NodeStats) -> NodeStats:
    """Refresh host-derived fields (node_linux.go equivalent)."""
    stats.updated_at = time.time()
    try:
        load1, _, _ = os.getloadavg()
        stats.load_avg_last1min = load1
        stats.cpu_load = load1 / max(stats.num_cpus, 1)
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as f:
            mem = dict(
                (line.split(":")[0], float(line.split()[1]))
                for line in f
                if ":" in line and len(line.split()) >= 2
            )
        stats.memory_total = mem.get("MemTotal", 0.0) * 1024
        stats.memory_used = (mem.get("MemTotal", 0.0) - mem.get("MemAvailable", 0.0)) * 1024
    except (OSError, ValueError):
        pass
    return stats


@dataclass
class LocalNode:
    """This process's identity in the cluster (node.go:29)."""

    node_id: str = field(default_factory=ids.new_node_id)
    ip: str = "127.0.0.1"
    region: str = ""
    state: NodeState = NodeState.SERVING
    stats: NodeStats = field(default_factory=NodeStats)

    # Receiver-side freshness observations, process-wide: node_id →
    # (newest sender mono_at seen, OUR monotonic clock when it first
    # appeared). Freshness is judged entirely on the RECEIVER's clock —
    # a peer whose wall clock stepped hours is neither falsely killed
    # (its advancing mono_at keeps refreshing the entry) nor falsely
    # alive (a dead node's stamp stops advancing and the entry ages on
    # our clock). Bounded by cluster size: one entry per node ever seen.
    _freshness: ClassVar[dict[str, tuple[float, float]]] = {}

    def to_dict(self) -> dict:
        d = {
            "node_id": self.node_id,
            "ip": self.ip,
            "region": self.region,
            "state": int(self.state),
        }
        d["stats"] = {k: v for k, v in vars(self.stats).items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LocalNode":
        stats = NodeStats(**d.get("stats", {}))
        return cls(
            node_id=d["node_id"],
            ip=d.get("ip", ""),
            region=d.get("region", ""),
            state=NodeState(d.get("state", 1)),
            stats=stats,
        )

    def is_available(self, max_age: float = 30.0) -> bool:
        """selector/interfaces.go IsAvailable — serving + fresh stats.

        Skew-tolerant: peers publishing a monotonic heartbeat stamp are
        judged by whether that stamp still ADVANCES, timed on the
        receiver's own clock; the wall-clock comparison survives only as
        a widened fallback for stamp-less peers."""
        if self.state != NodeState.SERVING:
            return False
        mono = self.stats.mono_at
        if mono:
            seen = LocalNode._freshness.get(self.node_id)
            now = time.monotonic()
            if seen is None or mono > seen[0]:
                LocalNode._freshness[self.node_id] = (mono, now)
                return True
            return now - seen[1] < max_age
        delta = time.time() - self.stats.updated_at
        return delta < max_age + SKEW_ALLOWANCE_S
