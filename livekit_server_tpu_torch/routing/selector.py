"""Node selection policies for room placement.

Reference parity: pkg/routing/selector — AnySelector (any.go:23),
CPULoadSelector (cpuload.go:24), SystemLoadSelector (sysload.go:24),
RegionAwareSelector (haversine distance over configured regions,
regionaware.go:26-120), sort-by policies (utils.go), availability checks
(interfaces.go:33-64). Media-plane addition: every policy first filters
nodes whose device room capacity is exhausted (plane occupancy), because a
batched-plane node saturates its room tensor long before its CPUs.
"""

from __future__ import annotations

import math
import random
from typing import Protocol

from livekit_server_tpu_torch.config.config import NodeSelectorConfig
from livekit_server_tpu_torch.routing.node import LocalNode, NodeState


class NoNodesAvailable(Exception):
    pass


class NodeSelector(Protocol):
    def select_node(self, nodes: list[LocalNode]) -> LocalNode: ...


def _filter_available(nodes: list[LocalNode]) -> list[LocalNode]:
    # Draining/stopping nodes are excluded EXPLICITLY, not just via
    # is_available()'s SERVING check: a node mid-drain (migration plane,
    # service/migration.py) must receive no new rooms regardless of how
    # the availability predicate evolves.
    out = [
        n for n in nodes
        if n.state != NodeState.SHUTTING_DOWN and n.is_available()
    ]
    # Plane capacity gate (batched-plane specific; no reference equivalent).
    out = [
        n
        for n in out
        if n.stats.plane_rooms_capacity == 0
        or n.stats.plane_rooms_used < n.stats.plane_rooms_capacity
    ]
    if not out:
        raise NoNodesAvailable
    return out


def _sort_by(nodes: list[LocalNode], key: str) -> list[LocalNode]:
    """selector/utils.go SelectSortedNode."""
    if key == "random" or not key:
        return random.sample(nodes, len(nodes))
    if key == "sysload":
        return sorted(nodes, key=lambda n: n.stats.load_avg_last1min)
    if key == "cpuload":
        return sorted(nodes, key=lambda n: n.stats.cpu_load)
    if key == "rooms":
        return sorted(nodes, key=lambda n: n.stats.num_rooms)
    raise ValueError(f"unknown sort_by: {key}")


class AnySelector:
    """any.go — any available node, sorted by policy."""

    def __init__(self, sort_by: str = "random"):
        self.sort_by = sort_by

    def select_node(self, nodes: list[LocalNode]) -> LocalNode:
        return _sort_by(_filter_available(nodes), self.sort_by)[0]


class CPULoadSelector:
    """cpuload.go — exclude nodes above the CPU load limit."""

    def __init__(self, cpu_load_limit: float = 0.9, sort_by: str = "random"):
        self.limit = cpu_load_limit
        self.sort_by = sort_by

    def select_node(self, nodes: list[LocalNode]) -> LocalNode:
        avail = _filter_available(nodes)
        ok = [n for n in avail if n.stats.cpu_load < self.limit]
        # Reference falls back to all nodes when none clear the bar.
        return _sort_by(ok or avail, self.sort_by)[0]


class SystemLoadSelector:
    """sysload.go — loadavg/NumCpus threshold variant."""

    def __init__(self, sysload_limit: float = 0.9, sort_by: str = "random"):
        self.limit = sysload_limit
        self.sort_by = sort_by

    def select_node(self, nodes: list[LocalNode]) -> LocalNode:
        avail = _filter_available(nodes)
        ok = [
            n
            for n in avail
            if n.stats.load_avg_last1min / max(n.stats.num_cpus, 1) < self.limit
        ]
        return _sort_by(ok or avail, self.sort_by)[0]


def haversine_km(lat1: float, lon1: float, lat2: float, lon2: float) -> float:
    """regionaware.go distanceBetween."""
    rl1, rl2 = math.radians(lat1), math.radians(lat2)
    dlat = rl2 - rl1
    dlon = math.radians(lon2 - lon1)
    a = math.sin(dlat / 2) ** 2 + math.cos(rl1) * math.cos(rl2) * math.sin(dlon / 2) ** 2
    return 6371.0 * 2 * math.asin(math.sqrt(a))


class RegionAwareSelector:
    """regionaware.go:26-120 — prefer nodes in the region closest to the
    current node's region; fall back to the inner selector over all."""

    def __init__(
        self,
        current_region: str,
        regions: list,
        inner: NodeSelector | None = None,
        sort_by: str = "random",
    ):
        self.current_region = current_region
        self.regions = {r.name: (r.lat, r.lon) for r in regions}
        self.inner = inner or AnySelector(sort_by)

    def _region_distance(self, region: str) -> float:
        if region == self.current_region:
            return 0.0
        if region not in self.regions or self.current_region not in self.regions:
            return math.inf
        here = self.regions[self.current_region]
        there = self.regions[region]
        return haversine_km(here[0], here[1], there[0], there[1])

    def select_node(self, nodes: list[LocalNode]) -> LocalNode:
        avail = _filter_available(nodes)
        by_dist = sorted(avail, key=lambda n: self._region_distance(n.region))
        best = self._region_distance(by_dist[0].region)
        if math.isinf(best):
            return self.inner.select_node(avail)
        closest = [n for n in by_dist if self._region_distance(n.region) == best]
        return self.inner.select_node(closest)


def create_selector(cfg: NodeSelectorConfig, current_region: str = "") -> NodeSelector:
    """routing.CreateRouter's selector construction (interfaces.go:116)."""
    if cfg.kind == "any":
        return AnySelector(cfg.sort_by)
    if cfg.kind == "cpuload":
        return CPULoadSelector(cfg.cpu_load_limit, cfg.sort_by)
    if cfg.kind == "sysload":
        return SystemLoadSelector(cfg.sysload_limit, cfg.sort_by)
    if cfg.kind == "regionaware":
        return RegionAwareSelector(current_region, cfg.regions, sort_by=cfg.sort_by)
    raise ValueError(f"unknown node selector kind: {cfg.kind}")
