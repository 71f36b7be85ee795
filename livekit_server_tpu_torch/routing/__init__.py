"""Routing / distribution layer.

Reference parity: pkg/routing (SURVEY.md §2.3) — the "distributed
communication backend". Node registry, room→node pinning, participant
signal relay, and placement selectors. Single-node mode uses in-memory
channels (LocalRouter, pkg/routing/localrouter.go). A "node" is a host
driving the batched media plane on its device. The port carries the
single-node router only; the multi-node router over a shared bus
(pkg/routing/redisrouter.go) waits for the bus (ROADMAP A13).
"""

from livekit_server_tpu_torch.routing.messagechannel import ChannelClosed, ChannelFull, MessageChannel
from livekit_server_tpu_torch.routing.node import LocalNode, NodeState, NodeStats
from livekit_server_tpu_torch.routing.router import (
    LocalRouter,
    ParticipantInit,
    Router,
    RouterError,
)
from livekit_server_tpu_torch.routing.selector import (
    AnySelector,
    CPULoadSelector,
    NodeSelector,
    RegionAwareSelector,
    SystemLoadSelector,
    create_selector,
)

__all__ = [
    "AnySelector",
    "CPULoadSelector",
    "ChannelClosed",
    "ChannelFull",
    "LocalNode",
    "LocalRouter",
    "MessageChannel",
    "NodeSelector",
    "NodeState",
    "NodeStats",
    "ParticipantInit",
    "RegionAwareSelector",
    "Router",
    "RouterError",
    "SystemLoadSelector",
    "create_selector",
]
