"""Routing / distribution layer.

Reference parity: pkg/routing (SURVEY.md §2.3) — the "distributed
communication backend". Node registry, room→node pinning, participant
signal relay, and placement selectors. Single-node mode uses in-memory
channels (LocalRouter, pkg/routing/localrouter.go); multi-node mode runs
over a shared KV + pub/sub bus (KVRouter — the seat Redis occupies in
pkg/routing/redisrouter.go; MemoryBus in one process, TCPBusClient to a
BusServer across processes). A "node" is a host driving the batched
media plane on its device.
"""

from livekit_server_tpu_torch.routing.kv import MemoryBus, MessageBus
from livekit_server_tpu_torch.routing.messagechannel import ChannelClosed, ChannelFull, MessageChannel
from livekit_server_tpu_torch.routing.node import LocalNode, NodeState, NodeStats
from livekit_server_tpu_torch.routing.router import (
    KVRouter,
    LocalRouter,
    ParticipantInit,
    Router,
    RouterError,
    create_router,
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
    "KVRouter",
    "LocalNode",
    "LocalRouter",
    "MemoryBus",
    "MessageBus",
    "MessageChannel",
    "NodeSelector",
    "NodeState",
    "NodeStats",
    "ParticipantInit",
    "RegionAwareSelector",
    "Router",
    "RouterError",
    "create_router",
    "SystemLoadSelector",
    "create_selector",
]
