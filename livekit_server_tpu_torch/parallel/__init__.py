"""Room shards over devices for the media plane.

Port of the JAX package's parallel/ package. The reference shards the
`[R]` room axis of `PlaneState` / `TickInputs` over a device mesh and
steps every shard in one `shard_map` program; the port splits the same
axis over an ordered tuple of torch devices (GPUs, or repeats of one
device) and steps each shard on its own device and stream. Host-side
room placement across nodes lives in livekit_server_tpu_torch.routing;
this package owns the device side.
"""

from livekit_server_tpu_torch.parallel.mesh import (
    ROOM_AXIS,
    make_mesh,
    make_sharded_tick,
    room_sharding,
    shard_tree,
)

__all__ = [
    "ROOM_AXIS",
    "make_mesh",
    "make_sharded_tick",
    "room_sharding",
    "shard_tree",
]
