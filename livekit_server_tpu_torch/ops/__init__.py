"""Leaf algebra of the media plane, as batched PyTorch.

Each module is the counterpart of the same-named module of the JAX
package: NamedTuples of tensors with the same field names, int32 lanes
for uint16/uint32 RTP values (two's-complement wrap), Python loops over
the small packet axis K where the reference scans. Functions batch over
any leading axes, so the room axis R is written out instead of vmapped.

The two Pallas kernels of the dense tick have hand-written CUDA
counterparts: `selector.decide_rooms` (phase 0) and
`allocation.allocate_budget_rooms` (phase 2); so has the paged tick's,
`paged_kernel.decide_pages`. One more kernel replaces no Pallas kernel:
`rtpstats.route_update_tick`, the dense tick's RTP-stats routing and
fold over K (phase 1). Each of the four wrappers launches its kernel on
CUDA tensors and runs its plain PyTorch version only on CPU tensors (see
ops/cuda.py).
"""
