"""Room shards over devices: the media plane split along its room axis.

Port of the JAX package's parallel/mesh.py. There, every media-plane
tensor carries a leading `[R]` room axis sharded over a
`jax.sharding.Mesh`, and the tick runs under `shard_map`, traced per
shard, so the Pallas grids are shard-local and no collective runs on the
hot path. Here:

* a `Mesh` is an ordered tuple of torch devices. Devices may repeat: N
  shards on one card (or on the CPU) are the same mechanism as N cards,
  and the CPU tests run 8 shards on `cpu`;
* a `Sharded` tree holds one tree per shard: rows [start, stop) of every
  leaf with a leading axis, on that shard's device (`room_sharding`),
  with 0-d leaves replicated (`shard_tree`, `gather_tree` its inverse);
* `make_sharded_tick` runs models/plane.py `media_plane_tick` once per
  shard, under the shard's device and on a stream of its own, launching
  every shard before it waits on any: B1 (`decide_rooms`) and B2
  (`allocate_budget_rooms`) launch once per shard a tick at [R/N, ...].
  Every output has a leading [R], so the outputs are the shards' outputs
  joined in room order. No leaf of PlaneState or TickOutputs is 0-d.

The paged pool's page axis is split the same way (`page_sharding`,
`shard_pool`). Pages are not independent: the stock pooled tick gathers
a room's sub column across its track pages (`tmembers`). A shard
computes its own pages plus copies of the pages that its rooms hold on
other shards (the halo, `PoolPlan`), copied explicitly and counted;
these stand in for the gathers GSPMD inserts in the reference. A
shard's pages and their halo are closed under `tmembers`, so every own
page computes exactly what the unsharded tick computes.

Every kernel launch runs under `torch.cuda.device(shard_device)` from
the caller's thread: the wrappers launch on the current device's stream
and the kernels' occupancy cache reads the current device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from livekit_server_tpu_torch.models import paged, plane
from livekit_server_tpu_torch.ops import audio as audio_ops, bwe as bwe_ops

ROOM_AXIS = "rooms"


class Mesh:
    """A 1-D mesh over the room axis: an ordered tuple of torch devices,
    repeats allowed. A CUDA device that is not visible raises."""

    def __init__(self, devices: Sequence[torch.device | str]):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(f"mesh device {d}: no CUDA device is available")
                index = torch.cuda.current_device() if d.index is None else d.index
                if not 0 <= index < torch.cuda.device_count():
                    raise ValueError(f"mesh device {d}: not visible "
                                     f"({torch.cuda.device_count()} CUDA devices)")
                d = torch.device("cuda", index)
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices: Sequence[torch.device | str] | None = None,
              n_devices: int | None = None) -> Mesh:
    """1-D mesh over the room axis. Defaults to every visible CUDA device
    and raises without a card unless `devices` is given; `n_devices`
    takes the first n."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. [torch.device('cpu')] * 8) for CPU shards")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if not 0 < n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices}: the mesh has {len(devices)} devices")
        devices = devices[:n_devices]
    return Mesh(devices)


def _bounds(mesh: Mesh, n: int, axis: str) -> tuple[tuple[int, int], ...]:
    N = mesh.size
    if n % N:
        raise ValueError(f"{axis} axis of {n} does not divide evenly over the mesh: "
                         f"R={n}, N={N}")
    step = n // N
    return tuple((i * step, (i + 1) * step) for i in range(N))


def room_sharding(mesh: Mesh, rooms: int) -> tuple[tuple[int, int], ...]:
    """The contiguous [start, stop) room range of each shard."""
    return _bounds(mesh, rooms, "room")


def page_sharding(mesh: Mesh, pages: int) -> tuple[tuple[int, int], ...]:
    """The contiguous [start, stop) page range of each shard of the paged
    pool (the same split, over the pool's page axis)."""
    return _bounds(mesh, pages, "page")


class Sharded:
    """A tree split over `mesh` along its leaves' leading axis: shard i is
    a tree of the same structure on `mesh.devices[i]`."""

    def __init__(self, mesh: Mesh, shards: Sequence[Any]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.mesh = mesh
        self.shards = list(shards)

    def map(self, fn: Callable[[Any], Any]) -> "Sharded":
        """The sharded tree of `fn(shard)` (e.g. a subtree)."""
        return Sharded(self.mesh, [fn(t) for t in self.shards])

    def leading(self) -> int:
        """The global leading size of the first leaf."""
        return sum(plane.tree_leaves(t)[0].shape[0] for t in self.shards)


def _split(tree: Any, mesh: Mesh, sharding: Callable) -> Sharded:
    per_shard: list[list] = [[] for _ in mesh.devices]
    for x in plane.tree_leaves(tree):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.dim() == 0:
            for i, d in enumerate(mesh.devices):
                per_shard[i].append(t.to(d, copy=True))
            continue
        for i, (a, b) in enumerate(sharding(mesh, t.shape[0])):
            per_shard[i].append(t[a:b].to(mesh.devices[i], copy=True).contiguous())
    return Sharded(mesh, [plane.tree_unflatten(tree, leaves) for leaves in per_shard])


def shard_tree(tree: Any, mesh: Mesh) -> Sharded:
    """Split every leaf with a leading [R] over the mesh onto fresh tensors
    on each shard's device; 0-d leaves are replicated. Leaves may be
    tensors or numpy arrays."""
    return _split(tree, mesh, room_sharding)


def shard_pool(tree: Any, mesh: Mesh) -> Sharded:
    """`shard_tree` for the paged pool's state and page table: every
    leaf's leading (page or room) axis is split over the mesh."""
    return _split(tree, mesh, page_sharding)


def gather_tree(tree: Sharded, device="cpu") -> Any:
    """The inverse of `shard_tree`: each leaf's shards joined in order on
    `device` (a 0-d leaf from shard 0)."""
    dev = torch.device(device)
    cols = zip(*[plane.tree_leaves(t) for t in tree.shards])
    leaves = [c[0].to(dev, copy=True) if c[0].dim() == 0
              else torch.cat([x.to(dev) for x in c]) for c in cols]
    return plane.tree_unflatten(tree.shards[0], leaves)


def split_rows(mesh: Mesh, n: int, rows) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """Global rows of an axis of `n` → [(shard, positions in `rows`, local
    rows)] for each shard that owns any of them."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    step = room_sharding(mesh, n)[0][1]
    owner = rows // step
    out = []
    for i in np.unique(owner).tolist():
        pos = np.nonzero(owner == i)[0]
        out.append((i, pos, rows[pos] - i * step))
    return out


def locate(tree: Sharded, row: int) -> tuple[Any, int]:
    """(the shard's tree, local row) holding global `row` of the leading
    axis of the first leaf."""
    (i, _, local), = split_rows(tree.mesh, tree.leading(), [row])
    return tree.shards[i], int(local[0])


def write_rows(tree: Sharded, rows, leaves: list) -> None:
    """Write `leaves` (per flat leaf, a host array or CPU tensor with a
    leading axis over `rows`) into global `rows` of every leaf, in place,
    on each owning shard."""
    for i, pos, local in split_rows(tree.mesh, tree.leading(), rows):
        dev = tree.mesh.devices[i]
        idx = torch.as_tensor(local, device=dev)
        for leaf, v in zip(plane.tree_leaves(tree.shards[i]), leaves):
            leaf[idx] = torch.as_tensor(np.asarray(v)[pos]).to(device=dev, dtype=leaf.dtype)


def read_rows(tree: Sharded, rows) -> Any:
    """Global `rows` of every leaf as a tree of CPU tensors."""
    rows = np.asarray(rows, np.int64).reshape(-1)
    tmpl = plane.tree_leaves(tree.shards[0])
    out = [torch.empty((len(rows),) + tuple(x.shape[1:]), dtype=x.dtype) for x in tmpl]
    for i, pos, local in split_rows(tree.mesh, tree.leading(), rows):
        idx = torch.as_tensor(local, device=tree.mesh.devices[i])
        for o, leaf in zip(out, plane.tree_leaves(tree.shards[i])):
            o[torch.as_tensor(pos)] = leaf.index_select(0, idx).cpu()
    return plane.tree_unflatten(tree.shards[0], out)


def shard_wires(packed, mesh: Mesh) -> list[np.ndarray]:
    """Host-side: packed inputs (`plane.pack_tick_inputs`: pkt [F, R, ...],
    fb [8, R, S], tf [1, R, T], the two scalars) → one wire per shard
    (its rows of axis 1), so each shard's step makes one host→device
    copy. R is rooms, or pages for the paged pool."""
    pkt, fb, tf, tick_ms, roll = packed
    return [plane.wire_inputs((pkt[:, a:b], fb[:, a:b], tf[:, a:b], tick_ms, roll))
            for a, b in room_sharding(mesh, pkt.shape[1])]


def upload_wires(wires: list[np.ndarray], mesh: Mesh, dims: plane.PlaneDims) -> Sharded:
    """Each shard's wire onto its device as TickInputs (`dims` the whole
    plane's)."""
    part = dims._replace(rooms=dims.rooms // mesh.size)
    return Sharded(mesh, [
        plane.unpack_tick_inputs(*plane.unwire_inputs(torch.from_numpy(w).to(d), part))
        for w, d in zip(wires, mesh.devices)])


class _ShardRunner:
    """One stream per shard (CUDA), and the context that makes a shard's
    device and stream current."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                        for d in mesh.devices]

    @contextlib.contextmanager
    def on(self, i: int):
        s = self.streams[i]
        if s is None:
            yield
            return
        d = self.mesh.devices[i]
        with torch.cuda.device(d):
            s.wait_stream(torch.cuda.current_stream(d))
            with torch.cuda.stream(s):
                yield

    def join(self) -> None:
        """Make each device's current stream wait for its shards' work."""
        for d, s in zip(self.mesh.devices, self.streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)

    def fetch(self, packed: list[torch.Tensor]) -> list[np.ndarray]:
        """Each shard's flat output buffer to the host, shard by shard
        (each copy waits for its own shard only)."""
        bufs = []
        for i, buf in enumerate(packed):
            with self.on(i):
                bufs.append(buf.cpu().numpy())
        self.join()
        return bufs


def join_outputs(bufs: list[np.ndarray], dims: plane.PlaneDims,
                 red_enabled: bool = True) -> plane.TickOutputs:
    """Per-shard flat output buffers → numpy TickOutputs at `dims` (the
    full plane), joined in row order."""
    part = dims._replace(rooms=dims.rooms // len(bufs))
    outs = [plane.unpack_tick_outputs(b, part, red_enabled) for b in bufs]
    if len(outs) == 1:
        return outs[0]                  # views of the one buffer, no copy
    return plane.TickOutputs(*[np.concatenate(xs) for xs in zip(*outs)])


class ShardedTick:
    """The dense media-plane tick over room shards (see the module
    docstring). With `donate`, each shard's new state is written into the
    tensors of the state it was given, which is returned; otherwise the
    state given is left as it was and a new one is returned."""

    def __init__(self, mesh: Mesh, audio_params=None, bwe_params=None,
                 donate: bool = True, red_enabled: bool = True):
        self.mesh = mesh
        self.ap = audio_params or audio_ops.AudioLevelParams()
        self.bp = bwe_params or bwe_ops.BWEParams()
        self.donate = donate
        self.red_enabled = red_enabled
        self._runner = _ShardRunner(mesh)

    def _run(self, state: Sharded, inputs_of: Callable[[int], plane.TickInputs]):
        if state.mesh.devices != self.mesh.devices:
            raise ValueError(f"state on {state.mesh}, tick on {self.mesh}")
        shards, packed = [], []
        for i, old in enumerate(state.shards):
            with self._runner.on(i):
                new, out = plane.media_plane_tick(old, inputs_of(i), self.ap, self.bp,
                                                  red_enabled=self.red_enabled)
                if self.donate:
                    for dst, src in zip(plane.tree_leaves(old), plane.tree_leaves(new)):
                        dst.copy_(src)
                    new = old
                shards.append(new)
                packed.append(plane.pack_tick_outputs(out))
        bufs = self._runner.fetch(packed)
        return (state if self.donate else Sharded(self.mesh, shards)), bufs

    def __call__(self, state: Sharded, inp: Sharded):
        """(sharded state, sharded TickInputs) → (state', numpy TickOutputs
        joined in room order)."""
        state, bufs = self._run(state, lambda i: inp.shards[i])
        dims = plane.PlaneDims(state.leading(), *inp.shards[0].sn.shape[1:],
                               inp.shards[0].estimate.shape[-1])
        return state, join_outputs(bufs, dims, self.red_enabled)

    def device_step(self, state: Sharded, wires: list[np.ndarray], dims: plane.PlaneDims):
        """The sharded counterpart of `plane.device_step`: each shard's
        wire (`shard_wires`) up to its device, the tick, each shard's flat
        output buffer down. Returns (state', per-shard numpy buffers)."""
        part = dims._replace(rooms=dims.rooms // self.mesh.size)
        devs = self.mesh.devices

        def inputs_of(i):
            buf = torch.from_numpy(wires[i]).to(devs[i])
            return plane.unpack_tick_inputs(*plane.unwire_inputs(buf, part))

        return self._run(state, inputs_of)

    def device_tick(self, state: Sharded, wires: list[np.ndarray], dims: plane.PlaneDims):
        """`device_step` and the join of its buffers: what the meshed
        `PlaneRuntime._device_step` runs a tick. Returns (state', numpy
        TickOutputs)."""
        state, bufs = self.device_step(state, wires, dims)
        return state, join_outputs(bufs, dims, self.red_enabled)


def make_sharded_tick(mesh: Mesh, audio_params: Any | None = None,
                      bwe_params: Any | None = None, donate: bool = True,
                      red_enabled: bool = True) -> ShardedTick:
    """The full media-plane tick over the mesh's room shards: a callable
    (sharded state, sharded inputs) → (state', joined numpy outputs)."""
    return ShardedTick(mesh, audio_params, bwe_params, donate, red_enabled)


# ---------------------------------------------------------------------------
# The paged pool over page shards.
# ---------------------------------------------------------------------------


class PoolPlan:
    """Which pages each shard computes: its own, then its halo (pages held
    by other shards that its pages reach through `tmembers`, closed under
    it), from a host copy of the page table's `tmembers` [P, MT]."""

    def __init__(self, mesh: Mesh, tmembers: np.ndarray):
        tm = np.asarray(tmembers)
        P = tm.shape[0]
        self.bounds = page_sharding(mesh, P)
        step = self.bounds[0][1]
        # Per shard: the halo's global pages grouped by owning shard
        # ([(j, local rows on j)]), and tmembers in ext-local indices.
        self.halo: list[list[tuple[int, np.ndarray]]] = []
        self.tmembers: list[np.ndarray] = []
        self.copies = 0
        for a, b in self.bounds:
            ext = np.arange(a, b)
            frontier = ext
            while len(frontier):
                t = tm[frontier]
                frontier = np.setdiff1d(t[t >= 0], ext)
                ext = np.concatenate([ext, frontier])
            halo = ext[b - a:]
            self.copies += len(halo)
            owner = halo // step
            self.halo.append([(int(j), halo[owner == j] - j * step)
                              for j in np.unique(owner).tolist()])
            pos = np.full(P, -1, np.int64)
            pos[ext] = np.arange(len(ext))
            t = tm[ext]
            self.tmembers.append(np.where(t >= 0, pos[np.maximum(t, 0)], -1).astype(np.int32))


def _with_halo(tree: Sharded, i: int, plan: PoolPlan) -> Any:
    """Shard i's tree with its halo rows appended (copies from the owning
    shards, on shard i's device)."""
    dev = tree.mesh.devices[i]
    srcs = [(plane.tree_leaves(tree.shards[j]),
             torch.as_tensor(rows, device=tree.mesh.devices[j]))
            for j, rows in plan.halo[i]]
    leaves = []
    for n, own in enumerate(plane.tree_leaves(tree.shards[i])):
        if own.dim() == 0 or not srcs:
            leaves.append(own)
            continue
        parts = [src[n].index_select(0, rows).to(dev) for src, rows in srcs]
        leaves.append(torch.cat([own, *parts]))
    return plane.tree_unflatten(tree.shards[i], leaves)


class _PageCols(NamedTuple):
    """The page-indexed columns of a PageTable but `tmembers`."""

    pg_room: torch.Tensor
    pg_tp: torch.Tensor
    pg_sp: torch.Tensor


class ShardedPoolTick:
    """The stock pooled tick (`paged.paged_plane_tick`) over page shards:
    each shard ticks its own pages with its halo appended and keeps its
    own rows. `cross_shard_pages` counts the halo pages copied."""

    def __init__(self, mesh: Mesh, audio_params=None, bwe_params=None,
                 red_enabled: bool = True):
        self.mesh = mesh
        self.ap = audio_params or audio_ops.AudioLevelParams()
        self.bp = bwe_params or bwe_ops.BWEParams()
        self.red_enabled = red_enabled
        self.cross_shard_pages = 0
        self._runner = _ShardRunner(mesh)

    def step(self, state: Sharded, inp: Sharded, table: Sharded, plan: PoolPlan | None = None):
        """(sharded pooled state, sharded pooled TickInputs, sharded page
        table) → (state', per-shard flat numpy output buffers). `plan`
        comes from the host copy of the table's tmembers; without one it
        is built from the device table."""
        if plan is None:
            plan = PoolPlan(self.mesh, gather_tree(table.map(lambda t: t.tmembers)).numpy())
        self.cross_shard_pages += plan.copies
        # Every halo copy reads the pre-tick state before any shard ticks.
        ext = []
        for i in range(self.mesh.size):
            cols = _with_halo(table.map(lambda t: _PageCols(t.pg_room, t.pg_tp, t.pg_sp)),
                              i, plan)
            mem = torch.as_tensor(plan.tmembers[i], device=self.mesh.devices[i])
            tbl = paged.PageTable(table.shards[i].rooms_pages, mem, *cols)
            ext.append((_with_halo(state, i, plan), _with_halo(inp, i, plan), tbl))
        shards, packed = [], []
        for i, (st, x, tbl) in enumerate(ext):
            n = state.shards[i].meta.is_video.shape[0]
            with self._runner.on(i):
                new, out = paged.paged_plane_tick(st, x, tbl, self.ap, self.bp, self.red_enabled)
                shards.append(plane.tree_map(lambda t: t[:n], new))
                packed.append(plane.pack_tick_outputs(plane.tree_map(lambda t: t[:n], out)))
        return Sharded(self.mesh, shards), self._runner.fetch(packed)

    def __call__(self, state: Sharded, inp: Sharded, table: Sharded, plan: PoolPlan | None = None):
        """`step` with the outputs joined in page order (numpy
        TickOutputs at pool shape)."""
        state, bufs = self.step(state, inp, table, plan)
        P = state.leading()
        dims = plane.PlaneDims(P, *inp.shards[0].sn.shape[1:], inp.shards[0].estimate.shape[-1])
        return state, join_outputs(bufs, dims, self.red_enabled)

