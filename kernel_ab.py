#!/usr/bin/env python3
"""Old against new: two builds of the port's CUDA kernels timed in one
process on one card, in turns.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 kernel_ab.py --old DIR [--kernels NAME ...]

DIR is another tree of this repository (for example the parent commit,
unpacked with `git archive`). Each named kernel (default: every kernel of
`cuda.SOURCES` whose source or shared headers differ between the trees)
is built from DIR's `livekit_server_tpu_torch/csrc/` with the same nvcc
flags and bound to this tree's wrapper, so the old source must keep the
C interface of the new one (a kernel DIR has no source for is left out).
Both builds run on the operands chip_smoke.py captures from the main
paths: one north-star dense tick (decide_rooms, allocate_budget_rooms,
rtpstats_rooms), one live step of the full PAGED_TIMING_DIMS pool
(paged_kernel, allocate_budget_rooms) and one after half its rooms are
released (paged_kernel), and the dead-page key's 1-page stock tick
(decide_rooms, allocate_budget_rooms, rtpstats_rooms); and on the operands of
chip_smoke's full-pool parity check, paged_kernel's mix entries (kernel
launches alone, off the main path). For each launch the two builds'
outputs must be equal; then each build's device time (chip_smoke.graph_ms)
is taken in the order old, new, new, old. Prints one JSON line per launch,
the card's name and power limit, and `{"ok": true}` last.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from livekit_server_tpu_torch.ops import (
    allocation, cuda, pacer, paged_kernel, rtpstats, selector,
)

# Kernel name → the module whose `_kernel()` returns its C launch function.
MODULES = {"decide_rooms": selector, "allocate_budget_rooms": allocation,
           "paged_kernel": paged_kernel, "rtpstats_rooms": rtpstats}


def changed(old_csrc: Path) -> list[str]:
    """The kernels old_csrc has a source for whose library would differ
    when built from it."""
    return [name for name, source in cuda.SOURCES.items()
            if (old_csrc / f"{source}.cu").is_file()
            and cuda.library_path(source, old_csrc) != cuda.library_path(source)]


def build_old(old_csrc: Path, names) -> dict:
    """Compile old_csrc's sources of the named kernels; returns kernel name
    → its C launch function, typed as this tree's wrapper types its own."""
    cuda.build(names, csrc=old_csrc)
    fns = {}
    for name in names:
        source = cuda.SOURCES[name]
        fn = getattr(ctypes.CDLL(str(cuda.library_path(source, old_csrc))), f"{source}_launch")
        new = MODULES[name]._kernel()
        fn.argtypes, fn.restype = new.argtypes, new.restype
        fns[name] = fn
    return fns


@contextlib.contextmanager
def using(module, fn):
    """Route the module's wrapper to the C launch function `fn`."""
    original = module._kernel
    module._kernel = lambda: fn
    try:
        yield
    finally:
        module._kernel = original


def launches(dev):
    """Yield, one path at a time, (path, [(kernel, wrapper, args, kwargs,
    launch shape, bytes moved, launches a timing graph)]) for the kernel
    launches chip_smoke captures there."""
    alloc = allocation.allocate_budget_rooms

    def row(name, wrapper, a, kw, res, count_bytes):
        if name == "decide_rooms":          # [R, T, K, S]
            shape = list(a[4].shape) + [a[0].current_spatial.shape[-1]]
        elif name == "paged_kernel":        # [live rows, TP, K, SP]
            shape = [a[5].numel(), *a[4].layer.shape[1:], a[3].shape[-1]]
        elif name == "rtpstats_rooms":      # [R, T, K]
            shape = list(a[3].shape)
        else:                               # [R, S, T]
            shape = list(a[1].shape)
        return name, wrapper, a, kw, shape, count_bytes(a, res), chip_smoke.GRAPH_LAUNCHES

    state, wires = chip_smoke.north_star_setup(dev)
    state, _ = chip_smoke.plane.device_tick(state, wires[0], chip_smoke.NORTH_STAR)
    _, seen = chip_smoke.capture_kernel_args(state, wires[1], chip_smoke.NORTH_STAR)
    del state, wires
    yield "dense", [
        row("decide_rooms", selector.decide_rooms, *seen["decide_rooms"],
            chip_smoke.decide_rooms_bytes),
        row("allocate_budget_rooms", alloc, *seen["allocate_budget_rooms"], chip_smoke.nbytes),
        row("rtpstats_rooms", rtpstats.route_update_tick, *seen["route_update_tick"],
            chip_smoke.rtpstats_rooms_bytes)]
    del seen
    torch.cuda.empty_cache()

    pager, room_sizes, state, table, rows, inv, _, wires = chip_smoke.full_pool(dev)
    state, seen = chip_smoke.capture_live_step(state, table, wires[0], rows, inv)
    yield "paged", [
        row("paged_kernel", paged_kernel.decide_pages, *seen["decide_pages"],
            chip_smoke.decide_pages_bytes),
        row("paged_kernel", chip_smoke.decide_launch, *seen["decide_pages"],
            chip_smoke.decide_pages_bytes),
        row("allocate_budget_rooms", alloc, *seen["allocate_budget_rooms"], chip_smoke.nbytes)]
    del seen
    rows, inv, _, wires = chip_smoke.release_half(pager, room_sizes, state, table, dev)
    _, seen = chip_smoke.capture_live_step(state, table, wires[0], rows, inv)
    del state, table, rows, inv, wires
    yield "paged half", [
        row("paged_kernel", paged_kernel.decide_pages, *seen["decide_pages"],
            chip_smoke.decide_pages_bytes),
        row("paged_kernel", chip_smoke.decide_launch, *seen["decide_pages"],
            chip_smoke.decide_pages_bytes)]
    del seen
    torch.cuda.empty_cache()

    d = chip_smoke.PAGED_TIMING_DIMS
    full_rows, _ = chip_smoke.full_pool_rows(dev)
    decide, mix, rows = chip_smoke.page_args((d.pool_pages, d.tpage, d.pkts, d.spage),
                                             np.random.default_rng(chip_smoke.SEED), dev,
                                             full_rows)
    kw = dict(wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    shape = [rows.numel(), d.tpage, d.pkts, d.spage, mix[0].shape[2]]   # + samples N
    mix_bytes = chip_smoke.mix_pages_bytes(mix, rows)
    decide_bytes = chip_smoke.decide_pages_bytes(
        (*decide, rows), paged_kernel.decide_pages(*decide, rows, **kw))
    yield "paged mix (kernel launch alone)", [
        ("paged_kernel", chip_smoke.mix_launch, (mix, rows), {}, shape, mix_bytes,
         chip_smoke.MIX_GRAPH_LAUNCHES),
        ("paged_kernel", chip_smoke.decide_mix_launch, (decide, mix, rows, kw), {}, shape,
         mix_bytes + decide_bytes, chip_smoke.MIX_GRAPH_LAUNCHES)]
    del decide, mix, rows
    torch.cuda.empty_cache()

    seen = chip_smoke.dead_key_calls(dev)
    yield "paged dead key", [
        row("decide_rooms", selector.decide_rooms, *seen["decide_rooms"],
            chip_smoke.decide_rooms_bytes),
        row("allocate_budget_rooms", alloc, *seen["allocate_budget_rooms"], chip_smoke.nbytes),
        row("rtpstats_rooms", rtpstats.route_update_tick, *seen["route_update_tick"],
            chip_smoke.rtpstats_rooms_bytes)]


def compare(name: str, path: str, call, a, kw, shape, old_fn, bytes_moved: int,
            graph_launches: int) -> dict:
    module = MODULES[name]
    new_out = call(*a, **kw)
    with using(module, old_fn):
        old_out = call(*a, **kw)
    torch.cuda.synchronize()
    ok, _ = chip_smoke.tree_equal(new_out, old_out)
    if not ok:
        raise AssertionError(f"{name} ({path}): old and new kernels disagree")
    del new_out, old_out
    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        ctx = using(module, old_fn) if which == "old" else contextlib.nullcontext()
        with ctx:
            times[which].append(chip_smoke.graph_ms(lambda: call(*a, **kw),
                                                    chip_smoke.KERNEL_REPS, graph_launches))
    row = {"kernel": name, "path": path, "entry": call.__name__, "shape": shape,
           "old_ms": times["old"], "new_ms": times["new"],
           "bound_ms": bytes_moved / chip_smoke.HBM_BYTES_PER_S * 1e3, "bytes": bytes_moved}
    row["speedup"] = sum(times["old"]) / sum(times["new"])
    row["new_over_bound"] = sum(times["new"]) / 2 / row["bound_ms"]
    print(json.dumps({"kernel_ab": row}), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="a tree of this repository holding the old kernel sources")
    ap.add_argument("--kernels", nargs="+", choices=sorted(cuda.SOURCES),
                    help="kernels to compare (default: those whose sources differ)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    old_csrc = args.old / "livekit_server_tpu_torch" / "csrc"
    names = args.kernels or changed(old_csrc)
    cuda.build()
    old = build_old(old_csrc, names)
    for path, calls in launches(dev):
        for name, wrapper, a, kw, shape, bytes_moved, graph_launches in calls:
            if name in old:
                compare(name, path, wrapper, a, kw, shape, old[name], bytes_moved,
                        graph_launches)
        del calls, a, kw
    print(chip_smoke.card_line(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
