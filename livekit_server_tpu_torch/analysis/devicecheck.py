"""devicecheck — the device-entry contracts of the port.

Every device-plane entry point registered with `@device_entry`
(analysis/registry.py), under the reference's contract names, is run at
the canonical dims derived from the `PlaneConfig` defaults — the dense
plane and the paged pool it maps to — with zeroed inputs. Three things
come out of each entry:

  * the output contract: leaf shapes and dtypes (and, for the mesh
    entry, the room split per shard) — catches a dtype promotion or a
    broadcast blow-up at review time. Entries whose plain path is
    meta-clean run on `torch.device("meta")` (no memory, no compute);
    the others run on the CPU, for the reason their spec names (a host
    read of an index, numpy outputs, a kernel wrapper that routes by
    device);
  * a cost tripwire: FLOPs from `torch.utils.flop_counter.FlopCounterMode`
    (it counts the matmul family, so most entries read 0) and bytes as
    the input plus output leaf sizes;
  * the in-place contract (the reference's GC10 semantic half, for a
    port without donation): each state leaf an entry updates keeps its
    storage — the same `untyped_storage().data_ptr()` before and after —
    and no other input leaf of `min_inplace_bytes` or more comes back as
    a fresh allocation of its shape and dtype, unless the entry is in
    `allow_no_inplace` with its reason (config.toml). It needs real
    storages, so it runs on the CPU here and on the card in
    chip_smoke.py.

The contracts live in `analysis/devicecheck_baseline.json` (shrink-only,
like the graftcheck baseline: drift or a stale entry fails the runner;
`python -m livekit_server_tpu_torch.analysis --resnapshot` rewrites it).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from livekit_server_tpu_torch.analysis import registry
from livekit_server_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1
DRIFT_RULE = "DEVC"      # contract drift
INPLACE_RULE = "INPL"    # the in-place contract
NL_FRACTION = 2          # live pages of the paged entries: half the pool


def canonical_dims():
    """(dense PlaneDims, PagedDims) from the PlaneConfig defaults — the
    derivation service/roommanager.py uses (pool_pages 0 → the dense-
    equivalent capacity)."""
    from livekit_server_tpu_torch.config.config import PlaneConfig
    from livekit_server_tpu_torch.models import paged, plane

    pc = PlaneConfig()
    dense = plane.PlaneDims(pc.rooms, pc.tracks_per_room, pc.pkts_per_track,
                            pc.subs_per_room)
    pool = pc.pager_pool_pages or (
        pc.rooms * (pc.tracks_per_room // pc.pager_tpage)
        * (pc.subs_per_room // pc.pager_spage))
    pdims = paged.PagedDims(pc.rooms, pc.tracks_per_room, pc.pkts_per_track,
                            pc.subs_per_room, pc.pager_tpage, pc.pager_spage, pool)
    return dense, pdims


class EntrySpec:
    """One entry's canonical call. `build(dev)` returns (callable, args);
    `state_args` names the args that are state trees the entry updates
    (their leaves must keep their storage), `state_out` picks the updated
    tree out of the result; `not_meta` is why the entry cannot run on the
    meta device (None: it can)."""

    def __init__(self, name: str, build: Callable[[torch.device], tuple],
                 state_args: tuple[int, ...] = (),
                 state_out: Callable[[Any], Any] | None = None,
                 not_meta: str | None = None, mesh: bool = False):
        self.name = name
        self.build = build
        self.state_args = state_args
        self.state_out = state_out if state_out is not None else (lambda out: out[0])
        self.not_meta = not_meta
        self.mesh = mesh


def _specs() -> list[EntrySpec]:
    from livekit_server_tpu_torch.models import paged, plane
    from livekit_server_tpu_torch.ops import pacer

    registry.import_all()
    entry = registry.entry
    dense, pdims = canonical_dims()
    pooled = pdims.pooled()
    R, T, K, S = dense
    P, MT, MS = pdims.pool_pages, pdims.max_tpages, pdims.max_spages
    NL = max(1, P // NL_FRACTION)
    N = 240                                       # samples of the mix entries
    i32 = torch.int32

    def inputs(dims, dev):
        return paged._zero_inputs(dims, 10, 0, dev)

    def live(dev):
        return (torch.arange(NL, dtype=i32, device=dev),
                torch.arange(P, dtype=i32, device=dev) % NL)

    def rows(n):
        return np.arange(n, dtype=np.int32)

    def decide(state, inp, live_rows):
        base = paged._base(state)
        return entry("paged_kernel.decide_pages")(
            state.sel, state.meta.is_svc, state.meta.is_video, base, inp, live_rows,
            wire_overhead=pacer.WIRE_OVERHEAD_BYTES)

    def sharded(dev):
        from livekit_server_tpu_torch.parallel import mesh as mesh_mod

        m = mesh_mod.make_mesh([dev, dev])
        tick = entry("mesh.sharded_tick")(m)
        return tick, (mesh_mod.shard_tree(plane.init_state(dense, dev), m),
                      mesh_mod.shard_tree(inputs(dense, dev), m))

    host_read = "its kernel wrapper routes by device, and the meta device is neither"
    return [
        EntrySpec("plane.init_state",
                  lambda dev: (lambda: entry("plane.init_state")(dense, dev), ())),
        EntrySpec("plane.media_plane_tick",
                  lambda dev: (entry("plane.media_plane_tick"),
                               (plane.init_state(dense, dev), inputs(dense, dev))),
                  state_args=(0,), not_meta=host_read),
        EntrySpec("plane.apply_ctrl_delta",
                  lambda dev: (entry("plane.apply_ctrl_delta"),
                               (plane.init_state(dense, dev), rows(8),
                                np.zeros((4, 8, T), np.int32),
                                np.zeros((4, 8, T, S), np.int32))),
                  state_args=(0,), state_out=lambda out: out),
        EntrySpec("paged.page_init_template",
                  lambda dev: (lambda: entry("paged.page_init_template")(pdims, dev), ())),
        EntrySpec("paged.paged_plane_tick",
                  lambda dev: (entry("paged.paged_plane_tick"),
                               (plane.init_state(pooled, dev), inputs(pooled, dev),
                                paged.init_table(pdims, dev))),
                  state_args=(0,), not_meta=host_read),
        EntrySpec("paged.paged_plane_tick_live",
                  lambda dev: (lambda st, inp, tb, lr, li: entry("paged.paged_plane_tick_live")(
                                   st, inp, tb, lr, li, decide(st, inp, lr)),
                               (plane.init_state(pooled, dev), inputs(pooled, dev),
                                paged.init_table(pdims, dev), *live(dev))),
                  state_args=(0,),
                  not_meta="the dead-page outputs read the tick scalars on the host"),
        EntrySpec("paged.paged_plane_tick_fused",
                  lambda dev: (entry("paged.paged_plane_tick_fused"),
                               (plane.init_state(pooled, dev), inputs(pooled, dev),
                                paged.init_table(pdims, dev), *live(dev))),
                  state_args=(0,),
                  not_meta="the dead-page outputs read the tick scalars on the host"),
        EntrySpec("paged.dead_page_outputs",
                  lambda dev: (lambda: entry("paged.dead_page_outputs")(
                                   MT, pdims.tpage, pdims.pkts, pdims.spage, 10, 0,
                                   device=dev), ()),
                  not_meta=host_read),
        EntrySpec("paged.apply_table_delta",
                  lambda dev: (entry("paged.apply_table_delta"),
                               (paged.init_table(pdims, dev), rows(16),
                                np.full((16, MT), -1, np.int32), np.full(16, -1, np.int32),
                                np.full(16, -1, np.int32), np.full(16, -1, np.int32),
                                rows(8), np.full((8, MT * MS), -1, np.int32))),
                  state_args=(0,), state_out=lambda out: out),
        EntrySpec("paged.reinit_pages",
                  lambda dev: (entry("paged.reinit_pages"),
                               (plane.init_state(pooled, dev), rows(16),
                                paged.page_init_template(pdims, dev))),
                  state_args=(0,), state_out=lambda out: out),
        EntrySpec("paged.move_state_rows",
                  lambda dev: (entry("paged.move_state_rows"),
                               (plane.init_state(pooled, dev), rows(16),
                                rows(16) + 16)),
                  state_args=(0,), state_out=lambda out: out),
        EntrySpec("paged_kernel.decide_pages",
                  lambda dev: (decide, (plane.init_state(pooled, dev), inputs(pooled, dev),
                                        live(dev)[0])),
                  not_meta=host_read),
        EntrySpec("mix.mix_tick",
                  lambda dev: (entry("mix.mix_tick"),
                               (torch.zeros((R, T, N), device=dev),
                                torch.zeros((R, T), device=dev),
                                torch.zeros((R, T), dtype=torch.bool, device=dev),
                                torch.zeros((R, S), dtype=i32, device=dev),
                                torch.zeros((R, T), device=dev)))),
        EntrySpec("mix.decode_tick",
                  lambda dev: (entry("mix.decode_tick"),
                               (torch.zeros((R, T, N), dtype=torch.uint8, device=dev),
                                torch.zeros((R, T), dtype=i32, device=dev))),
                  not_meta="its G.711 table is cached per device from a host array"),
        EntrySpec("mixer.device_mix",
                  lambda dev: (entry("mixer.device_mix"),
                               (torch.zeros((R, T, N), device=dev),
                                torch.zeros((R, T), dtype=torch.bool, device=dev),
                                torch.zeros((R, S), dtype=i32, device=dev)))),
        EntrySpec("mesh.sharded_tick", sharded, state_args=(0,), mesh=True,
                  not_meta="its outputs are fetched to the host (numpy)"),
    ]


# -- contract computation ---------------------------------------------------

def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def leaves(tree) -> list:
    """Tensor/array leaves in the reference's flatten order (NamedTuple
    fields depth first); a Sharded tree gives its shards' leaves joined
    along the leading axis (shape only — see `_sharded_leaf`)."""
    from livekit_server_tpu_torch.parallel.mesh import Sharded

    if _is_leaf(tree):
        return [tree]
    if isinstance(tree, Sharded):
        cols = zip(*[leaves(s) for s in tree.shards])
        return [_SharedShape(c) for c in cols]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return []


class _SharedShape:
    """The global shape of one leaf split over shards."""

    def __init__(self, col):
        x = col[0]
        self.dtype = x.dtype
        self.shape = tuple(x.shape) if x.dim() == 0 else (
            (sum(c.shape[0] for c in col),) + tuple(x.shape[1:]))
        self.nbytes = int(np.prod(self.shape)) * x.element_size()


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def _ptr(x) -> int | None:
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return x.untyped_storage().data_ptr()
    return None


def _state_leaves(tree) -> list:
    """Real tensors of a state tree (a Sharded tree: every shard's)."""
    from livekit_server_tpu_torch.parallel.mesh import Sharded

    if isinstance(tree, Sharded):
        return [leaf for s in tree.shards for leaf in _state_leaves(s)]
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def run_entry(spec: EntrySpec, dev: torch.device, *, min_bytes: int = 1 << 20,
              allow_no_inplace: bool = False) -> tuple[dict, list[str]]:
    """Run one entry on `dev`: (contract, in-place problems). The
    in-place problems are empty on the meta device (no storages)."""
    from torch.utils.flop_counter import FlopCounterMode

    fn, args = spec.build(dev)
    in_leaves = [x for a in args for x in leaves(a)]
    state_in = {i: [_ptr(x) for x in _state_leaves(args[i])] for i in spec.state_args}
    in_ptrs = {p for x in in_leaves if (p := _ptr(x)) is not None}
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        out = fn(*args)
    out_leaves = leaves(out)
    contract = {
        "out": [{"shape": list(x.shape), "dtype": _dtype(x)} for x in out_leaves],
        "flops": int(counter.get_total_flops()),
        "bytes": sum(_nbytes(x) for x in in_leaves) + sum(_nbytes(x) for x in out_leaves),
        "state_args": list(spec.state_args),
    }
    if spec.mesh:
        from livekit_server_tpu_torch.parallel import mesh as mesh_mod

        contract["sharding"] = [list(ab) for ab in
                                mesh_mod.room_sharding(args[0].mesh, args[0].leading())]
    problems: list[str] = []
    if dev.type == "meta" or allow_no_inplace:
        return contract, problems
    for i, ptrs in state_in.items():
        got = [_ptr(x) for x in _state_leaves(spec.state_out(out))]
        if len(got) != len(ptrs):
            problems.append(f"state arg {i}: {len(ptrs)} leaves in, {len(got)} out")
            continue
        moved = [j for j, (a, b) in enumerate(zip(ptrs, got)) if a != b]
        if moved:
            problems.append(f"state arg {i}: {len(moved)} of {len(ptrs)} leaves come back "
                            f"in new storage (first: leaf {moved[0]})")
    # the state args are held by the first clause; an output of a state
    # leaf's shape (need_keyframe vs subscribed) is a product, not a copy
    avail: dict[tuple, int] = {}
    for x in (x for i, a in enumerate(args) if i not in state_in for x in leaves(a)):
        if _nbytes(x) >= min_bytes:
            key = (tuple(x.shape), _dtype(x))
            avail[key] = avail.get(key, 0) + 1
    for x in out_leaves:
        key = (tuple(x.shape), _dtype(x))
        if avail.get(key, 0) > 0 and isinstance(x, torch.Tensor) and _ptr(x) not in in_ptrs:
            avail[key] -= 1
            problems.append(f"output {list(key[0])}/{key[1]} ({_nbytes(x) // 1024} KiB) "
                            "is a fresh allocation of an input's shape and dtype: a copy "
                            "per call")
    return contract, problems


def _entry_site(name: str) -> tuple[str, int]:
    """(repo-relative path, line) of the registered entry."""
    import inspect

    registry.import_all()
    fn = registry.DEVICE_ENTRIES.get(name)
    fallback = ("livekit_server_tpu_torch/analysis/devicecheck.py", 1)
    if fn is None:
        return fallback
    try:
        fn = inspect.unwrap(fn)
        src = inspect.getsourcefile(fn) or ""
        line = inspect.getsourcelines(fn)[1]
    except (TypeError, OSError):
        return fallback
    idx = src.find("livekit_server_tpu_torch")
    return (src[idx:] if idx >= 0 else src, line)


def compute_contracts(cfg: dict, device: torch.device | None = None
                      ) -> tuple[dict, list[Finding]]:
    """Run every entry: on `device` when given, else on the
    meta device where the entry is meta-clean and the CPU otherwise, with
    the in-place contract checked on the CPU. Returns (contracts by name,
    in-place findings)."""
    allow = dict(cfg.get("allow_no_inplace", {}))
    min_bytes = int(cfg.get("min_inplace_bytes", 1 << 20))
    cpu = torch.device("cpu")
    contracts: dict[str, dict] = {}
    findings: list[Finding] = []
    for spec in _specs():
        kw = dict(min_bytes=min_bytes, allow_no_inplace=spec.name in allow)
        if device is not None:
            contract, problems = run_entry(spec, device, **kw)
        elif spec.not_meta is None:
            contract, _ = run_entry(spec, torch.device("meta"), **kw)
            problems = run_entry(spec, cpu, **kw)[1] if spec.state_args else []
        else:
            contract, problems = run_entry(spec, cpu, **kw)
        contracts[spec.name] = contract
        path, line = _entry_site(spec.name)
        for why in problems:
            findings.append(Finding(
                INPLACE_RULE, path, line, f"devicecheck entry `{spec.name}`: {why}",
                hint="write the state in place, or list the entry under "
                "[devicecheck.allow_no_inplace] in config.toml with its reason",
            ))
    return contracts, findings


# -- baseline + runner ------------------------------------------------------

def load_baseline(path: Path) -> dict:
    p = Path(path)
    if not p.exists():
        return {}
    return json.loads(p.read_text()).get("entries", {})


def write_baseline(path: Path, contracts: dict) -> None:
    Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "entries": dict(sorted(contracts.items()))},
        indent=1) + "\n")


def diff_contracts(contracts: dict, baseline: dict, *, cost_rtol: float = 0.25,
                   shapes_only: bool = False) -> tuple[list[Finding], list[str]]:
    """(drift findings, stale baseline entry names). Shapes, dtypes,
    state args and the room split compare exactly; FLOPs and bytes within
    ±cost_rtol (skipped with `shapes_only`, e.g. a partial run)."""
    findings: list[Finding] = []
    for name, got in contracts.items():
        path, line = _entry_site(name)
        want = baseline.get(name)
        if want is None:
            findings.append(Finding(DRIFT_RULE, path, line,
                                    f"entry `{name}` has no committed contract",
                                    hint="--resnapshot"))
            continue
        if got["out"] != want.get("out"):
            findings.append(Finding(
                DRIFT_RULE, path, line,
                f"entry `{name}` output contract drifted: "
                f"{_shape_diff(want.get('out', []), got['out'])}",
                hint="shape/dtype drift — fix the regression, or --resnapshot if intended"))
        for key in ("sharding", "state_args"):
            if got.get(key) != want.get(key):
                findings.append(Finding(
                    DRIFT_RULE, path, line,
                    f"entry `{name}` {key} drifted: {want.get(key)} → {got.get(key)}",
                    hint="--resnapshot if intended"))
        if shapes_only:
            continue
        for k in ("flops", "bytes"):
            w, g = want.get(k, 0), got.get(k, 0)
            if abs(g - w) > cost_rtol * max(w, 1):
                findings.append(Finding(
                    DRIFT_RULE, path, line,
                    f"entry `{name}` {k} drifted {w} → {g} "
                    f"(>{int(cost_rtol * 100)}% — a broadcast blow-up or a dtype "
                    "promotion?)", hint="--resnapshot if intended"))
    stale = sorted(set(baseline) - set(contracts))
    return findings, stale


def _shape_diff(want: list[dict], got: list[dict]) -> str:
    if len(want) != len(got):
        return f"{len(want)} output leaves → {len(got)}"
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            return (f"leaf {i}: {w.get('shape')}/{w.get('dtype')} → "
                    f"{g.get('shape')}/{g.get('dtype')}")
    return "contract changed"


def run_check(root: Path, cfg: dict, *, resnapshot: bool = False
              ) -> tuple[list[Finding], list[str]]:
    """The runner's pass: (findings, stale baseline names). With
    `resnapshot`, rewrite the baseline from the live tree first."""
    bpath = Path(root) / cfg["baseline"]
    contracts, findings = compute_contracts(cfg)
    if resnapshot:
        write_baseline(bpath, contracts)
    drift, stale = diff_contracts(contracts, load_baseline(bpath),
                                  cost_rtol=float(cfg.get("cost_rtol", 0.25)))
    return findings + drift, stale
