"""Device-entry registry for the devicecheck contract pass.

`@device_entry("name")` marks a function (or a factory returning the
callable that runs on the device) as a device-plane entry point. The
decorator only records the callable in a module-level table and returns
it unchanged — zero cost at run time, no torch import — so models/ops/
runtime modules can register themselves without pulling the analysis
stack into the tick path. `analysis/devicecheck.py` owns the per-entry
argument specs and runs the contracts against this table.

Names are stable contract keys, the reference's own: they appear in the
committed `analysis/devicecheck_baseline.json`, so renaming one is a
contract change (re-snapshot with
`python -m livekit_server_tpu_torch.analysis --resnapshot`).
"""

from __future__ import annotations

from typing import Callable

# name → the registered callable
DEVICE_ENTRIES: dict[str, Callable] = {}


def device_entry(name: str) -> Callable:
    """Register a device entry point under a stable contract name. A
    factory (parallel/mesh.make_sharded_tick) registers itself;
    devicecheck's spec for it calls the factory first."""

    def wrap(fn: Callable) -> Callable:
        DEVICE_ENTRIES[name] = fn
        return fn

    return wrap


def entry(name: str) -> Callable:
    """Resolve a registered entry, importing the hosting modules on
    first use (registration happens at import time)."""
    if name not in DEVICE_ENTRIES:
        import_all()
    return DEVICE_ENTRIES[name]


def import_all() -> None:
    """Import every module that registers device entries."""
    import livekit_server_tpu_torch.models.paged  # noqa: F401
    import livekit_server_tpu_torch.models.plane  # noqa: F401
    import livekit_server_tpu_torch.ops.mix  # noqa: F401
    import livekit_server_tpu_torch.ops.paged_kernel  # noqa: F401
    import livekit_server_tpu_torch.parallel.mesh  # noqa: F401
    import livekit_server_tpu_torch.runtime.mixer  # noqa: F401
