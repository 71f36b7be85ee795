"""graftcheck for the port: AST invariant checks and device-entry contracts.

The port keeps the reference's runtime contracts — one state lock, a
lock order, one retry policy, bounded queues, checksummed checkpoints,
epoch-checked page handles, fenced KV writes, one host sync per tick —
and these are statically visible, so this package encodes them as AST
analyzers over `livekit_server_tpu_torch/`, wired into the tier-1 gate
(tests/test_torch_static_analysis.py):

  GC01 state-lock — the device state (`PlaneRuntime.state`) and its
       staging methods may only be touched under `state_lock` (or from
       a function the config allowlists as lock-held).
  GC03 lock-discipline — the asyncio lock acquisition graph
       (state_lock / _ckpt_lock / _create_locks) must be acyclic, and no
       blocking call may run while an asyncio lock is held; the card's
       host syncs (`torch.cuda.synchronize`, `.item()`, `.cpu()`,
       `.tolist()`, `.numpy()`, `Stream/Event.synchronize`) count as
       blocking.
  GC04 retry-policy — network dials/sends in routing/, service/ and the
       media relay route through utils/backoff.retry_async; bare
       while+sleep retry loops are findings.
  GC05 bounded-queues — every asyncio.Queue / collections.deque built in
       runtime/ and routing/ carries an explicit bound.
  GC06 checkpoint-hygiene — serialization in the checkpoint-bearing
       modules pairs with the utils/checksum codec in the same function.
  GC07 emit-hygiene — flight-recorder emits pass scalars only outside a
       sampled branch.
  GC08 page-handle-discipline — pager page indices (`pages_of_room`)
       used across an await or a state_lock release need `check_epoch`
       (or a re-mint) first.
  GC09 fencing-discipline — room-ownership KV keys are mutated only
       through the epoch-fenced writer API.
  GC12 host-sync-hygiene — blocking device reads reachable from the
       tick-path roots outside the declared seams (the one packed fetch
       per tick, `models/plane.py` `fetch_outputs`).

The reference's GC02, GC10 and GC11 are about `jax.jit` wrap sites; the
port has none, so they have no AST counterpart here. Their purposes
moved:
  * GC10's semantic half (do updated state leaves alias their inputs?)
    is devicecheck.py's in-place contract: each state leaf an entry
    updates keeps its storage, and no input leaf of 1 MB or more comes
    back as a fresh allocation of its shape and dtype;
  * GC11's runtime half (no recompile after warm-up) is the build
    ledger, runtime/compile_ledger.py, behind `/debug/compiles`;
  * GC02 (host side effects inside a traced region) waits for the first
    CUDA-graph capture site, where a host side effect inside the
    captured region becomes a real hazard.

The devicecheck pass (analysis/devicecheck.py, needs torch) runs every
`@device_entry` at canonical dims — on `torch.device("meta")` where the
entry's plain path allows it, else on the CPU — and pins output shapes
and dtypes, a FLOP/byte tripwire and the in-place contract in
`analysis/devicecheck_baseline.json`.

Config and baselines live beside this file: `config.toml` (the rule
tables; every allowlisted name must exist in the tree), `baseline.json`
(accepted findings, each with its reason; shrink-only) and
`devicecheck_baseline.json`. Suppressions: `# graftcheck: disable=GC05`
on the finding's line, `# graftcheck: disable-file=GC05` for a file;
a directive that suppresses nothing is itself a finding.

Entry point: `python -m livekit_server_tpu_torch.analysis`.
"""

from livekit_server_tpu_torch.analysis.core import (
    Config,
    Finding,
    Project,
    diff_baseline,
    load_baseline,
    load_project,
    run_all,
    write_baseline,
)

__all__ = [
    "Config",
    "Finding",
    "Project",
    "diff_baseline",
    "load_baseline",
    "load_project",
    "run_all",
    "write_baseline",
]
