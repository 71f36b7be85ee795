"""Readings for the output check's limits: the control, the faults, and
sound runs over many seeds, each in one process.

    python3 sfu_bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--control | --fault stale_state|half_rooms|altered_send]

Each seed is one run of the cell as `run.py` makes it (set-up, a window
of `--seconds`, the check), with the port's tick replaced by the reference in
bfloat16 (`--control`), by a planted fault (`--fault`), or left as it is.
Prints one line per seed with the check's numbers. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "sfu_bench":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    from sfu_bench import core, faults
    from sfu_bench.reference import control

    core.env_setup()
    from livekit_server_tpu_torch.models import plane as P

    if args.control:
        tick_fn, what = control.tick_bf16, "control_bf16"
    elif args.fault:
        tick_fn, what = faults.FAULTS[args.fault](P.media_plane_tick), args.fault
    else:
        tick_fn, what = None, "program"
    for seed in args.seeds:
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        res = core.run_cell(args.workload, seed, args.seconds, False, tick_fn=tick_fn,
                            out=out, err=err)
        print(json.dumps({"what": what, "workload": args.workload, "seed": seed,
                          "correct": res["correct"], "checks": res["checks"],
                          "ticks": res["attempted"], "failed": res["failed"],
                          "run_s": round(time.perf_counter() - t0, 3),
                          "lines": out.getvalue().splitlines()[:-1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
