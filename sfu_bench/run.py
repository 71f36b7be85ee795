"""Run one cell of the benchmark and print its result line.

    python3 sfu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, this folder and
the port (`livekit_server_tpu_torch`). The run needs a CUDA card; without
one, or with fewer cards than the cell asks for, or without the port, it
exits with code 2 and prints no result. Its standard output ends with the
result line (a JSON object); its standard error ends with each number of
the output check beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "sfu_bench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from sfu_bench import core

    core.env_setup()
    try:
        core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    except (core.BenchError, ImportError) as e:
        print(f"sfu_bench: no result: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
