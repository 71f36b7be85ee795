"""Largest port-vs-reference difference of every float leaf of the dense
tick, beside the bound `plane.float_tolerance` holds it to.

Runs the cases of test_torch_plane.py (JAX on the CPU against the port's
plain path) for more ticks than the test does and prints one line per
float leaf of TickOutputs and PlaneState:

    python tests/torch_leaf_errors.py [--ticks 40]
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from livekit_server_tpu.models import plane as jplane, synth as jsynth  # noqa: E402
from livekit_server_tpu_torch.models import plane as tplane, synth as tsynth  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_plane import CASES  # noqa: E402


def record(worst, names, port_leaves, ref_leaves):
    for name, p, r in zip(names, port_leaves, ref_leaves):
        r = np.asarray(r)
        if r.dtype.kind != "f":
            continue
        err = np.abs(p.numpy().astype(np.float64) - r)
        w = worst.setdefault(name, [0.0, 0.0])
        w[0] = max(w[0], float(err.max(initial=0.0)))
        w[1] = max(w[1], float(np.abs(r).max(initial=0.0)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=40)
    ticks = ap.parse_args().ticks
    jax.config.update("jax_platforms", "cpu")
    worst: dict[str, list[float]] = {}
    for case, (dims, spec_kw, red_enabled) in enumerate(CASES):
        tdims = tplane.PlaneDims(*dims)
        jspec, tspec = jsynth.TrafficSpec(**spec_kw), tsynth.TrafficSpec(**spec_kw)
        j_state = jsynth.make_state(dims, jspec)
        t_state = tplane.state_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(j_state)], device="cpu")
        state_names = tplane.leaf_names(t_state)
        j_step = jax.jit(lambda s, i, red=red_enabled: jplane.media_plane_tick(
            s, i, red_enabled=red))
        j_traffic = jsynth.init_traffic(dims, jspec, seed=case)
        t_traffic = tsynth.init_traffic(tdims, tspec, seed=case)
        for i in range(ticks):
            j_traffic, j_inp = jsynth.next_tick(j_traffic, dims, jspec, i, seed=case)
            t_traffic, t_inp = tsynth.next_tick(t_traffic, tdims, tspec, i, seed=case)
            if i % 5 == 4:
                j_inp = j_inp._replace(roll_quality=np.int32(1))
                t_inp = t_inp._replace(roll_quality=np.int32(1))
            j_state, j_out = j_step(j_state, jax.tree.map(jnp.asarray, j_inp))
            t_state, t_out = tplane.media_plane_tick(
                t_state, tplane.inputs_to_device(t_inp, "cpu"), red_enabled=red_enabled)
            record(worst, tplane.TickOutputs._fields, t_out, j_out)
            record(worst, state_names, tplane.tree_leaves(t_state), jax.tree.leaves(j_state))
    print(f"{'leaf':40s} {'max_abs_err':>12s} {'max_abs_ref':>12s}  bound (rtol, atol)")
    for name, (err, ref) in sorted(worst.items()):
        print(f"{name:40s} {err:12.4e} {ref:12.4e}  {tplane.float_tolerance(name)}")


if __name__ == "__main__":
    torch.set_num_threads(2)
    main()
