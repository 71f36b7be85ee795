"""The output check catches what it is there to catch: each fault planted
under the timed path, and the control (the reference in bfloat16 in the
program's place), come out as not correct; the unbroken run does not."""

from __future__ import annotations

import pytest

from sfu_bench import faults
from sfu_bench.reference import control
from sfu_bench.tests.conftest import cpu_run


def port_tick():
    from livekit_server_tpu_torch.models import plane

    return plane.media_plane_tick


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault):
    res, _, err = cpu_run("northstar_plane_steady", tick_fn=faults.FAULTS[fault](port_tick()))
    assert res["correct"] is False and res["failed"] > 0, err


def test_control_is_not_correct():
    res, _, err = cpu_run("northstar_plane_steady", tick_fn=control.tick_bf16)
    assert res["correct"] is False, err
    assert res["checks"]["float_err"]["value"] > res["checks"]["float_err"]["limit"]


def test_reference_tick_is_the_port_plain_tick():
    """At tiny dims on the CPU the frozen reference and the port's plain
    tick agree bit for bit over a few seeded ticks from one state."""
    import numpy as np

    from sfu_bench.gen import library
    from sfu_bench.paths.plane import meta_ctrl, ref_state, traffic_spec
    from sfu_bench.reference import node, tick as ref
    from sfu_bench.tests.conftest import tiny_dims
    from sfu_bench import core
    from livekit_server_tpu_torch.models import plane as P

    cell = core.load_cell("northstar_plane_steady")
    dims = tiny_dims("northstar_plane_steady")
    spec = traffic_spec(cell.config, cell.traffic)
    lib, _ = library.generate(dims, spec, 4, 5)
    rooms = np.arange(dims.rooms)
    r_state = ref_state(dims, spec, rooms)
    p_state = P.tree_unflatten(P.init_state(P.PlaneDims(*dims), device="cpu"),
                               [x.clone() for x in ref.tree_leaves(r_state)])
    for t in lib:
        inp = node.inputs_to_torch(t)
        r_state, r_out = ref.media_plane_tick(r_state, inp)
        p_state, p_out = P.media_plane_tick(p_state, P.TickInputs(*inp))
        for a, b in zip(ref.tree_leaves((r_state, r_out)), P.tree_leaves((p_state, p_out))):
            assert a.dtype == b.dtype and bool((a == b).all())
    assert meta_ctrl(dims, spec)[0].published.any()
