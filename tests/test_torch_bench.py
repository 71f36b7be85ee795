"""The port's bench CLI (livekit_server_tpu_torch/tools/bench.py) and its
device window (tools/bench_device.py) on the CPU:

* `absorb_twin_json` — the reference's two cases of its bench absorption
  contract (tests/test_traffic_twin.py) on the port's function;
* the device window (unpack → media_plane_tick → pack_tick_outputs over a
  device pool, counters summed on the device) — its forward count,
  evaluated count and integer checksum equal the JAX package's
  media_plane_tick stepped over the same synth ticks, its float words'
  sum within the byte leaves' tolerance;
* `--cpu --quick` as a subprocess — its last line is the reference's
  result JSON with a positive value; without a card and without --cpu it
  exits non-zero and names the missing card; a SIGTERM mid-section
  re-emits the result with the section in flight.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the planes here are small.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from livekit_server_tpu.models import plane as jplane, synth as jsynth  # noqa: E402
from livekit_server_tpu_torch.models import plane, synth  # noqa: E402
from livekit_server_tpu_torch.tools import bench_device  # noqa: E402
from livekit_server_tpu_torch.tools.bench import absorb_twin_json  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def test_absorb_twin_last_json_line_wins():
    out = "\n".join([
        "warmup chatter",
        json.dumps({"steps": [1]}),
        "progress: load x2.0",
        json.dumps({"steps": [1, 2], "partial": True}),
        json.dumps({"steps": [1, 2, 3], "capacity_knee_load": 2.0}),
    ])
    got = absorb_twin_json(out)
    assert got["capacity_knee_load"] == 2.0
    assert got["steps"] == [1, 2, 3]

    # A killed child that emitted only a partial curve still salvages it.
    partial = absorb_twin_json(out.rsplit("\n", 1)[0])
    assert partial["partial"] is True


def test_absorb_twin_raises_without_json():
    for stdout in ("", "no json here\nstill none", None):
        with pytest.raises(ValueError, match="twin produced no JSON"):
            absorb_twin_json(stdout)


def _jax_window(dims, spec_kw, ticks, seed):
    """The JAX package's tick over the same synth ticks: forwarded writes,
    evaluated pairs, the int64 sum of every integer and bool output leaf,
    the float64 sum of the float ones."""
    spec = jsynth.TrafficSpec(**spec_kw)
    state = jsynth.make_state(dims, spec)
    traffic = jsynth.init_traffic(dims, spec, seed=seed)

    @jax.jit
    def step(state, pkt, fb, tf, tick_ms, roll):
        inp = jplane.unpack_tick_inputs(pkt, fb, tf, tick_ms, roll)
        ev = jnp.sum(inp.valid[:, :, :, None] & state.ctrl.subscribed[:, :, None, :],
                     dtype=jnp.int32)
        state, out = jplane.media_plane_tick(state, inp)
        return state, out, ev

    fwd = ev = chk = 0
    fsum = 0.0
    for i in range(ticks):
        traffic, inp = jsynth.next_tick(traffic, dims, spec, i, seed=seed)
        state, out, e = step(state, *map(jnp.asarray, jplane.pack_tick_inputs(inp)))
        fwd += int(np.asarray(out.fwd_packets).astype(np.int64).sum())
        ev += int(e)
        for leaf in out:
            x = np.asarray(leaf)
            if x.dtype == np.float32:
                fsum += float(x.astype(np.float64).sum())
            else:
                chk += int(x.astype(np.int64).sum())
    return {"fwd": fwd, "evaluated": ev, "checksum": chk, "float_sum": fsum}


@pytest.mark.parametrize("spec_kw", [
    dict(video_tracks=2, audio_tracks=2),
    dict(video_tracks=2, audio_tracks=2, svc=True, tick_ms=20),
], ids=["simulcast", "svc"])
def test_device_window_matches_reference(spec_kw):
    dims = plane.PlaneDims(4, 4, 4, 4)
    got = bench_device.window_counts(dims, synth.TrafficSpec(**spec_kw), 6, device="cpu",
                                     seed=3)
    want = _jax_window(jplane.PlaneDims(*dims), spec_kw, 6, seed=3)
    assert got["fwd"] > 0
    assert {k: got[k] for k in ("fwd", "evaluated", "checksum")} == \
        {k: want[k] for k in ("fwd", "evaluated", "checksum")}
    rtol, _ = plane.float_tolerance("track_bps")
    assert got["float_sum"] == pytest.approx(want["float_sum"], rel=rtol)


def _bench(*args, timeout=240, check=True):
    return subprocess.run([sys.executable, "-m", "livekit_server_tpu_torch.tools.bench", *args],
                          cwd=ROOT, env=ENV, capture_output=True, text=True,
                          timeout=timeout, check=check)


def test_quick_on_the_cpu_prints_the_result_last():
    cp = _bench("--cpu", "--quick", "--rooms", "8", "--ticks", "4", "--warmup", "1")
    last = json.loads(cp.stdout.strip().splitlines()[-1])
    assert last["metric"] == "sfu_pkt_sub_writes_per_sec_per_chip"
    assert last["unit"] == "writes/s" and last["device"] == "cpu"
    assert last["value"] > 0 and last["vs_baseline"] > 0
    assert last["device_tick_ms"] > 0 and last["evaluated_per_s"] >= last["value"]
    assert "section_s" in last and "kernel_builds_total" in last
    assert not [k for k in last if k.endswith("_error")]


def test_without_a_card_the_bench_refuses():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cp = _bench("--quick", timeout=120, check=False)
    assert cp.returncode != 0
    assert "no CUDA device" in cp.stderr
    assert not cp.stdout.strip()


def test_sigterm_mid_section_emits_the_result():
    """The kill-safe emission: a SIGTERM while the primary section runs
    re-emits the result with `killed_in_section` and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "livekit_server_tpu_torch.tools.bench", "--cpu",
         "--rooms", "32", "--ticks", "400", "--warmup", "1"],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = ""
        while not first.startswith("{"):
            first = proc.stdout.readline()
            assert first or proc.poll() is None, proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0
    last = json.loads(rest.strip().splitlines()[-1])
    assert last["killed_in_section"] == "primary"
    assert last["metric"] == "sfu_pkt_sub_writes_per_sec_per_chip"
