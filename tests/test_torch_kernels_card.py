"""The port's CUDA kernels against their plain PyTorch versions at the
dense and paged tick shapes, and a few ticks of the whole plane on the
card against the CPU path.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no jax (skip the JAX-based conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels*.py

Every test here is marked `cuda`: it needs an NVIDIA GPU and `nvcc`, and
skips elsewhere. The kernels' odd-shape cases and the CPU routing checks
are in tests/test_torch_kernels.py.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from torch_kernel_fixture import (  # noqa: E402, F401 (card: a fixture)
    alloc_args, assert_trees_equal, card, decide_args, page_args,
)

from livekit_server_tpu_torch.models import plane, synth  # noqa: E402
from livekit_server_tpu_torch.ops import (  # noqa: E402
    allocation, cuda, pacer, paged_kernel, selector,
)

SHAPES = [(4, 4, 8, 40), (3, 5, 6, 7), (2, 3, 4, 70), (2, 12, 4, 100), (64, 10, 8, 10)]
# Page geometries (P, TP, K, SP) of the live-page kernel: SP=32 sets mask
# bit 31; TP=3 leaves a warp's last track group empty.
PAGE_SHAPES = [(16, 2, 4, 4), (24, 4, 8, 8), (64, 8, 8, 32), (12, 3, 5, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", SHAPES)
def test_kernels_match_plain(card, dims):
    """Each kernel against its plain version on the same card inputs;
    every output exact (the float32 `used` budget included)."""
    args = decide_args(dims, sum(dims), card)
    before = dict(cuda.launches)
    got = selector.decide_rooms(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    want = selector.decide_rooms_plain(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    torch.cuda.synchronize()
    assert_trees_equal(got, want)
    args = alloc_args(dims, sum(dims), card)
    got = allocation.allocate_budget_rooms(*args)
    want = allocation.allocate_budget_rooms_plain(*args)
    torch.cuda.synchronize()
    assert_trees_equal(got, want)
    assert cuda.launches == {**before, "decide_rooms": before["decide_rooms"] + 1,
                             "allocate_budget_rooms": before["allocate_budget_rooms"] + 1}


@pytest.mark.cuda
def test_paged_kernel_matches_plain(card):
    """The live-page kernel against its plain versions on the same card
    inputs at each of PAGE_SHAPES, with padded duplicate live rows:
    decide (selection, masks, sums, routing stacks), mix and the fused
    decide+mix launch, every output exact (the float32 mix too: same
    summation order, no FMA)."""
    kw = dict(wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    for page in PAGE_SHAPES:
        decide, mix, rows = page_args(page, sum(page), card, n_live=page[0] // 2 + 1,
                                      mix_n=96)
        before = cuda.launches["paged_kernel"]
        got = paged_kernel.decide_pages(*decide, rows, **kw)
        want = paged_kernel.decide_pages_plain(*decide, rows, **kw)
        torch.cuda.synchronize()
        assert_trees_equal(got, want)
        got_mix = paged_kernel.mix_pages(*mix, rows)
        want_mix = paged_kernel.mix_pages_plain(*mix, rows)
        torch.cuda.synchronize()
        assert torch.equal(got_mix, want_mix), page
        both, both_mix = paged_kernel.decide_mix_pages(*decide, *mix, rows, **kw)
        torch.cuda.synchronize()
        assert_trees_equal(both, want)
        assert torch.equal(both_mix, want_mix), page
        assert cuda.launches["paged_kernel"] == before + 3


@pytest.mark.cuda
def test_tick_on_card_matches_cpu(card):
    """Five ticks of the whole plane on the card against the CPU path:
    integers exact, floats within `plane.float_tolerance` of each leaf
    (powf and reduction order may differ by an ulp)."""
    dims = plane.PlaneDims(6, 6, 8, 12)
    spec = synth.TrafficSpec(video_tracks=2, audio_tracks=3, svc=True)
    states = {d: synth.make_state(dims, spec, device=d) for d in ("cpu", "cuda")}
    traffic = synth.init_traffic(dims, spec, seed=1)
    for i in range(5):
        traffic, inp = synth.next_tick(traffic, dims, spec, i, seed=1)
        outs = {}
        for d in states:
            states[d], outs[d] = plane.media_plane_tick(
                states[d], plane.inputs_to_device(inp, d))
        for name, x, y in zip(plane.TickOutputs._fields, outs["cpu"], outs["cuda"]):
            y = y.cpu()
            if x.is_floating_point():
                rtol, atol = plane.float_tolerance(name)
                torch.testing.assert_close(y, x, rtol=rtol, atol=atol, msg=name)
            else:
                assert torch.equal(x, y)
