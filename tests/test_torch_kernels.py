"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no jax (skip the JAX-based conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked `cuda` need an NVIDIA GPU and `nvcc`; elsewhere they skip.
The rest check the wrappers' routing on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from livekit_server_tpu_torch.models import plane, synth  # noqa: E402
from livekit_server_tpu_torch.ops import (  # noqa: E402
    allocation, cuda, pacer, paged_kernel, selector,
)

SHAPES = [(4, 4, 8, 40), (3, 5, 6, 7), (2, 3, 4, 70), (2, 12, 4, 100), (64, 10, 8, 10)]
# Page geometries (P, TP, K, SP) of the live-page kernel: SP=32 sets mask
# bit 31; TP=3 leaves a warp's last track group empty.
PAGE_SHAPES = [(16, 2, 4, 4), (24, 4, 8, 8), (64, 8, 8, 32), (12, 3, 5, 8)]


def _decide_args(dims, seed, dev):
    R, T, K, S = dims
    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(-1, 4, (R, T, S))),
        i32(rng.integers(-1, 3, (R, T, S))), i32(rng.integers(0, 4, (R, T, S))))
    pkt = (i32(rng.integers(0, 3, (R, T, K))), i32(rng.integers(0, 4, (R, T, K))),
           b(0.3, (R, T, K)), b(0.5, (R, T, K)), b(0.4, (R, T, K)),
           b(0.9, (R, T, K)), i32(rng.integers(40, 1300, (R, T, K))))
    return (state, b(0.5, (R, T)), b(0.6, (R, T)), b(0.7, (R, T, S)), *pkt)


def _alloc_args(dims, seed, dev):
    R, T, K, S = dims
    rng = np.random.default_rng(seed)
    bit = rng.random((R, T, 4, 4)) * 2e6 * (rng.random((R, T, 4, 4)) > 0.3)
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(dev)  # noqa: E731
    return (t(bit, np.float32), t(rng.integers(-1, 4, (R, S, T)), np.int32),
            t(rng.integers(-1, 4, (R, S, T)), np.int32),
            torch.from_numpy(rng.random((R, S, T)) < 0.2).to(dev),
            t(rng.random((R, S)) * 8e6, np.float32))


def page_args(page, seed, dev, n_live: int, mix_n: int = 0):
    """Seeded pooled operands of the live-page kernel: decide operands,
    mix operands (pcm [P, TP, mix_n], levels with ties at the top) and
    live_rows naming n_live distinct pages, padded with a duplicate to a
    power of two."""
    P, TP, K, SP = page
    rng = np.random.default_rng(seed)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    b = lambda p, shape: torch.from_numpy(rng.random(shape) < p).to(dev)  # noqa: E731
    state = selector.SelectorState(
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(-1, 4, (P, TP, SP))),
        i32(rng.integers(-1, 3, (P, TP, SP))), i32(rng.integers(0, 4, (P, TP, SP))))
    pk = lambda lo, hi: i32(rng.integers(lo, hi, (P, TP, K)))  # noqa: E731
    inp = plane.TickInputs(**dict.fromkeys(plane.TickInputs._fields))._replace(
        layer=pk(-1, 4), temporal=pk(0, 4), keyframe=b(0.3, (P, TP, K)),
        layer_sync=b(0.5, (P, TP, K)), end_frame=b(0.4, (P, TP, K)),
        valid=b(0.85, (P, TP, K)), size=pk(40, 1300), sn=pk(0, 65536),
        ts=i32(rng.integers(-2**31, 2**31, (P, TP, K), dtype=np.int64)),
        arrival_rtp=pk(0, 1 << 30), begin_pic=b(0.4, (P, TP, K)))
    decide = (state, b(0.4, (P, TP)), b(0.6, (P, TP)), b(0.7, (P, TP, SP)), inp)
    level = rng.random((P, TP)).astype(np.float32)
    level[:, : min(3, TP)] = level[:, -1:]                   # ties at the top
    mix = (torch.from_numpy(rng.standard_normal((P, TP, mix_n)).astype(np.float32) * 0.3).to(dev),
           torch.from_numpy(level).to(dev), b(0.7, (P, TP)),
           i32(rng.integers(-1, TP, (P, SP))),
           torch.from_numpy(rng.uniform(0.5, 1.5, (P, TP)).astype(np.float32)).to(dev))
    live = rng.choice(P, n_live, replace=False)
    nl = 1 << max(n_live - 1, 0).bit_length()
    rows = np.concatenate([live, np.repeat(live[:1], nl - n_live)])
    return decide, mix, i32(rows)


def _assert_trees_equal(a, b):
    for x, y in zip(plane.tree_leaves(a), plane.tree_leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", SHAPES)
def test_kernels_match_plain(card, dims):
    """Each kernel against its plain version on the same card inputs;
    every output exact (the float32 `used` budget included)."""
    args = _decide_args(dims, sum(dims), card)
    before = dict(cuda.launches)
    got = selector.decide_rooms(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    want = selector.decide_rooms_plain(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    torch.cuda.synchronize()
    _assert_trees_equal(got, want)
    args = _alloc_args(dims, sum(dims), card)
    got = allocation.allocate_budget_rooms(*args)
    want = allocation.allocate_budget_rooms_plain(*args)
    torch.cuda.synchronize()
    _assert_trees_equal(got, want)
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
        _assert_trees_equal(got, want)
        got_mix = paged_kernel.mix_pages(*mix, rows)
        want_mix = paged_kernel.mix_pages_plain(*mix, rows)
        torch.cuda.synchronize()
        assert torch.equal(got_mix, want_mix), page
        both, both_mix = paged_kernel.decide_mix_pages(*decide, *mix, rows, **kw)
        torch.cuda.synchronize()
        _assert_trees_equal(both, want)
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


def test_wrapper_routing():
    """CPU tensors take the plain version and launch nothing; a tensor on
    neither the CPU nor a card is refused, never silently routed to a
    plain version."""
    before = dict(cuda.launches)
    dims = (3, 4, 5, 9)
    args = _decide_args(dims, 1, "cpu")
    _assert_trees_equal(selector.decide_rooms(*args, wire_overhead=42),
                        selector.decide_rooms_plain(*args, wire_overhead=42))
    args = _alloc_args(dims, 2, "cpu")
    _assert_trees_equal(allocation.allocate_budget_rooms(*args),
                        allocation.allocate_budget_rooms_plain(*args))
    assert cuda.launches == before
    decide, mix, rows = page_args((8, 2, 3, 4), 5, "cpu", n_live=3, mix_n=4)
    _assert_trees_equal(paged_kernel.decide_pages(*decide, rows, wire_overhead=42),
                        paged_kernel.decide_pages_plain(*decide, rows, wire_overhead=42))
    assert torch.equal(paged_kernel.mix_pages(*mix, rows),
                       paged_kernel.mix_pages_plain(*mix, rows))
    assert cuda.launches == before
    args = _decide_args((1, 2, 2, 3), 3, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        selector.decide_rooms(*args, wire_overhead=42)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_kernel.mix_pages(*[x.to("meta") for x in mix], rows.to("meta"))
    with pytest.raises(ValueError, match="non-empty"):
        paged_kernel.decide_pages(*decide, rows[:0], wire_overhead=42)
    with pytest.raises(ValueError, match="unsupported device"):
        allocation.allocate_budget_rooms(*_alloc_args((1, 2, 2, 3), 4, "meta"))


def test_operand_checks():
    """`require` rejects a wrong dtype, shape or layout before a pointer
    crosses to C."""
    dev = torch.device("cpu")
    x = torch.zeros((2, 3), dtype=torch.int32)
    cuda.require(x, "x", torch.int32, (2, 3), dev)
    with pytest.raises(ValueError, match="dtype"):
        cuda.require(x.float(), "x", torch.int32, (2, 3), dev)
    with pytest.raises(ValueError, match="shape"):
        cuda.require(x, "x", torch.int32, (3, 2), dev)
    with pytest.raises(ValueError, match="contiguous"):
        cuda.require(x.t(), "x", torch.int32, (3, 2), dev)


def test_build_names_each_source():
    """Every kernel maps to a CUDA source in the package; library paths
    carry a digest of the source and flags."""
    for name, source in cuda.SOURCES.items():
        src = cuda.CSRC / f"{source}.cu"
        assert src.is_file(), name
        assert "sm_90a" in " ".join(cuda.NVCC_FLAGS)
        path = cuda.library_path(source)
        assert path.parent == cuda.BUILD and path.name.startswith(f"lib{source}-")
