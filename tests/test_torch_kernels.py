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
from livekit_server_tpu_torch.ops import allocation, cuda, pacer, selector  # noqa: E402

SHAPES = [(4, 4, 8, 40), (3, 5, 6, 7), (2, 3, 4, 70), (2, 12, 4, 100), (64, 10, 8, 10)]


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
    assert cuda.launches == {name: n + 1 for name, n in before.items()}


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
    args = _decide_args((1, 2, 2, 3), 3, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        selector.decide_rooms(*args, wire_overhead=42)
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
