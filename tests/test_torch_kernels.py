"""The port's CUDA kernels against their plain PyTorch versions at the
shapes that stress their shared-memory staging, and the wrappers'
routing, operand checks and build paths on the CPU.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no jax (skip the JAX-based conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels*.py

Tests marked `cuda` need an NVIDIA GPU and `nvcc`; elsewhere they skip.
The kernels at the tick shapes are in tests/test_torch_kernels_card.py.
"""

import shutil

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from torch_kernel_fixture import (  # noqa: E402, F401 (card: a fixture)
    alloc_args, assert_trees_equal, card, decide_args, page_args,
)
from torch_paged_fixture import phase2_alloc_case  # noqa: E402

from livekit_server_tpu_torch.ops import (  # noqa: E402
    allocation, cuda, paged_kernel, pacer, selector,
)

# (R, T, K, S, paged) for the staged kernels: rows of odd byte lengths
# (S = 7, 50, 70: 16-byte copies with ragged heads and tails), one room,
# and a prime room count above one tile (the persistent loop's tail).
# `paged` takes the allocation operands from the paged phase-2 geometry
# [R, S=8, T=64] with fill tracks past each room's own pages.
STAGING = {
    "paged-phase2-1037": (1037, 64, 8, 8, True),
    "one-room-s7": (1, 5, 6, 7, False),
    "s50-k16": (13, 8, 16, 50, False),
    "prime-1037-s70": (1037, 3, 4, 70, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STAGING))
def test_kernels_match_plain_staging(card, case):
    """decide_rooms and allocate_budget_rooms against their plain
    versions on the same card inputs at shapes that stress the staged
    spans' ragged edges and the persistent loop's tail; every output
    exact, float32 `used` included, and one launch each."""
    R, T, K, S, paged = STAGING[case]
    seed = R + T + K + S
    before = dict(cuda.launches)
    args = decide_args((R, T, K, S), seed, card)
    got = selector.decide_rooms(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    want = selector.decide_rooms_plain(*args, wire_overhead=pacer.WIRE_OVERHEAD_BYTES)
    torch.cuda.synchronize()
    assert_trees_equal(got, want)
    if paged:
        args = tuple(torch.from_numpy(a).to(card) for a in phase2_alloc_case(seed, R, T, S))
    else:
        args = alloc_args((R, T, K, S), seed, card)
    got = allocation.allocate_budget_rooms(*args)
    want = allocation.allocate_budget_rooms_plain(*args)
    torch.cuda.synchronize()
    assert_trees_equal(got, want)
    assert cuda.launches == {**before, "decide_rooms": before["decide_rooms"] + 1,
                             "allocate_budget_rooms": before["allocate_budget_rooms"] + 1}


def test_wrapper_routing():
    """CPU tensors take the plain version and launch nothing; a tensor on
    neither the CPU nor a card is refused, never silently routed to a
    plain version."""
    before = dict(cuda.launches)
    dims = (3, 4, 5, 9)
    args = decide_args(dims, 1, "cpu")
    assert_trees_equal(selector.decide_rooms(*args, wire_overhead=42),
                       selector.decide_rooms_plain(*args, wire_overhead=42))
    args = alloc_args(dims, 2, "cpu")
    assert_trees_equal(allocation.allocate_budget_rooms(*args),
                       allocation.allocate_budget_rooms_plain(*args))
    assert cuda.launches == before
    decide, mix, rows = page_args((8, 2, 3, 4), 5, "cpu", n_live=3, mix_n=4)
    assert_trees_equal(paged_kernel.decide_pages(*decide, rows, wire_overhead=42),
                       paged_kernel.decide_pages_plain(*decide, rows, wire_overhead=42))
    assert torch.equal(paged_kernel.mix_pages(*mix, rows),
                       paged_kernel.mix_pages_plain(*mix, rows))
    assert cuda.launches == before
    args = decide_args((1, 2, 2, 3), 3, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        selector.decide_rooms(*args, wire_overhead=42)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_kernel.mix_pages(*[x.to("meta") for x in mix], rows.to("meta"))
    with pytest.raises(ValueError, match="non-empty"):
        paged_kernel.decide_pages(*decide, rows[:0], wire_overhead=42)
    with pytest.raises(ValueError, match="unsupported device"):
        allocation.allocate_budget_rooms(*alloc_args((1, 2, 2, 3), 4, "meta"))


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


def test_library_path_digests_headers(tmp_path, monkeypatch):
    """A library's path changes when any shared `csrc/*.cuh` header
    changes or appears, so an edited header never reuses a stale build;
    it stays the same while nothing changes. Editing the shared selector
    step `select_step.cuh` rebuilds both kernels that include it."""
    real = tmp_path / "csrc"
    shutil.copytree(cuda.CSRC, real)
    users = ("decide_rooms", "paged_kernel")
    for source in users:
        assert '#include "select_step.cuh"' in (real / f"{source}.cu").read_text()
    before = {source: cuda.library_path(source, real) for source in users}
    header = real / "select_step.cuh"
    header.write_text(header.read_text() + "// edited\n")
    for source in users:
        assert cuda.library_path(source, real) != before[source]

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda, "CSRC", tmp_path)
    first = cuda.library_path("k")
    assert cuda.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda.library_path("k")
    assert second != first
    (tmp_path / "extra.cuh").write_text("// new\n")
    assert cuda.library_path("k") not in (first, second)
