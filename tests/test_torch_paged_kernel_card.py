"""The live-page kernel (csrc/paged_kernel.cu) against its plain PyTorch
versions at the edges of its tiles: one live entry, an entry count that no
tile size divides, padded duplicate rows, the pool's last page, odd spans
that take the ragged staging path, operands that start off a 16-byte
boundary, sparse packets, and page geometries whose tracks span more than
one warp. Every output of `decide_pages`, `mix_pages` and
`decide_mix_pages` must equal the plain version's bit for bit.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a card and no jax (skip the JAX-based conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_paged_kernel_card.py

Every test here is marked `cuda`: it needs an NVIDIA GPU and `nvcc`, and
skips elsewhere.
"""

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers, and the tensors here are small.
torch.set_num_threads(1)

from torch_kernel_fixture import assert_trees_equal, card, page_args  # noqa: E402, F401

from livekit_server_tpu_torch.ops import cuda, pacer, paged_kernel, selector  # noqa: E402

KW = dict(wire_overhead=pacer.WIRE_OVERHEAD_BYTES)

# name: (page geometry (P, TP, K, SP), live entries, mix samples, options).
# `rows` gives live_rows outright (no padding); `p_valid` the share of
# valid packets (most slots of a real tick are empty); `offset` moves
# every operand one element off its allocation, so no span is 16-byte
# aligned. 10007 is prime: no tile of more than one page divides it.
CASES = {
    "one-entry": ((24, 4, 8, 8), 1, 8, {}),
    "prime-entries": ((10007, 4, 8, 8), None, 8, {"rows": "all"}),
    "duplicates-last-page": ((50, 4, 8, 8), None, 8,
                             {"rows": [49, 0, 49, 3, 49, 7, 8, 49, 49]}),
    "odd-3-5-7-sparse": ((30, 3, 5, 7), 19, 6, {"p_valid": 0.1}),
    "k1": ((40, 3, 1, 7), 21, 5, {}),
    "offset-4-8-8": ((64, 4, 8, 8), 33, 8, {"offset": True, "p_valid": 0.3}),
    "geom-2-4-4": ((16, 2, 4, 4), 9, 8, {}),
    "geom-8-8-32": ((64, 8, 8, 32), 33, 12, {"p_valid": 0.3}),
}


def _offset(t):
    """A copy of t that starts one element past its allocation."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_paged_kernel_tile_edges(card, case):
    """decide_pages, mix_pages and decide_mix_pages against their plain
    versions on the same card inputs, one launch each, every output exact
    (the float32 mix too: same summation order, no FMA)."""
    page, n_live, mix_n, opt = CASES[case]
    rows = opt.get("rows")
    decide, mix, live = page_args(page, sum(page), card, n_live=n_live or 1, mix_n=mix_n,
                                  p_valid=opt.get("p_valid", 0.85))
    if rows == "all":
        live = torch.arange(page[0], dtype=torch.int32, device=card)
    elif rows is not None:
        live = torch.tensor(rows, dtype=torch.int32, device=card)
    if opt.get("offset"):
        sel, is_svc, is_video, base, inp = decide
        inp = inp._replace(**{f: _offset(getattr(inp, f)) for f in paged_kernel._PKT_FIELDS})
        decide = (selector.SelectorState(*map(_offset, sel)), _offset(is_svc),
                  _offset(is_video), _offset(base), inp)
        mix = tuple(map(_offset, mix))
    before = cuda.launches["paged_kernel"]
    want = paged_kernel.decide_pages_plain(*decide, live, **KW)
    got = paged_kernel.decide_pages(*decide, live, **KW)
    torch.cuda.synchronize()
    assert_trees_equal(got, want)
    want_mix = paged_kernel.mix_pages_plain(*mix, live)
    got_mix = paged_kernel.mix_pages(*mix, live)
    torch.cuda.synchronize()
    assert torch.equal(got_mix, want_mix)
    both, both_mix = paged_kernel.decide_mix_pages(*decide, *mix, live, **KW)
    torch.cuda.synchronize()
    assert_trees_equal(both, want)
    assert torch.equal(both_mix, want_mix)
    assert cuda.launches["paged_kernel"] == before + 3


@pytest.mark.cuda
def test_paged_kernel_refuses_page_past_shared_memory(card):
    """A page whose one-page tile exceeds the card's shared memory raises
    ValueError before any launch, on every entry; it never falls back to
    the plain version."""
    decide, mix, live = page_args((2, 512, 8, 32), 3, card, n_live=1, mix_n=4)
    before = cuda.launches["paged_kernel"]
    with pytest.raises(ValueError, match="shared memory"):
        paged_kernel.decide_pages(*decide, live, **KW)
    with pytest.raises(ValueError, match="shared memory"):
        paged_kernel.decide_mix_pages(*decide, *mix, live, **KW)
    assert cuda.launches["paged_kernel"] == before
