"""The port's dependency descriptor (livekit_server_tpu_torch.runtime.dd):
the reference's parse/patch round trips (tests/test_dd.py) on the port's
module, then the port's parse, build and patch_active_mask against the
JAX package's on seeded descriptors.

Reference parity: pkg/sfu/dependencydescriptor/ — parse mandatory +
extended + template structure, active-decode-targets bitmask location
and in-place rewrite.
"""

import dataclasses

import numpy as np
import pytest

from livekit_server_tpu.runtime import dd as jax_dd
from livekit_server_tpu_torch.runtime import dd

torch = pytest.importorskip("torch")
# One intra-op thread: these tests run beside timing-sensitive tests in
# other workers.
torch.set_num_threads(1)


def l2t2_structure():
    # 2 spatial x 2 temporal, 4 decode targets (dt = sid*2+tid), one
    # template per layer, simple fdiffs + chains.
    templates = [
        dd.Template(spatial=0, temporal=0, dtis=[3, 2, 3, 2], fdiffs=[4],
                    chain_diffs=[4, 0]),
        dd.Template(spatial=0, temporal=1, dtis=[0, 3, 0, 2], fdiffs=[2],
                    chain_diffs=[2, 2]),
        dd.Template(spatial=1, temporal=0, dtis=[0, 0, 3, 2], fdiffs=[1, 4],
                    chain_diffs=[1, 1]),
        dd.Template(spatial=1, temporal=1, dtis=[0, 0, 0, 3], fdiffs=[2, 1],
                    chain_diffs=[2, 1]),
    ]
    return dd.Structure(
        structure_id=3, num_decode_targets=4, templates=templates,
        num_chains=2, protected_by=[0, 0, 1, 1],
        resolutions=[(640, 360), (1280, 720)],
    )


def test_mandatory_only_roundtrip():
    raw = dd.build(True, False, template_id=5, frame_number=0xBEEF)
    assert len(raw) == 3
    d = dd.parse(raw)
    assert d.first_packet_in_frame and not d.last_packet_in_frame
    assert d.template_id == 5 and d.frame_number == 0xBEEF
    assert d.structure is None and d.active_mask is None


def test_structure_roundtrip_and_layers():
    s = l2t2_structure()
    raw = dd.build(True, True, template_id=3, frame_number=7, structure=s)
    d = dd.parse(raw)
    assert d.structure is not None
    got = d.structure
    assert got.structure_id == 3 and got.num_decode_targets == 4
    assert [(t.spatial, t.temporal) for t in got.templates] == [
        (0, 0), (0, 1), (1, 0), (1, 1)
    ]
    assert [t.dtis for t in got.templates] == [t.dtis for t in s.templates]
    assert [t.fdiffs for t in got.templates] == [t.fdiffs for t in s.templates]
    assert got.num_chains == 2 and got.protected_by == [0, 0, 1, 1]
    assert got.resolutions == [(640, 360), (1280, 720)]
    # Structure attach => all decode targets active.
    assert d.active_mask == 0b1111
    # dt -> max (spatial, temporal) map for the selector.
    assert got.decode_target_layers() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # Packet layer via template id (relative to structure_id).
    assert d.layer(got) == (0, 0)
    d2 = dd.parse(dd.build(True, True, template_id=4, frame_number=8))
    assert d2.layer(got) == (0, 1)   # relative index 4-3 = 1
    d3 = dd.parse(dd.build(True, True, template_id=5, frame_number=9))
    assert d3.layer(got) == (1, 0)   # relative index 2


def test_active_mask_needs_structure_and_patch():
    s = l2t2_structure()
    raw = dd.build(False, True, template_id=4, frame_number=9,
                   active_mask=0b1111, mask_bits=4)
    with pytest.raises(dd.NeedStructure):
        dd.parse(raw)
    d = dd.parse_with_structure(raw, s)
    assert d.active_mask == 0b1111 and d.active_mask_bit_off > 0

    # In-place restriction to spatial 0 only (targets 0,1).
    buf = bytearray(raw)
    assert dd.patch_active_mask(buf, 0, d, 0b0011)
    d3 = dd.parse_with_structure(bytes(buf), s)
    assert d3.active_mask == 0b0011
    # Everything else untouched.
    assert d3.template_id == 4 and d3.frame_number == 9


def test_mask_patch_with_structure_packet():
    s = l2t2_structure()
    raw = dd.build(True, True, template_id=3, frame_number=1, structure=s,
                   active_mask=0b1111, mask_bits=4)
    d = dd.parse(raw)
    assert d.active_mask == 0b1111 and d.active_mask_bit_off > 0
    buf = bytearray(raw)
    assert dd.patch_active_mask(buf, 0, d, 0b0101)
    assert dd.parse(bytes(buf)).active_mask == 0b0101


def test_truncated_dd_rejected():
    s = l2t2_structure()
    raw = dd.build(True, True, template_id=3, frame_number=7, structure=s)
    with pytest.raises(ValueError):
        dd.parse(raw[:5])


def test_custom_frame_deps_roundtrip():
    """frame_dependency_definition: custom dtis/fdiffs/chain-fdiffs decode
    (dependencydescriptorreader.go readFrameDtis/Fdiffs/Chains)."""
    s = l2t2_structure()
    raw = dd.build(
        True, True, template_id=3, frame_number=10, structure=s,
        active_mask=0b1011,
        custom_dtis=[3, 0, 2, 1],
        custom_fdiffs=[2, 17, 300],     # 1-, 2-, 3-nibble widths
        custom_chain_fdiffs=[7, 200],
    )
    d = dd.parse(raw)
    assert d.custom_dtis == [3, 0, 2, 1]
    assert d.custom_fdiffs == [2, 17, 300]
    assert d.custom_chain_fdiffs == [7, 200]
    assert d.active_mask == 0b1011
    # Custom dtis take precedence over the template's.
    assert d.effective_dtis(d.structure) == [3, 0, 2, 1]
    d_plain = dd.parse(dd.build(True, True, template_id=3, frame_number=11,
                                structure=s))
    assert d_plain.effective_dtis(d_plain.structure) == [3, 2, 3, 2]

    # Without an attached structure the widths need the cache.
    raw2 = dd.build(False, True, template_id=4, frame_number=12,
                    custom_dtis=[0, 3, 0, 2], custom_chain_fdiffs=[1, 2],
                    mask_bits=0)
    with pytest.raises(dd.NeedStructure):
        dd.parse(raw2)
    d2 = dd.parse_with_structure(raw2, s)
    assert d2.custom_dtis == [0, 3, 0, 2]
    assert d2.custom_chain_fdiffs == [1, 2]
    # custom fdiffs alone need no structure at all
    raw3 = dd.build(False, False, template_id=4, frame_number=13,
                    custom_fdiffs=[1])
    assert dd.parse(raw3).custom_fdiffs == [1]


def test_refine_layer_honors_custom_dtis():
    """A frame marked not-present for low decode targets gets its
    effective temporal raised; absent everywhere at its spatial → dropped
    for every subscriber (the custom-dti precedence the reference's DD
    selector applies)."""
    s = l2t2_structure()
    # Template (0,0) normally feeds dts 0..3. Custom dtis mark the frame
    # present ONLY for dt1 (s0,t1) and dt3 (s1,t1) → effective temporal 1.
    raw = dd.build(True, True, template_id=3, frame_number=20, structure=s,
                   custom_dtis=[0, 1, 0, 1])
    d = dd.parse(raw)
    assert d.layer(d.structure) == (0, 0)
    assert d.refine_layer(d.structure) == (0, 1)
    # No custom dtis → template behavior, unchanged.
    d2 = dd.parse(dd.build(True, True, template_id=3, frame_number=21,
                           structure=s))
    assert d2.refine_layer(d2.structure) == d2.layer(d2.structure)
    # Absent from every decode target at its spatial layer → MAX_TEMPORAL
    # (forwarded to nobody).
    raw3 = dd.build(True, True, template_id=3, frame_number=22, structure=s,
                    custom_dtis=[0, 0, 0, 0])
    d3 = dd.parse(raw3)
    assert d3.refine_layer(d3.structure) == (0, dd.MAX_TEMPORAL)


def _as_dict(desc):
    out = dataclasses.asdict(desc)
    out.pop("structure", None)
    return out


def test_port_dd_matches_jax_dd_on_seeded_descriptors():
    """Seeded descriptors (mandatory-only, with the structure, with an
    active mask, with custom dtis/fdiffs) built by both packages are the
    same bytes, parse to the same fields, refine to the same layers, and
    patch to the same bytes."""
    rng = np.random.default_rng(5)
    struct, jstruct = l2t2_structure(), None
    jstruct = jax_dd.Structure(
        **{**dataclasses.asdict(struct),
           "templates": [jax_dd.Template(**dataclasses.asdict(t)) for t in struct.templates]})
    for i in range(200):
        kw = dict(first=bool(rng.random() < 0.5), last=bool(rng.random() < 0.5),
                  template_id=int(rng.integers(3, 7)), frame_number=int(rng.integers(0, 1 << 16)))
        if rng.random() < 0.3:
            kw["active_mask"], kw["mask_bits"] = int(rng.integers(0, 16)), 4
        if rng.random() < 0.2:
            kw["custom_dtis"] = [int(x) for x in rng.integers(0, 4, 4)]
        if rng.random() < 0.2:
            kw["custom_fdiffs"] = [int(x) for x in rng.integers(1, 300, 2)]
        with_struct = rng.random() < 0.3
        raw = dd.build(**kw, structure=struct if with_struct else None)
        assert raw == jax_dd.build(**kw, structure=jstruct if with_struct else None)
        if with_struct:
            got, want = dd.parse(raw), jax_dd.parse(raw)
        else:
            got, want = dd.parse_with_structure(raw, struct), jax_dd.parse_with_structure(raw, jstruct)
        assert _as_dict(got) == _as_dict(want)
        assert got.refine_layer(struct) == want.refine_layer(jstruct)
        if got.active_mask is not None:
            mask = int(rng.integers(0, 16))
            a, b = bytearray(raw), bytearray(raw)
            assert (dd.patch_active_mask(a, 0, got, mask)
                    == jax_dd.patch_active_mask(b, 0, want, mask))
            assert a == b
