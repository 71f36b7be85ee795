"""AV1 Dependency Descriptor (DD) header extension: parse + patch.

Reference parity: pkg/sfu/dependencydescriptor/ — bitstreamreader.go
(MSB-first bit reader incl. the ns(n) non-symmetric encoding),
dependencydescriptorreader.go:57 (mandatory fields, extended flags,
template dependency structure, active-decode-targets bitmask) and the
writer's bitmask placement (dependencydescriptorwriter.go:254). This is
the byte half the device-side decode-target selection (ops/svc.py) needs:
structures are parsed once per keyframe on the host, cached per SSRC, and
every packet's (spatial, temporal) comes from a template-table lookup.

Scope: everything the SFU forwards or rewrites — mandatory fields,
extended flags, the full template dependency structure (layers, DTIs,
fdiffs, chains, resolutions), the active-decode-targets bitmask with
its exact bit offset so egress can patch it in place, AND the per-frame
custom dtis / fdiffs / chain fdiffs (frame_dependency_definition): the
reference reads them (dependencydescriptorreader.go readFrameDtis /
readFrameFdiffs / readFrameChains) and its selector prefers a frame's
custom DTIs over the template's when deciding per-decode-target
forwarding — so `effective_dtis`/`refine_layer` below feed the same
override into this build's layer-based selection.

A copy of the JAX package's runtime/dd.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MAX_TEMPLATES = 64
MAX_SPATIAL = 4
MAX_TEMPORAL = 8

# DecodeTargetIndication (2-bit): not present / discardable / switch / required
DTI_NOT_PRESENT = 0


class BitReader:
    """MSB-first bit reader (bitstreamreader.go)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def ok(self) -> bool:
        return self.pos <= len(self.data) * 8

    def remaining(self) -> int:
        return len(self.data) * 8 - self.pos

    def read_bits(self, n: int) -> int:
        if self.pos + n > len(self.data) * 8:
            raise ValueError("DD truncated")
        v = 0
        pos = self.pos
        for _ in range(n):
            byte = self.data[pos >> 3]
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def read_bool(self) -> bool:
        return bool(self.read_bits(1))

    def read_ns(self, num_values: int) -> int:
        """ns(n) non-symmetric unsigned (bitstreamreader.go:102)."""
        if num_values <= 1:
            return 0
        width = num_values.bit_length()
        num_min = (1 << width) - num_values
        v = self.read_bits(width - 1)
        if v < num_min:
            return v
        return (v << 1) + self.read_bits(1) - num_min


class BitWriter:
    """MSB-first writer (test/round-trip support; bitstreamwriter.go)."""

    def __init__(self) -> None:
        self.bits: list[int] = []

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def write_ns(self, v: int, num_values: int) -> None:
        if num_values <= 1:
            return
        width = num_values.bit_length()
        num_min = (1 << width) - num_values
        if v < num_min:
            self.write_bits(v, width - 1)
        else:
            self.write_bits(v + num_min, width)

    def tobytes(self) -> bytes:
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 1 << (7 - (i & 7))
        return bytes(out)


@dataclass
class Template:
    spatial: int
    temporal: int
    dtis: list[int] = field(default_factory=list)    # per decode target
    fdiffs: list[int] = field(default_factory=list)
    chain_diffs: list[int] = field(default_factory=list)


@dataclass
class Structure:
    """FrameDependencyStructure (dependencydescriptorextension.go)."""

    structure_id: int
    num_decode_targets: int
    templates: list[Template]
    num_chains: int = 0
    protected_by: list[int] = field(default_factory=list)
    resolutions: list[tuple[int, int]] = field(default_factory=list)

    def decode_target_layers(self) -> list[tuple[int, int]]:
        """Per decode target: (spatial, temporal) = max layer of any
        template where the DT is present (the dt → layer map ops/svc's
        selection consumes). Memoized — structures are parsed once per
        keyframe and never mutated, and this runs in per-packet paths."""
        cached = getattr(self, "_dt_layers", None)
        if cached is not None:
            return cached
        out = []
        for d in range(self.num_decode_targets):
            sp = tp = 0
            for t in self.templates:
                if d < len(t.dtis) and t.dtis[d] != DTI_NOT_PRESENT:
                    sp = max(sp, t.spatial)
                    tp = max(tp, t.temporal)
            out.append((sp, tp))
        object.__setattr__(self, "_dt_layers", out)
        return out


@dataclass
class Descriptor:
    first_packet_in_frame: bool
    last_packet_in_frame: bool
    template_id: int          # raw 6-bit field (index is relative to
                              # structure_id modulo 64)
    frame_number: int
    structure: Structure | None = None          # attached this packet
    active_mask: int | None = None
    active_mask_bit_off: int = -1               # bit offset of the mask
    active_mask_bits: int = 0
    # frame_dependency_definition overrides (None = use the template's)
    custom_dtis: list[int] | None = None
    custom_fdiffs: list[int] | None = None
    custom_chain_fdiffs: list[int] | None = None

    def _template(self, structure: Structure) -> Template | None:
        idx = (self.template_id + MAX_TEMPLATES - structure.structure_id) % MAX_TEMPLATES
        if idx >= len(structure.templates):
            return None
        return structure.templates[idx]

    def layer(self, structure: Structure) -> tuple[int, int]:
        """(spatial, temporal) of this packet via the template table."""
        t = self._template(structure)
        if t is None:
            return 0, 0
        return t.spatial, t.temporal

    def effective_dtis(self, structure: Structure) -> list[int] | None:
        """Per-decode-target indications for THIS frame: the custom
        override when present, else the template's (the precedence the
        reference's DD selector applies)."""
        if self.custom_dtis is not None:
            return self.custom_dtis
        t = self._template(structure)
        return t.dtis if t is not None and t.dtis else None

    def refine_layer(self, structure: Structure) -> tuple[int, int]:
        """(spatial, effective temporal) honoring per-frame DTIs.

        The template gives the frame's nominal (s, t). When DTIs mark the
        frame not-present for every decode target at temporal <= t (a
        per-frame skip — only expressible via custom dtis), the frame's
        effective temporal id is the lowest temporal of any decode target
        that still needs it, so layer-based selection drops it for
        subscribers below that point exactly as per-DT selection would.
        Absent from every decode target at this spatial → (s, MAX_TEMPORAL):
        forwardable to no one.

        Frames WITHOUT custom dtis take the template fast path (one table
        lookup — this runs per packet at ingest; template dtis are
        consistent with the template's own (s, t) by construction)."""
        sp, tp = self.layer(structure)
        dtis = self.custom_dtis
        if dtis is None:
            return sp, tp
        layers = structure.decode_target_layers()
        needed = [
            layers[d][1]
            for d in range(min(len(dtis), len(layers)))
            if dtis[d] != DTI_NOT_PRESENT and layers[d][0] >= sp
        ]
        if not needed:
            return sp, MAX_TEMPORAL
        return sp, max(tp, min(needed))


def parse(data: bytes) -> Descriptor:
    """Parse one DD extension payload (dependencydescriptorreader.go:57).
    Raises ValueError on truncation/overflow."""
    r = BitReader(data)
    first = r.read_bool()
    last = r.read_bool()
    template_id = r.read_bits(6)
    frame_number = r.read_bits(16)
    d = Descriptor(first, last, template_id, frame_number)
    if len(data) <= 3:
        return d

    structure_present = r.read_bool()
    active_present = r.read_bool()
    custom_dtis = r.read_bool()
    custom_fdiffs = r.read_bool()
    custom_chains = r.read_bool()

    if structure_present:
        d.structure = _parse_structure(r)
        # Structure attach implies all targets active unless overridden.
        d.active_mask = (1 << d.structure.num_decode_targets) - 1
        d.active_mask_bits = d.structure.num_decode_targets
    if (active_present or custom_dtis or custom_chains) and d.structure is None:
        # These fields' widths come from the sender's structure
        # (decode-target count / chain count); the caller re-parses via
        # parse_with_structure against its cache.
        raise NeedStructure(d)
    if active_present:
        d.active_mask_bit_off = r.pos
        d.active_mask_bits = d.structure.num_decode_targets
        d.active_mask = r.read_bits(d.structure.num_decode_targets)
    _parse_frame_deps(r, d, d.structure, custom_dtis, custom_fdiffs, custom_chains)
    return d


class NeedStructure(ValueError):
    """Raised when a DD needs the sender's cached structure to finish
    (active bitmask width = that structure's decode-target count)."""

    def __init__(self, partial: Descriptor):
        super().__init__("DD requires cached structure")
        self.partial = partial


def parse_with_structure(data: bytes, structure: Structure) -> Descriptor:
    """Parse using a previously-cached structure for field widths."""
    try:
        return parse(data)
    except NeedStructure:
        pass
    r = BitReader(data)
    first = r.read_bool()
    last = r.read_bool()
    template_id = r.read_bits(6)
    frame_number = r.read_bits(16)
    d = Descriptor(first, last, template_id, frame_number)
    r.read_bool()                      # structure_present (False here)
    active_present = r.read_bool()
    custom_dtis = r.read_bool()
    custom_fdiffs = r.read_bool()
    custom_chains = r.read_bool()
    if active_present:
        d.active_mask_bit_off = r.pos
        d.active_mask_bits = structure.num_decode_targets
        d.active_mask = r.read_bits(structure.num_decode_targets)
    _parse_frame_deps(r, d, structure, custom_dtis, custom_fdiffs, custom_chains)
    return d


def _parse_frame_deps(
    r: BitReader, d: Descriptor, structure: Structure | None,
    custom_dtis: bool, custom_fdiffs: bool, custom_chains: bool,
) -> None:
    """frame_dependency_definition (dependencydescriptorreader.go
    readFrameDtis/readFrameFdiffs/readFrameChains): per-frame overrides of
    the template's dtis / fdiffs / chain diffs."""
    if custom_dtis:
        d.custom_dtis = [r.read_bits(2) for _ in range(structure.num_decode_targets)]
    if custom_fdiffs:
        d.custom_fdiffs = []
        while True:
            size = r.read_bits(2)      # next_fdiff_size: 0 ends the list
            if size == 0:
                break
            if len(d.custom_fdiffs) >= MAX_TEMPLATES:
                raise ValueError("too many frame fdiffs")
            d.custom_fdiffs.append(r.read_bits(4 * size) + 1)
    if custom_chains:
        d.custom_chain_fdiffs = [r.read_bits(8) for _ in range(structure.num_chains)]


def _parse_structure(r: BitReader) -> Structure:
    structure_id = r.read_bits(6)
    num_dt = r.read_bits(5) + 1
    # template layers: 2-bit next_layer_idc walk
    templates: list[Template] = []
    spatial = temporal = 0
    while True:
        if len(templates) >= MAX_TEMPLATES:
            raise ValueError("too many DD templates")
        templates.append(Template(spatial=spatial, temporal=temporal))
        idc = r.read_bits(2)
        if idc == 1:      # next temporal
            temporal += 1
            if temporal >= MAX_TEMPORAL:
                raise ValueError("too many temporal layers")
        elif idc == 2:    # next spatial
            spatial += 1
            temporal = 0
            if spatial >= MAX_SPATIAL:
                raise ValueError("too many spatial layers")
        elif idc == 3:    # no more
            break
    for t in templates:
        t.dtis = [r.read_bits(2) for _ in range(num_dt)]
    for t in templates:
        while r.read_bool():
            t.fdiffs.append(r.read_bits(4) + 1)
    s = Structure(structure_id=structure_id, num_decode_targets=num_dt,
                  templates=templates)
    s.num_chains = r.read_ns(num_dt + 1)
    if s.num_chains:
        s.protected_by = [r.read_ns(s.num_chains) for _ in range(num_dt)]
        for t in templates:
            t.chain_diffs = [r.read_bits(4) for _ in range(s.num_chains)]
    if r.read_bool():  # resolutions
        spatial_layers = templates[-1].spatial + 1
        s.resolutions = [
            (r.read_bits(16) + 1, r.read_bits(16) + 1)
            for _ in range(spatial_layers)
        ]
    return s


def patch_active_mask(buf: bytearray, base_bit: int, d: Descriptor, mask: int) -> bool:
    """In-place rewrite of the active-decode-targets bitmask (the
    writer-side seat of dependencydescriptorwriter.go:254): `base_bit` is
    the DD payload's first bit position within `buf`. Returns False when
    this packet carries no bitmask field (nothing to patch — the
    restriction rides the next keyframe's descriptor instead)."""
    if d.active_mask_bit_off < 0 or d.active_mask_bits <= 0:
        return False
    pos = base_bit + d.active_mask_bit_off
    for i in range(d.active_mask_bits):
        bit = (mask >> (d.active_mask_bits - 1 - i)) & 1
        p = pos + i
        if bit:
            buf[p >> 3] |= 1 << (7 - (p & 7))
        else:
            buf[p >> 3] &= ~(1 << (7 - (p & 7)))
    return True


# -- writer (tests + synthetic SVC publishers) ------------------------------

def build(
    first: bool, last: bool, template_id: int, frame_number: int,
    structure: Structure | None = None, active_mask: int | None = None,
    mask_bits: int = 0,
    custom_dtis: list[int] | None = None,
    custom_fdiffs: list[int] | None = None,
    custom_chain_fdiffs: list[int] | None = None,
) -> bytes:
    """Serialize a DD mirroring the reader's field order — used by tests
    and the traffic synthesizer."""
    w = BitWriter()
    w.write_bits(1 if first else 0, 1)
    w.write_bits(1 if last else 0, 1)
    w.write_bits(template_id & 0x3F, 6)
    w.write_bits(frame_number & 0xFFFF, 16)
    any_custom = (
        custom_dtis is not None or custom_fdiffs is not None
        or custom_chain_fdiffs is not None
    )
    if structure is None and active_mask is None and not any_custom:
        return w.tobytes()
    w.write_bits(1 if structure is not None else 0, 1)   # structure present
    w.write_bits(1 if active_mask is not None else 0, 1)  # active present
    w.write_bits(1 if custom_dtis is not None else 0, 1)
    w.write_bits(1 if custom_fdiffs is not None else 0, 1)
    w.write_bits(1 if custom_chain_fdiffs is not None else 0, 1)
    if structure is not None:
        w.write_bits(structure.structure_id & 0x3F, 6)
        w.write_bits(structure.num_decode_targets - 1, 5)
        for i, t in enumerate(structure.templates):
            if i + 1 < len(structure.templates):
                nxt = structure.templates[i + 1]
                if nxt.spatial == t.spatial and nxt.temporal == t.temporal:
                    idc = 0
                elif nxt.spatial == t.spatial:
                    idc = 1
                else:
                    idc = 2
            else:
                idc = 3
            w.write_bits(idc, 2)
        for t in structure.templates:
            for dti in t.dtis:
                w.write_bits(dti, 2)
        for t in structure.templates:
            for f in t.fdiffs:
                w.write_bits(1, 1)
                w.write_bits(f - 1, 4)
            w.write_bits(0, 1)
        w.write_ns(structure.num_chains, structure.num_decode_targets + 1)
        if structure.num_chains:
            for p in structure.protected_by:
                w.write_ns(p, structure.num_chains)
            for t in structure.templates:
                cds = t.chain_diffs or [0] * structure.num_chains
                for cd in cds[: structure.num_chains]:
                    w.write_bits(cd, 4)
        w.write_bits(1 if structure.resolutions else 0, 1)
        for wd, ht in structure.resolutions:
            w.write_bits(wd - 1, 16)
            w.write_bits(ht - 1, 16)
    if active_mask is not None:
        bits = mask_bits or (structure.num_decode_targets if structure else 0)
        w.write_bits(active_mask, bits)
    if custom_dtis is not None:
        for dti in custom_dtis:
            w.write_bits(dti, 2)
    if custom_fdiffs is not None:
        for f in custom_fdiffs:
            if not 1 <= f <= 4096:
                # next_fdiff_size is 2 bits (1..3 nibbles): silently
                # truncating would misalign every later field.
                raise ValueError(f"custom fdiff {f} outside 1..4096")
            size = max(1, ((f - 1).bit_length() + 3) // 4)
            w.write_bits(size, 2)
            w.write_bits(f - 1, 4 * size)
        w.write_bits(0, 2)
    if custom_chain_fdiffs is not None:
        for cd in custom_chain_fdiffs:
            w.write_bits(cd, 8)
    return w.tobytes()
