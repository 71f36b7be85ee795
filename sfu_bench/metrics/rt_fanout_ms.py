"""The fan-out outside the munge walk a tick, in ms over the untraced
window: the `EgressBatch`, the speaker, keyframe, congestion and quality
views, the replay ring and probe padding (the runtime's `fanout_s` less
its `munge_s`; host clock). None where the program has no munge counter."""

from sfu_bench import runtime_layers


def read(rec):
    return runtime_layers.ms_per_tick(rec, "fanout_s", minus="munge_s")
