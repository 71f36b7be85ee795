"""Staging a tick, in ms over the untraced window: the drain (reorder,
dedup), the pack of the device inputs and the probe (the runtime's
`stage_s` and `probe_s` counters; host clock). None where the program has
no probe counter."""

from sfu_bench import runtime_layers


def read(rec):
    return runtime_layers.ms_per_tick(rec, "stage_s", "probe_s")
