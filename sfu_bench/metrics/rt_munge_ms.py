"""The munge walk a tick, in ms over the untraced window:
`HostMunger.apply_columns`, the native walker of native/csrc/munge.cpp over
the egress plane's room shards (the runtime's `munge_s` counter; host
clock). None where the program has no such counter."""

from sfu_bench import runtime_layers


def read(rec):
    return runtime_layers.ms_per_tick(rec, "munge_s")
