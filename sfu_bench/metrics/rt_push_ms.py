"""The ingest push a tick, in ms over the untraced window:
`IngestBuffer.push_batch` of the tick's receive batch (the runtime's
`push_s` counter; host clock). None where the program has no such counter."""

from sfu_bench import runtime_layers


def read(rec):
    return runtime_layers.ms_per_tick(rec, "push_s")
