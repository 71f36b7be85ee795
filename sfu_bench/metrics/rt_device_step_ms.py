"""The device step a tick, in ms over the untraced window: the ctrl upload
and `_device_step` (one upload of the packed inputs, the tick of
models/plane.py, one fetch of the outputs; the runtime's `ctrl_upload_s`
and `device_s` counters; host clock)."""

from sfu_bench import runtime_layers


def read(rec):
    return runtime_layers.ms_per_tick(rec, "ctrl_upload_s", "device_s")
