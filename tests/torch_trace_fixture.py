"""A tick's stage rows for the port's trace ring (runtime/trace.py
`TickTraceRing.record_tick`), built from named stages, for the trace
tests (tests/test_torch_trace_export.py, tests/test_torch_trace_blocks.py).
"""

from __future__ import annotations

import numpy as np

from livekit_server_tpu_torch.utils.spans import STAGES


def stage_rows(**stages: tuple[float, float]) -> tuple[np.ndarray, np.ndarray]:
    """(t0, dur): each stage's start and duration (perf_counter s) in
    `STAGES` order, from `name=(start, duration)` pairs; 0 for the rest."""
    t0, dur = np.zeros(len(STAGES)), np.zeros(len(STAGES))
    for name, (s0, ds) in stages.items():
        t0[STAGES.index(name)], dur[STAGES.index(name)] = s0, ds
    return t0, dur
