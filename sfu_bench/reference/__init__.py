"""The benchmark's plain reference of the SFU node's tick.

Plain PyTorch and numpy, frozen from the port's plain forms into the
benchmark's own folder: the tick (`tick.py` over `ops/`) and its inputs'
conversion (`node.py`). Nothing here imports `jax`, the JAX package or
the port (`livekit_server_tpu_torch`): the benchmark's tests check it.
`control.py` is the same reference in a lower precision, the control that
has to come out as not correct.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plain_mode():
    """TF32 off for matmuls and convolutions while the reference runs
    (the tick has none today; the switch keeps it so if one appears)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
