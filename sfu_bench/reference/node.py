"""The reference's inputs: a tick's numpy TickInputs as the tensors the
plain tick takes."""

from __future__ import annotations

import numpy as np
import torch

from . import tick


def inputs_to_torch(inp: tick.TickInputs, device="cpu") -> tick.TickInputs:
    """Numpy TickInputs → tensors of the tick's dtypes: int32 for integer
    fields, bool for flags, float32 for the rest."""
    def conv(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return torch.from_numpy(x.copy()).to(device)
        if x.dtype.kind in "iu":
            return torch.from_numpy(x.astype(np.int32)).to(device)
        return torch.from_numpy(x.astype(np.float32)).to(device)
    return tick.TickInputs(*[conv(x) for x in inp])
