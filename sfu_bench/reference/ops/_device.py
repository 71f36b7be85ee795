"""Device selection for the reference's ops: any torch device, no check."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cpu") -> torch.device:
    return torch.device(device)
