"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. "cuda" (the default of
    every entry point) raises when no card is visible: the port never
    falls back to the CPU on its own — callers that want the CPU path
    (tests, parity checks) ask for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
