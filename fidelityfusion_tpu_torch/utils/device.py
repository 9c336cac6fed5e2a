"""Device resolution for the port's entry points."""

from __future__ import annotations

import time

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Raises when CUDA is requested on a machine without it: the port never
    moves a run to the CPU on its own (pass ``device="cpu"`` for that).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def synced_time(device: torch.device) -> float:
    """``time.time()`` after the device's queued work has finished (a CUDA
    synchronize; nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()
