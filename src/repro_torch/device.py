"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``.

    A CUDA device that is not there raises ``RuntimeError``: the port never
    drops to the CPU unless the caller asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work, so a host clock read after it times the
    work and not its launch."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
