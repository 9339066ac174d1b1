"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` means the card. Asking for CUDA where none is found raises:
    nothing falls back to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
