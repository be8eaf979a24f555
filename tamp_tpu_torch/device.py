"""Device selection for the port's entry points.

The entry points run on the CUDA card.  ``device=None`` means ``"cuda"``
and raises when PyTorch sees no card; the CPU is used only when the caller
asks for it (``device="cpu"``), which is how the tests run the plain
versions of the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point: CUDA unless the CPU is asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tamp_tpu_torch needs a CUDA device (torch.cuda.is_available() "
            "is False); pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
