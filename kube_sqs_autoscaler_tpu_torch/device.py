"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
Asking for CUDA on a machine without a usable card raises: the port never
drops to the CPU on its own, because a CPU run reported as a card run is
a wrong measurement, not a slower one.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a :class:`torch.device`; raises
    :class:`RuntimeError` when it names CUDA and no card is available."""
    resolved = torch.device(DEFAULT_DEVICE if device is None else device)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(resolved)!r} requested but torch.cuda.is_available() "
            "is False (no usable CUDA card); pass device='cpu' "
            "(--device cpu on the worker binary) to run on the CPU"
        )
    if resolved.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(resolved)!r}")
    return resolved
