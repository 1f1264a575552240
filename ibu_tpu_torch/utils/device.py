"""Device selection.

The JAX package pins its platform through the environment
(:mod:`ibu_tpu.utils.platform`); here every device entry point takes an
explicit ``device`` argument and resolves it with :func:`resolve_device`.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → the current CUDA card if there is one, else the CPU. An
    explicit CUDA device raises when no card is available, rather than
    running somewhere else."""
    if device is None:
        return (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available()
            else torch.device("cpu")
        )
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA card is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; expected cpu or cuda")
    return device
