"""Device selection.

The JAX package pins its platform through the environment
(:mod:`ibu_tpu.utils.platform`); here every device entry point takes an
explicit ``device`` argument and resolves it with :func:`resolve_device`.
The port runs on a CUDA card; the CPU, where the plain torch versions stand
in for the kernels, is taken only when asked for by name.
"""

from __future__ import annotations

import torch

NO_CARD = ('no CUDA card is available (torch.cuda.is_available() is false); '
           'pass device="cpu" to run the plain torch versions on the CPU')


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA card; ``"cuda:i"`` → card
    ``i``; ``"cpu"`` → the CPU. A CUDA device, ``None`` included, raises
    ``RuntimeError`` when no card is available, rather than running
    somewhere else."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but {NO_CARD}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; expected cpu or cuda")
    return device


def select_device(arg: str | None, prog: str) -> torch.device | None:
    """A command's ``--device``: the CUDA card, or the CPU only when asked
    for by ``--device cpu``. ``None`` (after a message) when there is no card
    and the CPU was not asked for."""
    if arg is None and not torch.cuda.is_available():
        print(f"{prog}: no CUDA card (torch.cuda.is_available() is false); "
              "pass --device cpu to run the plain torch versions on the CPU", flush=True)
        return None
    try:
        return resolve_device(arg)
    except RuntimeError as err:
        print(f"{prog}: {err}", flush=True)
        return None
