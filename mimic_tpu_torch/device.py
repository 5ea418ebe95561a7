"""Device resolution that raises rather than falls back.

Every entry point of the port takes its device explicitly; nothing guesses
one.  Asking for ``cuda`` on a machine without a usable GPU is an error, not a
silent move to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``"cpu"`` / ``"cuda"`` / ``"cuda:N"`` / ``torch.device`` → ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable or the
    index is out of range, and ``ValueError`` for any other device type.
    """
    if device is None:
        raise ValueError("a device must be given explicitly ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r} (use 'cpu' or 'cuda')")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(dev)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist"
        )
    return torch.device("cuda", index)
