"""Device resolution that raises rather than falls back.

The port's entry points run on the card unless the caller asks for the CPU:
``None`` means ``"cuda"``.  Asking for ``cuda``, by name or by default, on a
machine without a usable GPU is an error, not a silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """``None`` (the card) / ``"cpu"`` / ``"cuda"`` / ``"cuda:N"`` /
    ``torch.device`` → ``torch.device``.  ``"cuda"`` without an index is the
    current card (``cuda:LOCAL_RANK`` in a process group).

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable or the
    index is out of range, and ``ValueError`` for any other device type.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device type {dev.type!r} (use 'cpu' or 'cuda')")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(dev)!r} requested but only "
            f"{torch.cuda.device_count()} CUDA device(s) exist"
        )
    return torch.device("cuda", index)
