"""Device resolution shared by the port's entry points.

Entry points default to the card.  When no GPU is present and the caller
did not ask for the CPU they raise: the port never falls back to the CPU
quietly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a card raises.
    A bare ``"cuda"`` resolves to the current card's index, so devices
    compare equal to the ones tensors report."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

