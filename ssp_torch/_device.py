"""Device resolution shared by the entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises for CUDA when no card is present
    rather than quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``.  A CPU tensor bound for a card goes through pinned
    memory and is copied without blocking: a copy from pageable memory makes
    the host wait for everything already queued on the stream, and the card
    then waits for the host to queue what comes next."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
