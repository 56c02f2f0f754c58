"""Device resolution shared by the entry points, host-to-device copies and
the constants kept on each device."""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device(device)``; raises for CUDA when no card is present
    rather than quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``.  A CPU tensor bound for a card goes through pinned
    memory and is copied without blocking: a copy from pageable memory makes
    the host wait for everything already queued on the stream, and the card
    then waits for the host to queue what comes next.

    Inside a CUDA graph's capture such a copy would read a temporary host
    buffer on every replay after it is gone, so it raises there: a captured
    region takes its host data through ``ssp_torch.graphs`` and its constants
    through :func:`constant`."""
    if device.type == "cuda" and t.device.type == "cpu":
        if _capturing(device):
            raise RuntimeError("a host tensor copied to the card inside a CUDA graph's capture")
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def constant(value: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The small host tensor ``value`` on ``device``, copied once per value and
    device and then shared: callers must not write to it.  Keyed by the
    value's type, shape and bytes, so a captured region finds there what its
    eager warm-up put there and uploads nothing."""
    if device.type == "cpu":
        return value
    value = value.contiguous()
    key = (str(device), value.dtype, tuple(value.shape), value.numpy().tobytes())
    hit = _CONSTANTS.get(key)
    if hit is None:
        hit = _CONSTANTS[key] = to_device(value, device)
    return hit
