"""Device resolution shared by the entry points, host-to-device copies and
the constants kept on each device."""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple, Union

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


# a staged chunk's most bytes, unless one frame is larger.  On the H100's
# host the host's copy into the ring and the card's read of it share the
# host's memory bandwidth, so a split overlaps little and each chunk costs
# the host ~0.1-0.2 ms: 16x480x640 (19.66 MB) uploads fastest whole,
# 64x480x640 in two (python -m ssp_torch.bench_upload)
CHUNK_BYTES = 40 << 20


def chunk_plan(frames: int, frame_bytes: int) -> List[Tuple[int, int]]:
    """The ``(start, stop)`` frame ranges of a staged upload, in order, each
    frame once: as few chunks as keep each near :data:`CHUNK_BYTES`, their
    frame counts differing by one at most."""
    n = max(1, min(frames, -(-frames * frame_bytes // CHUNK_BYTES)))
    edges = [frames * i // n for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


class StagingRing:
    """Page-locked host memory, kept and reused, through which host frames
    reach a card without a copy from pageable memory.

    :meth:`upload` copies the frames on the host into the ring one chunk of
    whole frames at a time (``Tensor.copy_``: the intra-op pool, and the
    cast to float32 that ``torch.as_tensor(src, dtype=torch.float32)``
    makes) and queues each chunk's copy to the card on the current stream
    without blocking, so the copy engine moves a chunk while the host copies
    the next, and the caller queues its next work without a sync.  The call
    returns once every byte is in the ring: the caller may change its frames
    then.  A region of the ring is
    written again only after the copy that read it has ended (an event
    recorded after it; a wait counts in ``slot_waits``), so calls queued
    without a sync keep their own frames.

    The ring is allocated at the first upload and grows only for a larger
    one.  It is freed with its owner; PyTorch's pinned allocator keeps the
    memory from reuse until the copies queued from it have ended.  A lock
    lets one upload use the ring at a time.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._host = torch.empty(0)
        self._copied: List[Tuple[int, int, torch.cuda.Event]] = []  # (lo, hi) elements, event
        self._events: List[torch.cuda.Event] = []  # ended, to record again
        self._lock = threading.Lock()

    def _reuse(self, lo: int, hi: int) -> int:
        """Wait until no queued copy reads elements ``[lo, hi)``; how many
        waits that took."""
        waits, keep = 0, []
        for a, b, event in self._copied:
            if a < hi and lo < b:
                if not event.query():
                    event.synchronize()
                    waits += 1
                self._events.append(event)
            else:
                keep.append((a, b, event))
        self._copied = keep
        return waits

    def upload(self, src: torch.Tensor, plan: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, int]:
        """``(src as float32 on the device, slot waits)``: ``src`` [F, ...]
        on the host, its frames staged in ``plan``'s chunks."""
        n = src.numel()
        out = torch.empty(src.shape, dtype=torch.float32, device=self.device)
        stream = torch.cuda.current_stream(self.device)
        per = n // max(1, src.shape[0])
        waits = 0
        with self._lock:
            if self._host.numel() < n:
                self._host = torch.empty(n, dtype=torch.float32, pin_memory=True)
                self._copied = []
            stage = self._host[:n].view(src.shape)
            for a, b in plan:
                waits += self._reuse(a * per, b * per)
                stage[a:b].copy_(src[a:b])
                out[a:b].copy_(stage[a:b], non_blocking=True)
                event = self._events.pop() if self._events else torch.cuda.Event()
                event.record(stream)
                self._copied.append((a * per, b * per, event))
        return out, waits


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
