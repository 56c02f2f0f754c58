"""The staged upload's pure part (``ssp_torch._device``), on the CPU.

* :func:`chunk_plan` covers every frame exactly once, in order, in as few
  chunks of whole frames as keep them near :data:`CHUNK_BYTES`, for batches
  of 1, 2, 15 and 16 at the three frame sizes the detect path's callers send
  (HPatches 240×320, KITTI 384×1248, the main path 480×640), and a batch
  larger than a chunk.
* :class:`StagingRing` rewrites a region only once the copies that read it
  have ended: it waits on each overlapping copy still in flight, counts
  those waits, and keeps the copies of regions it does not touch.

The ring's copies to the card are held bit for bit in
``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from ssp_torch._device import CHUNK_BYTES, StagingRing, chunk_plan


@pytest.mark.parametrize("hw", [(240, 320), (384, 1248), (480, 640)])
@pytest.mark.parametrize("frames", [1, 2, 15, 16, 64])
def test_chunk_plan_covers_every_frame_once_in_order(frames, hw):
    frame_bytes = hw[0] * hw[1] * 4
    plan = chunk_plan(frames, frame_bytes)
    assert [i for a, b in plan for i in range(a, b)] == list(range(frames))
    sizes = [b - a for a, b in plan]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert len(plan) == -(-frames * frame_bytes // CHUNK_BYTES)


class _Copy:
    """A stand-in for the CUDA event recorded after a region's copy."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


def test_ring_waits_only_on_overlapping_copies_in_flight():
    ring = StagingRing(torch.device("cpu"))
    ended, flying, elsewhere, later = _Copy(True), _Copy(False), _Copy(False), _Copy(False)
    ring._copied = [(0, 100, ended), (100, 200, flying), (300, 400, elsewhere), (150, 250, later)]
    assert ring._reuse(50, 160) == 2
    assert flying.waited and later.waited and not ended.waited and not elsewhere.waited
    assert ring._copied == [(300, 400, elsewhere)]
    assert ring._events == [ended, flying, later]  # ended: recorded again by the next copies
    assert ring._reuse(0, 300) == 0 and ring._copied == [(300, 400, elsewhere)]
    assert ring._reuse(399, 400) == 1 and ring._copied == []
