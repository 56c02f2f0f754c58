"""One region of work captured as a CUDA graph and replayed: the port's
counterpart of the JAX package's single-program dispatches (the HA
``one_dispatch`` program, the trainer's ``lax.scan`` of
``steps_per_dispatch`` steps).

A graph replays the same launches on the same addresses.  So what the
region reads from the host goes through static device buffers that the host
refills before each replay, never through an upload inside the region:

* every input is a named tensor of a shape and type fixed at construction;
  all of them live in one device buffer, and the host's values are packed
  into one of a ring of :data:`SLOTS` pinned host slots and copied over in ONE
  ``copy_(non_blocking=True)`` before the replay.  Each slot has an event,
  so the host never rewrites a slot whose copy is still queued; inputs
  already on the card are copied into their place on the device;
* :meth:`CapturedRegion.eager` runs the region's function as it is, on a
  side stream (the warm-up calls, each a real call whose result counts);
  :meth:`CapturedRegion.capture` records it once on that stream, with the
  given device generators registered so that every replay draws fresh
  numbers, the ones an eager call would have drawn; :meth:`replay` launches
  the graph on the current stream and returns the static outputs, which the
  next replay overwrites.

Only a CUDA device has graphs: the region refuses any other.  A failure to
capture raises; nothing here falls back to running eagerly.  Whatever the
region's function uploads from the host during the capture raises too
(``ssp_torch._device.to_device``): its constants must be on the card before
(``ssp_torch._device.constant``, filled by the warm-up).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

WARMUP = 3  # eager calls before the capture (lazy initialisation, kernel builds)
# pinned host slots of the inputs: the host refills one while the card may
# still copy from the other, so it queues at most this many replays ahead
SLOTS = 2
_ALIGN = 16  # byte alignment of each input inside the packed buffers


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the port's kernel wrappers.  They count the
    Python calls that reach the card, so a replay adds nothing to them: the
    difference across a capture is the launches of every replay."""
    from ssp_torch.kernels import down1, nms, stem, vresample

    return {"stem": stem.launches, "down1": down1.launches, "nms": nms.launches,
            "vresample": vresample.launches, "vresample_coef": vresample.coef_launches}


class CapturedRegion:
    """``fn(inputs)`` on static inputs shaped like ``example``, run eagerly,
    captured once and replayed (module docstring).

    ``fn`` takes the dict of static input tensors and returns the outputs (any
    structure of tensors).  ``generators`` are the device generators ``fn``
    draws from besides the device's default one.  After :meth:`capture`,
    ``capture_s`` is the capture's host seconds, ``pool_bytes`` the device
    memory it reserved (the graph's private pool) and ``launches_per_replay``
    the kernel wrappers' launches that each replay makes; ``replays`` counts
    the replays.
    """

    def __init__(self, fn: Callable[[Dict[str, torch.Tensor]], Any],
                 example: Mapping[str, torch.Tensor], *, device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        self.fn = fn
        self.device = device
        self.generators = list(generators)
        self._spec = {k: (tuple(v.shape), v.dtype) for k, v in example.items()}
        offsets, total = {}, 0
        for k, (shape, dtype) in self._spec.items():
            offsets[k] = total
            nbytes = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
            total += -(-nbytes // _ALIGN) * _ALIGN
        self._buffer = torch.empty(max(total, _ALIGN), dtype=torch.uint8, device=device)
        self._slots = [torch.empty_like(self._buffer, device="cpu").pin_memory()
                       for _ in range(SLOTS)]
        self.inputs = self._views(self._buffer, offsets)
        self._slot_views = [self._views(s, offsets) for s in self._slots]
        self._copied: list = [None] * SLOTS
        self._next = 0
        self.stream = torch.cuda.Stream(device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.launches_per_replay: Dict[str, int] = {}
        self.replays = 0

    def _views(self, buf: torch.Tensor, offsets: Mapping[str, int]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, (shape, dtype) in self._spec.items():
            n = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
            out[k] = buf[offsets[k]:offsets[k] + n].view(dtype).view(shape)
        return out

    def load(self, inputs: Mapping[str, torch.Tensor]) -> None:
        """Copy ``inputs`` (the example's names, shapes and types) into the
        static input buffers, queued on the current stream: the host tensors
        through the next pinned slot in one copy, the card's directly."""
        if set(inputs) != set(self._spec):
            raise ValueError(f"inputs {sorted(inputs)} are not the region's {sorted(self._spec)}")
        for k, v in inputs.items():
            if (tuple(v.shape), v.dtype) != self._spec[k]:
                raise ValueError(f"input {k!r}: {tuple(v.shape)} {v.dtype}, the region takes "
                                 f"{self._spec[k][0]} {self._spec[k][1]}")
        s = self._next
        self._next = (s + 1) % len(self._slots)
        on_host = [k for k, v in inputs.items() if v.device.type == "cpu"]
        if on_host:
            if self._copied[s] is not None:
                self._copied[s].synchronize()  # the slot's last copy has left it
            for k in on_host:
                self._slot_views[s][k].copy_(inputs[k])
            self._buffer.copy_(self._slots[s], non_blocking=True)
            self._copied[s] = torch.cuda.Event()
            self._copied[s].record()
        for k, v in inputs.items():
            if v.device.type != "cpu":
                self.inputs[k].copy_(v)

    def eager(self) -> Any:
        """``fn`` on the static inputs, run as it is on the side stream that
        the capture uses (a warm-up call; a real one: its result is
        returned)."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self.fn(self.inputs)
        cur.wait_stream(self.stream)
        return out

    def capture(self) -> None:
        """Record ``fn`` on the static inputs as the graph.  Nothing runs."""
        if self.graph is not None:
            raise RuntimeError("the region is captured already")
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = kernel_launches()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as the capture does first: what is left is in use
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.graph(graph, stream=self.stream):
            out = self.fn(self.inputs)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launches_per_replay = {k: v - before[k] for k, v in kernel_launches().items()}
        self.graph, self.outputs = graph, out

    def replay(self) -> Any:
        """Launch the graph on the current stream (after the inputs' last
        :meth:`load`); returns the static outputs."""
        if self.graph is None:
            raise RuntimeError("capture the region before replaying it")
        self.graph.replay()
        self.replays += 1
        return self.outputs

    def __call__(self, inputs: Mapping[str, torch.Tensor]) -> Any:
        """Load ``inputs`` and replay, after :data:`WARMUP` eager calls and the
        capture on the first call.  For a pure function of its inputs."""
        self.load(inputs)
        if self.graph is None:
            for _ in range(WARMUP):
                self.eager()
            self.capture()
        return self.replay()
