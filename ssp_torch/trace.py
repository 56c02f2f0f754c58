"""Spans: the port's layers timed where they run, switched by the profiler.

    with span("ssp.detect.upload", device=dev) as s:
        ...
        if s is not None:
            s.counts["pageable_bytes"] = n

A span is off unless a ``torch.profiler`` session is running (the
profiler's own flag, as the calling thread sees it, whatever activities the
session records).  Off, :func:`span`
returns one shared no-op context, which enters to ``None``: it enters no
profiler range, records no event and keeps nothing.  There is no other
switch.  Whoever profiles the program sees its spans: the benchmark's
traced windows, the trainer's ``profile:`` option, any other session.

On, a span

* enters ``torch.profiler.record_function(name)``, so it lies in the
  profiler's own trace on the clock of the operations it launched (the
  profiler's Chrome trace is the export);
* keeps one :class:`Span` in a ring of the newest :data:`RING`: its name,
  its id, the id of its root (one request: every span under one root
  shares it), its parent's id (a stack per thread), its start and end on
  ``time.perf_counter_ns()`` and its counts;
* given a CUDA ``device``, and unless the current stream is capturing a
  graph, records a pair of timing events on the current stream around its
  work.  :func:`spans` resolves them, after the caller's ``synchronize``,
  into the span's device interval on the same ``perf_counter_ns`` clock,
  through an anchor event recorded right after a ``synchronize`` the first
  time a session opens a span on that device.  A session, as the spans see
  it, ends when a span finds the profiler off or :func:`clear` runs.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

RING = 1 << 14  # spans kept, the newest

_enabled = torch._C._autograd._profiler_enabled  # the profiler's own flag
_OFF = nullcontext()
_ring: "collections.deque[Span]" = collections.deque()
_lock = threading.Lock()  # the ring and the event pool
_pool: List[torch.cuda.Event] = []  # timing events of resolved or dropped spans
_anchors: Dict[int, Tuple[torch.cuda.Event, int]] = {}  # device index -> (event, host ns)
_ids = itertools.count(1)
_local = threading.local()


@dataclass
class Span:
    name: str
    id: int
    request: int  # the root's id
    parent: Optional[int]
    start_ns: int  # time.perf_counter_ns()
    end_ns: Optional[int] = None  # None while open
    counts: Dict[str, int] = field(default_factory=dict)
    device_ns: Optional[Tuple[int, int]] = None  # resolved by spans(), perf_counter ns
    events: Optional[list] = None  # [anchor (event, host ns), start, end] until resolved


def _event() -> torch.cuda.Event:
    with _lock:
        if _pool:
            return _pool.pop()
    return torch.cuda.Event(enable_timing=True)


def _anchor(device: torch.device) -> Tuple[torch.cuda.Event, int]:
    index = device.index if device.index is not None else torch.cuda.current_device()
    a = _anchors.get(index)
    if a is None:
        torch.cuda.synchronize(device)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        a = _anchors[index] = (ev, time.perf_counter_ns())
    return a


class _Live:
    __slots__ = ("span", "device", "range", "stack", "stream")

    def __init__(self, name: str, device: Optional[torch.device], counts: Dict[str, int]):
        self.span = Span(name, 0, 0, None, 0, counts=counts)
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self) -> Span:
        s = self.span
        stack = self.stack = _local.__dict__.setdefault("stack", [])
        s.id = next(_ids)
        s.request, s.parent = (stack[-1].request, stack[-1].id) if stack else (s.id, None)
        s.start_ns = time.perf_counter_ns()
        self.range = torch.profiler.record_function(s.name)
        self.range.__enter__()
        if self.device is not None and not torch.cuda.is_current_stream_capturing():
            anchor = _anchor(self.device)
            self.stream = torch.cuda.current_stream(self.device)
            start = _event()
            start.record(self.stream)
            s.events = [anchor, start, None]
        stack.append(s)
        with _lock:
            if len(_ring) >= RING:
                old = _ring.popleft()
                if old.events is not None and old.end_ns is not None:
                    _pool.extend(old.events[1:])
            _ring.append(s)
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        if s.events is not None:
            end = _event()
            end.record(self.stream)
            s.events[2] = end
        self.stack.pop()
        self.range.__exit__(*exc)
        s.end_ns = time.perf_counter_ns()


def span(name: str, device: Optional[torch.device] = None, **counts: int):
    """A context over one layer's work, off unless the profiler runs (module
    docstring).  ``device``: where the work runs (a CUDA device adds its
    device interval); ``counts``: numbers the span carries, which the live
    span's ``counts`` may add to inside."""
    if not _enabled():
        if _anchors:
            _anchors.clear()
        return _OFF
    return _Live(name, device, counts)


def spans() -> List[Span]:
    """The ring's finished spans, oldest first, their device intervals
    resolved (waiting for the events' work where it is still queued)."""
    with _lock:
        done = [s for s in _ring if s.end_ns is not None]
    for s in done:
        if s.events is None:
            continue
        (anchor, host_ns), start, end = s.events
        end.synchronize()
        s.device_ns = (host_ns + round(anchor.elapsed_time(start) * 1e6),
                       host_ns + round(anchor.elapsed_time(end) * 1e6))
        s.events = None
        with _lock:
            _pool.extend((start, end))
    return done


def clear() -> None:
    """Empty the ring; the next span on a card takes a new anchor."""
    with _lock:
        for s in _ring:
            if s.events is not None and s.end_ns is not None:
                _pool.extend(s.events[1:])
        _ring.clear()
        _anchors.clear()
