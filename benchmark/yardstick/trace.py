"""The device trace of a traced window: ``torch.profiler`` (CUPTI) over the
window, its Chrome trace read back into plain intervals.

The metrics' trace records the device alone (``ProfilerActivity.CUDA``):
recording the host's operators too costs the host several microseconds an
operator, which opens idle gaps on the card that an untraced run does not
have.  Its window runs from the first device operation's start to the last
one's end (the window starts and ends with a ``synchronize``, so every
operation it queued runs inside; the idle time before the first launch, a few
microseconds, is not counted).  A second, shorter trace with the host's
operators (:func:`traced` with ``host=True``, window marked by the
annotation :data:`WINDOW`) names the idle gaps by what the host was doing.
Busy time is the union of the kernel, copy and memset intervals inside the
window.  A trace that holds no device record at all is taken again
(``torch.profiler`` has been seen to lose a whole trace in a fresh process),
up to :data:`ATTEMPTS` times.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "benchmark.window"
ATTEMPTS = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAMED_GAPS = 500  # the longest idle gaps, each named by the host's operation


@dataclass
class DeviceTrace:
    """Intervals in seconds, on the trace's clock."""

    start: float
    end: float
    device_ops: List[Tuple[str, float, float]]  # (name, start, duration), kernels and copies
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernels(self, kernel: str) -> List[float]:
        """Durations of the launches of the kernel function named ``kernel``
        (the trace's names are demangled signatures, ``void k<true>(...)``)."""
        pat = re.compile(rf"(^|[\s:]){re.escape(kernel)}[<(]")
        return [d for n, _, d in self.device_ops if pat.search(n)]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((max(s, self.start), min(s + d, self.end)) for _, s, d in self.device_ops)
        merged: List[Tuple[float, float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def top_device_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for name, _, d in self.device_ops:
            tot[name[:120]] += d
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time summed by what the host was doing as each gap opened:
        the shortest host operation that spans the gap's start."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host_ops, key=lambda o: o[1])
        starts = [s for _, s, _ in host]
        tot: Dict[str, float] = defaultdict(float)
        gaps.sort(key=lambda ab: ab[0] - ab[1])
        named, rest = gaps[:NAMED_GAPS], gaps[NAMED_GAPS:]
        if rest:
            tot[f"gaps shorter than {(rest[0][1] - rest[0][0]) * 1e6:.1f} us"] = sum(
                b - a for a, b in rest)
        for a, b in named:
            i = bisect.bisect_right(starts, a)
            best = None
            for name, s, d in host[max(0, i - 2000):i]:
                if s <= a < s + d and name != WINDOW and (best is None or d < best[1]):
                    best = (name, d)
            tot[best[0][:120] if best else "no host operation"] += b - a
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _read(path: str, host_ops: bool) -> Optional[DeviceTrace]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    if host_ops:
        window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
                  and e.get("cat") in ("user_annotation", "cpu_op")]
        if not window:
            return None
        start, end = window[0]["ts"] * 1e-6, (window[0]["ts"] + window[0]["dur"]) * 1e-6
    else:
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS and "dur" in e]
        if not spans:
            return None
        start, end = min(a for a, _ in spans) * 1e-6, max(b for _, b in spans) * 1e-6
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        rec = (e["name"], e["ts"] * 1e-6, e["dur"] * 1e-6)
        if cat in DEVICE_CATS:
            if rec[1] < end and rec[1] + rec[2] > start:
                dev.append(rec)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"):
            host.append(rec)
    if not dev:
        return None
    return DeviceTrace(start, end, dev, host)


def traced(run: Callable[[], object], host: bool = False) -> Tuple[object, DeviceTrace]:
    """``run()`` under the profiler (the device's operations, and with ``host``
    the host's operators inside the window annotation); its result and the
    window's trace.  Raises when every attempt comes back without a device
    record."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for _ in range(ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                result = run()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = _read(path, host)
        finally:
            os.unlink(path)
        if trace is not None:
            return result, trace
    raise RuntimeError(f"the profiler recorded no device operation in {ATTEMPTS} traces")
