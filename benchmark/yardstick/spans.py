"""The program's own spans (``ssp_torch.trace``) for the metric readers.

The spans are kept by the program in its ring while a profiler runs, so a
traced run holds those of its device-traced requests.  A reader takes the
spans whose root started between the first traced request's submission and
the last one's results; every function returns None where it finds none (a
program without spans among them)."""

from __future__ import annotations

from typing import List, Optional

from yardstick.records import Records
from yardstick.trace import DeviceTrace


def of_traced_requests(rec: Records) -> List:
    """The spans of the device-traced requests (every span under a root that
    started inside them)."""
    try:
        from ssp_torch import trace
    except ImportError:  # a program without spans
        return []
    n = rec.traced_items // rec.mix["batch"] if rec.mix.get("batch") else 0
    reqs = rec.requests[rec.attempted:rec.attempted + n]
    if not reqs:
        return []
    lo, hi = reqs[0].submit * 1e9, reqs[-1].done * 1e9
    found = trace.spans()
    roots = {s.id for s in found if s.parent is None and lo <= s.start_ns <= hi}
    return [s for s in found if s.request in roots]


def mean_host_ms(spans: List, name: str) -> Optional[float]:
    ms = [(s.end_ns - s.start_ns) * 1e-6 for s in spans if s.name == name]
    return sum(ms) / len(ms) if ms else None


def mean_device_ms(spans: List, name: str) -> Optional[float]:
    ms = [(s.device_ns[1] - s.device_ns[0]) * 1e-6 for s in spans
          if s.name == name and s.device_ns is not None]
    return sum(ms) / len(ms) if ms else None


def mean_count(spans: List, name: str, count: str) -> Optional[float]:
    n = [s.counts.get(count, 0) for s in spans if s.name == name]
    return sum(n) / len(n) if n else None


def idle_share_inside(t: Optional[DeviceTrace], annotation: str) -> Optional[float]:
    """Share (%) of the trace's window in which the device is idle while the
    host is inside an ``annotation`` range (its ``user_annotation`` events,
    on the trace's clock)."""
    if t is None:
        return None
    inside = sorted((max(s, t.start), min(s + d, t.end)) for n, s, d in t.host_ops
                    if n == annotation)
    if not inside:
        return None
    busy = t.busy_intervals()
    edges = [t.start] + [x for ab in busy for x in ab] + [t.end]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    total, last = 0.0, t.start  # `last`: where the merged ranges so far end
    for a, b in inside:
        a = max(a, last)
        if b <= a:
            continue
        total += sum(max(0.0, min(b, y) - max(a, x)) for x, y in idle)
        last = b
    return 100.0 * total / t.window_s
