"""What a run records for the metric readers, and the readers' shared
arithmetic.  A reader returns None where the run recorded nothing for it;
the harness then leaves that metric out of the result."""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from yardstick.trace import DeviceTrace
from yardstick.work import PEAK_BF16


@dataclass
class Request:
    submit: float  # host clock, s
    returned: float  # the program's call returned
    done: float  # results in host memory


@dataclass
class Records:
    cfg: Dict[str, Any] = field(default_factory=dict)  # the cell's configuration file
    mix: Dict[str, Any] = field(default_factory=dict)  # the cell's traffic mix file
    setup_s: float = 0.0
    window: Tuple[float, float] = (0.0, 0.0)  # host clock, s
    requests: List[Request] = field(default_factory=list)
    attempted: int = 0  # requests sent (or images given to the export)
    items_done: int = 0  # images of completed requests (or files written, steps' samples)
    trace: Optional[DeviceTrace] = None  # the device's operations (the metrics)
    host_trace: Optional[DeviceTrace] = None  # with the host's operators (the idle gaps' names)
    traced_items: int = 0  # items completed inside the device's traced window
    host_ms: List[float] = field(default_factory=list)  # the host's ms per unit, untraced


def rate(rec: Records) -> Optional[float]:
    """Items completed over the window's host seconds."""
    t0, t1 = rec.window
    return rec.items_done / (t1 - t0) if rec.items_done and t1 > t0 else None


def latency_ms(rec: Records, q: int) -> Optional[float]:
    """The q-th percentile (1..99) of the requests' submit-to-done ms."""
    lat = [(r.done - r.submit) * 1e3 for r in rec.requests]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=100)[q - 1]


def idle_share(rec: Records) -> Optional[float]:
    t = rec.trace
    return None if t is None else 100.0 * (1.0 - t.busy_s() / t.window_s)


def mfu(rec: Records, flops_per_item: float) -> Optional[float]:
    """Model FLOPs of the traced window's completed work over its length, as a
    share of the bf16 dense peak."""
    t = rec.trace
    if t is None or not rec.traced_items or not flops_per_item:
        return None
    return 100.0 * rec.traced_items * flops_per_item / t.window_s / PEAK_BF16


def host_ms(rec: Records) -> Optional[float]:
    return statistics.fmean(rec.host_ms) if rec.host_ms else None


def roofline(rec: Records, kernel: str, least_s: float, launches: int = 1) -> Optional[float]:
    """The kernel's least time for its launches in the traced window over their
    device time there: ``least_s`` for each unit of work (a request), which
    the kernel serves in ``launches`` launches."""
    if rec.trace is None:
        return None
    durations = rec.trace.kernels(kernel)
    if not durations:
        return None
    return 100.0 * least_s * len(durations) / launches / sum(durations)
