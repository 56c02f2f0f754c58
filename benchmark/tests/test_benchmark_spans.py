"""The readers of the program's spans count what they should from synthetic
records: the spans of the device-traced requests alone, their means, and the
idle time under the upload's annotation; None where they find nothing."""

from __future__ import annotations

import pytest

import run as bench_run
from conftest import bench

NEW = ["upload_ms.detect", "pageable_mb.detect", "forward_device_ms.detect",
       "postprocess_device_ms.detect", "idle_upload_share.detect"]
MS = 1_000_000  # ns


def _metrics():
    return [m for m in bench()["per_layer"] if m["name"] in NEW]


def _request_spans(trace, first_id, t0, upload_ms, forward_ms, post_ms, nbytes):
    """The four spans of one request whose root starts at ``t0`` ns."""
    root = first_id
    up = trace.Span("ssp.detect.upload", root + 1, root, root, t0 + MS,
                    t0 + MS + int(upload_ms * MS), {"pageable_bytes": nbytes},
                    device_ns=(t0 + MS, t0 + MS + int(upload_ms * MS)))
    fw = trace.Span("ssp.detect.forward", root + 2, root, root, t0 + 2 * MS, t0 + 3 * MS,
                    device_ns=(t0 + 2 * MS, t0 + 2 * MS + int(forward_ms * MS)))
    pp = trace.Span("ssp.detect.postprocess", root + 3, root, root, t0 + 3 * MS, t0 + 4 * MS,
                    device_ns=(t0 + 3 * MS, t0 + 3 * MS + int(post_ms * MS)))
    top = trace.Span("ssp.detect", root, root, None, t0, t0 + 5 * MS)
    return [top, up, fw, pp]


def test_span_readers_take_the_traced_requests(monkeypatch):
    from ssp_torch import trace
    from yardstick.records import Records, Request

    B = 16
    # 2 untraced requests, 3 device-traced ones (10 ms apart from t = 1 s),
    # then 1 request of the host-traced window
    reqs = [Request(0.5 + 0.01 * i, 0.5 + 0.01 * i + 0.005, 0.5 + 0.01 * i + 0.008)
            for i in range(2)]
    reqs += [Request(1.0 + 0.01 * i, 1.0 + 0.01 * i + 0.005, 1.0 + 0.01 * i + 0.008)
             for i in range(3)]
    reqs.append(Request(2.0, 2.005, 2.008))
    rec = Records(mix={"batch": B}, requests=reqs, attempted=2, traced_items=3 * B)
    found = []
    for i, (up, fw, pp, nb) in enumerate([(3.0, 4.0, 0.5, 100), (4.0, 5.0, 1.0, 200),
                                          (5.0, 6.0, 1.5, 300)]):
        t0 = int((1.0 + 0.01 * i) * 1e9) + 10_000
        found += _request_spans(trace, 100 + 10 * i, t0, up, fw, pp, nb)
    # outside the traced requests: the untraced window's and the host window's
    found += _request_spans(trace, 10, int(0.5 * 1e9) + 10_000, 50.0, 50.0, 50.0, 9999)
    found += _request_spans(trace, 900, int(2.0 * 1e9) + 10_000, 50.0, 50.0, 50.0, 9999)
    monkeypatch.setattr(trace, "spans", lambda: found)

    got = bench_run.read_metrics(_metrics(), rec)
    assert got["upload_ms.detect"]["value"] == pytest.approx(4.0)
    assert got["pageable_mb.detect"]["value"] == pytest.approx(200 / 1e6)
    assert got["forward_device_ms.detect"]["value"] == pytest.approx(5.0)
    assert got["postprocess_device_ms.detect"]["value"] == pytest.approx(1.0)
    assert "idle_upload_share.detect" not in got  # no host trace
    assert {got[m]["unit"] for m in got} == {"ms", "MB"}

    # no span found: every span reader returns nothing
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert bench_run.read_metrics(_metrics(), rec) == {}
    # spans, but no device-traced request (an untraced run)
    monkeypatch.setattr(trace, "spans", lambda: found)
    assert bench_run.read_metrics(_metrics(), Records(mix={"batch": B}, requests=reqs,
                                                      attempted=6)) == {}


def test_idle_upload_share_counts_idle_under_the_annotation():
    from yardstick.records import Records
    from yardstick.trace import DeviceTrace

    # a 10 ms window: the device busy 0-2, 3-6 and 8-9 ms; idle 2-3, 6-8, 9-10
    dev = [("k", 0.0, 0.002), ("k", 0.003, 0.003), ("Memcpy HtoD", 0.008, 0.001)]
    host = [("ssp.detect.upload", 0.0015, 0.001),   # idle 2-2.5 ms under it
            ("ssp.detect.upload", 0.0055, 0.002),   # idle 6-7.5 ms
            ("ssp.detect.upload", 0.0065, 0.0005),  # inside the one before: not twice
            ("ssp.detect.forward", 0.009, 0.001),   # another span's idle: not counted
            ("cudaMemcpyAsync", 0.0, 0.01)]
    rec = Records(host_trace=DeviceTrace(0.0, 0.01, dev, host))
    metric = [m for m in _metrics() if m["name"] == "idle_upload_share.detect"]
    got = bench_run.read_metrics(metric, rec)
    assert got["idle_upload_share.detect"]["value"] == pytest.approx(100 * 0.002 / 0.01)
    assert got["idle_upload_share.detect"]["unit"] == "%"
    # a host trace without the program's upload annotation (a program without spans)
    rec = Records(host_trace=DeviceTrace(0.0, 0.01, dev, host[-2:]))
    assert bench_run.read_metrics(metric, rec) == {}
    assert bench_run.read_metrics(metric, Records()) == {}


def test_span_readers_are_none_without_the_programs_spans(monkeypatch):
    import sys

    from yardstick.records import Records, Request

    import ssp_torch

    # a program without ssp_torch.trace (an import of it fails)
    monkeypatch.delattr(ssp_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "ssp_torch.trace", None)
    rec = Records(mix={"batch": 1}, requests=[Request(1.0, 1.1, 1.2)], traced_items=1)
    assert bench_run.read_metrics(_metrics(), rec) == {}
