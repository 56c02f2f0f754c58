"""The port's spans (``ssp_torch.trace``) on the CPU.

* With no profiler running, a detect call keeps no span and enters no
  ``record_function``: ``span`` hands back one shared no-op context.
* Under a CPU ``torch.profiler`` session one call of
  ``make_detect_describe_fn`` keeps its four spans in order, under one
  request id, each child's parent the root; the upload counts the batch's
  bytes as pageable; each span is in the profiler's Chrome trace as a
  ``user_annotation`` of the same length.
* The ring keeps the newest :data:`ssp_torch.trace.RING` spans.
* A CPU trainer run with ``profile: {enable: true}`` writes a trace holding
  ``ssp.train.dispatch``, its children under it.

The four tests take about 3 s of calls together on one CPU thread.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssp_torch import trace
from ssp_torch.export import descriptors_export as dd
from ssp_torch.models.fast_infer import best_apply_fn
from ssp_torch.models.superpoint import build_model
from ssp_torch.train.trainer import TrainAgent
from ssp_torch.utils.experiment import ExperimentPaths
from test_torch_threads import _one_thread  # noqa: F401  (autouse)

B, H, W = 2, 32, 48
DETECT = ["ssp.detect", "ssp.detect.upload", "ssp.detect.forward", "ssp.detect.postprocess"]


@pytest.fixture
def detect():
    model = build_model("SuperPointNet_gauss2", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    fn = dd.make_detect_describe_fn(best_apply_fn(model, input_hw=(H, W), device="cpu"),
                                    device="cpu", top_k=20)
    images = np.random.default_rng(0).uniform(size=(B, H, W)).astype(np.float32)
    return fn, images


@pytest.fixture
def ranges(monkeypatch):
    """The names ``torch.profiler.record_function`` is entered with."""
    names, real = [], torch.profiler.record_function

    def counted(name, *args):
        names.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return names


def test_no_profiler_no_span(detect, ranges, monkeypatch):
    fn, images = detect
    trace.clear()
    monkeypatch.setattr(torch.cuda, "Event", None)  # an event would raise
    fn(images)
    assert trace.spans() == [] and ranges == []
    assert trace.span("a") is trace.span("b", device=torch.device("cpu"), n=1)
    with trace.span("a") as s:
        assert s is None
    assert trace.spans() == [] and ranges == []


def test_detect_spans_under_a_cpu_profiler(detect, ranges, tmp_path):
    fn, images = detect
    with profile(activities=[ProfilerActivity.CPU]):  # the profiler's first use
        fn(images)
    trace.clear()
    del ranges[:]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(images)
    got = trace.spans()
    assert [s.name for s in got] == DETECT and ranges == DETECT
    root = got[0]
    assert root.parent is None and all(s.request == root.id for s in got)
    assert all(s.parent == root.id for s in got[1:])
    assert got[1].counts == {"pageable_bytes": images.nbytes}
    assert all(s.counts == {} for s in got if s.name != "ssp.detect.upload")
    assert all(s.device_ns is None for s in got)  # the CPU: no device interval
    for a, b in zip(got[1:], got[2:]):
        assert a.end_ns <= b.start_ns
    assert root.start_ns <= got[1].start_ns and got[-1].end_ns <= root.end_ns

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    for s in got:
        (e,) = [e for e in events if e.get("name") == s.name
                and e.get("cat") == "user_annotation"]
        ring_us = (s.end_ns - s.start_ns) / 1e3
        assert abs(e["dur"] - ring_us) <= max(0.1 * ring_us, 50.0), (s.name, e["dur"], ring_us)
    trace.clear()
    assert trace.spans() == []


def test_the_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(trace, "RING", 16)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(40):
            with trace.span("outer", n=i):
                with trace.span("inner"):
                    pass
    got = trace.spans()
    assert len(got) == 16
    assert [s.counts["n"] for s in got if s.name == "outer"] == list(range(32, 40))
    ids = [s.id for s in got]
    assert ids == sorted(ids) and ids[-1] - ids[0] == 15
    assert all(s.parent == s.request for s in got if s.name == "inner")
    trace.clear()


def test_trainer_profile_holds_its_spans(tmp_path):
    cfg = {"model": {"name": "SuperPointNet_gauss2", "params": {"dtype": "float32"},
                     "batch_size": B, "learning_rate": 0.001},
           "data": {"preprocessing": {"resize": [H, W]}},
           "train_iter": 3, "tensorboard_interval": 100, "save_interval": 100,
           "validation_interval": 0, "validation_size": 0,
           "profile": {"enable": True, "steps": 1}}
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"image": rng.uniform(size=(B, H, W)).astype(np.float32),
                   "points": rng.uniform([0, 0], [W - 1, H - 1], (B, 20, 2)).astype(np.float32),
                   "points_valid": np.ones((B, 20), bool)}

    agent = TrainAgent(cfg, save_path=ExperimentPaths("run", tmp_path), device="cpu")
    agent.train_loader = batches()
    trace.clear()
    agent.train()
    events = json.loads((tmp_path / "run" / "profile" / "trace_3.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"ssp.train.dispatch", "ssp.train.loader_wait", "ssp.train.prologue",
            "ssp.train.step"} <= names
    got = trace.spans()  # the one profiled turn, eager on the CPU
    assert [s.name for s in got] == ["ssp.train.dispatch", "ssp.train.loader_wait",
                                     "ssp.train.prologue", "ssp.train.step"]
    assert all(s.parent == got[0].id and s.device_ns is None for s in got[1:])
    assert agent.loader_wait_s > 0
    trace.clear()
