"""The detect path's upload on one GPU: how fast the host copies frames into
page-locked memory, how fast the card reads them from there, and what a
staged upload and a whole request cost at each chunk plan.

    python -m ssp_torch.bench_upload

The sources are ``SOURCES`` pageable batches sent in turn, as the
benchmark's client sends its templates, so that a copy reads memory that
the last one did not leave in the host's caches.  Readings, medians over
``REPS`` after warm-up, at the process's intra-op thread count (PyTorch's
default unless the caller set one):

* ``host_copy_gbs``: a pageable float32 batch copied into page-locked memory,
  at 16×480×640 (19.66 MB), 1×384×1248 (1.92 MB) and 1×240×320 (0.31 MB),
  through ``Tensor.copy_`` (the intra-op pool) and through ``np.copyto`` on
  ``.numpy()`` views (one thread);
* ``h2d_gbs``: page-locked to the card without blocking, and pageable to the
  card by ``.to``, between CUDA events;
* ``chunked_host_ms``: the 16×480×640 host copy alone in 1, 2, 4 and 8 equal
  chunks, with no copy to the card (the cost of a chunk to the host);
* ``steps_us``: the staged upload's steps at 16×480×640 in one chunk, each
  on the host's clock;
* ``staged_ms``: :class:`ssp_torch._device.StagingRing` at 16×480×640 at each
  plan of :func:`_plans`: host ms until the call returns and until the last
  byte is on the card; the plain ``.to`` beside them;
* ``large_ms``: the same at 64×480×640 (78.64 MB) in 1, 2, 3 and 4 chunks;
* ``request_ms``: ``make_detect_describe_fn`` at 16×480×640 (seeded gauss2
  weights, K=1000, refined) and ``.cpu()`` of its results, a request as the
  benchmark's client sends it, at each plan and with the plain ``.to`` (a
  CUDA tensor skips the ring), in turns over ``ROUNDS`` rounds of
  ``REQUESTS``.

Each time is a start on an idle card, as a closed loop's request.  Prints one
JSON line with the card's name and power limit.  It needs a CUDA card.
"""

from __future__ import annotations

import itertools
import json
import statistics
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ssp_torch import _device
from ssp_torch.bench import _card

REPS = 40
ROUNDS = 10
REQUESTS = 16  # a round's requests per variant
SOURCES = 8
BATCH, H, W = 16, 480, 640


def _sources(shape) -> Callable[[], torch.Tensor]:
    """The next of ``SOURCES`` pageable float32 batches of ``shape``, in turn."""
    return itertools.cycle([torch.rand(shape) for _ in range(SOURCES)]).__next__


def _median_ms(fn: Callable[[], object], reps: int = REPS) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _tensor_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    dst.copy_(src)


def _numpy_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    np.copyto(dst.numpy(), src.numpy(), casting="unsafe")


def host_copy_gbs() -> Dict[str, Dict[str, float]]:
    out = {}
    for shape in ((BATCH, H, W), (1, 384, 1248), (1, 240, 320)):
        nxt = _sources(shape)
        dst = torch.empty(shape, pin_memory=True)
        mb = dst.nbytes / 1e6
        out["x".join(map(str, shape))] = {
            name: mb / _median_ms(lambda f=f: f(dst, nxt()))
            for name, f in (("tensor_copy", _tensor_copy), ("numpy_copyto", _numpy_copy))}
    return out


def h2d_gbs(dev: torch.device) -> Dict[str, float]:
    src = torch.rand(BATCH, H, W)
    pinned = src.pin_memory()
    dst = torch.empty(src.shape, device=dev)

    def events(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return src.nbytes / statistics.median(times) / 1e6

    return {"pinned": events(lambda: dst.copy_(pinned, non_blocking=True)),
            "pageable": events(lambda: dst.copy_(src))}


def _equal(n: int) -> List[Tuple[int, int]]:
    edges = [BATCH * i // n for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def _plans() -> Dict[str, List[Tuple[int, int]]]:
    plans = {f"equal{n}": _equal(n) for n in (1, 2, 3, 4, 8)}
    plans["first1+1"] = [(0, 1), (1, BATCH)]
    plans["first2+2"] = [(0, 2), (2, 9), (9, BATCH)]
    plans["9+7"] = [(0, 9), (9, BATCH)]
    return plans


def chunked_host_ms() -> Dict[str, float]:
    nxt = _sources((BATCH, H, W))
    dst = torch.empty(BATCH, H, W, pin_memory=True)

    def copy(plan):
        src = nxt()
        for a, b in plan:
            _tensor_copy(dst[a:b], src[a:b])

    return {f"equal{n}": _median_ms(lambda n=n: copy(_equal(n))) for n in (1, 2, 4, 8)}


def large_ms(dev: torch.device) -> Dict[str, Dict[str, float]]:
    """The staged upload of 64×480×640 (78.64 MB) in 1, 2, 3 and 4 equal
    chunks: host ms until the call returns and until the last byte lands."""
    nxt = _sources((4 * BATCH, H, W))
    ring = _device.StagingRing(dev)
    out = {}
    for n in (1, 2, 3, 4):
        edges = [4 * BATCH * i // n for i in range(n + 1)]
        plan = list(zip(edges[:-1], edges[1:]))

        def landed(plan=plan):
            ring.upload(nxt(), plan)
            torch.cuda.synchronize()

        out[f"equal{n}"] = {"return": _median_ms(lambda plan=plan: ring.upload(nxt(), plan)),
                            "landed": _median_ms(landed)}
    return out


def steps_us(dev: torch.device) -> Dict[str, float]:
    """The staged upload's steps at 16×480×640 in one chunk, each timed on the
    host (median us): the card's output buffer, the host copy into the
    ring, the queued copy to the card, the event after it."""
    nxt = _sources((BATCH, H, W))
    stage = torch.empty(BATCH, H, W, pin_memory=True)
    times: Dict[str, List[float]] = {k: [] for k in ("empty", "host_copy", "h2d_call", "event")}
    for _ in range(REPS):
        src = nxt()
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        out = torch.empty(src.shape, device=dev)
        t.append(time.perf_counter())
        _tensor_copy(stage, src)
        t.append(time.perf_counter())
        out.copy_(stage, non_blocking=True)
        t.append(time.perf_counter())
        torch.cuda.Event().record(torch.cuda.current_stream(dev))
        t.append(time.perf_counter())
        for k, a, b in zip(times, t, t[1:]):
            times[k].append((b - a) * 1e6)
    return {k: statistics.median(v) for k, v in times.items()}


def staged_ms(dev: torch.device) -> Dict[str, Dict[str, float]]:
    nxt = _sources((BATCH, H, W))
    ring = _device.StagingRing(dev)
    out = {}
    for name, plan in _plans().items():
        def landed(plan=plan):
            ring.upload(nxt(), plan)
            torch.cuda.synchronize()

        out[name] = {"return": _median_ms(lambda plan=plan: ring.upload(nxt(), plan)),
                     "landed": _median_ms(landed)}

    def plain():
        nxt().to(dev)
        torch.cuda.synchronize()

    out["plain_to"] = {"return": _median_ms(lambda: nxt().to(dev)), "landed": _median_ms(plain)}
    return out


def request_ms(dev: torch.device) -> Dict[str, Dict[str, float]]:
    from ssp_torch.export import descriptors_export as dd
    from ssp_torch.models.fast_infer import best_apply_fn
    from ssp_torch.models.superpoint import build_model

    model = build_model("SuperPointNet_gauss2", device=dev, generator=torch.Generator().manual_seed(0))
    fn = dd.make_detect_describe_fn(best_apply_fn(model, input_hw=(H, W), device=dev),
                                    device=dev, top_k=1000, conf_thresh=0.015)
    nxt = _sources((BATCH, H, W))
    real_plan = dd.chunk_plan
    variants: Dict[str, Callable[[], None]] = {
        "plain_to": lambda: [o.cpu() for o in fn(nxt().to(dev))]}
    for name, plan in _plans().items():
        def run(plan=plan):
            dd.chunk_plan = lambda *_: plan
            try:
                [o.cpu() for o in fn(nxt())]
            finally:
                dd.chunk_plan = real_plan
        variants[name] = run
    for run in variants.values():
        run()
    rounds: Dict[str, List[float]] = {k: [] for k in variants}
    for r in range(ROUNDS):
        order = list(variants) if r % 2 == 0 else list(variants)[::-1]
        for k in order:
            t0 = time.perf_counter()
            for _ in range(REQUESTS):
                variants[k]()
            rounds[k].append((time.perf_counter() - t0) * 1e3 / REQUESTS)
    return {k: {"median": statistics.median(v), "quartiles": statistics.quantiles(v, n=4)}
            for k, v in rounds.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_upload needs a CUDA card")
    dev = torch.device("cuda")
    torch.cuda.init()
    print(json.dumps({
        "device": _card(), "threads": torch.get_num_threads(),
        "host_copy_gbs": host_copy_gbs(), "h2d_gbs": h2d_gbs(dev),
        "chunked_host_ms": chunked_host_ms(), "steps_us": steps_us(dev),
        "staged_ms": staged_ms(dev), "large_ms": large_ms(dev),
        "request_ms": request_ms(dev)}))


if __name__ == "__main__":
    main()
