"""The port's own kernels, the ordered scatter-add and the cross-checked
matcher, on one GPU: each against its plain version, then timed two ways
beside the one PyTorch call for the same function.

    python -m ssp_torch.bench_own_kernels

To compare two commits on one card, copy this file into the other tree's
``ssp_torch/`` and run it there too: the wrappers' interfaces are the same.
``chip_smoke.py`` phases 17 and 21 (b) run the same cases and readings
(:func:`scatter_rows`, :func:`matcher_cases`, :func:`check_matcher`,
:func:`matcher_rows`) on their own inputs.

Shapes: the scatter at each shape one flagship training step gives it,
recorded from a step of ``configs/pipeline240_wsem_200k.yaml`` at full width
(B=16, 240×320, sparse 1000×100) on a seeded device corpus with seeded
random weights: the descriptor taps 16×4000×256 → 1200 and the match rows
16×1000×256 → 1200; the matcher at 1000×1000 SIFT (128-byte) and ORB
(32-byte) rows of 0..255 and on the fixtures pair
(``tests/data/torch_classical``, noise against blobs).

Each time is held against the plain version first, bit for bit.  Three
readings per function:

* device ms: a CUDA graph of ``CALLS`` captured calls, replayed ``REPS``
  times between CUDA events, over the calls (the host's per-call work is
  not in it);
* eager ms: CUDA events around ``CALLS`` back-to-back eager calls (it holds
  the host's per-call time where that exceeds the card's);
* the device operations of one eager call under ``torch.profiler``, with
  their durations, read in a fresh process on the same inputs
  (:func:`fresh_ops`: ``python -m ssp_torch.bench_own_kernels --ops
  FILE``); a call that shows other operations than the kernel's own
  launches (a memset, a copy), or none, raises.

``scatter_add`` into zeros (the one PyTorch call for the scatter's sums,
in atomic order) is read the same ways.  Prints one JSON line with the
card's name and power limit.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ssp_torch.bench import PEAK_FP32, PEAK_INT8, _card, bound
from ssp_torch.bench_kernels import _time_ms

CALLS = 50
REPS = 20
ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "torch_classical"
FLAGSHIP = ROOT / "configs" / "pipeline240_wsem_200k.yaml"
MATCHER_ROWS = 1000
# the device operations of one call: the scatter's sort and sums, the
# matcher's one kernel
SCATTER_OPS = ("sort_kernel", "rows_kernel")
MATCHER_OPS = ("match_kernel",)


def device_ms(fn, calls: int = CALLS) -> float:
    """Mean device ms of ``fn()``: ``calls`` calls captured in one CUDA
    graph (after two warm-up calls on a side stream), the graph replayed
    ``REPS`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * REPS)
    del graph
    torch.cuda.empty_cache()
    return ms


def device_ops(fn, calls: int = 20, warmup: int = 3, sessions: int = 3) -> list:
    """The device operations (kernels, memsets, copies) of one eager call of
    ``fn()``: [(name, ms)] in order of first start, ms the mean over
    ``calls`` calls under ``torch.profiler``.  The profiler traces
    ``warmup`` calls first and drops them (a trace that starts at the call
    loses some of its first operations).  It still loses a call's records
    now and then (9 calls of 10 recorded, once), so an operation counts
    round(records / calls) times per call: one seen in fewer than half the
    calls not at all.  Once in a while it records no device operation in a
    whole trace, even in a fresh process (the first matcher case, once): a
    trace with none is taken again, up to ``sessions`` traces in all, and
    [] comes back only if every one of them saw nothing on the device."""
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []

    def keep(prof):
        events.extend(e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith("ProfilerStep"))

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warmup, active=calls, repeat=1),
                     on_trace_ready=keep) as prof:
            for i in range(warmup + calls):
                fn()
                if i == warmup + calls - 1:
                    torch.cuda.synchronize()
                prof.step()
        if events:
            break
    by_name = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        by_name.setdefault(e.name[:60], []).append(e.time_range.elapsed_us() / 1e3)
    return [(name, sum(ms) / len(ms)) for name, ms in by_name.items()
            for _ in range(round(len(ms) / calls))]


def _expect_ops(ops: list, kernels: tuple, what: str) -> None:
    """Raises unless ``ops`` (one call's) are ``kernels``' launches, one
    each, and nothing else."""
    seen = sorted(next((k for k in kernels if k in n), n) for n, _ in ops)
    if seen != sorted(kernels):
        raise AssertionError(f"{what}: device operations per call {ops} under torch.profiler, "
                             f"expected {kernels} and nothing else")


def readings(fn) -> dict:
    """Device ms and eager ms of ``fn``."""
    return {"ms": device_ms(fn), "eager_ms": _time_ms(fn, CALLS)}


def _call(kind: str, args: tuple):
    """The call a case of :func:`fresh_ops` names, on its (CUDA) inputs."""
    from ssp_torch.kernels import bfmatch
    from ssp_torch.kernels import ordered_scatter as osc

    if kind == "match":
        qb, tb, hamming = args
        return lambda: bfmatch.launch(qb, tb, hamming)
    src, idx, t = args
    if kind == "scatter":
        return lambda: osc.ordered_scatter(src, idx, t)
    r, k, c = src.shape
    zeros = torch.zeros(r, t, c, dtype=src.dtype, device=src.device)
    ex = idx[..., None].expand(r, k, c)
    return lambda: zeros.scatter_add(1, ex, src)


def fresh_ops(cases: dict, workdir: Path) -> dict:
    """{name: :func:`device_ops` of the case's call} read in a fresh Python
    process on the same inputs, ``cases`` {name: (kind, args)}: ``("scatter",
    (src, idx, T))``, ``("scatter_add", (src, idx, T))`` (into zeros) or
    ``("match", (query bytes, train bytes, hamming))``.  The inputs go
    through a file under ``workdir``.  A process that has run much else
    (``chip_smoke.py``'s) may see none of a kernel's launches under
    ``torch.profiler``; a fresh one sees them all."""
    path = Path(workdir) / "own_kernel_calls.pt"
    torch.save({name: (kind, tuple(a.cpu() if torch.is_tensor(a) else a for a in args))
                for name, (kind, args) in cases.items()}, path)
    try:
        run = subprocess.run([sys.executable, "-m", "ssp_torch.bench_own_kernels", "--ops",
                              str(path)], cwd=ROOT, capture_output=True, text=True)
    finally:
        path.unlink()
    if run.returncode:
        raise RuntimeError(f"bench_own_kernels --ops exited {run.returncode}: "
                           f"{run.stderr[-2000:]}")
    return {name: [tuple(op) for op in ops]
            for name, ops in json.loads(run.stdout.strip().splitlines()[-1]).items()}


def _ops_main(path: Path) -> None:
    """``--ops FILE``: the device operations of each case of a
    :func:`fresh_ops` file, as one JSON line."""
    dev = torch.device("cuda")
    cases = torch.load(path)
    out = {}
    for name, (kind, args) in cases.items():
        out[name] = device_ops(_call(kind, tuple(a.to(dev) if torch.is_tensor(a) else a
                                                 for a in args)))
    print(json.dumps(out), flush=True)


def flagship_scatter_calls(dev: torch.device, seed: int = 0) -> list:
    """The ordered scatter's inputs of one flagship training step, in call
    order: ``[(src, idx, T)]``.  The agent is the flagship configuration at
    full width with seeded random weights (no checkpoint) on a device corpus
    of 16 seeded samples (uniform pixels, 300 points each, seeded class
    maps); its sparse loss samples 1000 matches and 100 non-matches each."""
    import yaml

    from ssp_torch import registry
    from ssp_torch.data.device_corpus import DeviceCorpus
    from ssp_torch.kernels import ordered_scatter as osc
    from ssp_torch.train import trainer  # noqa: F401  (registers the agents)
    from ssp_torch.utils.experiment import ExperimentPaths

    cfg = yaml.safe_load(FLAGSHIP.read_text())
    cfg.update(pretrained=None, steps_per_dispatch=1)
    B, (h, w) = cfg["model"]["batch_size"], cfg["data"]["preprocessing"]["resize"]
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    n = 16
    arrays = {"image": rng.integers(0, 256, (n, h, w)).astype(np.uint8),
              "points": rng.uniform([0, 0], [w - 1, h - 1], (n, 300, 2)).astype(np.float32),
              "points_valid": rng.uniform(size=(n, 300)) < 0.8,
              "sem": rng.integers(0, 134, (n, h, w)).astype(np.int32)}
    calls, real = [], osc.ordered_scatter

    def record(src, idx, T):
        calls.append((src.detach().clone(), idx.clone(), T))
        return real(src, idx, T)

    with tempfile.TemporaryDirectory() as td:
        agent = registry.get("agent", cfg["front_end_model"])(
            cfg, save_path=ExperimentPaths("bench_own_kernels", Path(td)), device=dev, eager=True)
        agent.device_corpus = DeviceCorpus({k: torch.from_numpy(v).to(dev)
                                            for k, v in arrays.items()}, n)
        batch = agent.prepare(agent.next_batch())
        osc.ordered_scatter = record
        try:
            agent.step(batch)
        finally:
            osc.ordered_scatter = real
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not calls or any(s.shape[0] != B for s, _, _ in calls):
        raise AssertionError(f"the flagship step gave the scatter {len(calls)} calls")
    return calls


def scatter_rows(calls: list, workdir: Path) -> dict:
    """The ordered scatter on ``calls`` (``[(src, idx, T)]`` on the card)
    and on the last call's indices sorted and reversed along k, each against
    the plain version on the host bit for bit (signed zeros included); then,
    per distinct shape, the readings of the kernel and of ``scatter_add``
    into zeros, their device operations (:func:`fresh_ops`, through
    ``workdir``), the plain version's eager ms and the bound (src, idx and
    out once).  Returns {shape: row}."""
    from ssp_torch.kernels import ordered_scatter as osc

    cases = [(f"{s.shape[0]}x{s.shape[1]}x{s.shape[2]}->{t}", s, i, t) for s, i, t in calls]
    src, idx, t = calls[-1]
    srt = idx.sort(dim=1).values
    cases += [(f"{cases[-1][0]} {tag}", src, i, t) for tag, i in (("sorted", srt),
                                                                 ("reversed", srt.flip(1)))]
    rows, on_card = {}, {}
    for name, src, idx, t in cases:
        got = osc.ordered_scatter(src, idx, t).cpu()
        want = osc.ordered_scatter_plain(src.cpu(), idx.cpu(), t)
        err = float((got - want).abs().max())
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"ordered_scatter {name}: max abs err {err} against the plain "
                                 f"version (or a signed zero)")
        if name in rows or " " in name:
            continue
        r, k, c = src.shape
        zeros = torch.zeros(r, t, c, device=src.device)
        ex = idx[..., None].expand(r, k, c)
        kernel = readings(lambda: osc.ordered_scatter(src, idx, t))
        library = readings(lambda: zeros.scatter_add(1, ex, src))
        on_card[name] = ("scatter", (src, idx, t))
        on_card[f"{name} scatter_add"] = ("scatter_add", (src, idx, t))
        b_ms, b_by = bound(r * k * c, PEAK_FP32, 4.0 * src.numel() + 8.0 * idx.numel() +
                           4.0 * zeros.numel())
        rows[name] = {**kernel, "plain_ms": _time_ms(lambda: osc.ordered_scatter_plain(src, idx, t),
                                                     CALLS),
                      "library_ms": library["ms"], "library_eager_ms": library["eager_ms"],
                      "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    ops = fresh_ops(on_card, workdir)
    for name, row in rows.items():
        _expect_ops(ops[name], SCATTER_OPS, f"ordered_scatter at {name}")
        row.update(ops=ops[name], library_ops=ops[f"{name} scatter_add"])
    return rows


def matcher_cases(seed: int = 21) -> dict:
    """{name: (query, train)} numpy rows: the fixtures pair's SIFT and ORB
    rows; ``MATCHER_ROWS``² SIFT (float32 integers 0..255, 128 bytes) and
    ORB (uint8, 32 bytes) with shared rows (distance 0), duplicate train rows
    (ties to the lowest index) and duplicate query rows; two train rows
    whose squared distances to the query share a float root (4,197,201 at
    row 0, 4,197,200 at row 1: OpenCV keeps row 0); SIFT and ORB rows of 4
    and 124 bytes (300 × 257)."""
    rng = np.random.default_rng(seed)
    cases = {}
    with np.load(FIXTURES / "noise.npz") as a, np.load(FIXTURES / "blobs.npz") as b:
        cases["fixtures_sift"] = (a["sift_plain_desc"].astype(np.float32),
                                  b["sift_plain_desc"].astype(np.float32))
        cases["fixtures_orb"] = (a["orb_desc"], b["orb_desc"])
    for tag, dim, dtype in (("sift", 128, np.float32), ("orb", 32, np.uint8)):
        q = rng.integers(0, 256, (MATCHER_ROWS, dim)).astype(dtype)
        t = rng.integers(0, 256, (MATCHER_ROWS, dim)).astype(dtype)
        t[:50] = q[:50]        # shared rows: distance 0
        t[100:110] = t[99]     # duplicate train rows: ties to the lowest index
        q[200:210] = q[199]    # duplicate query rows
        cases[f"{MATCHER_ROWS}x{MATCHER_ROWS}_{tag}"] = (q, t)
    tie_t = np.zeros((2, 128), np.float32)
    tie_t[:, :64], tie_t[:, 64], tie_t[:, 65], tie_t[0, 66] = 255.0, 188.0, 16.0, 1.0
    cases["root_tie"] = (np.zeros((1, 128), np.float32), tie_t)
    for width in (4, 124):
        for tag, dtype in (("sift", np.float32), ("orb", np.uint8)):
            cases[f"{tag}_{width}B"] = tuple(rng.integers(0, 256, (n, width)).astype(dtype)
                                             for n in (300, 257))
    return cases


def check_matcher(cases: dict, dev: torch.device):
    """Each case of :func:`matcher_cases` through the kernel on ``dev``,
    equal to the plain version on the card and on the host; the root tie
    kept at train row 0; an empty side gives no match.  Returns ({name:
    matches}, max abs err, {name: (query, train) on ``dev``})."""
    from ssp_torch.kernels import bfmatch

    on_card = {k: (torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev))
               for k, (q, t) in cases.items()}
    matches, err = {}, 0.0
    for k, (q, t) in on_card.items():
        got = bfmatch.bfmatch(q, t)
        want = bfmatch.bfmatch_plain(q, t)
        want_cpu = bfmatch.bfmatch_plain(q.cpu(), t.cpu())
        if got.shape != want.shape or got.shape != want_cpu.shape:
            raise AssertionError(f"the matcher on {k}: {len(got)} matches, its plain version "
                                 f"{len(want)} (card) and {len(want_cpu)} (CPU)")
        if got.numel():
            err = max(err, float((got - want).abs().max()),
                      float((got.cpu() - want_cpu).abs().max()))
        if not torch.equal(got, want) or not torch.equal(got.cpu(), want_cpu):
            raise AssertionError(f"the matcher on {k} differs from its plain version by up to "
                                 f"{err}")
        matches[k] = len(got)
    if matches["root_tie"] != 1 or bfmatch.bfmatch(*on_card["root_tie"])[0, 1] != 0:
        raise AssertionError("the matcher broke a tie on the float root against the lower index")
    q0 = on_card[f"{MATCHER_ROWS}x{MATCHER_ROWS}_sift"][0]
    if bfmatch.bfmatch(q0[:0], q0).shape != (0, 3) or bfmatch.bfmatch(q0, q0[:0]).shape != (0, 3):
        raise AssertionError("the matcher: an empty side gives matches")
    return matches, err, on_card


def matcher_rows(on_card: dict, workdir: Path) -> dict:
    """The readings of ``bfmatch.launch`` (the kernel's call on byte rows)
    at 1000×1000 SIFT and ORB and the fixtures' SIFT, with the eager ms of
    ``bfmatch`` (with its checks and compaction) and of the plain version
    and the bound: the least int8 tensor-core work for the same function,
    L2 as |a|² + |b|² − 2 a·b, a u8 × u8 product summed exactly in int32 (2
    operations per byte pair; the norms are O(N D)), Hamming as |a| + |b| −
    2 a·b over the 8 D bits as 0/1 int8 values (2 per bit pair); the byte
    rows read once, a key per query row written once; the device operations
    of a call (:func:`fresh_ops`, through ``workdir``)."""
    from ssp_torch.kernels import bfmatch

    out, calls = {}, {}
    for name in (f"{MATCHER_ROWS}x{MATCHER_ROWS}_sift", f"{MATCHER_ROWS}x{MATCHER_ROWS}_orb",
                 "fixtures_sift"):
        q, t = on_card[name]
        hamming = q.dtype == torch.uint8
        qb, tb = (q, t) if hamming else (q.to(torch.uint8), t.to(torch.uint8))
        kernel = readings(lambda: bfmatch.launch(qb, tb, hamming))
        calls[name] = ("match", (qb, tb, hamming))
        ops = 2.0 * q.shape[0] * t.shape[0] * q.shape[1] * (8 if hamming else 1)
        b_ms, b_by = bound(ops, PEAK_INT8, qb.numel() + tb.numel() + q.shape[0] * 8)
        out[name] = {**kernel, "wrapper_ms": _time_ms(lambda: bfmatch.bfmatch(q, t), 20),
                     "plain_ms": _time_ms(lambda: bfmatch.bfmatch_plain(q, t), 5),
                     "bound_ms": b_ms, "bound_by": b_by}
    ops = fresh_ops(calls, workdir)
    for name, row in out.items():
        _expect_ops(ops[name], MATCHER_OPS, f"the matcher on {name}")
        row["ops"] = ops[name]
    return out


def _ops_text(ops: list) -> str:
    return ", ".join(f"{n} {ms:.4f} ms" for n, ms in ops)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", type=Path, help="a file of fresh_ops: print its calls' device "
                    "operations as one JSON line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ssp_torch.bench_own_kernels needs a CUDA card")
    if args.ops:
        return _ops_main(args.ops)
    import ssp_torch

    dev = torch.device("cuda")
    smi = _card()
    with tempfile.TemporaryDirectory() as td:
        scatter = scatter_rows(flagship_scatter_calls(dev), Path(td))
        matches, _, on_card = check_matcher(matcher_cases(), dev)
        match = matcher_rows(on_card, Path(td))
    for name, r in scatter.items():
        print(f"{name} ({smi}): kernel device {r['ms']:.4f} ms, eager {r['eager_ms']:.4f} ms, "
              f"{len(r['ops'])} device operations per call ({_ops_text(r['ops'])}); bound "
              f"{r['bound_ms']:.6f} ms; scatter_add device {r['library_ms']:.4f}, eager "
              f"{r['library_eager_ms']:.4f} ms, {len(r['library_ops'])} operations "
              f"({_ops_text(r['library_ops'])})", flush=True)
    for name, r in match.items():
        print(f"{name} ({smi}): kernel device {r['ms']:.4f} ms, eager {r['eager_ms']:.4f} ms, "
              f"{len(r['ops'])} device operations per call ({_ops_text(r['ops'])}); bound "
              f"{r['bound_ms']:.6f} ms", flush=True)
    print(json.dumps({"package": str(Path(ssp_torch.__file__).parent), "card": smi,
                      "scatter": scatter, "match": match, "matches": matches}), flush=True)


if __name__ == "__main__":
    main()
