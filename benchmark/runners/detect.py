"""Detect+describe as a service sees it: a closed loop of one client whose
requests are batches of gray frames in host memory.

The program under test is the port's export path,
``ssp_torch.export.descriptors_export.make_detect_describe_fn`` over
``ssp_torch.models.fast_infer.best_apply_fn`` (the folded bf16 forward, NMS
kernel, top-k, soft-argmax refinement, descriptor sampling).  A request ends
when its points, valid flags and descriptors are in host memory.

The client holds its requests as the port's exports hold their images, in
pageable host memory, and reads each result back as the exports do
(``descriptors_export._host``: ``.cpu()`` of each output).

The mix's parameters: ``batch`` frames of ``height`` × ``width`` per request,
drawn from ``pool`` seed-made frames into ``templates`` fixed requests that
the client sends in turn; ``top_k``, ``conf_thresh``, ``nms_radius`` and
``subpixel`` as the export's config gives them; ``warmup`` requests of
set-up; in a ``--trace 1`` run, after the window, ``trace_seconds`` traced on
the device, then ``gap_seconds`` with the host's operators;
``check_requests`` requests of the window, sampled from the seed, held to the
reference after the window; ``limits`` on the numbers of
``yardstick.compare``.
"""

from __future__ import annotations

import gc
import random
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

import torch

from reference import points as ref_points
from reference import superpoint as ref_net
from yardstick import compare, faults, frames
from yardstick.records import Records, Request
from yardstick.trace import traced

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class Cell:
    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], bench_dir: Path,
                 device: torch.device):
        from ssp_torch.export import descriptors_export
        from ssp_torch.models.fast_infer import best_apply_fn
        from ssp_torch.models.weights import load_flax_npz

        self.cfg, self.mix, self.device = cfg, mix, device
        self.weights = bench_dir / cfg["weights"]["inference"]
        self.B, self.H, self.W = mix["batch"], mix["height"], mix["width"]
        model = load_flax_npz(self.weights, cfg["registry_name"], device=device)
        self.program: Callable[[torch.Tensor], Outputs] = (
            descriptors_export.make_detect_describe_fn(
                best_apply_fn(model, input_hw=(self.H, self.W), device=device), device=device,
                **self._post()))
        self.templates: List[torch.Tensor] = []
        self.kept: List[int] = []  # the template of each held result

    def _post(self) -> Dict[str, Any]:
        m = self.mix
        return {"top_k": m["top_k"], "conf_thresh": m["conf_thresh"],
                "nms_radius": m["nms_radius"], "subpixel": m["subpixel"]}

    def setup(self, seed: int) -> None:
        """The seed's requests in host memory, then the warm-up requests."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        pool = frames.structured_frames(self.mix["pool"], self.H, self.W, g)
        picks = [torch.randperm(self.mix["pool"], generator=g, device=self.device)[:self.B]
                 for _ in range(self.mix["templates"])]
        self.templates = [pool[p].cpu() if self.device.type == "cuda" else pool[p].clone()
                          for p in picks]
        del pool
        self.rng = random.Random(seed)
        for i in range(max(1, self.mix["warmup"])):
            _, host = self._request(i % len(self.templates))
        # the sampled requests' results are copied into these, so that every
        # result is freed as the exports free it and the host's allocator
        # sees the exports' pattern
        self.held = [tuple(torch.empty_like(o) for o in host)
                     for _ in range(self.mix["check_requests"])]

    def _request(self, t: int) -> Tuple[Request, Outputs]:
        """One request: the program's call on template ``t``, its results read
        back into host memory."""
        t0 = time.perf_counter()
        out = self.program(self.templates[t])
        t1 = time.perf_counter()
        host = tuple(o.cpu() for o in out)
        t2 = time.perf_counter()
        return Request(t0, t1, t2), host

    def window(self, seconds: float, rec: Records, trace: bool) -> None:
        """Requests until ``seconds`` have passed; the window closes when the
        request in flight completes."""
        n_keep = self.mix["check_requests"]
        self.kept = []
        count = [0]

        def loop(until: float) -> int:
            """Requests until the host clock passes ``until``; how many."""
            first = len(rec.requests)
            while True:
                t = count[0] % len(self.templates)
                req, host = self._request(t)
                rec.requests.append(req)
                # reservoir sample of every request, drawn from the seed
                j = count[0] if count[0] < n_keep else self.rng.randrange(count[0] + 1)
                if j < n_keep:
                    for h, o in zip(self.held[j], host):
                        h.copy_(o)
                    self.kept[j:j + 1] = [t]
                count[0] += 1
                del host  # freed before the next request's read-back, as the exports free it
                if req.done >= until:
                    return len(rec.requests) - first

        start = time.perf_counter()
        loop(start + seconds)
        rec.window = (start, rec.requests[-1].done)
        rec.attempted = len(rec.requests)
        rec.items_done = self.B * len(rec.requests)
        rec.host_ms = [(r.returned - r.submit) * 1e3 for r in rec.requests]
        if trace:
            n, rec.trace = traced(lambda: loop(time.perf_counter() + self.mix["trace_seconds"]))
            rec.traced_items = self.B * n
            _, rec.host_trace = traced(lambda: loop(time.perf_counter() + self.mix["gap_seconds"]),
                                       host=True)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.program = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def control(self) -> Callable[[torch.Tensor], Outputs]:
        """The reference put in the program's place at the precision below
        the configuration's bf16: scaled float8 e4m3 operands."""
        w = ref_net.load_npz(self.weights, self.device)

        def run(x: torch.Tensor) -> Outputs:
            out = ref_net.forward(w, x.to(self.device), quant=ref_net.scaled_fp8)
            return self._ref_post(out)

        return run

    def faults(self) -> Dict[str, Callable]:
        """The faults this cell can have, planted under its program."""
        p = self.program
        return {"half_batch": faults.half_batch(p),
                "altered_descriptor": faults.altered(p, faults.negate_first_descriptor)}

    def _ref_post(self, out: Dict[str, torch.Tensor]) -> Outputs:
        p = self._post()
        return ref_points.detect_describe(ref_net.heatmap(out["semi"]), out["desc"],
                                          top_k_=p["top_k"], conf_thresh=p["conf_thresh"],
                                          nms_radius=p["nms_radius"], subpixel=p["subpixel"])

    def numbers(self) -> Dict[str, float]:
        """The kept requests against the fp32 reference."""
        w = ref_net.load_npz(self.weights, self.device)
        per_image = []
        for t, (pts, valid, desc) in zip(self.kept, self.held):
            out = ref_net.forward(w, self.templates[t].to(self.device))
            rp, rv, _ = self._ref_post(out)
            pts, valid, desc = (o.to(self.device) for o in (pts, valid, desc))
            at = ref_points.sample_descriptors(out["desc"], pts[..., :2])
            per_image += [compare.image_numbers(pts[i], valid[i], rp[i], rv[i], desc[i], at[i])
                          for i in range(self.B)]
        return compare.summarize(per_image)
