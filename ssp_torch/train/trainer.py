"""Training agent: the loop around the step (port of ``ssp/train/trainer.py``;
reference ``Train_model_frontend_all.py`` / ``Train_model_heatmap_all.py``).

Config merge over :data:`DEFAULT_CONFIG`, interval scaling by ``r =
real_batch_size // batch_size``, the iteration loop with interleaved
validation, periodic checkpoints, metric logging, checkpoint rescue on
Ctrl-C and a host-memory watchdog.  Registered as ``Train_model_heatmap``,
``Train_model_heatmap_all``, ``Train_model_frontend`` and
``Train_model_frontend_all``, the JAX package's four names for one agent.

Batch semantics are the JAX trainer's: the *real* batch is the global batch
of every step, and ``n_iter`` counts micro-batches (it advances by ``r`` a
step), so checkpoint names line up with the reference's.  Events are
labelled with the interval boundary that a step's window crossed
(``hits``/``boundary``), so names and metric steps are the same multiples
for any stride.

Randomness: a CPU ``torch.Generator`` draws the homographies and a
generator on the training device draws the photometric values and the
descriptor loss's samples, both seeded from the config's ``seed``; the
numbers are not ``jax.random``'s.

With ``training.device_corpus`` the CLI attaches the training set to the
card (:meth:`TrainAgent.attach_device_corpus`) and each step samples its
batch there; validation keeps the host loader.  ``model.exact_accumulation``
with ``r > 1`` runs :func:`~ssp_torch.train.step.accum_train_step` (the
reference's summed micro-batch gradients) on the real batch;
``model.dense_loss.enable`` the dense descriptor loss.

``steps_per_dispatch`` k: each loop turn makes k steps, ``n_iter`` advances
by r·k, the intervals are aligned to that stride and the metrics logged are
the turn's last step's, as the JAX trainer's ``lax.scan`` of k steps per
device program (``multi_train_step`` on the host loader, the device corpus's
scan otherwise).  On one card with k > 1 the turn is its counterpart on
Hopper, for either source of batches: one step (the raw batch →
:func:`prepare_body` → the agent's ``step``) captured once as a CUDA graph
(``ssp_torch.graphs``) and replayed k times, each replay after its own host
inputs (:func:`prepare_prologue`'s homographies and warp plans, and on the
host loader's path the loader's batch, whose readers pad the points to a
fixed K, under ``raw.<key>``), copied in through the graph's pinned slots,
and followed by the schedule's step; the device corpus's batch is sampled
inside the graph.  The first :data:`ssp_torch.graphs.WARMUP` steps run
eagerly and count, so a run equals the same run with ``eager=True`` (the
constructor's keyword: the same loop, every step eager) bit for bit: both
make the optimizer capturable
(:meth:`~ssp_torch.train.state.TrainState.set_capturable`), which no other
loop does.  The turn stays eager on the CPU and with several training ranks
(gloo's collectives cannot be captured, and NCCL across cards is untried
without a machine of several cards).

Validation telemetry, as the JAX trainer's: ``val_residual_diagnostic: true``
adds the soft-argmax residual error at the label points
(``val_subpix_residual_err``) and a histogram of the predicted offsets; the
first validation image and its warped view are logged as heatmap overlays
and NMS detections (``ssp_torch.utils.draw``; the NMS kernel on the card).
Neither ever stops training: a failure is logged and the run goes on.
``profile: {enable, logdir, steps}`` writes a ``torch.profiler`` trace of
the ``steps`` steps after the second to ``logdir`` (``<exper>/profile``),
with the loop's spans (``ssp.train.*``, :meth:`TrainAgent.dispatch`).

Data parallelism: in a process group of W ranks (``ssp_torch.parallel``,
started by ``python -m ssp_torch.cli.train`` under torchrun with
``SSP_DISTRIBUTED``) each rank trains a replica on ``real_batch_size / W``
rows of every global batch: the loader's batch split by
:func:`~ssp_torch.parallel.shard_rows`, or, with the device corpus (which
each card holds whole, as the JAX package replicates it), rows each rank
samples itself.  The step is the global batch's (``ssp_torch.train.step``:
global normalisers and BatchNorm moments, gradients and metrics summed over
the ranks; with accumulation each rank's rows split into the r
micro-batches and only the last reduces), and validation reports the
global batch's metrics.  Where the world size W does not divide the global
batch, the run trains, as the JAX trainer's mesh does, on the largest n ≤ W
that divides it: ranks 0..n−1 form the training group
(:func:`~ssp_torch.parallel.training_group`), every collective of the loop,
the step and validation goes over it (:func:`~ssp_torch.parallel.scope`),
and ranks n..W−1 are idle: they build nothing, draw and write nothing, and
wait for the others when the process group is left.  Rank r's generators are
seeded with ``seed + 1 + r``, so
the ranks' draws are not the single process's (nor are the port's
``jax.random``'s).  Rank 0 alone writes the configuration, the metrics, the
checkpoints, the validation images and the profile; every rank starts from
the same weights and resumes from the same checkpoint.
"""

from __future__ import annotations

import copy
import functools
import logging
import resource
import signal
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ssp_torch._device import resolve_device, to_device
from ssp_torch.core.grid import flatten_detection
from ssp_torch.data.device_corpus import DeviceCorpus
from ssp_torch.data.pipeline import prepare_batch, prepare_body, prepare_prologue
from ssp_torch.graphs import WARMUP, CapturedRegion
from ssp_torch.losses.subpixel import subpixel_residual_loss
from ssp_torch.models.superpoint import build_model
from ssp_torch.parallel import mesh
from ssp_torch.postprocess.points import extract_keypoints, soft_argmax_refine
from ssp_torch.registry import register
from ssp_torch.trace import span
from ssp_torch.train.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ssp_torch.train.state import TrainState
from ssp_torch.train.step import accum_train_step, eval_step, global_totals, train_step
from ssp_torch.utils.config import dict_update
from ssp_torch.utils.experiment import ExperimentPaths, MetricsLogger

log = logging.getLogger(__name__)

DEFAULT_CONFIG: Dict[str, Any] = {
    "train_iter": 170000,
    "save_interval": 2000,
    "tensorboard_interval": 200,
    "validation_interval": 1000,
    "validation_size": 4,
    "model": {
        "batch_size": 16,
        "eval_batch_size": 16,
        "learning_rate": 0.001,
        "detector_loss": {"loss_type": "softmax"},
        "lambda_loss": 1,
        "multi_task_loss": False,
        "dense_loss": {"enable": False, "params": {}},
        "sparse_loss": {"enable": True, "params": {}},
    },
    "data": {
        "semantic": False,
        "ignore_class": 133,
        "gaussian_label": {"enable": False, "params": {}},
        "augmentation": {"photometric": {"enable": False}, "homographic": {"enable": False}},
        "warped_pair": {"enable": False},
    },
}


def precision_recall(heatmap: np.ndarray, labels: np.ndarray, thresh: float = 0.015):
    """Thresholded-heatmap precision and recall against the binary label map
    (reference ``batch_precision_recall``)."""
    pred = (heatmap >= thresh).astype(np.float32)
    lab = (labels > 0).astype(np.float32)
    tp = (pred * lab).sum()
    return float(tp / max(pred.sum(), 1e-6)), float(tp / max(lab.sum(), 1e-6))


def hits(n0: int, n1: int, interval: int, lo: int = 0) -> bool:
    """True iff a multiple of ``interval`` lies in ``[max(n0, lo), n1)``: the
    window a step advanced ``n_iter`` through crossed a boundary."""
    a = max(n0, lo)
    if n1 <= a or interval <= 0:
        return False
    return (n1 - 1) // interval >= -(-a // interval)


def boundary(n_iter: int, interval: int) -> int:
    """The largest multiple of ``interval`` below ``n_iter``: the label of
    an event whose window ended at ``n_iter``."""
    return ((n_iter - 1) // interval) * interval


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _on_training_group(method):
    """Run ``method`` with the agent's training group as the group that
    ``ssp_torch.parallel`` reads."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with mesh.scope(self.group):
            return method(self, *args, **kwargs)
    return run


@register("agent", "Train_model_heatmap", "Train_model_heatmap_all", "Train_model_frontend",
          "Train_model_frontend_all")
class TrainAgent:
    def __init__(self, config: Dict[str, Any], save_path: Optional[ExperimentPaths] = None,
                 exper_name: str = "exp", *, device="cuda", eager: bool = False):
        self.config = dict_update(copy.deepcopy(DEFAULT_CONFIG), config)
        self.device = resolve_device(device)
        self.eager = eager
        m = self.config["model"]
        self.batch_size = int(m["batch_size"])
        self.real_batch_size = int(m.get("real_batch_size", self.batch_size))
        self.r = max(self.real_batch_size // self.batch_size, 1)
        W, self.rank = mesh.world(), mesh.rank()
        # ranks 0..world-1 train; their numbers are the same in either group
        self.group, self.world = mesh.training_group(self.real_batch_size)
        self.idle = self.rank >= self.world
        if self.world < W:
            log.warning("a global batch of %d does not split over %d ranks: ranks 0..%d train "
                        "(the largest count that divides it)", self.real_batch_size, W,
                        self.world - 1)
        if self.idle:
            log.warning("rank %d is idle: it waits for the training ranks at the end",
                        self.rank)
            return
        self.local_batch = self.real_batch_size // self.world
        for k in ("train_iter", "validation_interval", "tensorboard_interval", "save_interval"):
            self.config[k] = int(self.config[k]) * self.r
        # reference-exact micro-batch accumulation (summed gradients, BatchNorm
        # statistics per micro-batch); otherwise the real batch is one batch
        self.accumulate = bool(m.get("exact_accumulation", False)) and self.r > 1
        if self.accumulate:
            if self.local_batch % self.r:
                raise ValueError(f"{self.local_batch} rows per rank ({self.world} ranks) do not "
                                 f"split into {self.r} micro-batches")
            log.info("exact gradient accumulation: r=%d micro-batches", self.r)
        self.steps_per_dispatch = spd = max(int(self.config.get("steps_per_dispatch", 1)), 1)
        if spd > 1:
            # the JAX trainer's alignment of the intervals to its stride, so
            # that events fall on the same boundaries
            stride = self.r * spd
            for k in ("validation_interval", "tensorboard_interval", "save_interval"):
                v = int(self.config[k])
                self.config[k] = max(((v + stride - 1) // stride) * stride, stride)
            log.info("steps_per_dispatch %d: %d steps per loop turn, intervals aligned to %d",
                     spd, spd, stride)

        self.exper = save_path or ExperimentPaths(exper_name)
        if self.rank == 0:
            self.exper.dump_config(self.config)
        self.n_iter = 0
        self.max_iter = self.config["train_iter"]
        self._val_logger: Optional[MetricsLogger] = None
        with mesh.scope(self.group):
            self._build()
        self.train_loader: Optional[Iterator] = None
        self.val_loader: Optional[Iterator] = None
        self.device_corpus: Optional[DeviceCorpus] = None
        self.loader_wait_s = 0.0  # the host's wait for train_loader's batches
        # the captured step of the graphed loop, and the eager steps made
        # before its capture
        self.region: Optional[CapturedRegion] = None
        self._warm_steps = 0

    # -- construction -------------------------------------------------
    def _build(self) -> None:
        m = self.config["model"]
        data = self.config["data"]
        seed = int(self.config.get("seed", 0))
        params = dict(m.get("params") or {})
        params.setdefault("dtype", "bfloat16")  # the flax module's default compute type
        self.model = build_model(m["name"], device=self.device,
                                 generator=torch.Generator().manual_seed(seed), **params).train()
        self.semantic = bool(data.get("semantic", False))
        self.warped_pair = bool(data.get("warped_pair", {}).get("enable", False))
        self.state = TrainState.create(self.model, learning_rate=float(m["learning_rate"]),
                                       max_steps=max(self.max_iter // self.r, 1))

        if m.get("dense_loss", {}).get("enable"):
            p = dict(m["dense_loss"].get("params") or {})
            desc_loss, desc_params = "dense", {"lambda_d": p.get("lambda_d", 250),
                                               "descriptor_dist": p.get("descriptor_dist", 4)}
        else:
            p = dict(m.get("sparse_loss", {}).get("params") or {})
            desc_loss, desc_params = "sparse", {
                "num_matching_attempts": int(p.get("num_matching_attempts", 1000)),
                "num_masked_non_matches_per_match": int(
                    p.get("num_masked_non_matches_per_match", 100)),
                "lamda_d": float(p.get("lamda_d", 1.0)),
                "method": p.get("method", "2d"),
            }
        self.step_kwargs = dict(
            semantic=self.semantic,
            warped_pair=self.warped_pair,
            det_loss_type=m.get("detector_loss", {}).get("loss_type", "softmax"),
            desc_loss=desc_loss,
            desc_params=desc_params,
            lambda_loss=float(m.get("lambda_loss", 1)),
            multi_task=bool(m.get("multi_task_loss", False)),
            ignore_class=int(data.get("ignore_class", 133)),
            sem_fused=bool(m.get("fused_semantic_ce", True)),
        )

        aug = data.get("augmentation", {})
        gl = data.get("gaussian_label", {})
        sigma = None
        if gl.get("enable"):
            sigma = float(gl.get("params", {}).get("GaussianBlur", {}).get("sigma", 0.2))
        common = dict(warped_pair=data.get("warped_pair", {}), gaussian_label_sigma=sigma,
                      ignore_class=int(data.get("ignore_class", 133)),
                      sem_warp_mode=data.get("sem_warp_mode", "bilinear"))
        self.prep_train = dict(common, photometric=self._photo_cfg(aug.get("photometric", {}),
                                                                   "train"),
                               homographic=aug.get("homographic", {}))
        self.prep_val = dict(common, photometric=self._photo_cfg(aug.get("photometric", {}), "val"),
                             homographic=self._val_homographic(aug.get("homographic", {})))
        # homographies on the host (the two-pass warp reads them there); the
        # photometric values and the descriptor samples on the device
        self.host_generator = torch.Generator().manual_seed(seed + 1 + self.rank)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1 + self.rank)

        pretrained = self.config.get("pretrained")
        if not pretrained and self.config.get("auto_resume", True) \
                and not self.config.get("retrain", False):
            # relaunching into an experiment that has checkpoints continues it
            prev = latest_checkpoint(self.exper.checkpoints)
            if prev is not None:
                log.warning("auto-resuming from %s (auto_resume)", prev)
                load_checkpoint(prev, self.state, mode="full")
                self.n_iter = self.state.step * self.r
        elif pretrained and not self.config.get("retrain", False):
            reset = bool(self.config.get("reset_iter", True))
            mode = "weights" if reset else "full"
            log.info("loading pretrained %s (mode=%s)", pretrained, mode)
            load_checkpoint(pretrained, self.state, mode=mode, reset_iter=reset)
            self.n_iter = self.state.step * self.r
        mesh.barrier()  # every rank has read its checkpoint before rank 0 writes one

    def attach_device_corpus(self, dataset) -> None:
        """Upload ``dataset`` to the device (``training.device_corpus_quantize``
        stores its images as uint8); the training stream then samples the
        real batch there instead of reading ``train_loader``."""
        quantize = bool((self.config.get("training") or {}).get("device_corpus_quantize", False))
        self.device_corpus = DeviceCorpus.from_dataset(dataset, device=self.device,
                                                       quantize=quantize)
        log.info("device corpus attached: %d samples, %s", self.device_corpus.n,
                 {k: (tuple(v.shape), str(v.dtype)) for k, v in self.device_corpus.arrays.items()})

    def next_batch(self) -> Dict[str, Any]:
        """This rank's rows of the next training batch before preparation:
        sampled from the device corpus when one is attached, else its share of
        the global batch that ``train_loader`` reads."""
        if self.device_corpus is not None:
            return self.device_corpus.sample(self.local_batch, self.generator)
        with span("ssp.train.loader_wait"):
            t0 = time.perf_counter()
            batch = next(self.train_loader)
            self.loader_wait_s += time.perf_counter() - t0
        return mesh.shard_rows(batch, self.world, self.rank)

    @staticmethod
    def _photo_cfg(cfg: Dict[str, Any], split: str) -> Dict[str, Any]:
        cfg = dict(cfg)
        enable_key = f"enable_{split}"
        if enable_key in cfg:
            cfg["enable"] = bool(cfg.get("enable", False)) and bool(cfg[enable_key])
        return cfg

    @staticmethod
    def _val_homographic(cfg: Dict[str, Any]) -> Dict[str, Any]:
        cfg = dict(cfg)
        if "enable_val" in cfg:
            cfg["enable"] = bool(cfg.get("enable", False)) and bool(cfg["enable_val"])
        return cfg

    def prepare(self, host_batch: Dict[str, np.ndarray], *, train: bool = True,
                **kwargs) -> Dict[str, torch.Tensor]:
        """A raw batch (``ImageDataset.batches`` on the host, or the device
        corpus's) → the training batch on the device; ``kwargs`` go to
        ``prepare_batch`` (``draws``, ``warp``, ``reference``)."""
        dev = self.device

        def put(key, dtype):
            return to_device(torch.as_tensor(host_batch[key], dtype=dtype), dev)

        sem = put("sem", torch.int32) if self.semantic else None
        return prepare_batch(put("image", torch.float32), put("points", torch.float32),
                             put("points_valid", torch.bool), sem=sem,
                             generator=self.generator, host_generator=self.host_generator,
                             **(self.prep_train if train else self.prep_val), **kwargs)

    # the host loader's keys that a training step reads, at the types it reads
    _RAW = {"image": torch.float32, "points": torch.float32, "points_valid": torch.bool,
            "sem": torch.int32}

    def _region_step(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One training step from its host inputs (:meth:`_inputs`; the region
        a CUDA graph captures, where they are its static inputs on the card):
        the raw batch, sampled from the device corpus or the loader's under
        ``raw.<key>``, then :func:`prepare_body` and the agent's ``step``."""
        if self.device_corpus is not None:
            raw = self.device_corpus.sample(self.local_batch, self.generator)
        else:
            raw = {k[4:]: to_device(v, self.device) for k, v in inputs.items()
                   if k.startswith("raw.")}
        prologue = {k: v for k, v in inputs.items() if not k.startswith("raw.")}
        sem = raw["sem"].to(torch.int32) if self.semantic else None
        batch = prepare_body(raw["image"].float(), raw["points"].float(),
                             raw["points_valid"].bool(), prologue, sem=sem,
                             generator=self.generator, **self.prep_train)
        return self.step(batch)

    def _prologue(self, hw) -> Dict[str, torch.Tensor]:
        """The host's part of the preparation of the next training batch of
        images of ``hw`` (H, W)."""
        with span("ssp.train.prologue"):
            return prepare_prologue(self.local_batch, tuple(hw), self.device,
                                    homographic=self.prep_train["homographic"],
                                    warped_pair=self.prep_train["warped_pair"],
                                    host_generator=self.host_generator)

    def _inputs(self) -> Dict[str, torch.Tensor]:
        """The next training step's host inputs, CPU tensors of fixed shapes:
        its prologue and, on the host loader's path, this rank's rows of the
        loader's next batch under ``raw.<key>``."""
        if self.device_corpus is not None:
            return self._prologue(self.device_corpus.arrays["image"].shape[1:])
        host = self.next_batch()
        keys = [k for k in self._RAW if k != "sem" or self.semantic]
        raw = {f"raw.{k}": torch.as_tensor(host[k], dtype=self._RAW[k]) for k in keys}
        return dict(self._prologue(host["image"].shape[1:]), **raw)

    def graphable(self) -> bool:
        """True where a loop turn can replay a captured step (module
        docstring), with ``eager=True`` too."""
        return self.device.type == "cuda" and self.world == 1 and self.steps_per_dispatch > 1

    def graphed(self) -> bool:
        """True where a loop turn replays a captured step."""
        return self.graphable() and not self.eager

    @_on_training_group
    def dispatch(self) -> Dict[str, torch.Tensor]:
        """One loop turn: ``steps_per_dispatch`` steps; the last one's
        metrics.  Its spans (``ssp_torch.trace``, host side only) are the
        turn, the loader's wait, the prologue, the static inputs' load and
        each replay or eager step."""
        with span("ssp.train.dispatch"):
            self.state.set_capturable(self.graphable())
            for _ in range(self.steps_per_dispatch):
                inputs = self._inputs()
                if not self.graphed():
                    with span("ssp.train.step"):
                        metrics = self._region_step(inputs)
                    continue
                if self.region is None:
                    self.region = CapturedRegion(self._region_step, inputs, device=self.device,
                                                 generators=[self.generator])
                    log.info("the training step (%s) runs as a CUDA graph, %d replays per loop "
                             "turn, after %d eager steps", "device corpus" if self.device_corpus
                             is not None else "host loader", self.steps_per_dispatch, WARMUP)
                with span("ssp.train.load"):
                    self.region.load(inputs)
                if self._warm_steps < WARMUP:
                    with span("ssp.train.step"):
                        metrics = self.region.eager()
                    self._warm_steps += 1
                    continue
                if self.region.graph is None:
                    self.region.capture()
                with span("ssp.train.replay"):
                    metrics = self.region.replay()
                self.state.finish_update()
            # a replay's outputs are its static buffers: the next one overwrites them
            return {k: v.clone() for k, v in metrics.items()}

    # -- steps ----------------------------------------------------------
    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update on a prepared batch: the accumulated step with
        ``exact_accumulation`` and r > 1, else the plain one."""
        if self.accumulate:
            return accum_train_step(self.state, batch, self.r, generator=self.generator,
                                    **self.step_kwargs)
        return train_step(self.state, batch, generator=self.generator, **self.step_kwargs)

    def eval_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The metrics of a prepared validation batch (running statistics)."""
        return eval_step(self.state, batch, generator=self.generator, **self.step_kwargs)

    # -- loop ---------------------------------------------------------
    @_on_training_group
    def train(self) -> None:
        if self.idle:
            return
        if self.train_loader is None and self.device_corpus is None:
            raise ValueError("set train_loader or attach a device corpus first")
        rank0 = self.rank == 0
        logger = MetricsLogger(self.exper, "train") if rank0 else None
        tb_int = self.config["tensorboard_interval"]
        val_int = self.config["validation_interval"]
        save_int = self.config["save_interval"]
        interrupted = {"flag": False}
        prev_handler = signal.signal(signal.SIGINT, lambda *_: interrupted.update(flag=True))
        # host-memory watchdog: past the budget (85% of MemTotal unless
        # rss_budget_mb says otherwise; 0 disables) the trainer checkpoints
        # and raises instead of being killed without a checkpoint
        budget_mb = self.config.get("rss_budget_mb")
        if budget_mb is None:
            try:
                with open("/proc/meminfo") as f:
                    budget_mb = 0.85 * int(f.readline().split()[1]) / 1024.0
            except OSError:
                budget_mb = 0
        budget_mb = float(budget_mb)

        # a torch.profiler trace of the steps after the second (profile:
        # {enable: true, logdir: ..., steps: N})
        prof_cfg = self.config.get("profile", {}) or {}
        prof = None
        prof_done = not prof_cfg.get("enable") or not rank0

        if self.steps_per_dispatch > 1 and self.device.type == "cuda" and not self.graphed():
            why = ("eager=True" if self.eager else
                   f"{self.world} ranks: collectives between ranks are not captured")
            log.info("steps_per_dispatch %d: every step runs eagerly (%s)",
                     self.steps_per_dispatch, why)
        t0 = time.time()
        n_last_log = self.n_iter
        try:
            while self.n_iter < self.max_iter and not interrupted["flag"]:
                n0 = self.n_iter
                if not prof_done and prof is None and n0 >= 2 * self.r:
                    prof = self._start_profile()
                metrics = self.dispatch()
                self.n_iter = n0 + self.r * self.steps_per_dispatch
                if prof is not None and self.n_iter >= (2 + int(prof_cfg.get("steps", 5))) * self.r:
                    self._stop_profile(prof, Path(prof_cfg.get("logdir",
                                                               self.exper.root / "profile")))
                    prof, prof_done = None, True

                if hits(n0, self.n_iter, tb_int):
                    scal = {k: float(v) for k, v in metrics.items()}
                    scal["iters_per_s"] = ((self.n_iter - n_last_log) / max(time.time() - t0, 1e-9)
                                           if n0 else 0.0)
                    scal["host_rss_mb"] = rss_mb()
                    over = bool(budget_mb and scal["host_rss_mb"] > budget_mb)
                    if self.world > 1:  # one rank over its budget stops every rank
                        flag = torch.full((), float(over), device=self.device)
                        over = bool(mesh.global_sum(flag) > 0)
                    if over:
                        if rank0:
                            save_checkpoint(self.exper.checkpoints, self.state, self.n_iter)
                        raise RuntimeError(
                            f"host RSS {scal['host_rss_mb']:.0f} MB exceeds the "
                            f"{budget_mb:.0f} MB budget at iter {self.n_iter}; checkpoint saved: "
                            f"resume with pretrained: {self.exper.checkpoints}/"
                            f"superPointNet_{self.n_iter}.pth.tar")
                    t0 = time.time()
                    n_last_log = self.n_iter
                    b = boundary(self.n_iter, tb_int)
                    if rank0:
                        logger.log(b, scal)
                        log.info("iter %d loss %.4f det %.4f desc %.4f", b, scal["loss"],
                                 scal["loss_det"], scal["loss_desc"])
                if val_int and self.val_loader is not None and hits(n0, self.n_iter, val_int):
                    self._validate(label=boundary(self.n_iter, val_int))
                if rank0 and hits(n0, self.n_iter, save_int, lo=1):
                    save_checkpoint(self.exper.checkpoints, self.state,
                                    boundary(self.n_iter, save_int))
        finally:
            signal.signal(signal.SIGINT, prev_handler)
            if prof is not None:
                prof.__exit__(None, None, None)
            if rank0:
                save_checkpoint(self.exper.checkpoints, self.state, self.n_iter)
                logger.close()
            if self._val_logger is not None:
                self._val_logger.close()
                self._val_logger = None

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, logdir: Path) -> None:
        """Wait for the card, stop ``prof`` and write its Chrome trace as
        ``<logdir>/trace_<n_iter>.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        logdir.mkdir(parents=True, exist_ok=True)
        path = logdir / f"trace_{self.n_iter}.json"
        prof.export_chrome_trace(str(path))
        log.info("profile of iterations up to %d written to %s", self.n_iter, path)

    @_on_training_group
    def _validate(self, label: Optional[int] = None) -> Dict[str, float]:
        """The mean of each metric over ``validation_size + 1`` validation
        batches (running BatchNorm statistics), logged with the ``val_``
        prefix at ``label`` (``n_iter`` without one), with the residual
        diagnostic (``val_residual_diagnostic``) and the first batch's
        images.  On several ranks every rank validates its rows of each batch,
        the metrics are the global batch's, and rank 0 logs them and draws its
        first image."""
        rank0 = self.rank == 0
        if self._val_logger is None and rank0:
            self._val_logger = MetricsLogger(self.exper, "val")
        logger = self._val_logger
        step_label = self.n_iter if label is None else label
        n_batches = int(self.config.get("validation_size", 4)) + 1
        agg: Dict[str, list] = {}
        first_batch = None
        for i in range(n_batches):
            batch = self.prepare(mesh.shard_rows(next(self.val_loader), self.world, self.rank),
                                 train=False)
            if i == 0:
                first_batch = batch
            for k, v in self.eval_batch(batch).items():
                agg.setdefault(k, []).append(float(v))
        scalars = {k: float(np.mean(v)) for k, v in agg.items()}
        if first_batch is not None and self.config.get("val_residual_diagnostic", False):
            diag = self.residual_diagnostic(first_batch)
            if diag is not None:
                scalars["subpix_residual_err"], offsets = diag
                if rank0:
                    logger.log_histogram(step_label, "val/subpix_residual_offsets", offsets)
        if rank0:
            logger.log(step_label, scalars, prefix="val_")
            if first_batch is not None:
                self._log_val_images(logger, first_batch, step_label)
        return scalars

    def _eval_forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The model's evaluation forward (running statistics, no gradient);
        its mode is restored after."""
        model = self.state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return model(images)
        finally:
            model.train(was_training)

    def residual_diagnostic(self, batch: Dict[str, torch.Tensor]):
        """(mean soft-argmax residual error, predicted offsets [n, 2] numpy of
        the valid points) of the batch's label points: each point rounded,
        refined on the evaluation heatmap, and held against its true
        fractional part (reference ``pred_soft_argmax`` diagnostics,
        ``Train_model_heatmap_all.py:623-675``).  None when the batch has no
        points or the diagnostic fails (it never stops training).  On several
        ranks the error is the global batch's mean and the offsets this
        rank's."""
        if "points" not in batch or "points_valid" not in batch:
            return None
        per_image = offsets = None
        try:
            heat = flatten_detection(self._eval_forward(batch["image"])["semi"])[..., 0]
            pts, valid = batch["points"], batch["points_valid"]
            r = torch.round(pts[..., :2])
            per_image = subpixel_residual_loss(heat, r, pts[..., :2] - r, valid)
            pts3 = torch.cat([r, torch.zeros_like(r[..., :1])], dim=-1)
            offsets = (soft_argmax_refine(heat, pts3)[..., :2] - r)[valid].cpu().numpy()
        except Exception:  # diagnostics must never kill training
            log.exception("residual diagnostic failed")
            per_image = None
        if self.world > 1:  # every rank joins the sum, whatever happened on its own
            zero = torch.zeros((), device=self.device)
            tot = global_totals(
                err=zero if per_image is None else per_image.sum().float(),
                n=zero if per_image is None else zero + per_image.numel(),
                failed=zero + (per_image is None))
            if float(tot["failed"]) > 0:
                return None
            return float(tot["err"] / tot["n"]), offsets
        if per_image is None:
            return None
        return float(per_image.mean()), offsets

    def _log_val_images(self, logger: MetricsLogger, batch: Dict[str, torch.Tensor],
                        step: int) -> None:
        """Heatmap and label overlay and NMS detections of the first
        validation image and of its warped view (reference TensorBoard
        images, ``Train_model_frontend_all.py:535-566``)."""
        from ssp_torch.utils.draw import draw_keypoints, img_overlap

        m = self.config["model"]
        det_thresh = float(m.get("detection_threshold", 0.015))
        nms_rad = int(m.get("nms", 4))

        def panels(images, labels, tag):
            heat_t = flatten_detection(self._eval_forward(images[:1])["semi"])[0, ..., 0]
            heat = heat_t.cpu().numpy()
            img = images[0, ..., 0].cpu().numpy()
            logger.log_image(step, f"val/{tag}_heatmap_overlay",
                             img_overlap(heat / max(float(heat.max()), 1e-6),
                                         labels[0, ..., 0].cpu().numpy(), img))
            pts, valid = extract_keypoints(heat_t.contiguous(), k=300, conf_thresh=det_thresh,
                                           nms_radius=nms_rad)
            logger.log_image(step, f"val/{tag}_nms_detections",
                             draw_keypoints(img, pts[valid].cpu().numpy()))

        try:
            panels(batch["image"], batch["labels_2d"], "base")
            if "warped_image" in batch:
                panels(batch["warped_image"], batch["warped_labels_2d"], "warped")
        except Exception:  # visualization must never kill training
            log.exception("val image logging failed")
