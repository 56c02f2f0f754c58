"""Data parallelism over processes (port of ``ssp/parallel/mesh.py``).

The JAX package shards each batch over a 1-D ``data`` mesh of devices and
lets GSPMD insert the reductions: BatchNorm moments and losses over the
global batch, the gradient all-reduce.  The counterpart here is a
``torch.distributed`` process group with one rank per card, started by
``torchrun``: each rank holds a replica of the model and its rows of the
global batch, and the reductions are explicit collectives.

* :func:`init_distributed` joins the group from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and puts the rank on ``cuda:LOCAL_RANK`` (NCCL) or on the
  CPU (gloo).  Several ranks on one card need gloo: NCCL refuses two ranks
  on one device, and gloo's ``all_reduce`` and ``broadcast`` take CUDA
  tensors (its ``all_gather`` does not, so nothing here uses it).
* :func:`world` and :func:`rank` read the default group: 1 and 0 without
  one, so single-process code is unchanged.
* :func:`shard_rows` splits a batch by rows as ``shard_batch`` shards it.
* :func:`all_reduce_sum` is the differentiable sum over the ranks (its
  backward sums the gradients over the ranks); :func:`global_sum` the
  detached one; :func:`reduce_sum_` sums gradients and metrics in place,
  one collective per dtype.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ssp_torch._device import resolve_device

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group described by torchrun's environment and return
    this rank's device: ``cuda:LOCAL_RANK`` for a CUDA ``device``, else the
    CPU.  ``backend`` defaults to NCCL on a card and gloo on the CPU; pass
    ``"gloo"`` to run several ranks on one card."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"a distributed run needs {', '.join(missing)} in the environment "
                           f"(launch it with torchrun)")
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank_, world_size=world_)
    return dev


def shutdown() -> None:
    """Wait for every rank, then leave the process group (if one was
    joined).  Call it when the work is done: a rank that leaves while another
    still talks to it aborts (gloo)."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() > 1:
            dist.barrier()
        dist.destroy_process_group()


def world() -> int:
    """The number of ranks of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_rank0() -> bool:
    """True on the rank that writes the run's files."""
    return rank() == 0


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def shard_rows(batch: Dict[str, Any], world_: int, rank_: int) -> Dict[str, Any]:
    """Rank ``rank_``'s rows of ``batch`` (a dict of arrays or tensors): a
    leaf whose first dimension ``world_`` divides is split into ``world_``
    consecutive blocks, any other leaf is kept whole (each rank then computes
    it in full, as ``shard_batch`` replicates it)."""
    def part(x):
        n = x.shape[0] if getattr(x, "ndim", 0) else 0
        if world_ == 1 or n == 0 or n % world_:
            return x
        b = n // world_
        return x[rank_ * b:(rank_ + 1) * b]

    return {k: part(v) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks; its gradient is the Σ over the ranks of the
    incoming gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ of ``t`` over the ranks, differentiable: the backward sums the
    incoming gradients over the ranks.  ``t`` itself with one rank."""
    return t if world() == 1 else _AllReduceSum.apply(t)


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ of ``t`` over the ranks, detached (a new tensor; ``t`` with one
    rank)."""
    if world() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its Σ over the ranks, in place: one flat
    ``all_reduce`` per dtype and device."""
    if world() == 1:
        return
    groups: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

