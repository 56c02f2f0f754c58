"""Data parallelism over processes: a process group with one rank per card
(mirrors ``ssp/parallel``)."""

from ssp_torch.parallel.mesh import (  # noqa: F401
    all_reduce_sum,
    barrier,
    global_sum,
    init_distributed,
    is_rank0,
    rank,
    reduce_sum_,
    scope,
    shard_rows,
    shutdown,
    training_group,
    world,
)
