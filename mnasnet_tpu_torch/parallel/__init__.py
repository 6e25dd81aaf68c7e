"""Data parallelism over processes (``parallel/dist.py``): the counterpart of
``mnasnet_tpu/parallel/``."""

from mnasnet_tpu_torch.parallel.dist import (
    Flag,
    ReplicaMismatch,
    Replicas,
    all_reduce_max_,
    all_reduce_sum,
    all_reduce_sum_,
    assert_replicated,
    barrier,
    broadcast_,
    broadcast_seed,
    broadcast_state_,
    close,
    global_rows,
    init_distributed,
    rank,
    state_tensors,
    world_size,
)

__all__ = [
    "Flag",
    "ReplicaMismatch",
    "Replicas",
    "all_reduce_max_",
    "all_reduce_sum",
    "all_reduce_sum_",
    "assert_replicated",
    "barrier",
    "broadcast_",
    "broadcast_seed",
    "broadcast_state_",
    "close",
    "global_rows",
    "init_distributed",
    "rank",
    "state_tensors",
    "world_size",
]
