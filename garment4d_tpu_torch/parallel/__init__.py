"""Data parallelism on `torch.distributed`: joining the process group
(`launch.py`) and the collectives that make a step over N processes at
global batch B the single-process step at batch B (`data.py`)."""

from garment4d_tpu_torch.parallel.data import (
    average_gradients,
    broadcast_module,
    check_batch_divisible,
    local_batch_indices,
    mean_over_ranks,
    reduce_metric_sums,
    shard_batch,
    shared_seed,
)
from garment4d_tpu_torch.parallel.launch import (
    barrier,
    in_group,
    initialize_distributed,
    is_main_process,
    per_process_batch,
    rank,
    shutdown,
    world_size,
)

__all__ = ["average_gradients", "barrier", "broadcast_module", "check_batch_divisible",
           "in_group", "initialize_distributed", "is_main_process", "local_batch_indices",
           "mean_over_ranks", "per_process_batch", "rank", "reduce_metric_sums",
           "shard_batch", "shared_seed", "shutdown", "world_size"]
