"""Data parallelism (counterpart of `pdm_ssd_tpu/parallel`): see `ddp`."""
from .ddp import (  # noqa: F401
    broadcast_from_rank0, check_held, gather_to_rank0, global_count, global_sum,
    init_distributed, is_distributed, padded_size, rank, rank_rows, shard_indices, shutdown,
    spawn, sync_sum, unwrap, world_size, wrap_model,
)
