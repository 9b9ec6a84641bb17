from .data_parallel import (  # noqa: F401
    all_reduce_sum,
    init_distributed,
    mean_bn_statistics,
    mean_gradients,
    rank_and_world,
    reduce_metrics,
    replicate,
    shard_batch,
    shard_rows,
)
