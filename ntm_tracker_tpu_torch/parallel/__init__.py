from ntm_tracker_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    parallel_train_step,
)
