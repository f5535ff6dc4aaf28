from word2bits_tpu_torch.parallel.mesh import make_mesh
from word2bits_tpu_torch.parallel.sharded import (
    make_sharded_train_step,
    shard_params,
)

__all__ = ["make_mesh", "make_sharded_train_step", "shard_params"]
