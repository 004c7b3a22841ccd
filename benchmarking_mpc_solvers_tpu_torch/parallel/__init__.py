from .mesh import (  # noqa: F401
    BATCH_AXIS,
    SAMPLE_AXIS,
    Mesh,
    make_mesh,
    shard_batch,
    sharded_episodes,
    sharded_episodes_kernel,
)
from .mppi_sharded import make_sharded_mppi_step  # noqa: F401
from .distributed import distributed_init, global_mesh, global_stats  # noqa: F401
