"""Row sharding over torch.distributed (porotpu/parallel)."""

from .sharding import (
    COLLECTIVES,
    RowMesh,
    gather_vector,
    reset_collectives,
    shard_amg,
    shard_ell,
    shard_operator,
    shard_vector,
    solver_mesh,
)
