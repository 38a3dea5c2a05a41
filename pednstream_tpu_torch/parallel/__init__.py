"""Multi-device scaling over ``torch.distributed`` (the counterpart of
``pednstream_tpu/parallel``): replica data parallelism (``mesh``) and
link-axis state sharding (``link_shard``)."""

from .mesh import (
    BlockDraws,
    Mesh,
    all_gather,
    all_reduce_sum,
    assert_same_on_all_ranks,
    data_parallel_env_step,
    init_rank,
    make_mesh,
    make_mesh_2d,
    shard_batch,
    spawn_ranks,
    unshard_batch,
)
from .link_shard import (
    assert_no_full_ring_collectives,
    hybrid_state_shardings,
    link_params_shardings,
    link_state_shardings,
    make_hybrid_sharded_simulate,
    make_link_sharded_simulate,
    make_link_sharded_step,
    shard_hybrid_state,
    shard_link_params,
    shard_link_state,
    unshard_state,
)

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "shard_batch",
    "data_parallel_env_step",
    "link_state_shardings",
    "link_params_shardings",
    "shard_link_state",
    "shard_link_params",
    "make_link_sharded_simulate",
    "make_link_sharded_step",
    "hybrid_state_shardings",
    "shard_hybrid_state",
    "make_hybrid_sharded_simulate",
    "assert_no_full_ring_collectives",
    # what explicit SPMD adds to the single-controller names above
    "Mesh",
    "BlockDraws",
    "all_gather",
    "all_reduce_sum",
    "assert_same_on_all_ranks",
    "init_rank",
    "spawn_ranks",
    "unshard_batch",
    "unshard_state",
]
