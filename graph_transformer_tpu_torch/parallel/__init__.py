"""The parallel layer on ``torch.distributed`` — port of
``graph_transformer_tpu/parallel/``: the (data, model) mesh of ranks, the
multi-process bootstrap and launcher, the sharded (GSPMD-like) step, the
edge- and node-partitioned steps with their halo exchange, and the
four-regime dry run (``dryrun.py``)."""

from graph_transformer_tpu_torch.parallel.edge_partition import (
    HaloPlan,
    build_halo_plan,
    halo_cost_model,
    halo_gather,
    init_halo_unsup_params,
    make_halo_train_step,
    make_shard_map_train_step,
    partition_graphs_by_edges,
)
from graph_transformer_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from graph_transformer_tpu_torch.parallel.spmd import (
    batch_pspec,
    make_spmd_train_step,
    param_pspec,
    shard_batch,
    shard_params,
)

__all__ = [
    "HaloPlan",
    "build_halo_plan",
    "halo_cost_model",
    "halo_gather",
    "init_halo_unsup_params",
    "make_halo_train_step",
    "make_shard_map_train_step",
    "partition_graphs_by_edges",
    "make_mesh",
    "mesh_shape_for",
    "batch_pspec",
    "param_pspec",
    "shard_batch",
    "shard_params",
    "make_spmd_train_step",
]
