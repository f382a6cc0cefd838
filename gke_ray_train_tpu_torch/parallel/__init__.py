"""parallel/ — the mesh, tensor parallelism, FSDP2 sharding and per-rank
input placement (counterpart of ``gke_ray_train_tpu/parallel/``, its
``data``, ``fsdp``, ``model``, ``context`` and ``pipe`` axes, and the
slices of ``data``: ``hierarchical.py``)."""

from gke_ray_train_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_CONTEXT, AXIS_DATA, AXIS_FSDP, AXIS_MODEL, AXIS_PIPE, BATCH_AXES,
    MESH_AXES, MeshConfig, batch_group_size, batch_groups, batch_rank,
    build_mesh, context_group, context_rank, context_size, distributed_init,
    is_distributed, local_rank, mesh_config_of, model_rank, num_slices_of,
    pipe_group, pipe_rank, pipe_size, slice_assignments, slice_groups,
    stage_group, token_groups)
