from repro_torch.distributed.sharding import (  # noqa: F401
    AxisRules,
    MeshShape,
    axis_group,
    axis_rules,
    current_rules,
    device_mesh,
    logical_to_spec,
    mesh_shape,
    partitioned,
    placements_of,
    shard,
    spec_for_axes,
)
