from repro_torch.distributed.sharding import (  # noqa: F401
    AxisRules,
    MeshShape,
    axis_rules,
    current_rules,
    device_mesh,
    logical_to_spec,
    shard,
    spec_for_axes,
)
