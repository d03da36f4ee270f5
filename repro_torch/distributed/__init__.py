"""Distribution layer (counterpart of ``repro.distributed``): the
sharding rules and the collectives over ``torch.distributed``."""

from .sharding import (  # noqa: F401
    MeshLayout,
    batch_specs,
    cache_spec_overrides,
    dp_axes,
    dp_entry,
    dp_size,
    local_shape,
    map_with_path,
    mesh_axis_names,
    mesh_sizes,
    param_specs,
    tp_axis,
    tree_bytes_per_device,
)
from .collectives import bucketed, compressed_psum, ring_all_reduce, unbucketed  # noqa: F401
