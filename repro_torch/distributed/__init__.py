"""Distribution layer (counterpart of ``repro.distributed``): the
sharding rules, the collectives over ``torch.distributed`` and their
execution as tensor, expert and fully-sharded parallelism."""

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
from .tensor_parallel import (  # noqa: F401
    Placement,
    copy_to,
    gather_from,
    gather_leaf,
    mesh_axes,
    reduce_from,
)
