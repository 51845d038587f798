"""Device inventory and selection, the device mesh (``mesh``) and frames
rendered over it (``shard``)."""

from tpurt_torch.parallel.mesh import (  # noqa: F401
    SAMPLE_AXIS, TILE_AXIS, Mesh, device_inventory, make_mesh, mesh_info,
    select_devices)
from tpurt_torch.parallel.shard import render_frame_sharded  # noqa: F401
