"""Device inventory and selection (``mesh``). The device mesh and the
sharded renderers (tpurt/parallel/mesh.make_mesh, shard.py) are not
ported yet (ROADMAP A.6)."""

from tpurt_torch.parallel.mesh import device_inventory, select_devices  # noqa: F401
