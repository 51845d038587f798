"""Mesh picking: which mesh is under a screen coordinate (port of
tpurt/render/pick.py).

Counterpart of the checkIntersectingRay kernel (src/Trace.cl:655-699),
which the reference's (bit-rotted) viewer dispatched 1x1 on mouse
clicks to tint the picked mesh (main.cpp:385-469). Semantics preserved:
backface culling ONLY for OneSided meshes (Trace.cl:684 — note this
differs from the render path's cull policy), no other backface
rejection, closest world-space hit wins, -1 when nothing is under the
cursor. Vectorised: pass many uv coords at once. Host-side glue over
the modular engine's plain intersection steps, on the scene's device;
it launches no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.core import v3 as v3lib
from tpurt_torch.core.camera import Camera, make_ray
from tpurt_torch.render.intersect import (
    _EPS, _bruteforce_range, _bvh_traverse, _finalize_local, _mesh_frame,
    _rotate, local_rays)
from tpurt_torch.scene.types import MaterialType, Scene


def pick_mesh(scene: Scene, camera: Camera, uv,
              bruteforce_threshold: int = 4096) -> torch.Tensor:
    """uv: (..., 2) in [0,1]^2 -> (...,) int32 mesh index or -1, on the
    scene's device."""
    uv = torch.as_tensor(np.asarray(uv, np.float32), device=scene.device)
    ro, rd = make_ray(camera, uv)
    o = v3lib.from_rows(ro.reshape(-1, 3))
    d = v3lib.from_rows(rd.reshape(-1, 3))
    r = o.x.shape[0]
    best_dst = torch.full((r,), float("inf"), device=scene.device)
    best_mesh = torch.full((r,), -1, dtype=torch.int32, device=scene.device)
    for i, (first, count) in enumerate(scene.mesh_tri_ranges):
        rot, pos, scale = _mesh_frame(scene, i)
        lo, ld = local_rays(scene, i, o, d)
        # Picking culls backfaces ONLY for OneSided (Trace.cl:684).
        cull = scene.mesh_mat_types[i] == int(MaterialType.ONE_SIDED)
        if count <= bruteforce_threshold:
            lb = _bruteforce_range(scene, lo, ld, first, count, cull)
        else:
            lb = _bvh_traverse(
                scene, int(scene.mesh_root[i]), lo, ld, cull, scene.max_leaf_tris,
                scene.mesh_qmin[i].cpu().numpy(), scene.mesh_qscale[i].cpu().numpy())
        valid, point_l, _n, _back = _finalize_local(scene, lo, ld, lb, cull)
        if not scale > _EPS:
            valid = torch.zeros_like(valid)
        point_w = _rotate(rot, point_l * scale) + pos
        dst = v3lib.length(point_w - o)
        closer = valid & (dst < best_dst)
        best_dst = torch.where(closer, dst, best_dst)
        best_mesh = torch.where(closer, i, best_mesh)
    return best_mesh.reshape(uv.shape[:-1])
