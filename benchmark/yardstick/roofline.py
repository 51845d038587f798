"""The chip's peaks and the work a frame needs, for ``trace_roofline_pct``
and ``frame_mfu``.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its full
power limit of 700 W: 67e12 float32 operations a second outside the
tensor cores, 3.35e12 bytes a second of HBM. A run states the card's
power limit beside its numbers (``nvidia-smi``). Copied from
``chip_smoke.py:245-246``.

The work a frame needs is counted from the configuration and the
frame's exact path segments alone, the same whatever implements it:

    ops(frame)   = segments * (2 * ceil(log2 N) * BOX_OPS
                               + LEAF_TRIS * MT_DET_OPS + SHADE_OPS)
    bytes(frame) = T * 18 * 4 + W * H * 3 * 4
    bound(frame) = max(ops / PEAK_F32, bytes / PEAK_BYTES)

N is the configuration's mesh triangle count, T the scene's triangles
(the mesh and the box), read once as f32 positions and normals, and the
frame's f32 accumulator is written once. ``segments`` excludes the
padding lanes a launch adds past the frame's end. A segment costs a
descent of a binary tree over N triangles, two box tests a level, one
leaf of LEAF_TRIS triangles to their determinant test, and the shading
tail. The operation counts of a box test, a triangle's determinant test
and the shading tail are copied from ``chip_smoke.py:254-277``.
"""

from __future__ import annotations

import math

PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
BOX_OPS = 55
MT_DET_OPS = 21
SHADE_OPS = 25
LEAF_TRIS = 3


def ops_per_segment(n_mesh_tris: int) -> int:
    levels = math.ceil(math.log2(max(n_mesh_tris, 2)))
    return 2 * levels * BOX_OPS + LEAF_TRIS * MT_DET_OPS + SHADE_OPS


def frame_bytes(n_scene_tris: int, width: int, height: int) -> int:
    return n_scene_tris * 18 * 4 + width * height * 3 * 4


def bound_s(segments: int, frames: int, n_mesh_tris: int, n_scene_tris: int,
            width: int, height: int) -> float:
    """The least time the chip could take for ``frames`` frames holding
    ``segments`` exact path segments in all."""
    ops = segments * ops_per_segment(n_mesh_tris)
    nbytes = frames * frame_bytes(n_scene_tris, width, height)
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)
