"""Procedural triangle meshes: the stand-ins ``default_scene`` uses when
no OBJ is on disk, and the JSON scenes' shapes (numpy; same code and output as
tpurt/scene/procedural.py, which the port cannot import because
``tpurt.scene`` pulls in jax)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def icosphere(subdivisions: int = 3, radius: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Icosahedron subdivided ``subdivisions`` times: 20 * 4^subdivisions
    triangles with exact sphere normals, as (n,3,3) positions/normals."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        tri = verts[faces]
        mid_ab = tri[:, 0] + tri[:, 1]
        mid_bc = tri[:, 1] + tri[:, 2]
        mid_ca = tri[:, 2] + tri[:, 0]
        pts = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2], mid_ab, mid_bc, mid_ca])
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        n = len(tri)
        a, b, c = np.arange(n), np.arange(n, 2 * n), np.arange(2 * n, 3 * n)
        ab, bc, ca = (
            np.arange(3 * n, 4 * n),
            np.arange(4 * n, 5 * n),
            np.arange(5 * n, 6 * n),
        )
        faces = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
        verts = pts
    pos = verts[faces].astype(np.float32) * np.float32(radius)
    nrm = verts[faces].astype(np.float32)  # unit sphere => normal == position
    return pos, nrm


def box(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box, 12 triangles, flat face normals."""
    sx, sy, sz = (s / 2.0 for s in size)
    cx, cy, cz = center
    corners = np.array(
        [
            [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
            [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
            [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
            [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz],
        ],
        np.float32,
    )
    quads = [
        ([0, 1, 2, 3], [0, 0, -1]), ([5, 4, 7, 6], [0, 0, 1]),
        ([4, 0, 3, 7], [-1, 0, 0]), ([1, 5, 6, 2], [1, 0, 0]),
        ([4, 5, 1, 0], [0, -1, 0]), ([3, 2, 6, 7], [0, 1, 0]),
    ]
    pos, nrm = [], []
    for idx, normal in quads:
        a, b, c, d = corners[idx]
        pos += [np.stack([a, b, c]), np.stack([a, c, d])]
        nrm += [np.broadcast_to(np.asarray(normal, np.float32), (3, 3)).copy()] * 2
    return np.stack(pos), np.stack(nrm)


def torus_knot(
    p: int = 2, q: int = 3, segments: int = 256, sides: int = 32,
    radius: float = 1.0, tube: float = 0.3,
) -> Tuple[np.ndarray, np.ndarray]:
    """(p, q) torus knot tube; 2 * segments * sides triangles with smooth
    normals."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    r = radius * (2 + np.cos(q * t)) * 0.5
    center = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), radius * np.sin(q * t) * 0.5], 1
    )
    d_center = np.gradient(center, axis=0)
    tangent = d_center / np.linalg.norm(d_center, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(tangent, up)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    norm = np.cross(side, tangent)

    phi = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring_n = (
        np.cos(phi)[None, :, None] * side[:, None, :]
        + np.sin(phi)[None, :, None] * norm[:, None, :]
    )
    verts = center[:, None, :] + tube * ring_n

    s0, f0 = np.meshgrid(np.arange(segments), np.arange(sides), indexing="ij")
    s1, f1 = (s0 + 1) % segments, (f0 + 1) % sides

    def quads(arr):
        return np.concatenate([
            np.stack([arr[s0, f0], arr[s1, f0], arr[s1, f1]], 2),
            np.stack([arr[s0, f0], arr[s1, f1], arr[s0, f1]], 2),
        ]).reshape(-1, 3, 3)

    return quads(verts).astype(np.float32), quads(ring_n).astype(np.float32)
