"""The benchmark's own scene inputs: the mesh of a configuration (an OBJ
file or a procedural torus knot), the Cornell box around it, the
materials and the camera's per-frame scalars.

Nothing here imports the program. The same triangles go to the program
(``SceneBuilder.add_triangles`` and ``scene_around``) and to the plain
reference (``reference.RefScene``); the box, the materials and the
camera the reference works out again from the configuration file.

Frozen copies, each from the repository as it stood when the benchmark
was written:
- ``parse_obj``: ``tpurt_torch/scene/obj.py:20-76`` (semantics of the
  reference's loadMeshFromOBJFile, readobj.hpp:270-344), with the face
  rows gathered in one numpy call instead of one call a face.
- ``torus_knot``: ``tpurt_torch/scene/procedural.py:89-123``.
- ``cornell_box``: ``tpurt_torch/scene/builder.py:516-591``
  (addCornellBoxToScene, image.hpp:401-449, and addQuad,
  readobj.hpp:378-408).
- ``euler``: ``tests/oracle.py:127-138`` (Trace.cl's makeRotation).
"""

from __future__ import annotations

import gzip
import hashlib
import os
import sys
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

F = np.float32

#: Material types (Trace.cl's enum).
SOLID, CHECKER, INVISIBLE, GLASSY, ONE_SIDED = 0, 1, 2, 3, 4


@dataclass
class Material:
    type: int = SOLID
    ior: float = 1.0
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_strength: float = 0.0
    reflectiveness: float = 0.0
    specular_probability: float = 0.0


@dataclass
class Mesh:
    """One mesh instance: its triangles (T, 3, 3) positions and normals,
    its transform and material."""

    pos: np.ndarray
    nrm: np.ndarray
    material: Material
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0
    scale: float = 1.0
    name: str = ""


@dataclass
class SceneSpec:
    """What a configuration file describes, resolved to meshes in the
    order the reference adds them."""

    meshes: List[Mesh] = field(default_factory=list)


# -- the mesh -----------------------------------------------------------------


def parse_obj(text: str, warn=None) -> Tuple[np.ndarray, np.ndarray]:
    """OBJ text -> (positions (n, 3, 3) f32, normals (n, 3, 3) f32):
    ``v``/``vn`` lines, triangle faces ``v/t/n`` or ``v//n``, 1-based;
    malformed or out-of-range faces warn and are skipped."""
    if warn is None:
        warn = lambda msg: print(msg, file=sys.stderr)
    vertices, normals, fv, fn = [], [], [], []
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("v ") or line.startswith("vn "):
            parts = line.split()
            if len(parts) >= 4:
                try:
                    xyz = [float(parts[1]), float(parts[2]), float(parts[3])]
                except ValueError:
                    continue
                (vertices if parts[0] == "v" else normals).append(xyz)
        elif line.startswith("f "):
            parts = line.split()[1:]
            v_idx, n_idx = [], []
            ok = len(parts) == 3
            for p in parts if ok else ():
                comps = p.split("/")
                if len(comps) != 3 or not comps[0] or not comps[2]:
                    ok = False
                    break
                try:
                    v_idx.append(int(comps[0]) - 1)
                    n_idx.append(int(comps[2]) - 1)
                except ValueError:
                    ok = False
                    break
            if not ok:
                warn(f"Unsupported face format: {line}")
                continue
            fv.append(v_idx)
            fn.append(n_idx)
    v = np.asarray(vertices, F).reshape(-1, 3)
    n = np.asarray(normals, F).reshape(-1, 3)
    vi = np.asarray(fv, np.int64).reshape(-1, 3)
    ni = np.asarray(fn, np.int64).reshape(-1, 3)
    good = ((vi >= 0) & (vi < len(v)) & (ni >= 0) & (ni < len(n))).all(1)
    for k in np.flatnonzero(~good):
        warn(f"Index out of bounds in face: f {vi[k] + 1} // {ni[k] + 1}")
    vi, ni = vi[good], ni[good]
    return v[vi].reshape(-1, 3, 3), n[ni].reshape(-1, 3, 3)


def load_obj(path: str, sha256: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file, gzip-compressed where it ends in ``.gz``; where
    ``sha256`` is given, the uncompressed bytes must hash to it."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    if sha256 and hashlib.sha256(data).hexdigest() != sha256:
        raise ValueError(f"{path}: content does not match its sha256")
    return parse_obj(data.decode())


def torus_knot(p: int = 2, q: int = 3, segments: int = 256, sides: int = 32,
               radius: float = 1.0, tube: float = 0.3):
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

    return quads(verts).astype(F), quads(ring_n).astype(F)


def model_triangles(cfg: dict, root: str) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's mesh as (pos, nrm), checked against the
    triangle count the file states."""
    mesh = cfg["mesh"]
    if mesh["kind"] == "obj":
        pos, nrm = load_obj(os.path.join(root, mesh["file"]),
                            mesh.get("sha256", ""))
    elif mesh["kind"] == "torus_knot":
        pos, nrm = torus_knot(segments=mesh["segments"], sides=mesh["sides"],
                              radius=mesh["radius"], tube=mesh["tube"])
    else:
        raise ValueError(f"unknown mesh kind {mesh['kind']!r}")
    if pos.shape[0] != mesh["triangles"]:
        raise ValueError(f"mesh has {pos.shape[0]} triangles, the "
                         f"configuration states {mesh['triangles']}")
    return pos, nrm


# -- the Cornell box ----------------------------------------------------------


def _quad(a, b, c, d, normal, material, name):
    a, b, c, d = (np.asarray(v, F) for v in (a, b, c, d))
    pos = np.stack([np.stack([a, b, c]), np.stack([a, c, d])])
    nrm = np.broadcast_to(np.asarray(normal, F), (2, 3, 3)).copy()
    return Mesh(pos=pos, nrm=nrm, material=material, name=name)


def cornell_box(model_pos: np.ndarray, scale: float, room: float) -> List[Mesh]:
    """The box's seven quads, in the order the reference adds them, sized
    around the model's bounds times its scale: floor, ceiling, front
    (one-sided), back (green), left (blue), right (red), light."""
    flat = model_pos.reshape(-1, 3)
    bmin = flat.min(0) * F(scale)
    bmax = flat.max(0) * F(scale)
    min_x, max_x = bmin[0] - room, bmax[0] + room
    min_y, max_y = bmin[1], bmax[1] + room  # the floor is not lowered
    min_z, max_z = bmin[2] - room, bmax[2] + room
    solid = lambda col: Material(color=col)
    lx, lz, ly = 50.0, 50.0, max_y - 1.0
    return [
        _quad((min_x, min_y, min_z), (max_x, min_y, min_z),
              (max_x, min_y, max_z), (min_x, min_y, max_z), (0, 1, 0),
              Material(color=(0.1, 0.1, 0.1), specular_probability=1.0),
              "floor"),
        _quad((min_x, max_y, min_z), (max_x, max_y, min_z),
              (max_x, max_y, max_z), (min_x, max_y, max_z), (0, -1, 0),
              solid((1.0, 1.0, 1.0)), "ceiling"),
        _quad((min_x, min_y, max_z), (max_x, min_y, max_z),
              (max_x, max_y, max_z), (min_x, max_y, max_z), (0, 0, -1),
              Material(type=ONE_SIDED, color=(1.0, 1.0, 1.0)), "front"),
        _quad((min_x, min_y, min_z), (max_x, min_y, min_z),
              (max_x, max_y, min_z), (min_x, max_y, min_z), (0, 0, 1),
              solid((0.1, 0.8, 0.1)), "back"),
        _quad((min_x, min_y, min_z), (min_x, min_y, max_z),
              (min_x, max_y, max_z), (min_x, max_y, min_z), (1, 0, 0),
              solid((0.1, 0.1, 1.0)), "left"),
        _quad((max_x, min_y, min_z), (max_x, min_y, max_z),
              (max_x, max_y, max_z), (max_x, max_y, min_z), (-1, 0, 0),
              solid((1.0, 0.2, 0.2)), "right"),
        _quad((-lx, ly, -lz), (lx, ly, -lz), (lx, ly, lz), (-lx, ly, lz),
              (0, -1, 0),
              Material(color=(1.0, 1.0, 1.0), emission_color=(1.0, 1.0, 1.0),
                       emission_strength=8.0, specular_probability=1.0),
              "light"),
    ]


def scene_spec(cfg: dict, pos: np.ndarray, nrm: np.ndarray) -> SceneSpec:
    """The whole scene of a configuration: the box, then the model with
    its material and scale (the model goes after the box, main.cpp:298)."""
    m = cfg["model"]
    model = Mesh(pos=pos, nrm=nrm, material=Material(**m["material"]),
                 scale=float(m["scale"]), name="model")
    box = cornell_box(pos, float(m["scale"]), float(cfg["cornell_breathing_room"]))
    return SceneSpec(meshes=box + [model])


# -- the camera ---------------------------------------------------------------


def euler(pitch, yaw, roll) -> np.ndarray:
    """makeRotation (Trace.cl) in numpy float32."""
    cx, sx = F(np.cos(F(pitch))), F(np.sin(F(pitch)))
    cy, sy = F(np.cos(F(yaw))), F(np.sin(F(yaw)))
    cz, sz = F(np.cos(F(roll))), F(np.sin(F(roll)))
    return np.array([
        [cy * cz, cy * sz, -sy],
        [cz * sy * sx - cx * sz, cx * cz + sx * sy * sz, cy * sx],
        [sx * sz + cx * cz * sy, cx * sy * sz - cz * sx, cx * cy],
    ], F)


@dataclass(frozen=True)
class Pose:
    """A camera as a request states it."""

    position: Tuple[float, float, float]
    pitch: float
    yaw: float
    roll: float
    fov_degrees: float
    aspect: float

    def scalars(self):
        """(position (3,), rotation (3, 3), tan of the half fov, aspect),
        numpy float32, as MakeRay (Trace.cl:596-621) uses them."""
        tan = np.tan(F(self.fov_degrees) * F(0.5) * F(np.pi / 180))
        return (np.asarray(self.position, F), euler(self.pitch, self.yaw,
                                                    self.roll),
                F(tan), F(self.aspect))


def pose(cfg: dict, width: int, height: int, yaw: float = None) -> Pose:
    c = cfg["camera"]
    return Pose(tuple(float(v) for v in c["position"]), float(c["pitch"]),
                float(c["yaw"] if yaw is None else yaw), float(c["roll"]),
                float(c["fov_degrees"]), float(width) / float(height))
