"""SceneBuilder: host-side scene assembly -> frozen torch Scene (port of
tpurt/scene/builder.py).

Geometry, BVHs, the modular engine's threaded node rows and the
megakernel row bank are built in numpy exactly as tpurt builds them —
the SAH builder is the port's copy of tpurt's (``accel/bvh.py`` and the
C++ builder behind ``_native``), and the emitters below are the same
code — so the port's banks are bit-identical to tpurt's
(tests/test_torch_scene.py and tests/test_torch_config.py hold them so).

Freeze reads from ``tpurt_torch.config`` the child-bounds format (u8 on
the node's grid, or bf16 with ``MEGA_BF16_BOUNDS``), the arity and the
leaf size. It emits the inline static stage, one fused static chain
entry, and either one chain entry per instanced mesh or, above
``MEGA_TLAS_THRESHOLD`` instanced meshes, tpurt's many-instance (TLAS)
regime: one instance row per mesh under a world-space top-level BVH in
the same bank, reached through a single ``-2`` chain entry. Materials
are deduplicated by value into slots (``Scene.mesh_mat_slot``).

Two rules depart from tpurt's freeze. A fused static BVH of at least
``NATIVE_BVH_MIN_TRIS`` triangles is built by the native builder, as a
large mesh's is in ``add_triangles``: the same tree as the numpy
builder's but for SAH ties within an ulp. And where the inline stage
cannot hold every small identity mesh (a large identity mesh counts in
its budget), the OneSided single quads stay inline instead of taking a
chain entry each; that bank differs from tpurt's and renders the same
image.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpurt_torch import _native
from tpurt_torch import config as cfgmod
from tpurt_torch.accel.bvh import (
    DEFAULT_LEAF_CAP, BVHNodes, build_bvh, bvh_stats, thread_links)
from tpurt_torch.config import CORNELL_BREATHING_ROOM
from tpurt_torch.scene.obj import load_obj as _load_obj_file
from tpurt_torch.scene.obj import parse_obj
from tpurt_torch.scene.types import MaterialType, Scene, culls_backfaces
from tpurt_torch.utils.profiling import span

#: Bits of a packed stack entry reserved for the resume slot.
MEGA_SLOT_BITS = 6
#: Triangle budget of the inline static stage.
MEGA_STATIC_MAX_TRIS = 64
#: Triangle count from which a BVH is built by the native builder:
#: a mesh's in ``add_triangles``, the fused static one in the freeze.
NATIVE_BVH_MIN_TRIS = 512


def mega_row_width(leaf_tris: int, arity: int, bounds_fmt: str = "u8") -> int:
    """Bank row width (tpurt builder.mega_row_width): 19 words a leaf
    triangle; a node row 7 + 3 words a child (u8) or 7 + 4 (bf16)."""
    node_w = 7 + (4 if bounds_fmt == "bf16" else 3) * arity
    w = max(19 * leaf_tris, node_w)
    w = -(-w // 8) * 8
    if leaf_tris >= 8:
        w = max(w, 160)
    if w > 160:
        w = -(-w // 64) * 64
        if w == 256:
            w = 320
    return w


def _i32f(v) -> np.float32:
    return np.array(v, np.int32).view(np.float32)


def _bf16_dir(vals, up: bool) -> np.ndarray:
    """Conservative bf16 rounding of f32 values (tpurt builder._bf16_dir):
    the returned uint16 (the f32's top half), read as an f32 with a zero
    low half, is <= vals (up=False) or >= vals (up=True). Truncation
    moves toward zero; where that lands on the wrong side, step one bf16
    ulp away from zero."""
    f = np.atleast_1d(np.asarray(vals, np.float32))
    t = f.view(np.uint32) & np.uint32(0xFFFF0000)
    dec = t.view(np.float32)
    need = (dec < f) if up else (dec > f)
    t = np.where(need, t + np.uint32(0x10000), t)
    return (t >> 16).astype(np.uint16)


def _pack_child_slots(row, kids, bounds_fmt: str, arity: int, lo, hi):
    """One node row's child-slot words (tpurt builder._pack_child_slots).
    u8: 3 words a slot on the node's grid (row[0:6]); bf16: 4 words a
    slot, absolute bounds rounded outward (_bf16_dir), two per word as
    f32 top halves, the meta at base + 3. Decoded boxes always contain
    the true boxes; an empty slot has meta 0 and lo > hi."""
    if bounds_fmt == "bf16":
        u16f = lambda a, b: np.array(
            np.uint32(a) | (np.uint32(b) << np.uint32(16)), np.uint32
        ).view(np.float32)
        for s_idx, (meta, clo, chi) in enumerate(kids):
            lo16 = _bf16_dir(clo.astype(np.float32), up=False)
            hi16 = _bf16_dir(chi.astype(np.float32), up=True)
            base = 7 + 4 * s_idx
            row[base] = u16f(lo16[0], lo16[1])
            row[base + 1] = u16f(lo16[2], hi16[0])
            row[base + 2] = u16f(hi16[1], hi16[2])
            row[base + 3] = _i32f(meta)
        big, neg = np.uint16(0x7F7F), np.uint16(0xFF7F)
        for s_idx in range(len(kids), arity):
            base = 7 + 4 * s_idx
            row[base] = u16f(big, big)  # lo = +MAX > hi = -MAX
            row[base + 1] = u16f(big, neg)
            row[base + 2] = u16f(neg, neg)
            row[base + 3] = 0.0
        return
    scale = (hi - lo) / 255.0
    origin32 = lo.astype(np.float32)
    scale32 = np.where(scale > 0, scale, 0.0).astype(np.float32)
    row[0:3] = origin32
    row[3:6] = scale32
    safe = np.where(scale32 > 0, scale32.astype(np.float64), 1.0)
    dec = lambda q: origin32.astype(np.float64) + q * scale32.astype(np.float64)
    for s_idx, (meta, clo, chi) in enumerate(kids):
        ql = np.clip(np.floor((clo - origin32) / safe), 0, 255)
        qh = np.clip(np.ceil((chi - origin32) / safe), 0, 255)
        for _ in range(3):
            ql = np.where(dec(ql) > clo, np.maximum(ql - 1, 0), ql)
            qh = np.where(
                (dec(qh) < chi) & (scale32 > 0), np.minimum(qh + 1, 255), qh
            )
        ql = ql.astype(np.uint32)
        qh = qh.astype(np.uint32)
        w0 = ql[0] | (ql[1] << 8) | (ql[2] << 16) | (qh[0] << 24)
        w1 = qh[1] | (qh[2] << 8)
        base = 7 + 3 * s_idx
        row[base] = np.array(w0, np.uint32).view(np.float32)
        row[base + 1] = np.array(w1, np.uint32).view(np.float32)
        row[base + 2] = _i32f(meta)
    for s_idx in range(len(kids), arity):
        base = 7 + 3 * s_idx
        row[base] = np.array(
            np.uint32(255 | (255 << 8) | (255 << 16)), np.uint32
        ).view(np.float32)
        row[base + 1] = 0.0
        row[base + 2] = 0.0


def _emit_mega_subtree(rows, nodes, root, tri_pos, tri_nrm, tri_mesh,
                       bounds_fmt: str, leaf_tris: int, row_width: int,
                       arity: int):
    """Emit a BVH2 subtree as arity-wide megakernel rows (layouts as in
    tpurt builder._emit_mega_subtree). Returns (root_row, root_is_leaf,
    depth)."""
    bmin, bmax, child, first, ntris = nodes
    counts: Dict[int, int] = {}

    def subtree_count(i) -> int:
        i = int(i)
        if i not in counts:
            if ntris[i] > 0:
                counts[i] = int(ntris[i])
            else:
                counts[i] = subtree_count(child[i]) + subtree_count(
                    int(child[i]) + 1
                )
        return counts[i]

    def subtree_tris(i):
        out = []
        stack = [int(i)]
        while stack:
            j = stack.pop()
            if ntris[j] > 0:
                out.extend(range(int(first[j]), int(first[j]) + int(ntris[j])))
            else:
                stack.append(int(child[j]) + 1)
                stack.append(int(child[j]))
        return out

    def emit_leaf(i):
        tris = subtree_tris(i)
        assert 1 <= len(tris) <= leaf_tris, len(tris)
        row = np.zeros(row_width, np.float32)
        for k in range(leaf_tris):
            base = 19 * k
            if k < len(tris):
                t = tris[k]
                row[base:base + 9] = np.asarray(tri_pos[t], np.float32).reshape(9)
                row[base + 9:base + 18] = np.asarray(
                    tri_nrm[t], np.float32).reshape(9)
                row[base + 18] = _i32f(-1 if tri_mesh is None else int(tri_mesh[t]))
            else:
                row[base + 18] = _i32f(-1)  # zero triangle: MT det==0 rejects
        rows.append(row)
        return len(rows) - 1

    def collect_slots(i):
        slots = [i]

        def area(j):
            s = bmax[j] - bmin[j]
            return float(s[0] * (s[1] + s[2]) + s[1] * s[2])

        while len(slots) < arity - 1:
            internals = [
                j for j in slots
                if ntris[j] == 0 and subtree_count(j) > leaf_tris
            ]
            if not internals:
                break
            j = max(internals, key=area)
            slots.remove(j)
            slots.append(int(child[j]))
            slots.append(int(child[j]) + 1)
        return slots

    def emit_node(i):
        if ntris[i] > 0 or subtree_count(i) <= leaf_tris:
            return emit_leaf(i), True, 0
        slots = collect_slots(i)
        my = len(rows)
        rows.append(None)  # reserve (pre-order)
        row = np.zeros(row_width, np.float32)
        lo = np.min([bmin[j] for j in slots], axis=0).astype(np.float64)
        hi = np.max([bmax[j] for j in slots], axis=0).astype(np.float64)
        axis = int(np.argmax(hi - lo))
        slots.sort(key=lambda j: float(bmin[j][axis] + bmax[j][axis]))
        row[6] = _i32f(axis)
        kids = []
        depth = 0
        for j in slots:
            target, is_leaf, d = emit_node(j)
            depth = max(depth, d)
            kids.append((
                (target << 1) | (1 if is_leaf else 0),
                np.asarray(bmin[j], np.float64),
                np.asarray(bmax[j], np.float64),
            ))
        _pack_child_slots(row, kids, bounds_fmt, arity, lo, hi)
        rows[my] = row
        return my, False, depth + 1

    return emit_node(root)


#: Instance row of the TLAS regime (tpurt builder.MEGA_INST_ROW_WORDS),
#: 22 words: [0:3] position, [3:12] row-major rotation, [12] scale,
#: [13] i32 flags one_sided | cull << 1, [14] i32 owner mesh, [15] i32
#: root meta (root_row << 1 | is_leaf), [16:19] / [19:22] the local root
#: box (the mesh's u16 grid span, the unrolled chain's pretest box).
MEGA_INST_ROW_WORDS = 22
#: Meta bit marking an instance-row target in TLAS child slots and stack
#: entries (row targets stay below 2^27).
MEGA_ITAG = 1 << 28


def _euler_np(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """float32 XYZ-Euler rotation in vecmath.euler_rotation's expressions
    and association order (tpurt builder._euler_np): the instance rows'
    baked rotation, equal bit for bit to the unrolled chain's table,
    which the port also computes in numpy."""
    p, y, r = np.float32(pitch), np.float32(yaw), np.float32(roll)
    cx, sx = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(r), np.sin(r)
    return np.array([
        [cy * cz, cy * sz, -sy],
        [cz * sy * sx - cx * sz, cx * cz + sx * sy * sz, cy * sx],
        [sx * sz + cx * cz * sy, cx * sy * sz - cz * sx, cx * cy],
    ], np.float32)


def _emit_tlas(rows, entries, bounds_fmt: str, row_width: int, arity: int):
    """The top-level BVH over instance rows as node rows of the bank's
    format (tpurt builder._emit_tlas): an arity-wide split of the
    instances sorted along the widest axis into near-equal chunks, slots
    sorted by centroid along the recorded axis, leaf metas tagged
    MEGA_ITAG. ``entries``: [(inst_row, world_lo (3,) f64, world_hi)].
    Returns (root_row, depth); the root is always a node row."""

    def emit(items, force_node=False):
        if len(items) == 1 and not force_node:
            row_idx, lo, hi = items[0]
            return row_idx, True, lo, hi, 0
        lo = np.min([e[1] for e in items], axis=0)
        hi = np.max([e[2] for e in items], axis=0)
        axis = int(np.argmax(hi - lo))
        items = sorted(items, key=lambda e: float(e[1][axis] + e[2][axis]))
        n_chunks = min(arity, len(items))
        cuts = [round(k * len(items) / n_chunks) for k in range(n_chunks + 1)]
        chunks = [items[cuts[k]:cuts[k + 1]] for k in range(n_chunks)
                  if cuts[k] < cuts[k + 1]]
        my = len(rows)
        rows.append(None)  # reserve (pre-order)
        row = np.zeros(row_width, np.float32)
        row[6] = _i32f(axis)
        kids = []
        depth = 0
        for ch in chunks:
            t, is_inst, clo, chi, d = emit(ch)
            depth = max(depth, d)
            kids.append(((MEGA_ITAG | (t << 1)) if is_inst else (t << 1), clo, chi))
        kids.sort(key=lambda k: float(k[1][axis] + k[2][axis]))
        _pack_child_slots(row, kids, bounds_fmt, arity, lo, hi)
        rows[my] = row
        return my, False, lo, hi, depth + 1

    target, _is_inst, _lo, _hi, depth = emit(entries, force_node=True)
    return target, depth


def _instance_row(m, mesh: int, root_meta: int, grid, row_width: int):
    """An instance row (MEGA_INST_ROW_WORDS) and its conservative world
    box: the local root box's 8 corners transformed in float64, padded
    one f32 ulp outward (tpurt's freeze, many-instance branch)."""
    gmin32, scale32 = grid
    rmin = gmin32
    rmax = (gmin32 + np.float32(65535.0) * scale32).astype(np.float32)
    rot = _euler_np(m.pitch, m.yaw, m.roll)
    mt = int(m.material.type)
    row = np.zeros(row_width, np.float32)
    row[0:3] = np.asarray(m.pos, np.float32)
    row[3:12] = rot.reshape(9)
    row[12] = np.float32(m.scale)
    row[13] = _i32f(int(mt == int(MaterialType.ONE_SIDED)) | (int(culls_backfaces(mt)) << 1))
    row[14] = _i32f(mesh)
    row[15] = _i32f(root_meta)
    row[16:19] = rmin
    row[19:22] = rmax
    corners = np.array([[rmin[0] if (k & 1) == 0 else rmax[0],
                         rmin[1] if (k & 2) == 0 else rmax[1],
                         rmin[2] if (k & 4) == 0 else rmax[2]]
                        for k in range(8)], np.float64)
    world = ((corners * np.float64(m.scale)) @ rot.astype(np.float64).T
             + np.asarray(m.pos, np.float64))
    wlo = np.nextafter(world.min(axis=0).astype(np.float32), -np.inf)
    whi = np.nextafter(world.max(axis=0).astype(np.float32), np.inf)
    return row, wlo.astype(np.float64), whi.astype(np.float64)


def _subtree_indices(child, ntris, root):
    stack = [int(root)]
    while stack:
        idx = stack.pop()
        yield idx
        if ntris[idx] == 0:
            stack.append(int(child[idx]))
            stack.append(int(child[idx]) + 1)


def _walk_rows(bmin_arr, bmax_arr, child, first, ntris, hit, miss, roots):
    """The modular walk's packed node rows (Scene.node_q) and each mesh
    root's uint16 grid (origin, cell) — tpurt's freeze, step for step.
    Conservative: decoded lo <= true lo and decoded hi >= true hi,
    checked and fixed up element-wise against f32 decode rounding, so
    the walk may over-visit but never misses. The megakernel chain's
    root-pretest box is the grid's span."""
    m_nodes = len(ntris)
    assert m_nodes < (1 << 24), "node count exceeds packed miss-link field"
    assert ntris.max(initial=0) < (1 << 8), (
        "leaf size exceeds packed field; lower the builder leaf cap")
    w6 = np.where(ntris == 0, hit.astype(np.int64), first).astype(np.int32)
    w7 = ((miss.astype(np.int64) + 1) | (ntris.astype(np.int64) << 24)
          ).astype(np.int32)
    qlo = np.zeros((m_nodes, 3), np.uint16)
    qhi = np.zeros((m_nodes, 3), np.uint16)
    root_params = {}
    f32 = lambda x: x.astype(np.float32).astype(np.float64)
    for root in roots:
        members = list(_subtree_indices(child, ntris, root))
        gmin = bmin_arr[root].astype(np.float64)
        gmax = bmax_arr[root].astype(np.float64)
        scale = (gmax - gmin) / 65535.0
        safe = np.where(scale > 0, scale, 1.0)
        sub_lo = bmin_arr[members].astype(np.float64)
        sub_hi = bmax_arr[members].astype(np.float64)
        ql = np.clip(np.floor((sub_lo - gmin) / safe), 0, 65535)
        qh = np.clip(np.ceil((sub_hi - gmin) / safe), 0, 65535)
        gmin32, scale32 = f32(gmin), f32(np.where(scale > 0, scale, 0.0))
        for _ in range(3):
            ql = np.where(gmin32 + ql * scale32 > sub_lo,
                          np.maximum(ql - 1, 0), ql)
            qh = np.where((gmin32 + qh * scale32 < sub_hi) & (scale32 > 0),
                          np.minimum(qh + 1, 65535), qh)
        qlo[members] = ql.astype(np.uint16)
        qhi[members] = qh.astype(np.uint16)
        root_params[root] = (gmin.astype(np.float32),
                             np.where(scale > 0, scale, 0.0).astype(np.float32))
    q32 = lambda lo16, hi16: (lo16.astype(np.uint32)
                              | (hi16.astype(np.uint32) << 16)).view(np.float32)
    node_q = np.zeros((m_nodes, 5), np.float32)
    node_q[:, 0] = q32(qlo[:, 0], qlo[:, 1])
    node_q[:, 1] = q32(qlo[:, 2], qhi[:, 0])
    node_q[:, 2] = q32(qhi[:, 1], qhi[:, 2])
    node_q[:, 3] = w6.view(np.float32)
    node_q[:, 4] = w7.view(np.float32)
    return node_q, root_params


@dataclasses.dataclass
class Material:
    """Host-side RayTracingMaterial (readobj.hpp:48-56)."""

    type: MaterialType = MaterialType.SOLID
    ior: float = 1.0
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emission_strength: float = 0.0
    reflectiveness: float = 0.0
    specular_probability: float = 0.0


@dataclasses.dataclass
class MeshHandle:
    """Host-side MeshInfo (readobj.hpp:75-81); mutable until freeze."""

    node_idx: int
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    pitch: float = 0.0
    yaw: float = 0.0
    roll: float = 0.0
    scale: float = 1.0
    material: Material = dataclasses.field(default_factory=Material)
    first_tri: int = 0
    num_tris: int = 0


def _is_identity(m: MeshHandle) -> bool:
    return (
        tuple(np.asarray(m.pos, np.float64).tolist()) == (0.0, 0.0, 0.0)
        and float(m.pitch) == 0.0 and float(m.yaw) == 0.0
        and float(m.roll) == 0.0 and float(m.scale) == 1.0
    )


class SceneBuilder:
    def __init__(self) -> None:
        self._tri_pos: List[np.ndarray] = []
        self._tri_nrm: List[np.ndarray] = []
        self._num_tris = 0
        self.nodes = BVHNodes.empty()
        self.meshes: List[MeshHandle] = []
        self._mesh_cache: Dict[str, Tuple[int, int, int]] = {}

    # -- geometry ---------------------------------------------------------

    def _append_tris(self, pos: np.ndarray, nrm: np.ndarray) -> int:
        first = self._num_tris
        self._tri_pos.append(np.asarray(pos, np.float32).reshape(-1, 3, 3))
        self._tri_nrm.append(np.asarray(nrm, np.float32).reshape(-1, 3, 3))
        self._num_tris += self._tri_pos[-1].shape[0]
        return first

    def _consolidate(self):
        if len(self._tri_pos) != 1:
            empty = np.zeros((0, 3, 3), np.float32)
            self._tri_pos = [np.concatenate(self._tri_pos, 0)
                             if self._tri_pos else empty]
            self._tri_nrm = [np.concatenate(self._tri_nrm, 0)
                             if self._tri_nrm else empty]
        return self._tri_pos[0], self._tri_nrm[0]

    def add_triangles(self, pos, nrm, max_depth: int = 64) -> MeshHandle:
        """Append a triangle soup, build its BVH, return an (un-added)
        handle with the default OBJ material (white Solid)."""
        with span("tpurt.scene.bvh"):
            pos = np.asarray(pos, np.float32).reshape(-1, 3, 3)
            nrm = np.asarray(nrm, np.float32).reshape(-1, 3, 3)
            first = self._append_tris(pos, nrm)
            tri_pos, tri_nrm = self._consolidate()
            root = self._build_bvh_fast(tri_pos, tri_nrm, first, pos.shape[0],
                                        max_depth)
        return MeshHandle(
            node_idx=root,
            material=Material(type=MaterialType.SOLID, color=(1.0, 1.0, 1.0)),
            first_tri=first, num_tris=pos.shape[0],
        )

    def _build_bvh_fast(self, tri_pos, tri_nrm, first: int, count: int,
                        max_depth: int) -> int:
        """SAH build: native C++ for large meshes, numpy otherwise —
        exactly tpurt's SceneBuilder._build_bvh_fast."""
        if count < NATIVE_BVH_MIN_TRIS:
            return build_bvh(self.nodes, tri_pos, tri_nrm, first, count,
                             max_depth)
        bmin, bmax, child, nfirst, ntris = _native.build_bvh(
            tri_pos, tri_nrm, first, count, max_depth, DEFAULT_LEAF_CAP)
        base = len(self.nodes)
        for i in range(len(ntris)):
            self.nodes.append(
                bmin[i], bmax[i],
                int(child[i]) + base if ntris[i] == 0 else 0,
                int(nfirst[i]), int(ntris[i]),
            )
        return base

    def load_obj(self, path: str) -> MeshHandle:
        """loadMeshFromOBJFile with the per-file geometry cache."""
        if path in self._mesh_cache:
            root, first, num = self._mesh_cache[path]
            return MeshHandle(
                node_idx=root,
                material=Material(type=MaterialType.SOLID, color=(1.0, 1.0, 1.0)),
                first_tri=first, num_tris=num,
            )
        pos, nrm = _load_obj_file(path)
        handle = self.add_triangles(pos, nrm, max_depth=64)
        self._mesh_cache[path] = (handle.node_idx, handle.first_tri,
                                  handle.num_tris)
        return handle

    def load_obj_text(self, text: str) -> MeshHandle:
        pos, nrm = parse_obj(text)
        return self.add_triangles(pos, nrm, max_depth=64)

    # -- instances --------------------------------------------------------

    def add_mesh(self, handle: MeshHandle) -> int:
        self.meshes.append(handle)
        return len(self.meshes) - 1

    def add_quad(self, a, b, c, d, normal, color) -> MeshHandle:
        """addQuad (readobj.hpp:378-408): triangles (a,b,c), (a,c,d), one
        normal, identity transform, Solid of ``color``; added at once."""
        a, b, c, d = (np.asarray(v, np.float32) for v in (a, b, c, d))
        normal = np.asarray(normal, np.float32)
        pos = np.stack([np.stack([a, b, c]), np.stack([a, c, d])])
        nrm = np.broadcast_to(normal, (2, 3, 3)).copy()
        first = self._append_tris(pos, nrm)
        tri_pos, tri_nrm = self._consolidate()
        root = build_bvh(self.nodes, tri_pos, tri_nrm, first, 2, max_depth=10)
        handle = MeshHandle(
            node_idx=root,
            material=Material(type=MaterialType.SOLID,
                              color=tuple(map(float, color))),
            first_tri=first, num_tris=2,
        )
        self.add_mesh(handle)
        return handle

    def add_cornell_box(self, mesh: MeshHandle) -> None:
        """addCornellBoxToScene (image.hpp:401-449), geometry and
        materials as tpurt builds them."""
        room = CORNELL_BREATHING_ROOM
        bmin = self.nodes.bmin[mesh.node_idx] * np.float32(mesh.scale)
        bmax = self.nodes.bmax[mesh.node_idx] * np.float32(mesh.scale)
        min_x, max_x = bmin[0] - room, bmax[0] + room
        min_y, max_y = bmin[1], bmax[1] + room  # floor not lowered
        min_z, max_z = bmin[2] - room, bmax[2] + room

        floor = self.add_quad(
            (min_x, min_y, min_z), (max_x, min_y, min_z),
            (max_x, min_y, max_z), (min_x, min_y, max_z),
            (0, 1, 0), (0.1, 0.1, 0.1),
        )
        floor.material = Material(
            type=MaterialType.SOLID, ior=1.0, color=(0.1, 0.1, 0.1),
            specular_probability=1.0,
        )
        self.add_quad(  # ceiling
            (min_x, max_y, min_z), (max_x, max_y, min_z),
            (max_x, max_y, max_z), (min_x, max_y, max_z),
            (0, -1, 0), (1.0, 1.0, 1.0),
        )
        front = self.add_quad(
            (min_x, min_y, max_z), (max_x, min_y, max_z),
            (max_x, max_y, max_z), (min_x, max_y, max_z),
            (0, 0, -1), (1.0, 1.0, 1.0),
        )
        front.material.type = MaterialType.ONE_SIDED
        self.add_quad(  # back wall, green
            (min_x, min_y, min_z), (max_x, min_y, min_z),
            (max_x, max_y, min_z), (min_x, max_y, min_z),
            (0, 0, 1), (0.1, 0.8, 0.1),
        )
        self.add_quad(  # left wall, blue
            (min_x, min_y, min_z), (min_x, min_y, max_z),
            (min_x, max_y, max_z), (min_x, max_y, min_z),
            (1, 0, 0), (0.1, 0.1, 1.0),
        )
        self.add_quad(  # right wall, red
            (max_x, min_y, min_z), (max_x, min_y, max_z),
            (max_x, max_y, max_z), (max_x, max_y, min_z),
            (-1, 0, 0), (1.0, 0.2, 0.2),
        )
        lx, lz, ly = 50.0, 50.0, max_y - 1.0
        light = self.add_quad(
            (-lx, ly, -lz), (lx, ly, -lz), (lx, ly, lz), (-lx, ly, lz),
            (0, -1, 0), (0.0, 0.0, 0.0),
        )
        light.material = Material(
            type=MaterialType.SOLID, ior=1.0, color=(1.0, 1.0, 1.0),
            emission_color=(1.0, 1.0, 1.0), emission_strength=8.0,
            specular_probability=1.0,
        )

    # -- freeze -----------------------------------------------------------

    def freeze(self, device="cuda") -> Scene:
        """Flatten to a Scene on ``device`` (tpurt SceneBuilder.freeze)."""
        with span("tpurt.scene.freeze"):
            return self._freeze(device)

    def _freeze(self, device) -> Scene:
        tri_pos, tri_nrm = self._consolidate()
        bmin, bmax, child, first, ntris = self.nodes.as_arrays()
        bmin_arr = np.asarray(bmin, np.float32).reshape(-1, 3)
        bmax_arr = np.asarray(bmax, np.float32).reshape(-1, 3)

        roots = sorted({m.node_idx for m in self.meshes})
        hit, miss = thread_links(child, ntris, roots)
        node_q, root_params = _walk_rows(bmin_arr, bmax_arr, child, first,
                                         ntris, hit, miss, roots)

        bounds_fmt = "bf16" if cfgmod.MEGA_BF16_BOUNDS else "u8"
        leaf_tris = int(cfgmod.MEGA_LEAF_TRIS)
        arity = int(cfgmod.MEGA_NODE_ARITY)
        if not 2 <= arity <= (1 << MEGA_SLOT_BITS) - 1:
            raise ValueError(f"MEGA_NODE_ARITY={arity}: a node row holds 2 to "
                             f"{(1 << MEGA_SLOT_BITS) - 1} children")
        row_width = mega_row_width(leaf_tris, arity, bounds_fmt)
        rows: List[np.ndarray] = []
        chain: List[Tuple[int, int, bool]] = []
        chain_members: List[Tuple[int, ...]] = []
        mega_depth = 0
        nodes_tuple = (bmin_arr, bmax_arr, child, first, ntris)

        # Inline static stage: small identity meshes (OneSided only as
        # single quads, where candidate-level rejection is equivalent).
        inline = [
            i for i, m in enumerate(self.meshes)
            if m.num_tris > 0 and _is_identity(m)
            and (int(m.material.type) != int(MaterialType.ONE_SIDED)
                 or m.num_tris <= 2)
        ]
        ntris_of = lambda ids: sum(self.meshes[i].num_tris for i in ids)
        if ntris_of(inline) > MEGA_STATIC_MAX_TRIS:
            # The rest joins the fused static BVH, which cannot hold a
            # OneSided quad: keep those inline, not a chain entry each.
            inline = [i for i in inline if int(self.meshes[i].material.type)
                      == int(MaterialType.ONE_SIDED)]
            if ntris_of(inline) > MEGA_STATIC_MAX_TRIS:
                inline = []
        static_rows, static_cull, static_onesided, static_owner = [], [], [], []
        for i in inline:
            m = self.meshes[i]
            mt = int(m.material.type)
            for t in range(m.first_tri, m.first_tri + m.num_tris):
                row = np.zeros(19, np.float32)
                row[0:9] = tri_pos[t].reshape(9)
                row[9:18] = tri_nrm[t].reshape(9)
                row[18] = _i32f(i)
                static_rows.append(row)
                static_owner.append(i)
                static_cull.append(culls_backfaces(mt))
                static_onesided.append(mt == int(MaterialType.ONE_SIDED))

        static_members = [
            i for i, m in enumerate(self.meshes)
            if m.num_tris > 0 and _is_identity(m)
            and int(m.material.type) != int(MaterialType.ONE_SIDED)
            and i not in inline
        ]
        if static_members:
            ms = [self.meshes[i] for i in static_members]
            s_pos = np.concatenate(
                [tri_pos[m.first_tri:m.first_tri + m.num_tris] for m in ms]).copy()
            s_nrm = np.concatenate(
                [tri_nrm[m.first_tri:m.first_tri + m.num_tris] for m in ms]).copy()
            s_mesh = np.concatenate(
                [np.full(self.meshes[i].num_tris, i, np.int64)
                 for i in static_members])
            if len(s_pos) >= NATIVE_BVH_MIN_TRIS:
                s_root, s_nodes = 0, _native.build_bvh(
                    s_pos, s_nrm, 0, len(s_pos), 64, 2, aux=s_mesh)
            else:
                s_tree = BVHNodes.empty()
                s_root = build_bvh(s_tree, s_pos, s_nrm, 0, len(s_pos), 64,
                                   leaf_cap=2, aux=s_mesh)
                s_nodes = s_tree.as_arrays()
            root_row, root_leaf, d = _emit_mega_subtree(
                rows, s_nodes, s_root, s_pos, s_nrm, s_mesh,
                bounds_fmt, leaf_tris, row_width, arity,
            )
            chain.append((-1, root_row, root_leaf))
            chain_members.append(tuple(static_members))
            mega_depth = max(mega_depth, d)

        inst_list = [
            i for i, m in enumerate(self.meshes)
            if i not in static_members and i not in inline and m.num_tris > 0
        ]
        use_tlas = len(inst_list) > int(cfgmod.MEGA_TLAS_THRESHOLD)
        emitted: Dict[int, Tuple[int, bool]] = {}
        inst_depth = 0
        for i in inst_list:
            m = self.meshes[i]
            if m.node_idx not in emitted:
                root_row, root_leaf, d = _emit_mega_subtree(
                    rows, nodes_tuple, m.node_idx, tri_pos, tri_nrm, None,
                    bounds_fmt, leaf_tris, row_width, arity,
                )
                inst_depth = max(inst_depth, d)
                emitted[m.node_idx] = (root_row, root_leaf)
            if not use_tlas:
                root_row, root_leaf = emitted[m.node_idx]
                chain.append((i, root_row, root_leaf))
                chain_members.append((i,))
        tlas_bounds: Tuple[float, ...] = ()
        if use_tlas:
            # Many-instance regime: one instance row per mesh (transform
            # baked) under a world-space top-level BVH, one (-2) entry.
            assert row_width >= MEGA_INST_ROW_WORDS, (
                f"bank width {row_width} cannot hold an instance row")
            assert len(rows) + 2 * len(inst_list) < (1 << 27)
            entries = []
            for i in inst_list:
                m = self.meshes[i]
                root_row, root_leaf = emitted[m.node_idx]
                row, wlo, whi = _instance_row(
                    m, i, (root_row << 1) | int(root_leaf),
                    root_params[m.node_idx], row_width)
                entries.append((len(rows), wlo, whi))
                rows.append(row)
            tlas_root, tlas_depth = _emit_tlas(rows, entries, bounds_fmt,
                                               row_width, arity)
            chain.append((-2, tlas_root, False))
            chain_members.append(tuple(inst_list))
            # TLAS pushes + the exit marker + the deepest instance subtree.
            mega_depth = max(mega_depth, tlas_depth + 1 + inst_depth)
            ulo = np.min([e[1] for e in entries], axis=0)
            uhi = np.max([e[2] for e in entries], axis=0)
            tlas_bounds = tuple(float(v) for v in ulo) + tuple(
                float(v) for v in uhi)
            print(f"tpurt_torch: {len(inst_list)} instanced meshes > TLAS "
                  f"threshold {cfgmod.MEGA_TLAS_THRESHOLD} — routing through "
                  f"the instance-row TLAS (depth {tlas_depth}); transforms "
                  f"are baked (re-freeze to animate)", file=sys.stderr)
        else:
            mega_depth = max(mega_depth, inst_depth)

        mega_rows = (np.stack(rows) if rows
                     else np.zeros((1, row_width), np.float32))
        assert len(mega_rows) < (1 << 27), "row index exceeds packed meta field"

        # Material slots: dedup by value (tpurt's freeze); a slot's
        # representative is its first mesh.
        slot_of: Dict[tuple, int] = {}
        mesh_mat_slot: List[int] = []
        mat_slot_rep: List[int] = []
        for i, m in enumerate(self.meshes):
            a = m.material
            key = (int(a.type), float(a.ior), tuple(a.color),
                   tuple(a.emission_color), float(a.emission_strength),
                   float(a.reflectiveness), float(a.specular_probability))
            if key not in slot_of:
                slot_of[key] = len(mat_slot_rep)
                mat_slot_rep.append(i)
            mesh_mat_slot.append(slot_of[key])

        k = len(self.meshes)
        zeros3 = np.zeros((0, 3), np.float32)
        mats = [m.material for m in self.meshes]
        f32 = lambda vals, *shape: np.asarray(vals, np.float32).reshape(k, *shape)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return Scene(
            tri_pos_a=t(tri_pos[:, 0]), tri_pos_b=t(tri_pos[:, 1]),
            tri_pos_c=t(tri_pos[:, 2]), tri_nrm_a=t(tri_nrm[:, 0]),
            tri_nrm_b=t(tri_nrm[:, 1]), tri_nrm_c=t(tri_nrm[:, 2]),
            node_min=t(bmin_arr), node_max=t(bmax_arr),
            node_index=t(np.where(ntris == 0, child, first).astype(np.int32)),
            node_ntris=t(ntris.astype(np.int32)), node_hit=t(hit),
            node_miss=t(miss), node_q=t(node_q),
            tri_packed=t(np.concatenate(
                [tri_pos.reshape(-1, 9), tri_nrm.reshape(-1, 9)], axis=1
            ).astype(np.float32)),
            mesh_qmin=t(np.stack([root_params[m.node_idx][0] for m in self.meshes])
                        if k else zeros3),
            mesh_qscale=t(np.stack([root_params[m.node_idx][1] for m in self.meshes])
                          if k else zeros3),
            mega_rows=t(mega_rows),
            mega_static_rows=t(np.stack(static_rows) if static_rows
                               else np.zeros((0, 19), np.float32)),
            mesh_root=t(np.asarray([m.node_idx for m in self.meshes], np.int32)),
            mesh_pos=t(f32([m.pos for m in self.meshes], 3)),
            mesh_pitch=t(f32([m.pitch for m in self.meshes])),
            mesh_yaw=t(f32([m.yaw for m in self.meshes])),
            mesh_roll=t(f32([m.roll for m in self.meshes])),
            mesh_scale=t(f32([m.scale for m in self.meshes])),
            mat_type=t(np.asarray([int(m.type) for m in mats], np.int32)),
            mat_ior=t(f32([m.ior for m in mats])),
            mat_color=t(f32([m.color for m in mats], 3)),
            mat_emission_color=t(f32([m.emission_color for m in mats], 3)),
            mat_emission_strength=t(f32([m.emission_strength for m in mats])),
            mat_reflectiveness=t(f32([m.reflectiveness for m in mats])),
            mat_specular_prob=t(f32([m.specular_probability for m in mats])),
            max_leaf_tris=max(int(ntris.max()) if len(ntris) else 0, 1),
            mesh_tri_ranges=tuple((m.first_tri, m.num_tris) for m in self.meshes),
            mega_chain=tuple(chain),
            mega_chain_members=tuple(chain_members),
            mega_stack_depth=int(mega_depth) + 2,
            mesh_mat_types=tuple(int(m.type) for m in mats),
            mega_static_cull=tuple(static_cull),
            mega_static_onesided=tuple(static_onesided),
            mega_static_owner=tuple(static_owner),
            mesh_identity=tuple(_is_identity(m) for m in self.meshes),
            mega_bounds_fmt=bounds_fmt,
            mega_leaf_tris=leaf_tris,
            mega_arity=arity,
            mega_tlas=use_tlas,
            mega_tlas_bounds=tlas_bounds,
            mesh_mat_slot=tuple(mesh_mat_slot),
            mat_slot_rep=tuple(mat_slot_rep),
        )

    def stats(self, handle: MeshHandle) -> dict:
        """bvh_stats of the mesh's BVH (PrintDebugBVH)."""
        return bvh_stats(self.nodes, handle.node_idx)
