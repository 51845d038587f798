"""Scene representation (torch port of tpurt/scene/types.py).

``Scene`` is a plain dataclass: tensor fields plus static metadata. It
carries what both engines and the scalar oracle read: the triangle soup,
the modular engine's threaded BVH (``node_*``, the packed ``node_q``
rows and the exact ``tri_packed`` triangle rows), the megakernel row
bank (``mega_rows``), the inline static stage, the per-mesh transforms,
quantisation grids and materials.

Integer words inside the f32 banks (child metas, leaf aux words, static
owners, ``node_q`` words) are bit patterns: read them with
``Tensor.view(torch.int32)``, never with a cast.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Mapping, Tuple

import numpy as np
import torch


class MaterialType(enum.IntEnum):
    """MaterialType (Trace.cl:28-34)."""

    SOLID = 0
    CHECKER = 1
    INVISIBLE = 2
    GLASSY = 3
    ONE_SIDED = 4


def culls_backfaces(material_type: int) -> bool:
    """A mesh's backface-cull policy: cull unless Glassy, Invisible or
    OneSided (Trace.cl:460-462)."""
    return int(material_type) not in (MaterialType.GLASSY, MaterialType.INVISIBLE,
                                      MaterialType.ONE_SIDED)


#: Tensor fields and their dtypes, in declaration order.
ARRAY_FIELDS = {
    "tri_pos_a": torch.float32, "tri_pos_b": torch.float32,
    "tri_pos_c": torch.float32, "tri_nrm_a": torch.float32,
    "tri_nrm_b": torch.float32, "tri_nrm_c": torch.float32,
    "node_min": torch.float32, "node_max": torch.float32,
    "node_index": torch.int32, "node_ntris": torch.int32,
    "node_hit": torch.int32, "node_miss": torch.int32,
    "node_q": torch.float32, "tri_packed": torch.float32,
    "mesh_qmin": torch.float32, "mesh_qscale": torch.float32,
    "mega_rows": torch.float32, "mega_static_rows": torch.float32,
    "mesh_root": torch.int32, "mesh_pos": torch.float32,
    "mesh_pitch": torch.float32, "mesh_yaw": torch.float32,
    "mesh_roll": torch.float32, "mesh_scale": torch.float32,
    "mat_type": torch.int32, "mat_ior": torch.float32,
    "mat_color": torch.float32, "mat_emission_color": torch.float32,
    "mat_emission_strength": torch.float32,
    "mat_reflectiveness": torch.float32, "mat_specular_prob": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class Scene:
    """Frozen scene: K mesh instances over a shared triangle soup, with
    the modular engine's BVH and the megakernel's row bank and traversal
    chain (tpurt Scene semantics, field for field)."""

    tri_pos_a: torch.Tensor  # (T, 3) f32
    tri_pos_b: torch.Tensor
    tri_pos_c: torch.Tensor
    tri_nrm_a: torch.Tensor
    tri_nrm_b: torch.Tensor
    tri_nrm_c: torch.Tensor
    # Flat BVH (GPUNode semantics, src/readobj.hpp:27-31): ``index`` is
    # the first triangle of a leaf or the first child of an internal
    # node; siblings are adjacent.
    node_min: torch.Tensor  # (M, 3) f32
    node_max: torch.Tensor  # (M, 3) f32
    node_index: torch.Tensor  # (M,) i32
    node_ntris: torch.Tensor  # (M,) i32, 0 = internal
    # Threaded walk links per mesh subtree: on a box hit of an internal
    # node go to node_hit (its first child), on a miss or after a leaf
    # to node_miss; -1 ends the walk.
    node_hit: torch.Tensor  # (M,) i32
    node_miss: torch.Tensor  # (M,) i32
    # The walk's packed node rows: u16 box bounds on the mesh's grid
    #   [0] qx_lo | qy_lo<<16   [1] qz_lo | qx_hi<<16   [2] qy_hi | qz_hi<<16
    #   [3] i32 first child (internal) / first triangle (leaf)
    #   [4] i32 (miss_link + 1) | (num_tris << 24)
    # decoded as mesh_qmin + q * mesh_qscale (conservative).
    node_q: torch.Tensor  # (M, 5) f32
    tri_packed: torch.Tensor  # (T, 18) f32: pa pb pc na nb nc, exact
    mesh_qmin: torch.Tensor  # (K, 3) f32 root quantisation grid origin
    mesh_qscale: torch.Tensor  # (K, 3) f32 root quantisation cell size
    mega_rows: torch.Tensor  # (Mm, W) f32, bitcast-i32 words inside
    mega_static_rows: torch.Tensor  # (S, 19) f32
    mesh_root: torch.Tensor  # (K,) i32
    mesh_pos: torch.Tensor  # (K, 3) f32
    mesh_pitch: torch.Tensor  # (K,) f32
    mesh_yaw: torch.Tensor
    mesh_roll: torch.Tensor
    mesh_scale: torch.Tensor
    mat_type: torch.Tensor  # (K,) i32
    mat_ior: torch.Tensor
    mat_color: torch.Tensor  # (K, 3)
    mat_emission_color: torch.Tensor  # (K, 3)
    mat_emission_strength: torch.Tensor
    mat_reflectiveness: torch.Tensor
    mat_specular_prob: torch.Tensor

    # --- static metadata (same meaning as tpurt's) ---
    max_leaf_tris: int = 2  # largest BVH leaf: bounds the walk's leaf loop
    mesh_tri_ranges: Tuple[Tuple[int, int], ...] = ()
    mega_chain: Tuple[Tuple[int, int, bool], ...] = ()
    mega_chain_members: Tuple[Tuple[int, ...], ...] = ()
    mega_stack_depth: int = 8
    mesh_mat_types: Tuple[int, ...] = ()
    mega_static_cull: Tuple[bool, ...] = ()
    mega_static_onesided: Tuple[bool, ...] = ()
    mega_static_owner: Tuple[int, ...] = ()
    mesh_identity: Tuple[bool, ...] = ()
    mega_bounds_fmt: str = "u8"  # node-row child bounds: "u8" or "bf16"
    mega_leaf_tris: int = 3
    mega_arity: int = 8
    # Many-instance (TLAS) regime: the instanced meshes are instance rows
    # under a top-level BVH, reached through one (-2) chain entry whose
    # pretest box is mega_tlas_bounds (world lo xyz, hi xyz).
    mega_tlas: bool = False
    mega_tlas_bounds: Tuple[float, ...] = ()
    # Material slots (freeze-time dedup by value): mesh -> slot, and each
    # slot's representative mesh, whose material row the slot reads.
    mesh_mat_slot: Tuple[int, ...] = ()
    mat_slot_rep: Tuple[int, ...] = ()

    @property
    def num_meshes(self) -> int:
        return self.mesh_root.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_pos_a.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_index.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mega_rows.device

    @functools.cached_property
    def cache(self) -> dict:
        """Arrays derived from this scene's fields on first use and kept
        with it (kernel B3's triangle layout, the modular engine's index
        lists). Not a field: ``to`` and ``dataclasses.replace`` give a
        scene that starts with an empty cache."""
        return {}

    def to(self, device) -> "Scene":
        """The same scene with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in ARRAY_FIELDS
        })


#: Static metadata fields (everything in Scene that is not a tensor).
STATIC_FIELDS = tuple(
    f.name for f in dataclasses.fields(Scene) if f.name not in ARRAY_FIELDS
)


def from_arrays(arrays: Mapping[str, np.ndarray], static: Mapping,
                device="cuda") -> Scene:
    """Build a Scene on ``device`` from numpy arrays (by ARRAY_FIELDS
    name) and static metadata (by STATIC_FIELDS name) — e.g. a tpurt
    Scene's fields read out as numpy, carried across to the port
    unchanged. Banks keep their exact bits (no dtype round trip through
    a cast)."""
    tensors = {}
    for name, dtype in ARRAY_FIELDS.items():
        a = np.ascontiguousarray(arrays[name])
        np_dtype = np.float32 if dtype == torch.float32 else np.int32
        if a.dtype != np_dtype:
            raise ValueError(f"{name}: expected {np_dtype.__name__}, got {a.dtype}")
        tensors[name] = torch.from_numpy(a.copy()).to(device)
    meta = {k: static[k] for k in STATIC_FIELDS if k in static}
    return Scene(**tensors, **meta)
