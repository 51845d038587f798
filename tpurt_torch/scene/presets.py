"""Canonical scenes (port of tpurt/scene/presets.py): the reference's
default workload — the model (an OBJ, or a procedural stand-in keyed by
name) made white Solid with specularProbability 1 at scale 0.5, inside
the Cornell box, appended last, seen from the settings.hpp camera — and
the scenes of tpurt's bench rows (bench.py ``build_scene``).

Every entry point builds on ``device``, the CUDA device unless the
caller names another; without a card that fails, it does not fall back.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import numpy as np

import tpurt_torch.config as cfgmod
from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, MeshHandle, SceneBuilder
from tpurt_torch.scene.types import MaterialType, Scene

#: The five materials tpurt's many-instance grid cycles through
#: (tests/test_many_meshes.py _grid_scene).
GRID_MATERIALS = (
    Material(type=MaterialType.SOLID, color=(0.9, 0.4, 0.3)),
    Material(type=MaterialType.SOLID, color=(0.3, 0.9, 0.4),
             reflectiveness=0.8, specular_probability=0.5),
    Material(type=MaterialType.CHECKER, color=(0.9, 0.9, 0.9),
             emission_color=(0.1, 0.1, 0.6), emission_strength=25.0),
    Material(type=MaterialType.GLASSY, ior=1.5, color=(1.0, 1.0, 1.0)),
    Material(type=MaterialType.SOLID, color=(0.9, 0.9, 0.2),
             emission_color=(1.0, 0.9, 0.7), emission_strength=2.0),
)
#: The one material of tpurt's many-instance probe (scripts/probe_r74.py).
PROBE_MATERIAL = Material(type=MaterialType.SOLID, color=(0.9, 0.5, 0.3),
                          reflectiveness=0.5, specular_probability=0.4)


def _model_for(builder: SceneBuilder, cfg: RenderConfig) -> MeshHandle:
    path = cfg.object_path
    if path and os.path.exists(path):
        return builder.load_obj(path)
    # Radius 96, not 100: see tpurt's presets (keeps the Cornell ceiling
    # off the camera's horizon row).
    name = os.path.splitext(os.path.basename(path or ""))[0]
    if name in ("knot", "torus_knot"):
        pos, nrm = procedural.torus_knot(segments=192, sides=24, radius=80.0,
                                         tube=22.0)
    elif name.startswith("sphere"):
        pos, nrm = procedural.icosphere(int(name[len("sphere"):] or 3), 96.0)
    else:
        pos, nrm = procedural.icosphere(subdivisions=3, radius=96.0)
    return builder.add_triangles(pos, nrm)


def scene_around(builder: SceneBuilder, mesh: MeshHandle, cfg: RenderConfig,
                 device="cuda") -> Tuple[Scene, Camera]:
    """The reference main program's model setup (main.cpp:256-304) for
    ``mesh``."""
    mesh.material = Material(
        type=MaterialType.SOLID, ior=1.0, color=(1.0, 1.0, 1.0),
        specular_probability=1.0,
    )
    mesh.scale = 0.5
    builder.add_cornell_box(mesh)
    builder.add_mesh(mesh)  # the model goes after the box (main.cpp:298)
    cam = Camera.create(
        position=cfg.camera_position, pitch=cfg.camera_pitch,
        yaw=cfg.camera_yaw, roll=cfg.camera_roll,
        fov_degrees=cfg.fov_degrees, aspect_ratio=cfg.aspect_ratio,
        device=device,
    )
    return builder.freeze(device), cam


def default_scene(cfg: Optional[RenderConfig] = None, device="cuda"
                  ) -> Tuple[Scene, Camera, SceneBuilder]:
    cfg = cfg or RenderConfig()
    b = SceneBuilder()
    scene, cam = scene_around(b, _model_for(b, cfg), cfg, device)
    return scene, cam, b


def cornell_sphere_scene(subdivisions: int = 2,
                         cfg: Optional[RenderConfig] = None, device="cuda"
                         ) -> Tuple[Scene, Camera, SceneBuilder]:
    """Cornell box around an icosphere (the tests' small scene)."""
    cfg = (cfg or RenderConfig()).replace(object_path=f"sphere{subdivisions}.obj")
    return default_scene(cfg, device)


def bench_scene(kind: str, cfg: RenderConfig, device="cuda"
                ) -> Tuple[Scene, Camera]:
    """A scene of tpurt's bench rows (bench.py ``build_scene``):
    "teapot" — the 6,144-triangle torus knot of the low-poly
    brute-force row ``teapot-720p-bruteforce``; "sphere" — the
    1,280-triangle icosphere of radius 100 of the parity row
    ``parity-640x480-1spp``. Each at scale 0.5 in the Cornell box."""
    if kind == "teapot":
        pos, nrm = procedural.torus_knot(segments=96, sides=32, radius=80.0,
                                         tube=22.0)
    elif kind == "sphere":
        pos, nrm = procedural.icosphere(3, radius=100.0)
    else:
        raise ValueError(f"unknown bench scene: {kind!r}")
    b = SceneBuilder()
    return scene_around(b, b.add_triangles(pos, nrm), cfg, device)


def grid_scene(k: int, subdivisions: int = 0, materials=GRID_MATERIALS,
               device="cuda") -> Scene:
    """tpurt's many-instance grid (tests/test_many_meshes.py _grid_scene,
    scripts/probe_r74.py grid_scene): ``k`` instances of one
    icosphere(``subdivisions``, radius 10), each with its own position
    on a grid, yaw 0.3 i and scale 0.4 + 0.02 (i % 5), inside the
    Cornell box sized for the sphere at scale 0.5 (7 meshes), the i-th
    instance taking ``materials[i % len(materials)]``. Above
    config.MEGA_TLAS_THRESHOLD instances it freezes into the TLAS
    regime."""
    b = SceneBuilder()
    pos, nrm = procedural.icosphere(subdivisions, radius=10.0)
    proto = b.add_triangles(pos, nrm)
    proto.material = Material(type=MaterialType.SOLID, color=(1.0, 1.0, 1.0))
    proto.scale = 0.5
    b.add_cornell_box(proto)
    side = math.ceil(math.sqrt(k))
    for i in range(k):
        b.add_mesh(dataclasses.replace(
            proto,
            pos=(-120.0 + 240.0 * (i % side) / max(side - 1, 1),
                 30.0 + 200.0 * (i // side) / max(side - 1, 1),
                 -40.0 + 10.0 * (i % 3)),
            yaw=0.3 * i, scale=0.4 + 0.02 * (i % 5),
            material=materials[i % len(materials)],
        ))
    return b.freeze(device)


def deep_chain(n: int = 70, ratio: float = 2.25, seed: int = 0):
    """(pos, nrm) of ``n`` fins whose SAH tree is a chain ``n - 2`` levels
    deep: fin k has two vertices at x = 0, +-0.1 (cos a, sin a) with an
    angle a drawn from ``seed``, and its third at (3 c, 0, 0), c =
    ``ratio`` ** k, so its centroid is (c, 0, 0). Every y and z candidate
    plane of the builder's SAH leaves a side empty (all centroids there
    are 0), and on x the largest fin's centroid is the only one past the
    plane at 1/6 of the node box (ratio > 2): each split peels one fin.
    Every box holds the points x in (0, 3), |y| < 0.036, |z| < 0.029,
    so a ray from there with a positive x component hits both children
    of every node row, whose axis is x, and visits the rest first."""
    c = np.float64(ratio) ** np.arange(n)
    ang = np.random.default_rng(seed).uniform(0.3, 1.2, n)
    a, b = 0.1 * np.cos(ang), 0.1 * np.sin(ang)
    zero = np.zeros(n)
    pos = np.stack([np.stack([zero, a, b], -1), np.stack([zero, -a, -b], -1),
                    np.stack([3.0 * c, zero, zero], -1)], 1)
    face = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    face /= np.linalg.norm(face, axis=-1, keepdims=True)
    nrm = np.broadcast_to(face[:, None], pos.shape)
    return pos.astype(np.float32), nrm.astype(np.float32)


#: Where deep_stack_scene puts the chain, and its camera's offset from
#: there: inside every box of the chain (deep_chain).
DEEP_CHAIN_POS = (0.0, 64.0, 0.0)
DEEP_CAMERA_OFFSET = (1.5, 0.015625, -0.0078125)


def deep_stack_scene(cfg: RenderConfig, arity: int = 4, device="cuda"
                     ) -> Tuple[Scene, Camera]:
    """The Cornell box around ``cfg``'s object with ``deep_chain()`` in
    it, seen from inside every box of the chain along +x (a stack-depth
    test scene): frozen with node rows of ``arity`` children
    (config.MEGA_NODE_ARITY for this freeze). At arity 4 a row holds
    three children, two levels of the SAH tree, and a primary ray pushes
    two entries at each row it descends (the resume entry and the
    second child): mega_stack_depth 36, a budget of 72 stack words, of
    which the primary rays hold 67 after trip 34 (kernel B1 keeps such
    stacks in global memory)."""
    b = SceneBuilder()
    model = _model_for(b, cfg)
    model.material = Material(type=MaterialType.SOLID, ior=1.0,
                              color=(1.0, 1.0, 1.0), specular_probability=1.0)
    model.scale = 0.5
    b.add_cornell_box(model)
    b.add_mesh(model)
    chain = b.add_triangles(*deep_chain(), max_depth=256)
    chain.material = Material(type=MaterialType.SOLID, color=(0.9, 0.6, 0.3))
    chain.pos = DEEP_CHAIN_POS
    b.add_mesh(chain)
    old = cfgmod.MEGA_NODE_ARITY
    cfgmod.MEGA_NODE_ARITY = arity
    try:
        scene = b.freeze(device)
    finally:
        cfgmod.MEGA_NODE_ARITY = old
    cam = Camera.create(position=np.add(DEEP_CHAIN_POS, DEEP_CAMERA_OFFSET),
                        yaw=math.pi / 2, fov_degrees=cfg.fov_degrees,
                        aspect_ratio=cfg.aspect_ratio, device=device)
    return scene, cam
