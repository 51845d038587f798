"""Declarative JSON scene files (port of tpurt/scene/jsonscene.py).

The reference has no scene description beyond hard-coded C++
(settings.hpp globals + addCornellBoxToScene); this gives users a data
format for the same capabilities. Schema:

{
  "camera": {"position": [0,150,250], "pitch": 0, "yaw": 3.14,
             "roll": 0, "fov_degrees": 90},
  "meshes": [
    {"source": {"obj": "model.obj"}            # or
               {"procedural": "icosphere", "subdivisions": 3, "radius": 100}
               {"procedural": "torus_knot", ...}
               {"procedural": "box", "size": [1,1,1]}
               {"quad": {"corners": [[..],[..],[..],[..]], "normal": [..]}},
     "position": [0,0,0], "pitch": 0, "yaw": 0, "roll": 0, "scale": 1,
     "material": {"type": "solid|checker|invisible|glassy|one_sided",
                  "color": [1,1,1], "ior": 1.0,
                  "emission_color": [0,0,0], "emission_strength": 0,
                  "reflectiveness": 0, "specular_probability": 0},
     "cornell_box": false}                     # wrap this mesh in the box
  ]
}
"""

from __future__ import annotations

from typing import Tuple

from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.types import MaterialType, Scene

_TYPES = {
    "solid": MaterialType.SOLID,
    "checker": MaterialType.CHECKER,
    "invisible": MaterialType.INVISIBLE,
    "glassy": MaterialType.GLASSY,
    "one_sided": MaterialType.ONE_SIDED,
}


def _material(spec: dict) -> Material:
    return Material(
        type=_TYPES[spec.get("type", "solid")],
        ior=float(spec.get("ior", 1.0)),
        color=tuple(spec.get("color", (0, 0, 0))),
        emission_color=tuple(spec.get("emission_color", (0, 0, 0))),
        emission_strength=float(spec.get("emission_strength", 0.0)),
        reflectiveness=float(spec.get("reflectiveness", 0.0)),
        specular_probability=float(spec.get("specular_probability", 0.0)),
    )


def _geometry(b: SceneBuilder, source: dict):
    if "obj" in source:
        return b.load_obj(source["obj"])
    if "quad" in source:
        q = source["quad"]
        a, bb, c, d = q["corners"]
        handle = b.add_quad(a, bb, c, d, q["normal"], (1, 1, 1))
        b.meshes.pop()  # add_quad auto-appends; JSON controls placement
        return handle
    p = source.get("procedural")
    if p == "icosphere":
        pos, nrm = procedural.icosphere(
            int(source.get("subdivisions", 3)), float(source.get("radius", 1.0))
        )
    elif p == "torus_knot":
        pos, nrm = procedural.torus_knot(
            p=int(source.get("p", 2)), q=int(source.get("q", 3)),
            segments=int(source.get("segments", 256)),
            sides=int(source.get("sides", 32)),
            radius=float(source.get("radius", 1.0)),
            tube=float(source.get("tube", 0.3)),
        )
    elif p == "box":
        pos, nrm = procedural.box(tuple(source.get("size", (1, 1, 1))))
    else:
        raise ValueError(f"unknown geometry source: {source}")
    return b.add_triangles(pos, nrm)


def scene_from_json(spec: dict, cfg: RenderConfig,
                    device="cuda") -> Tuple[Scene, Camera]:
    """The scene and camera a JSON spec (the schema above) describes, on
    ``device``."""
    b = SceneBuilder()
    for mesh_spec in spec.get("meshes", []):
        handle = _geometry(b, mesh_spec["source"])
        if "material" in mesh_spec:
            handle.material = _material(mesh_spec["material"])
        handle.pos = tuple(mesh_spec.get("position", (0.0, 0.0, 0.0)))
        handle.pitch = float(mesh_spec.get("pitch", 0.0))
        handle.yaw = float(mesh_spec.get("yaw", 0.0))
        handle.roll = float(mesh_spec.get("roll", 0.0))
        handle.scale = float(mesh_spec.get("scale", 1.0))
        if mesh_spec.get("cornell_box"):
            b.add_cornell_box(handle)  # box quads appended before the model
        b.add_mesh(handle)

    cam_spec = spec.get("camera", {})
    cam = Camera.create(
        position=cam_spec.get("position", cfg.camera_position),
        pitch=cam_spec.get("pitch", cfg.camera_pitch),
        yaw=cam_spec.get("yaw", cfg.camera_yaw),
        roll=cam_spec.get("roll", cfg.camera_roll),
        fov_degrees=cam_spec.get("fov_degrees", cfg.fov_degrees),
        aspect_ratio=cfg.aspect_ratio, device=device,
    )
    return b.freeze(device), cam
