"""tpurt_torch's own copies of what it reads from tpurt: ``RenderConfig``
(field names, defaults, order and refusals), the module constants, and
the SAH builder (numpy below 512 triangles, the C++ builder from the
port's csrc/ above) — whose trees must give the modular engine's
threaded-BVH fields bit for bit as tpurt's freeze gives them. And the
scene and camera entry points default to the card."""

import dataclasses
import inspect

import numpy as np
import pytest

import tpurt.config as t_config
from tpurt.scene import procedural as t_proc
from tpurt.scene.builder import SceneBuilder as TBuilder
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt_torch import _native
from tpurt_torch import config as p_config
from tpurt_torch.accel import bvh as p_bvh
from tpurt_torch.core.camera import Camera
from tpurt_torch.scene import procedural, types
from tpurt_torch.scene import presets
from tpurt_torch.scene.builder import SceneBuilder
from tpurt_torch.scene.presets import cornell_sphere_scene

BVH_FIELDS = ("node_min", "node_max", "node_index", "node_ntris", "node_hit",
              "node_miss", "node_q", "tri_packed", "mesh_qmin", "mesh_qscale",
              "mesh_root", "tri_pos_a", "tri_nrm_b")


def bits(a) -> np.ndarray:
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def test_render_config_fields_and_defaults_match():
    t_fields = [(f.name, f.default) for f in dataclasses.fields(t_config.RenderConfig)]
    p_fields = [(f.name, f.default) for f in dataclasses.fields(p_config.RenderConfig)]
    n = len(t_fields)
    assert p_fields[:n] == t_fields
    assert dict(p_fields[n:]) == p_config.MODEL_FIELDS
    assert list(p_config.MODEL_FIELDS) == [name for name, _ in p_fields[n:]]
    cfg = p_config.RenderConfig(width=640, height=480)
    ref = t_config.RenderConfig(width=640, height=480)
    assert p_config.tpurt_knobs(cfg) == dataclasses.asdict(ref)
    glass = cfg.replace(model_material={"type": 3, "ior": 1.5}, model_scale=1.0)
    assert set(p_config.tpurt_knobs(glass)) - set(dataclasses.asdict(ref)) == {
        "model_material", "model_scale"}
    assert (cfg.tile_size, cfg.tiles(), cfg.aspect_ratio) == (
        ref.tile_size, ref.tiles(), ref.aspect_ratio)
    assert cfg.replace(engine="modular").engine == "modular"


@pytest.mark.parametrize("bad", [
    dict(seed_mode="other"), dict(engine="other"), dict(dense_engine="other"),
    dict(mega_body="other"), dict(width=0), dict(height=-1),
    dict(rays_per_pixel=0), dict(pixels_per_lane=0), dict(mega_interleave=0),
    dict(mega_tail_passes=0), dict(mega_schedule="other"),
    dict(sample_flatten=True),
])
def test_render_config_refusals_match(bad):
    with pytest.raises(ValueError) as theirs:
        t_config.RenderConfig(**bad)
    with pytest.raises(ValueError) as mine:
        p_config.RenderConfig(**bad)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("name", [
    "CORNELL_BREATHING_ROOM", "EPSILON", "IOR_AIR", "SELECT_GATHER_THRESHOLD",
    "MEGA_TLAS_THRESHOLD", "MEGA_SKIP_CAP", "MEGA_ROOT_EXPAND",
    "MEGA_ROOT_EXPAND_MAX_E", "MEGA_EXPAND_PASSES", "MEGA_LEAF_TRIS",
    "MEGA_NODE_ARITY", "MEGA_BF16_BOUNDS",
])
def test_constants_match(name):
    assert getattr(p_config, name) == getattr(t_config, name)


def _knot_scenes():
    """A 6,144-triangle mesh (native builder) beside a 20-triangle one
    (numpy builder), each transformed, plus the Cornell box."""
    out = []
    for builder, proc, kw in ((SceneBuilder, procedural, {"device": "cpu"}),
                              (TBuilder, t_proc, {})):
        b = builder()
        knot = b.add_triangles(*proc.torus_knot(segments=96, sides=32,
                                                radius=80.0, tube=22.0))
        knot.scale, knot.yaw = 0.5, 0.3
        b.add_cornell_box(knot)
        b.add_mesh(knot)
        ball = b.add_triangles(*proc.icosphere(0, radius=20.0))
        ball.pos = (40.0, 30.0, 0.0)
        b.add_mesh(ball)
        out.append(b.freeze(**kw))
    return out


@pytest.mark.parametrize("which", ["cornell-sphere", "knot"])
def test_threaded_bvh_fields_bit_equal(which):
    if which == "knot":
        mine, theirs = _knot_scenes()
        assert mine.num_triangles > 6144
    else:
        cfg = t_config.RenderConfig(object_path="sphere1.obj")
        mine = cornell_sphere_scene(1, cfg, device="cpu")[0]
        theirs = t_cornell(1, cfg)[0]
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(bits(getattr(mine, f)),
                                      bits(getattr(theirs, f)), err_msg=f)
    assert mine.max_leaf_tris == theirs.max_leaf_tris
    assert mine.mesh_tri_ranges == theirs.mesh_tri_ranges


def test_native_builder_matches_numpy_builder():
    """The C++ builder and the numpy builder make the same tree."""
    pos, nrm = procedural.torus_knot(segments=24, sides=8, radius=30.0, tube=8.0)
    pos, nrm = np.ascontiguousarray(pos), np.ascontiguousarray(nrm)
    p2, n2 = pos.copy(), nrm.copy()
    nodes = p_bvh.BVHNodes.empty()
    p_bvh.build_bvh(nodes, p2, n2, 0, len(pos), 64)
    mine = _native.build_bvh(pos, nrm, 0, len(pos), 64, p_bvh.DEFAULT_LEAF_CAP)
    ref = nodes.as_arrays()
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pos, p2)
    with pytest.raises(ValueError, match="contiguous"):
        _native.build_bvh(pos[:, ::-1], nrm, 0, 4, 64, 2)


@pytest.mark.parametrize("fn", [
    Camera.create, SceneBuilder.freeze, types.from_arrays,
    presets.scene_around, presets.default_scene, presets.cornell_sphere_scene,
    presets.bench_scene,
])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
