"""tpurt_torch's scene freeze against tpurt's: the megakernel banks, the
static stage, the packed materials, the chain, its parameter table and
the root-expansion tables are bit-identical (compared as uint32), and a
tpurt Scene carried across with ``scene.from_arrays`` renders the same
tables — on the Cornell sphere, the chain scene, and tpurt's K = 12
instance grid in the TLAS regime with u8 and with bf16 node bounds
(instance rows, TLAS nodes, union box and material slots included)."""

import numpy as np
import pytest
import torch

from test_torch_cuda import chain_scene, knot_obj_text
import tpurt.config as t_config
from test_many_meshes import _grid_scene
from tpurt.config import RenderConfig
from tpurt.render.megakernel import _chain_params as t_chain_params
from tpurt.render.shading import pack_materials as t_pack
from tpurt.scene import procedural as t_proc
from tpurt.scene.builder import Material as TMaterial
from tpurt.scene.builder import SceneBuilder as TBuilder
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt.scene.types import MaterialType as TMT
import tpurt_torch.config as config
from tpurt_torch import scene as port_scene
from tpurt_torch.render.megakernel import _chain_params
from tpurt_torch.render.shading import pack_materials
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.obj import parse_obj
from tpurt_torch.scene.presets import cornell_sphere_scene, grid_scene
from tpurt_torch.scene.types import ARRAY_FIELDS, STATIC_FIELDS, MaterialType


def bits(a) -> np.ndarray:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _scenes(which):
    if which == "cornell":
        cfg = RenderConfig(object_path="sphere1.obj")
        return (cornell_sphere_scene(1, cfg, device="cpu")[0],
                t_cornell(1, cfg)[0])
    if which.startswith("grid"):  # tests/test_many_meshes.py's K = 12 grid
        old = config.MEGA_BF16_BOUNDS, t_config.MEGA_BF16_BOUNDS
        config.MEGA_BF16_BOUNDS = t_config.MEGA_BF16_BOUNDS = which == "grid-bf16"
        try:
            return grid_scene(12, device="cpu"), _grid_scene(12)[0]
        finally:
            config.MEGA_BF16_BOUNDS, t_config.MEGA_BF16_BOUNDS = old
    return (chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cpu"),
            chain_scene(TBuilder, TMaterial, TMT, t_proc))


@pytest.fixture(scope="module", params=["cornell", "chain", "grid", "grid-bf16"])
def scenes(request):
    return _scenes(request.param)


def test_banks_and_static_stage_bit_equal(scenes):
    mine, theirs = scenes
    for f in ("mega_rows", "mega_static_rows", "tri_pos_a", "tri_nrm_c",
              "mesh_qmin", "mesh_qscale"):
        np.testing.assert_array_equal(bits(getattr(mine, f)),
                                      bits(getattr(theirs, f)), err_msg=f)
    for f in ("mega_chain", "mega_chain_members", "mega_stack_depth",
              "mega_static_cull", "mega_static_onesided", "mega_static_owner",
              "mesh_tri_ranges", "mesh_mat_types", "mesh_identity",
              "mega_leaf_tris", "mega_arity", "mega_bounds_fmt", "mega_tlas",
              "mega_tlas_bounds", "mesh_mat_slot", "mat_slot_rep"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.mega_rows.shape[1] == 64  # the shipped a8/l3/W64 layout


def test_materials_and_chain_tables_bit_equal(scenes):
    mine, theirs = scenes
    np.testing.assert_array_equal(bits(pack_materials(mine)),
                                  bits(t_pack(theirs)))
    p, tp = _chain_params(mine), t_chain_params(theirs)
    np.testing.assert_array_equal(bits(p.table), bits(tp.table))
    assert (p.root, p.root_leaf, p.mesh, p.expand) == (
        tp.root, tp.root_leaf, tp.mesh, tp.expand)
    if any(p.expand):
        np.testing.assert_array_equal(bits(p.roots_f), bits(tp.roots_f))
        np.testing.assert_array_equal(p.roots_i, np.asarray(tp.roots_i))


def test_from_arrays_round_trip(scenes):
    mine, theirs = scenes
    carried = port_scene.from_arrays(
        {f: np.asarray(getattr(theirs, f)) for f in ARRAY_FIELDS},
        {f: getattr(theirs, f) for f in STATIC_FIELDS}, device="cpu")
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(
            bits(getattr(carried, f)).view(np.uint8),
            bits(getattr(mine, f)).view(np.uint8), err_msg=f)
    for f in STATIC_FIELDS:
        assert getattr(carried, f) == getattr(mine, f), f
    np.testing.assert_array_equal(bits(_chain_params(carried).table),
                                  bits(_chain_params(mine).table))


def test_obj_parse_matches_tpurt():
    from tpurt.scene.obj import parse_obj as t_parse

    text = knot_obj_text()
    warned = []
    pos, nrm = parse_obj(text, warn=warned.append)
    tpos, tnrm = t_parse(text, warn=lambda m: None)
    np.testing.assert_array_equal(pos, tpos)
    np.testing.assert_array_equal(nrm, tnrm)
    assert pos.shape == (2 * 24 * 8, 3, 3) and len(warned) == 2


def test_scene_to_device_and_unported_regimes():
    """A scene moves between devices, and what used to be refused now
    freezes: more instanced meshes than MEGA_TLAS_THRESHOLD go into the
    TLAS regime, and ``from_arrays`` carries a TLAS scene across."""
    scene, _ = _scenes("cornell")
    moved = scene.to("cpu")
    assert moved.device.type == "cpu" and moved.mega_chain == scene.mega_chain
    b = SceneBuilder()
    pos, nrm = procedural.icosphere(0, radius=5.0)
    for i in range(9):  # more instanced meshes than MEGA_TLAS_THRESHOLD
        h = b.add_triangles(pos, nrm)
        h.pos = (10.0 * (i + 1), 0.0, 0.0)
        b.add_mesh(h)
    tlas = b.freeze("cpu")
    assert tlas.mega_tlas and tlas.mega_chain[-1][0] == -2
    assert len(tlas.mega_tlas_bounds) == 6 and tlas.mat_slot_rep == (0,)
    carried = port_scene.from_arrays(
        {f: getattr(tlas, f).numpy() for f in ARRAY_FIELDS},
        {f: getattr(tlas, f) for f in STATIC_FIELDS}, device="cpu")
    assert carried.mega_tlas and carried.mega_chain == tlas.mega_chain
    assert carried.mega_tlas_bounds == tlas.mega_tlas_bounds
    assert torch.equal(carried.mega_rows.view(torch.int32),
                       tlas.mega_rows.view(torch.int32))



def _boxed(builder_cls, material_cls, mt, pos, nrm, box=True, device=None):
    """A Glassy identity mesh in the Cornell box built around it (the
    glass-cornell layout at a test size), or beside one light quad,
    frozen by either package's builder; returns (scene, the mesh's
    index)."""
    b = builder_cls()
    model = b.add_triangles(pos, nrm)
    model.material = material_cls(type=mt.GLASSY, ior=1.5, color=(1.0, 1.0, 1.0))
    if box:
        b.add_cornell_box(model)
    else:
        light = b.add_quad((-60, 180, -60), (60, 180, -60), (60, 180, 60),
                           (-60, 180, 60), (0, -1, 0), (0, 0, 0))
        light.material = material_cls(type=mt.SOLID, color=(1, 1, 1),
                                      emission_color=(1, 1, 0.9),
                                      emission_strength=10.0)
    i = b.add_mesh(model)
    return (b.freeze() if device is None else b.freeze(device)), i


def _assert_banks_equal(mine, theirs):
    for f in ("mega_rows", "mega_static_rows"):
        np.testing.assert_array_equal(bits(getattr(mine, f)),
                                      bits(getattr(theirs, f)), err_msg=f)
    for f in ("mega_chain", "mega_chain_members", "mega_stack_depth",
              "mega_static_owner", "mega_static_cull", "mega_static_onesided"):
        assert getattr(mine, f) == getattr(theirs, f), f


@pytest.mark.parametrize("sub", [2, 3])
def test_a_large_fused_static_bvh_is_built_natively_as_tpurts(sub, monkeypatch):
    """A fused static BVH of NATIVE_BVH_MIN_TRIS triangles or more (an
    identity icosphere(3), 1,280 triangles, and a light quad) is built by
    the native builder, its owner ids permuted alongside, and the bank is
    tpurt's (numpy-built) bit for bit; below the threshold (icosphere(2),
    320 + 2) the numpy builder builds it, as before."""
    from tpurt_torch import _native
    from tpurt_torch.scene import builder

    calls = []
    inner = _native.build_bvh

    def spy(*a, **k):
        calls.append(k.get("aux") is not None)
        return inner(*a, **k)

    monkeypatch.setattr(_native, "build_bvh", spy)
    pos, nrm = procedural.icosphere(sub, radius=40.0)
    mine, i = _boxed(SceneBuilder, Material, MaterialType, pos, nrm, box=False,
                     device="cpu")
    theirs, _ti = _boxed(TBuilder, TMaterial, TMT,
                         *t_proc.icosphere(sub, radius=40.0), box=False)
    big = len(pos) + 2 >= builder.NATIVE_BVH_MIN_TRIS
    assert mine.mega_chain[0][0] == -1 and i in mine.mega_chain_members[0]
    # add_triangles' own build of the sphere, then the fused one with ids.
    assert calls == ([False, True] if big else [])
    _assert_banks_equal(mine, theirs)


def test_box_onesided_quads_stay_inline_beside_a_large_identity_mesh():
    """A Cornell box around an identity mesh of 512 triangles: the model
    and the box's six two-sided quads share the fused static BVH, built
    natively; the one-sided front quad, which that BVH cannot hold, stays
    inline instead of taking a chain entry of its own (tpurt's layout);
    the fused BVH is the one tpurt builds over the same members."""
    from tpurt_torch.scene.builder import NATIVE_BVH_MIN_TRIS

    pos, nrm = procedural.torus_knot(segments=32, sides=8, radius=80.0,
                                     tube=22.0)
    assert len(pos) == NATIVE_BVH_MIN_TRIS == 512
    mine, i = _boxed(SceneBuilder, Material, MaterialType, pos, nrm,
                     device="cpu")
    theirs, _ti = _boxed(TBuilder, TMaterial, TMT, *t_proc.torus_knot(
        segments=32, sides=8, radius=80.0, tube=22.0))
    front = 2  # floor, ceiling, front: add_cornell_box's order
    assert int(mine.mesh_mat_types[front]) == int(MaterialType.ONE_SIDED)
    assert theirs.mega_chain == ((-1, 0, False),
                                 (front, len(theirs.mega_rows) - 1, True))
    assert mine.mega_chain == ((-1, 0, False),)
    assert mine.mega_chain_members == theirs.mega_chain_members[:1]
    assert i in mine.mega_chain_members[0]
    assert mine.mega_static_owner == (front, front)
    assert mine.mega_static_onesided == (True, True)
    assert mine.mega_static_cull == (False, False)
    np.testing.assert_array_equal(bits(mine.mega_rows),
                                  bits(theirs.mega_rows[:-1]))
