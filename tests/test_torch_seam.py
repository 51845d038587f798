"""The launch seam between the drivers and the megakernel's two
backends, on the CPU.

* A launch reads its scene once, in ``megakernel.scene_tables``: over one
  ``run_megakernel`` call on a BVH scene with root expansion, a dense
  scene and a TLAS scene, the ``tpurt.sync.<site>`` spans number the
  pinned per-launch totals, no scene tensor is read twice, and no read
  of a scene tensor happens outside ``scene_tables``.
* The Scene's host material types (``mesh_mat_types``), which the seam
  reads in place of the ``mat_type`` tensor, equal that tensor for every
  way the port makes a Scene.
* The backface-cull rule (Trace.cl:460-462) is ``culls_backfaces``, and
  every table that carries a cull flag carries its value.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpurt_torch import anim, viewer
from tpurt_torch.config import RenderConfig
from tpurt_torch.render import intersect
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.plucker_fused import build_dense_table
from tpurt_torch.render.renderer import flat_batch_args
from tpurt_torch.scene import builder, procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.jsonscene import scene_from_json
from tpurt_torch.scene.presets import (
    bench_scene, cornell_sphere_scene, deep_stack_scene, default_scene,
    grid_scene, scene_around)
from tpurt_torch.scene.types import (
    ARRAY_FIELDS, STATIC_FIELDS, MaterialType, culls_backfaces, from_arrays)
from tpurt_torch.utils import profiling as P

CFG = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=3,
                   object_path="sphere0.obj", mega_body="xla", pixels_per_lane=2,
                   mega_tail_passes=2, compaction_threshold=0)

#: One launch's blocking reads by site, P = 2: the scene's (``chain``: its
#: seven per-mesh tensors; ``roots``: the expanded roots' rows, none in
#: the dense mode or the TLAS regime; ``static_rows``), the camera's for
#: the one quota slot's directions, and the launch's segment count.
READS = {
    "bvh": {"chain": 7, "roots": 1, "static_rows": 1, "camera": 1, "segments": 1},
    "dense": {"chain": 7, "static_rows": 1, "camera": 1, "segments": 1},
    "tlas": {"chain": 7, "static_rows": 1, "camera": 1, "segments": 1},
}


def _launch_case(kind):
    if kind == "dense":
        cfg = CFG.replace(mega_dense=True)
        b = SceneBuilder()
        knot = b.add_triangles(*procedural.torus_knot(segments=24, sides=8,
                                                      radius=80.0, tube=22.0))
        scene, cam = scene_around(b, knot, cfg, device="cpu")
        return scene, flat_batch_args(scene, cam, cfg, 0)
    scene, cam, _ = cornell_sphere_scene(0, CFG, device="cpu")
    if kind == "tlas":
        scene = grid_scene(12, device="cpu")
    return scene, flat_batch_args(scene, cam, CFG, 0)


@pytest.mark.parametrize("kind", ["bvh", "dense", "tlas"])
def test_a_launch_reads_the_scene_once(kind, monkeypatch):
    scene, args = _launch_case(kind)
    ctx = mk.prepare(scene, **args)
    assert (ctx.tables.dense is not None) == (kind == "dense")
    assert ctx.tlas == (kind == "tlas")
    assert any(ctx.tables.params.expand) == (kind == "bvh")

    reads, inside = [], []
    read, tables = mk.host_read, mk.scene_tables

    def spy_read(t, site, to=None):
        reads.append((site, t.data_ptr() if t.numel() else None, bool(inside)))
        return read(t, site, to)

    def spy_tables(*a, **k):
        inside.append(True)
        try:
            return tables(*a, **k)
        finally:
            inside.pop()

    monkeypatch.setattr(mk, "host_read", spy_read)
    monkeypatch.setattr(mk, "scene_tables", spy_tables)
    P.reset()
    mk.run_megakernel(scene, body_backend="plain", **args)
    sites = {name[len(P.SYNC):]: rec["calls"]
             for name, rec in P.totals()["spans"].items() if name.startswith(P.SYNC)}
    assert sites == READS[kind]
    assert "mat_type" not in sites and "mesh_cull" not in sites
    assert P.totals()["counts"]["host_syncs"] == sum(READS[kind].values())

    fields = {getattr(scene, f).data_ptr(): f for f in ARRAY_FIELDS
              if getattr(scene, f).numel()}
    of_scene = [(site, fields.get(ptr), ins) for site, ptr, ins in reads
                if ptr in fields or site == "roots"]
    named = [f for _site, f, _ins in of_scene if f is not None]
    assert len(named) == len(set(named)), named
    assert "mat_type" not in named
    assert all(ins for _site, _f, ins in of_scene), of_scene
    assert len(of_scene) == sum(n for s, n in READS[kind].items()
                                if s in ("chain", "roots", "static_rows"))


def _scene_json():
    return {"meshes": [
        {"source": {"procedural": "icosphere", "subdivisions": 1, "radius": 30},
         "position": [0, 40, 0], "material": {"type": name, "ior": 1.5},
         "cornell_box": i == 0}
        for i, name in enumerate(("solid", "checker", "invisible", "glassy",
                                  "one_sided"))]}


def _made(how):
    """A Scene made the way ``how`` names, on the CPU."""
    small = CFG.replace(width=8, height=8)
    if how == "freeze":
        return _five_materials_scene()
    if how == "from_arrays":
        scene = _five_materials_scene()
        return from_arrays({f: getattr(scene, f).numpy() for f in ARRAY_FIELDS},
                           {f: getattr(scene, f) for f in STATIC_FIELDS}, device="cpu")
    if how == "jsonscene":
        return scene_from_json(_scene_json(), small, device="cpu")[0]
    if how == "default_scene":
        return default_scene(small, device="cpu")[0]
    if how == "cornell_sphere_scene":
        return cornell_sphere_scene(0, small, device="cpu")[0]
    if how == "bench_scene":
        return bench_scene("teapot", small.replace(mega_dense=True), device="cpu")[0]
    if how == "glass_model":
        return default_scene(small.replace(model_scale=1.0, model_material={
            "type": 3, "ior": 1.5, "color": [1.0, 1.0, 1.0]}), device="cpu")[0]
    if how == "grid_scene":
        return grid_scene(12, device="cpu")
    if how == "deep_stack_scene":
        return deep_stack_scene(small, device="cpu")[0]
    if how == "to":
        return _five_materials_scene().to("cpu")
    if how == "set_mesh_yaw":
        return anim.set_mesh_yaw(_five_materials_scene(), 2, 0.5)
    if how == "recolor_mesh":
        return viewer.recolor_mesh(grid_scene(12, device="cpu"), 7)
    raise ValueError(how)


def _five_materials_scene(transformed=True):
    """One small mesh of each MaterialType (transformed: each a chain
    entry of its own) and a Solid light quad."""
    b = SceneBuilder()
    pos, nrm = procedural.icosphere(1, radius=20.0)
    for k, mt in enumerate(MaterialType):
        mesh = b.add_triangles(pos, nrm)
        mesh.material = Material(type=mt, ior=1.5, color=(0.8, 0.7, 0.6))
        if transformed:
            mesh.pos, mesh.yaw = (-80.0 + 40.0 * k, 30.0, 0.0), 0.3 * k
        b.add_mesh(mesh)
    light = b.add_quad((-60, 180, -60), (60, 180, -60), (60, 180, 60),
                       (-60, 180, 60), (0, -1, 0), (0, 0, 0))
    light.material = Material(type=MaterialType.SOLID, color=(1, 1, 1),
                              emission_color=(1, 1, 1), emission_strength=5.0)
    return b.freeze("cpu")


@pytest.mark.parametrize("how", [
    "freeze", "from_arrays", "jsonscene", "default_scene",
    "cornell_sphere_scene", "bench_scene", "glass_model", "grid_scene",
    "deep_stack_scene", "to", "set_mesh_yaw", "recolor_mesh"])
def test_host_material_types_equal_the_mat_type_tensor(how):
    scene = _made(how)
    assert len(scene.mesh_mat_types) == scene.num_meshes
    assert list(scene.mesh_mat_types) == scene.mat_type.tolist()
    if how in ("freeze", "from_arrays", "jsonscene", "to", "set_mesh_yaw"):
        assert set(scene.mesh_mat_types) == {int(m) for m in MaterialType}


@pytest.mark.parametrize("mt", list(MaterialType))
def test_one_backface_cull_rule(mt):
    """Solid and Checker cull backfaces; Invisible, Glassy and OneSided
    do not. A mesh of each type carries that policy in the chain table,
    the scene tables, the dense sweep's table, an instance row's flags,
    the modular engine's mesh tables and, inline, the static stage's."""
    want = mt in (MaterialType.SOLID, MaterialType.CHECKER)
    assert culls_backfaces(mt) == culls_backfaces(int(mt)) == want
    scene = _five_materials_scene()
    i = list(MaterialType).index(mt)
    st = mk.scene_tables(scene, dense=True)
    (e,) = [e for e, (m, _r, _l) in enumerate(scene.mega_chain) if m == i]
    assert st.params.table[e, mk._CP_CULL].item() == float(want)
    assert bool(st.mesh_cull[i]) == want
    first, count = scene.mesh_tri_ranges[i]
    cols = (st.dense.owner == i) & (st.dense.ids >= 0)
    assert int(cols.sum()) == count
    assert bool((st.dense.cull[cols] == float(want)).all())
    assert bool(intersect._mesh_tables(scene)[0][i]) == want
    dense_again = build_dense_table(scene)
    assert torch.equal(dense_again.cull, st.dense.cull)

    handle = SimpleNamespace(pos=(1.0, 2.0, 3.0), pitch=0.1, yaw=0.2, roll=0.3,
                             scale=0.5, material=Material(type=mt, ior=1.5))
    grid = (np.zeros(3, np.float32), np.ones(3, np.float32))
    row, _lo, _hi = builder._instance_row(handle, 3, 0, grid, 64)
    flags = int(row.view(np.int32)[13])
    assert (flags >> 1, flags & 1) == (int(want), int(mt == MaterialType.ONE_SIDED))

    inline = _five_materials_scene(transformed=False)
    owners = np.asarray(inline.mega_static_owner)
    if (owners == i).any():
        assert {c for c, o in zip(inline.mega_static_cull, owners) if o == i} == {want}



@pytest.mark.parametrize("kind", ["bvh", "dense", "tlas", "packed", "list", "jitter"])
def test_a_context_gives_the_kernels_launch_configuration(kind):
    """The kernel's MkCfg and tables from a context, as the launch and
    fresh_lanes take them (``mega_cuda._launch_inputs``, ``ctx.tables``):
    the counts the kernel walks its tables by match the tables' shapes,
    and the kernel's chain table is the plain loop's."""
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render.renderer import list_batch_args

    if kind in ("bvh", "dense", "tlas"):
        scene, args = _launch_case(kind)
    else:
        scene, cam, _ = cornell_sphere_scene(0, CFG, device="cpu")
        args = {"packed": lambda: flat_batch_args(scene, cam, CFG, 0, frames=2),
                "list": lambda: list_batch_args(scene, cam, CFG,
                                                np.arange(300)[::-1].copy()),
                "jitter": lambda: flat_batch_args(
                    scene, cam, CFG.replace(subpixel_jitter=True), 0)}[kind]()
    ctx = mk.prepare(scene, **args)
    r = args["pixel_index"].shape[0]
    cfg = mega_cuda._launch_inputs(ctx, ctx.rows.device, r)
    assert isinstance(cfg, mega_cuda._JitterCfg if kind == "jitter" else mega_cuda._Cfg)
    st, k = ctx.tables, ctx.tables.kernel
    assert (cfg.n_lanes, cfg.e_count, cfg.num_meshes, cfg.n_static) == (
        r, len(scene.mega_chain), scene.num_meshes, len(scene.mega_static_cull))
    assert (cfg.tlas, cfg.deep, cfg.max_trips) == (int(kind == "tlas"), 0, 0)
    assert k["chain"] is st.params.table
    assert k["meta"].dtype == torch.int32 and k["meta"].shape == (
        4 * cfg.e_count + 3 * cfg.n_static + cfg.num_meshes + 1,)
    assert k["srows"].shape == (max(cfg.n_static, 1), 19)
    assert k["roots_f"].shape == (cfg.e_count, 1 + 6 * cfg.arity)
    assert k["roots_i"].shape == (cfg.e_count, cfg.arity)
    assert st.mats.shape == (cfg.num_meshes, 11) and st.mats.is_contiguous()
    if kind in ("packed", "list"):
        assert ctx.slot_rd.is_contiguous() and ctx.slot_pix.dtype == torch.int32
        assert cfg.rd_rows == ctx.slot_rd.shape[1] and ctx.slot_rd.shape[0] == 3
        assert (cfg.frames, cfg.ppf) == (2, 2)  # packed F = 2; a list quota P = 2
    else:
        assert cfg.rd_rows == ctx.slot_rd.shape[1] == CFG.pixels_per_lane - 1
