"""The modular engine on the CPU: tpurt_torch's intersection, brute-force
sweeps, shading wrapper, integrator and tile renderer against tpurt's
and the scalar oracle.

* ``intersect_scene`` on random rays into the chain scene (a fused
  identity mesh, two transformed instances, a light quad) with
  ``bruteforce_threshold`` 4096 (every mesh swept) and 16 (every mesh
  but the light walks its threaded BVH): valid, mesh and backface equal
  on every ray. Distances are not all bit-identical: XLA's CPU rsqrt is
  not the correctly rounded 1/sqrt the port uses to normalise the local
  direction, and its instance-transform contractions round differently.
  Measured on four ray sets: 42-64% of hits bit-identical, 96-98% within
  4 ulp, the largest relative difference 1.8e-5 (ROADMAP C); the bound
  is >= 95% within 4 ulp and 3e-5 relative on all.
* kernel B3's plain version against tpurt's ``mt_sweep_pallas`` in
  interpret mode (icosphere(1), 64 rays): indices equal, t within rtol
  1e-4 (tests/test_pallas.py's bound); against the exact sweep: equal.
* ``shade_hit`` / ``select_material``, the row-layout wrappers.
* Frames of the 16x16 golden scene through ``engine="modular"`` with each
  dense engine, both seed modes, and a frame with cropped edge tiles:
  <= 0.5% of pixels differ from tpurt's modular frames and the oracle
  (tpurt's own knife-edge bound), equal segment counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from test_render_golden import assert_mostly_bitwise
from test_torch_cuda import chain_scene
from test_torch_shading import _batch, ulps
from tpurt.config import RenderConfig
from tpurt.render import intersect as t_intersect
from tpurt.render import renderer as t_renderer
from tpurt.render.pallas_kernels import mt_sweep_pallas
from tpurt.render.pallas_kernels import pad_tri_rows as t_pad
from tpurt.render.shading import select_material as t_select
from tpurt.render.shading import shade_hit as t_shade
from tpurt.scene import procedural as t_proc
from tpurt.scene.builder import Material as TMaterial
from tpurt.scene.builder import SceneBuilder as TBuilder
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt.scene.types import MaterialType as TMT
from tpurt_torch import config as p_config
from tpurt_torch.render import mt_sweep
from tpurt_torch.render import renderer
from tpurt_torch.render.intersect import intersect_scene
from tpurt_torch.render.shading import select_material, shade_hit
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.presets import cornell_sphere_scene
from tpurt_torch.scene.types import MaterialType

GOLDEN = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=3,
                      tile_size=16, object_path="sphere0.obj", engine="modular")


def port(cfg: RenderConfig) -> p_config.RenderConfig:
    """The port's config of tpurt's (the port's own fields at their
    defaults)."""
    return p_config.RenderConfig(**{f: getattr(cfg, f) for f in
                                    RenderConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def chain_pair():
    return (chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cpu"),
            chain_scene(TBuilder, TMaterial, TMT, t_proc))


def _rays(seed, n=4096):
    r = np.random.default_rng(seed)
    o = r.uniform(-150, 150, (n, 3)).astype(np.float32)
    o[:, 1] = r.uniform(-40, 200, n)
    target = r.uniform(-70, 70, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("threshold", [4096, 16])
@pytest.mark.parametrize("engine", ["exact", "pallas", "plucker"])
def test_intersect_scene_matches_tpurt(chain_pair, threshold, engine):
    mine_scene, their_scene = chain_pair
    o, d = _rays(threshold)
    mine = intersect_scene(mine_scene, torch.from_numpy(o), torch.from_numpy(d),
                           threshold, engine)
    theirs = t_intersect.intersect_scene(their_scene, jnp.asarray(o),
                                         jnp.asarray(d), threshold, engine)
    valid = np.asarray(theirs.valid)
    assert 0.3 < valid.mean() < 0.95  # both hits and misses are exercised
    if engine == "plucker":
        # The fast dense form: acceptance knife edges within ~1 ulp.
        agree = (mine.mesh_idx.numpy() == np.asarray(theirs.mesh_idx)).mean()
        assert agree >= 0.995, agree
        return
    for f in ("valid", "mesh_idx", "backface"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
    a, b = mine.dst.numpy()[valid], np.asarray(theirs.dst)[valid]
    within = (ulps(a, b) <= 4).mean()
    assert within >= 0.95 and (np.abs(a - b) / b).max() <= 3e-5, within
    np.testing.assert_allclose(mine.point.numpy()[valid],
                               np.asarray(theirs.point)[valid], rtol=3e-5,
                               atol=1e-3)


def _sphere_rows():
    pos, nrm = procedural.icosphere(1, radius=50.0)
    rows = np.concatenate([pos.reshape(-1, 9), nrm.reshape(-1, 9)], 1)
    cull = np.arange(len(rows)) % 3 != 0
    r = np.random.default_rng(7)
    o = r.uniform(-120, 120, (64, 3)).astype(np.float32)
    d = r.uniform(-80, 80, (64, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return rows.astype(np.float32), cull, o, d


def test_mt_sweep_plain_matches_tpurt_interpret():
    rows, cull, o, d = _sphere_rows()
    t_rows, t_flags = t_pad(rows, cull)
    t_t, t_i = mt_sweep_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_rows),
                               jnp.asarray(t_flags), len(rows), interpret=True)
    p_rows, p_flags = mt_sweep.pad_tri_rows(torch.from_numpy(rows),
                                            torch.from_numpy(cull))
    np.testing.assert_array_equal(p_rows.numpy(), t_rows)
    np.testing.assert_array_equal(p_flags.numpy(), t_flags)
    before = mt_sweep.LAUNCHES
    t, i = mt_sweep.mt_sweep(torch.from_numpy(o), torch.from_numpy(d), p_rows,
                             p_flags, len(rows))
    assert mt_sweep.LAUNCHES == before  # a CPU tensor runs the plain version
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(t_i))
    hit = i.numpy() >= 0
    assert 0 < hit.sum() < len(hit)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(t_t)[hit], rtol=1e-4)
    assert np.isinf(t.numpy()[~hit]).all()


def test_mt_sweep_plain_is_the_exact_first_minimum():
    """Duplicate rows tie: the lower row wins, as in the exact sweep."""
    rows, cull, o, d = _sphere_rows()
    rows = np.concatenate([rows, rows])
    cull = np.concatenate([cull, cull])
    p_rows, p_flags = mt_sweep.pad_tri_rows(torch.from_numpy(rows),
                                            torch.from_numpy(cull))
    t, i = mt_sweep.mt_sweep(torch.from_numpy(o), torch.from_numpy(d), p_rows,
                             p_flags, len(rows))
    assert (i.numpy() < len(rows) // 2).all()
    t1, i1 = mt_sweep.mt_sweep(torch.from_numpy(o), torch.from_numpy(d), p_rows,
                               p_flags, len(rows) // 2)
    np.testing.assert_array_equal(i.numpy(), i1.numpy())
    np.testing.assert_array_equal(t.numpy(), t1.numpy())


def test_shade_hit_and_select_material_match_tpurt(chain_pair):
    mine_scene, their_scene = chain_pair
    b = _batch(3, n=4096)
    b["hit_mesh"] = np.random.default_rng(3).integers(-1, 4, 4096).astype(np.int32)
    mesh = np.clip(b["hit_mesh"], 0, 3)
    for a, t in zip(select_material(mine_scene, torch.from_numpy(mesh)),
                    t_select(their_scene, jnp.asarray(mesh))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(t))
    pin = {k: torch.from_numpy(v.astype(np.int64) if k == "rng" else v)
           for k, v in b.items()}
    mine = shade_hit(mine_scene, max_bounces=5, **pin)
    theirs = t_shade(their_scene, max_bounces=5,
                     **{k: jnp.asarray(v) for k, v in b.items()})
    np.testing.assert_array_equal(mine.rng.numpy().astype(np.uint32),
                                  np.asarray(theirs.rng))
    for f in ("bounces", "continuing", "invisible"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(theirs, f)), err_msg=f)
    for f in ("origin", "throughput", "light"):
        assert ulps(getattr(mine, f).numpy(),
                    np.asarray(getattr(theirs, f))).max() <= 4, f
    assert mine.direction.shape == (4096, 3)


@pytest.fixture(scope="module")
def oracle_frame():
    tscene, tcam, _ = t_cornell(0, GOLDEN)
    return oracle.render(tscene, tcam, 16, 16, 2, 3)


@pytest.mark.parametrize("seed_mode,dense", [
    ("reference", "exact"), ("reference", "pallas"), ("reference", "plucker"),
    ("decorrelated", "pallas"),
])
def test_modular_frame_matches_tpurt_and_oracle(oracle_frame, seed_mode, dense):
    cfg = GOLDEN.replace(seed_mode=seed_mode, dense_engine=dense)
    tscene, tcam, _ = t_cornell(0, cfg)
    tstats = {}
    theirs = t_renderer.render_frame(tscene, tcam, cfg, stats=tstats)
    scene, cam, _ = cornell_sphere_scene(0, port(cfg), device="cpu")
    stats = {}
    mine = renderer.render_frame(scene, cam, port(cfg), stats=stats)
    assert_mostly_bitwise(mine, theirs)
    assert stats["segments"] == int(tstats["segments"])
    if seed_mode == "reference":
        ref, ref_px = oracle_frame
        assert_mostly_bitwise(mine, ref)
        img = renderer.render_image(scene, cam, port(cfg))
        assert img.dtype == np.uint8 and img.shape == (16, 16, 3)
        assert_mostly_bitwise(img, ref_px)


def test_modular_edge_tiles_and_tile_entry_points():
    cfg = GOLDEN.replace(width=24, height=20, tile_size=16, rays_per_pixel=1)
    tscene, tcam, _ = t_cornell(0, cfg)
    theirs = t_renderer.render_frame(tscene, tcam, cfg)
    scene, cam, _ = cornell_sphere_scene(0, port(cfg), device="cpu")
    mine = renderer.render_frame(scene, cam, port(cfg))
    assert mine.shape == (20, 24, 3)
    assert_mostly_bitwise(mine, np.asarray(theirs))
    tile, segs = renderer.render_tile_with_stats(scene, cam, port(cfg), 16, 16,
                                                 8, 8)
    t_tile, t_segs = t_renderer.render_tile_with_stats(tscene, tcam, cfg, 16, 16,
                                                       8, 8)
    assert tile.shape == (8, 8, 3) and segs == int(t_segs)
    assert_mostly_bitwise(tile.numpy(), np.asarray(t_tile))
    np.testing.assert_array_equal(
        renderer.render_tile(scene, cam, port(cfg), 16, 16, 8, 8).numpy(),
        tile.numpy())


def test_modular_accumulator_raises():
    """Accumulators are ported: a modular frame through a
    TileAccumulator equals the frame without one, a second frame resumes
    every tile from it, and an object that is not an accumulator
    raises."""
    from tpurt_torch.io.checkpoint import TileAccumulator

    cfg = port(GOLDEN).replace(tile_size=8)
    scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
    want = renderer.render_frame(scene, cam, cfg)
    acc = TileAccumulator(cfg)
    np.testing.assert_array_equal(
        renderer.render_frame(scene, cam, cfg, accumulator=acc), want)
    assert acc.num_tiles == 4
    stats = {}
    np.testing.assert_array_equal(
        renderer.render_frame(scene, cam, cfg, accumulator=acc, stats=stats),
        want)
    assert stats["segments"] == 0  # every tile came from the accumulator
    with pytest.raises(AttributeError):
        renderer.render_frame(scene, cam, cfg, accumulator=object())
