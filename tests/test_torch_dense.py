"""The brute-force megakernel (RenderConfig.mega_dense) on the CPU:
tpurt_torch's dense table, kernel B2's plain version and the dense loop
against tpurt's.

* ``component_rows`` and ``build_dense_table`` against tpurt's: ids,
  owner, entry, cull and orient exactly equal. Coefficients are cross
  and dot products, which XLA's CPU backend contracts into fused
  multiply-adds and the port does not (it must not: the kernel is built
  with -fmad=false to stay bitwise with the plain version on the card).
  Where a difference cancels, one rounding of a product shows as many
  ulps of the small result, so the bound is 2 ulp at the products' own
  scale (ROADMAP C).
* The plain sweep against tpurt's ``sweep_entry_local`` in interpret
  mode, over the three chain entries of the chain scene: winner columns
  equal on >= 99.5% of rays (measured: all, on three ray sets); where
  they agree, t within 2 ulp on >= 85% (measured 90-92%) and within 1e-5
  relative on all (measured <= 4.9e-6): the plane sums cancel, and the
  fused products above carry into t (the fast-dense contract).
* Lane state after 1 and 4 trips and whole 16x16 frames (2 spp,
  3 bounces, Cornell box around a small icosphere) against tpurt's dense
  XLA body: integer fields equal on >= 99.5% of lanes; <= 0.5% of pixels
  differ, segment counts within 0.5%.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_render_golden import assert_mostly_bitwise
from test_torch_cuda import chain_scene
from test_torch_megakernel import port_lane
from test_torch_modular import port
from test_torch_shading import ulps
from tpurt.config import RenderConfig
from tpurt.core.v3 import V3 as TV3
from tpurt.render import plucker as t_plucker
from tpurt.render import plucker_fused as t_fused
from tpurt.render import renderer as t_renderer
from tpurt.scene import procedural as t_proc
from tpurt.scene.builder import Material as TMaterial
from tpurt.scene.builder import SceneBuilder as TBuilder
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt.scene.types import MaterialType as TMT
from tpurt_torch.core.v3 import V3
from tpurt_torch.core.vecmath import cross3
from tpurt_torch.render import mega_cuda
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render import plucker_fused
from tpurt_torch.render.plucker import component_rows
from tpurt_torch.render.renderer import flat_batch_args, render_frame
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.presets import cornell_sphere_scene
from tpurt_torch.scene.types import MaterialType

DENSE = RenderConfig(width=16, height=16, rays_per_pixel=2, max_bounces=3,
                     tile_size=16, object_path="sphere1.obj", mega_body="xla",
                     mega_dense=True, compaction_threshold=0)


@pytest.fixture(scope="module")
def chain_pair():
    return (chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cpu"),
            chain_scene(TBuilder, TMaterial, TMT, t_proc))


def _product_scale(pa, e1, e2):
    """(4, 10, T) magnitudes of the products behind each coefficient."""
    n = lambda a: np.linalg.norm(a, axis=-1)
    ones = np.ones(len(pa))
    det = [n(e1) * n(e2)] * 3 + [ones] * 7
    u = [n(pa) * n(e2)] * 3 + [n(e2)] * 3 + [ones] * 4
    v = [n(pa) * n(e1)] * 3 + [n(e1)] * 3 + [ones] * 4
    t = [ones] * 6 + [n(e1) * n(e2)] * 3 + [n(pa) * n(e1) * n(e2)]
    return np.stack([np.stack(x) for x in (det, u, v, t)])


def assert_close_at_scale(mine, theirs, scale):
    assert (np.abs(mine - theirs) <= 2.0 ** -22 * scale).all(), (
        np.abs(mine - theirs) / scale).max()


def test_component_rows_match_tpurt():
    r = np.random.default_rng(0)
    pa, pb, pc = (r.uniform(-100, 100, (500, 3)).astype(np.float32)
                  for _ in range(3))
    e1, e2 = pb - pa, pc - pa
    mine = component_rows(*(torch.from_numpy(a) for a in (pa, e1, e2)),
                          cross3(torch.from_numpy(e1), torch.from_numpy(e2)))
    theirs = t_plucker.component_rows(
        *(jnp.asarray(a) for a in (pa, e1, e2)),
        jnp.cross(jnp.asarray(e1), jnp.asarray(e2)))
    mine = np.stack([a.numpy() for a in mine])
    assert mine.shape == (4, 10, 500)
    assert_close_at_scale(mine, np.stack([np.asarray(b) for b in theirs]),
                          _product_scale(pa, e1, e2))


def test_dense_table_matches_tpurt(chain_pair):
    mine_scene, their_scene = chain_pair
    mine = plucker_fused.build_dense_table(mine_scene)
    theirs = t_fused.build_dense_table(their_scene)
    n = theirs.count
    assert mine.count == n and mine.ids.shape[0] % plucker_fused.COL_CHUNK == 0
    for f in ("ids", "owner", "entry", "cull", "orient"):
        np.testing.assert_array_equal(getattr(mine, f).numpy()[:n],
                                      np.asarray(getattr(theirs, f))[0, :n],
                                      err_msg=f)
    assert (mine.ids.numpy()[n:] == -1).all() and (mine.entry.numpy()[n:] == -1).all()
    rows = mine.rows.numpy()[:n]
    pa = rows[:, 0:3]
    assert_close_at_scale(mine.coeffs.numpy()[:, :, :n],
                          np.asarray(theirs.coeffs)[:, :10, :n],
                          _product_scale(pa, rows[:, 3:6] - pa, rows[:, 6:9] - pa))
    starts = [int(np.argmax(mine.entry.numpy() == e)) for e in range(3)]
    assert mine.entry_range.numpy().tolist() == [
        [starts[0], starts[1]], [starts[1], starts[2]], [starts[2], n]]
    np.testing.assert_array_equal(
        mine.rows.numpy()[:n], mine_scene.tri_packed.numpy()[mine.ids.numpy()[:n]])


def _local_rays(scene, n=1024, seed=0):
    """Rays aimed at random triangles of each lane's chain entry, in that
    entry's local frame (the fused entry's frame is the world's)."""
    r = np.random.default_rng(seed)
    table = plucker_fused.build_dense_table(scene)
    entry = r.integers(0, 3, n).astype(np.int32)
    ranges = table.entry_range.numpy()
    col = r.integers(ranges[entry, 0], ranges[entry, 1])
    tri = scene.tri_packed.numpy()[table.ids.numpy()[col]]
    w = r.dirichlet((1, 1, 1), n).astype(np.float32) * 1.2 - 0.1
    target = (tri[:, 0:3] * w[:, :1] + tri[:, 3:6] * w[:, 1:2]
              + tri[:, 6:9] * w[:, 2:3])
    o = (target + r.normal(size=(n, 3)) * 60.0).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return table, entry, o, d


def test_plain_sweep_matches_tpurt_interpret(chain_pair):
    mine_scene, their_scene = chain_pair
    table, entry, o, d = _local_rays(mine_scene)
    t, col = plucker_fused.sweep_plain(
        V3(*(torch.from_numpy(o[:, i].copy()) for i in range(3))),
        V3(*(torch.from_numpy(d[:, i].copy()) for i in range(3))),
        torch.from_numpy(entry), table)
    tt, tcol = t_fused.sweep_entry_local(
        TV3(*(jnp.asarray(o[:, i]) for i in range(3))),
        TV3(*(jnp.asarray(d[:, i]) for i in range(3))),
        jnp.asarray(entry), t_fused.build_dense_table(their_scene),
        interpret=True)
    col, tcol = col.numpy(), np.asarray(tcol)
    hit = tcol >= 0
    assert 0.3 < hit.mean() < 0.99
    same = col == tcol
    assert same.mean() >= 0.995, same.mean()
    both = same & hit
    a, b = t.numpy()[both], np.asarray(tt)[both]
    assert (ulps(a, b) <= 2).mean() >= 0.85
    assert (np.abs(a - b) / b).max() <= 1e-5
    assert np.isinf(t.numpy()[col < 0]).all()
    # every winner lies in its lane's own entry
    won = col >= 0
    assert (table.entry.numpy()[col[won]] == entry[won]).all()


def test_sweep_wrapper_on_cpu_is_the_plain_version(chain_pair):
    mine_scene, _ = chain_pair
    table, entry, o, d = _local_rays(mine_scene, n=256, seed=1)
    lo = V3(*(torch.from_numpy(o[:, i].copy()) for i in range(3)))
    ld = V3(*(torch.from_numpy(d[:, i].copy()) for i in range(3)))
    before = plucker_fused.LAUNCHES
    a = plucker_fused.sweep_entry_local(lo, ld, torch.from_numpy(entry), table)
    b = plucker_fused.sweep_plain(lo, ld, torch.from_numpy(entry), table)
    assert plucker_fused.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="dense table"):
        plucker_fused.check_table(table, torch.device("meta"))


@pytest.fixture(scope="module")
def dense_states():
    tscene, tcam, _ = t_cornell(1, DENSE)
    statics = t_renderer._mega_statics(DENSE, DENSE.width, DENSE.height)
    b = t_renderer._flat_batch_size(DENSE)
    states = {}
    for k in (1, 4):
        st, _ = t_renderer._mega_flat_start(
            tscene, tcam, jnp.asarray([0, 0, 0, k], jnp.int32), batch=b,
            pixels_per_lane=1, **statics)
        states[k] = port_lane(st)
    scene, cam, _ = cornell_sphere_scene(1, port(DENSE), device="cpu")
    return scene, cam, states


@pytest.mark.parametrize("trips", [1, 4])
def test_dense_lane_state_matches_tpurt(dense_states, trips):
    scene, cam, theirs = dense_states
    args = flat_batch_args(scene, cam, port(DENSE), 0)
    assert args["dense"]
    mine = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                             **args)
    agree, _ = mega_cuda.compare_lanes(mine, theirs[trips])
    assert agree >= 0.995, agree


@pytest.mark.parametrize("quota,tail,seed_mode", [
    (1, 1, "reference"), (2, 2, "decorrelated")])
def test_dense_frame_matches_tpurt(quota, tail, seed_mode):
    cfg = DENSE.replace(pixels_per_lane=quota, mega_tail_passes=tail,
                        seed_mode=seed_mode)
    tscene, tcam, _ = t_cornell(1, cfg)
    tstats = {}
    theirs = t_renderer.render_frame(tscene, tcam, cfg, stats=tstats)
    scene, cam, _ = cornell_sphere_scene(1, port(cfg), device="cpu")
    stats = {}
    mine = render_frame(scene, cam, port(cfg), stats=stats)
    assert_mostly_bitwise(mine, np.asarray(theirs))
    assert abs(stats["segments"] - tstats["segments"]) <= 0.005 * tstats["segments"]
    # The BVH megakernel renders the same frame (the dense mode changes
    # how hits are found, not which).
    bvh = render_frame(scene, cam, port(cfg.replace(mega_dense=False)))
    assert_mostly_bitwise(mine, bvh)
