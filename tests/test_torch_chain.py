"""The megakernel on a multi-entry chain, against tpurt's XLA body: a
fused static chain entry (a BVH of identity meshes with per-owner cull
in its leaves) plus two transformed instances of one OBJ (Glassy and
OneSided), so the fold to world space, the chain skip, root expansion on
three entries and every material branch run.

Lane state after 1 and 4 trips agrees in its integer fields on >= 99.5%
of lanes. Glass makes the self-intersection knife edge frequent: a ray
leaving a surface re-hits it at t just above EPSILON depending on the
last bit of its hit point (ROADMAP C). Measured: 0 lanes differ up to
trip 11, then 1, 2, 5, 6, 10 of 1024 at trips 12-16, every one first
differing in a local hit at t < 1.5e-4 on the glass or OneSided knot —
so after 16 trips the bound is 98.5%. Whole frames agree under tpurt's
knife-edge tolerance (<= 0.5% of pixels), segments within 0.5%."""

import numpy as np
import pytest

import jax.numpy as jnp

from test_render_golden import assert_mostly_bitwise
from test_torch_megakernel import port_lane
from test_torch_cuda import chain_scene
from tpurt.config import RenderConfig
from tpurt.core.camera import Camera as TCamera
from tpurt.render import renderer as t_renderer
from tpurt.scene import procedural as t_proc
from tpurt.scene.builder import Material as TMaterial
from tpurt.scene.builder import SceneBuilder as TBuilder
from tpurt.scene.types import MaterialType as TMT
from tpurt_torch.core.camera import Camera
from tpurt_torch.render import mega_cuda
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.renderer import flat_batch_args, render_frame
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.types import MaterialType

CFG = RenderConfig(width=32, height=32, rays_per_pixel=3, max_bounces=6,
                   pixels_per_lane=2, mega_tail_passes=3, mega_body="xla",
                   compaction_threshold=0)
POSE = dict(position=(0, 80, 220), pitch=-0.15, yaw=3.14159, fov_degrees=70,
            aspect_ratio=1.0)


@pytest.fixture(scope="module")
def chain():
    tscene = chain_scene(TBuilder, TMaterial, TMT, t_proc)
    tcam = TCamera.create(**POSE)
    statics = t_renderer._mega_statics(CFG, CFG.width, CFG.height)
    b = t_renderer._flat_batch_size(CFG)
    states = {}
    for k in (1, 4, 16, 10 ** 6):
        st, _ = t_renderer._mega_flat_start(
            tscene, tcam, jnp.asarray([0, 0, 0, k], jnp.int32), batch=b,
            pixels_per_lane=2, **statics)
        states[k] = port_lane(st)
    scene = chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cpu")
    assert [m for m, _, _ in scene.mega_chain] == [-1, 1, 2]
    return scene, Camera.create(**POSE, device="cpu"), states


@pytest.mark.parametrize("trips", [1, 4, 16])
def test_chain_lane_state_matches_tpurt(chain, trips):
    scene, cam, theirs = chain
    mine = mk.run_megakernel(scene, max_iterations=trips, return_state=True,
                             **flat_batch_args(scene, cam, CFG, 0))
    agree, _ = mega_cuda.compare_lanes(mine, theirs[trips])
    assert agree >= (0.995 if trips < 16 else 0.985), agree


def test_chain_frame_matches_tpurt(chain):
    scene, cam, theirs = chain
    final = theirs[10 ** 6]
    assert bool(final.done.all())
    ref = np.concatenate([np.stack([c.numpy() for c in a], -1)
                          for a in final.accs]) / np.float32(CFG.rays_per_pixel)
    ref = ref[:CFG.width * CFG.height].reshape(CFG.height, CFG.width, 3)
    stats = {}
    mine = render_frame(scene, cam, CFG, stats=stats)
    assert_mostly_bitwise(mine, ref)
    t_segs = int(final.segments.sum())
    assert abs(stats["segments"] - t_segs) <= 0.005 * t_segs
    assert (mine > 0).any(axis=-1).mean() > 0.05
