"""Every bank shape the autotuner sweeps (tpurt_torch.autotune.AXES:
node arity, leaf capacity, bounds format), frozen and rendered by the
port against tpurt on the CPU: the bank bit for bit, and the 16x16
frame of icosphere(3) (1,280 triangles, enough for arity 32 and
8-triangle leaves) under tpurt's knife-edge tolerance
(``assert_mostly_bitwise``, <= 0.5% of pixels) with segment counts
within 0.5%. Each case compiles one tpurt program (~15 s)."""

import numpy as np
import pytest

import tpurt.config as t_c
import tpurt_torch.config as _c
from test_render_golden import assert_mostly_bitwise
from test_torch_scene import bits
from tpurt.config import RenderConfig
from tpurt.render.renderer import render_frame as t_render_frame
from tpurt.scene.presets import default_scene as t_default_scene
from tpurt_torch import autotune
from tpurt_torch.render.renderer import render_frame
from tpurt_torch.scene.presets import default_scene

CFG = RenderConfig(width=16, height=16, rays_per_pixel=1, max_bounces=2,
                   tile_size=16, object_path="sphere3.obj", mega_body="xla")
AXES = dict(autotune.AXES)
DEFAULT = {"node_arity": 8, "leaf_tris": 3, "bounds_fmt": "u8"}
SHAPES = sorted({tuple(dict(DEFAULT, **{axis: v}).items())
                 for axis in ("node_arity", "leaf_tris", "bounds_fmt")
                 for v in AXES[axis]})


@pytest.mark.parametrize("shape", [dict(s) for s in SHAPES],
                         ids=lambda s: "a{node_arity}-l{leaf_tris}-{bounds_fmt}".format(**s))
def test_bank_shape_matches_tpurt(shape, monkeypatch):
    for mod in (_c, t_c):
        monkeypatch.setattr(mod, "MEGA_NODE_ARITY", shape["node_arity"])
        monkeypatch.setattr(mod, "MEGA_LEAF_TRIS", shape["leaf_tris"])
        monkeypatch.setattr(mod, "MEGA_BF16_BOUNDS", shape["bounds_fmt"] == "bf16")
    scene, cam, _ = default_scene(CFG, device="cpu")
    tscene, tcam, _ = t_default_scene(CFG)
    assert (scene.mega_arity, scene.mega_leaf_tris, scene.mega_bounds_fmt) == (
        shape["node_arity"], shape["leaf_tris"], shape["bounds_fmt"])
    np.testing.assert_array_equal(bits(scene.mega_rows), bits(tscene.mega_rows))
    assert scene.mega_chain == tscene.mega_chain
    assert scene.mega_stack_depth == tscene.mega_stack_depth
    stats, t_stats = {}, {}
    mine = render_frame(scene, cam, CFG, stats=stats)
    theirs = t_render_frame(tscene, tcam, CFG, stats=t_stats)
    assert_mostly_bitwise(mine, theirs)
    assert abs(stats["segments"] - t_stats["segments"]) <= 0.005 * t_stats["segments"]
