"""The glass-cornell deployment on the CPU, without jax: the port's plain
path renders a Glassy model at the configuration's scale and camera as
the benchmark's plain reference does, pixel for pixel and segment for
segment; the configuration gives the program the model the reference
reads; and the counters of kernel B1's own work (``mega_cuda.work_counts``
and the benchmark's readers of them) add up as they say."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from tpurt_torch.config import RenderConfig
from tpurt_torch.render import mega_cuda
from tpurt_torch.render.renderer import render_batch_flat
from tpurt_torch.render.tonemap import tonemap
from tpurt_torch.scene.builder import SceneBuilder
from tpurt_torch.scene.presets import model_material, scene_around
from tpurt_torch.scene.types import MaterialType
from tpurt_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from yardstick import drivers, reference, scene, spec  # noqa: E402

W, H, SPP, BOUNCES = 24, 12, 2, 12


def _glass_cfg(segments=16, sides=6):
    with open(os.path.join(BENCH, "configs", "glass-cornell.json")) as f:
        cfg = json.load(f)
    cfg["mesh"] = {"kind": "torus_knot", "segments": segments, "sides": sides,
                   "radius": 80.0, "tube": 22.0,
                   "triangles": 2 * segments * sides}
    return cfg


@pytest.mark.parametrize("knot", [(16, 6), (32, 8)], ids=["numpy", "native"])
def test_the_plain_path_renders_glass_as_the_reference(knot):
    """glass-cornell's material, scale and camera on torus_knot(16, 6, 80,
    22) (192 triangles) and torus_knot(32, 8, 80, 22) (512, so that the
    fused static BVH of the identity model and the box's two-sided quads
    is built natively), the one-sided front quad inline, at 24x12, 2 spp,
    12 bounces: the port's plain path (the benchmark's own route,
    drivers.render_config + scene_around) and the plain reference agree
    on every pixel and every segment, with no tolerance."""
    cfg = _glass_cfg(*knot)
    pos, nrm = scene.model_triangles(cfg, BENCH)
    sspec = scene.scene_spec(cfg, pos, nrm)
    pose = scene.pose(cfg, W, H)
    traffic = {"width": W, "height": H, "spp": SPP, "bounces": BOUNCES,
               "render": {"pixels_per_lane": 1, "rays_per_batch": 512,
                          "compaction_threshold": 0}}
    rcfg = drivers.render_config(cfg, traffic, pose)
    b = SceneBuilder()
    prog_scene, cam = scene_around(b, b.add_triangles(pos, nrm), rcfg,
                                   device="cpu")
    assert prog_scene.mega_chain == ((-1, 0, False),)
    assert prog_scene.mega_static_rows.shape[0] == 2
    m, segs, _ = render_batch_flat(prog_scene, cam, rcfg, 0, frame_index=9)
    prog = tonemap(m[:W * H]).numpy()
    rs = reference.RefScene(sspec, "cpu")
    u8, rsegs, _ = reference.render(rs, [pose], np.zeros(W * H, np.int64),
                                    np.arange(W * H), np.full(W * H, 9), W, H,
                                    SPP, BOUNCES)
    assert np.array_equal(prog, u8.numpy())
    pad = 512 - W * H  # padding lanes repeat the last pixel
    rsegs = rsegs.numpy()
    assert segs == int(rsegs.sum()) + pad * int(rsegs[-1])
    # Glass makes the paths long: more segments a sample than bounces
    # the white model's diffuse paths would reach on average.
    assert rsegs.sum() / (W * H * SPP) > 3.0


def test_every_configuration_gives_the_program_the_references_model():
    """For every configuration of BENCHMARK.json, the model the program
    builds from its RenderConfig (``render.model_material`` /
    ``model_scale``, or main.cpp's override without them) is the one the
    plain reference reads from ``model``; glass-cornell's is Glassy, ior
    1.5, at scale 1.0, on bunny-cornell's own mesh file."""
    bench = spec.benchmark(ROOT)
    for c in bench["configs"]:
        cfg = spec.config(ROOT, bench, c["name"])
        rcfg = drivers.render_config(cfg, {"width": 8, "height": 8, "spp": 1,
                                           "bounces": 1},
                                     scene.pose(cfg, 8, 8))
        want = scene.Material(**cfg["model"]["material"])
        got = model_material(rcfg)
        assert int(got.type) == want.type, c["name"]
        for k in ("ior", "emission_strength", "reflectiveness",
                  "specular_probability", "color", "emission_color"):
            assert np.array_equal(np.float32(getattr(got, k)),
                                  np.float32(getattr(want, k))), (c["name"], k)
        assert rcfg.model_scale == cfg["model"]["scale"], c["name"]
    glass = spec.config(ROOT, bench, "glass-cornell")
    bunny = spec.config(ROOT, bench, "bunny-cornell")
    assert glass["mesh"] == bunny["mesh"]
    assert glass["model"]["material"]["type"] == MaterialType.GLASSY
    assert glass["model"]["material"]["ior"] == 1.5
    assert glass["model"]["scale"] == 1.0 and glass["reduced"] == []
    assert glass["camera"] == {"position": [0.0, 20.0, 230.0], "pitch": -0.08,
                               "yaw": 3.14, "roll": 0.0, "fov_degrees": 45.0}
    pos, _ = scene.model_triangles(glass, spec.config_dir(ROOT, bench,
                                                           "glass-cornell"))
    assert pos.shape == (69120, 3, 3)


@pytest.mark.parametrize("bad", [
    dict(model_material={"type": 7}), dict(model_material={"ior": 1.5}),
    dict(model_material={"type": 3, "roughness": 0.1}), dict(model_scale=0.0),
])
def test_the_model_fields_refuse_what_no_material_is(bad):
    with pytest.raises(ValueError):
        RenderConfig(**bad)


@pytest.mark.parametrize("rows", [4, 6])
def test_work_counts_sum_the_launchs_own_rows(rows):
    """``work_counts`` on a launch's (4, R) work, or the TLAS regime's
    (6, R): the most trips, the sums of the first three work rows and of
    the trips, lanes x the most trips, and the sum of the last row, the
    completion groups; the TLAS regime's instance rows (3 and 4) are not
    summed. Where every lane ran as many trips as the longest, no slot is
    idle."""
    rng = np.random.default_rng(3)
    trips = torch.from_numpy(rng.integers(0, 40, 1000).astype(np.int32))
    work = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, (rows, 1000))
                            .astype(np.int32))
    got = mega_cuda.work_counts(trips, work).tolist()
    w = work.numpy().astype(np.int64)
    t = trips.numpy().astype(np.int64)
    assert got == [t.max(), w[0].sum(), w[1].sum(), w[2].sum(), t.sum(),
                   1000 * t.max(), w[rows - 1].sum()]
    assert got[1] > 2 ** 31 and got[6] > 2 ** 31  # summed in 64 bits
    even = mega_cuda.work_counts(torch.full((64,), 9, dtype=torch.int32),
                                 work[:, :64]).tolist()
    assert even[4] == even[5] == 9 * 64
    assert len(mega_cuda.WORK_COUNTERS) == len(got) - 1
    assert mega_cuda.WORK_COUNTERS[-1] == "b1.completion_warps"


def _reader(name):
    return spec.reader(BENCH, name)


def test_the_readers_of_b1s_counters():
    """The three readers read only what was counted while a profiler
    recorded, and give nothing where a counter is missing, as on the
    plain backend, which keeps no per-lane work."""
    run = types.SimpleNamespace(profiled=lambda: [0, 1], width=4, height=2,
                                traffic={"spp": 5})
    names = ("segments_per_sample.stream", "lane_idle_pct.stream",
             "box_tests_per_segment.stream")
    cfg = RenderConfig(width=8, height=4, rays_per_pixel=2, max_bounces=3,
                       rays_per_batch=64, compaction_threshold=0,
                       object_path="sphere0.obj")
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        b = SceneBuilder()
        from tpurt_torch.scene import procedural
        prog_scene, cam = scene_around(
            b, b.add_triangles(*procedural.icosphere(0, 96.0)), cfg, "cpu")
        render_batch_flat(prog_scene, cam, cfg, 0)
    assert not any(k.startswith("b1.")
                   for k in profiling.totals(traced=True)["counts"])
    assert [_reader(n)(run) for n in names] == [None, None, None]
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name, n in zip(mega_cuda.WORK_COUNTERS, (600, 90, 120, 300, 400)):
            profiling.count(name, n)
    profiling.count("b1.segments", 1000)  # outside the profiler: not read
    vals = [_reader(n)(run) for n in names]
    assert vals == [120 / (2 * 4 * 2 * 5), 100.0 * (1 - 300 / 400), 600 / 120]
    profiling.reset()


def test_the_reader_of_lanes_per_completion():
    """``lanes_per_completion.stream``: the segments B1 completed over
    its completion groups, counted while a profiler recorded; nothing
    where the groups were not counted, as in a program before the
    counter, or where nothing was profiled."""
    read = _reader("lanes_per_completion.stream")
    run = types.SimpleNamespace(profiled=lambda: [0], width=4, height=2,
                                traffic={"spp": 5})
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("b1.segments", 1200)
    assert read(run) is None  # no b1.completion_warps
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("b1.segments", 1200)
        profiling.count("b1.completion_warps", 96)
    profiling.count("b1.completion_warps", 1000)  # outside the profiler: not read
    assert read(run) == 1200 / 96
    assert read(types.SimpleNamespace(profiled=lambda: [])) is None
    profiling.reset()
