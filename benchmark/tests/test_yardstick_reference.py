"""The plain reference on a tiny scene on the CPU: it agrees with itself
however its lanes are grouped, it agrees with the program's plain torch
version pixel for pixel and segment for segment, and its control (the
same reference in bfloat16) does not."""

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from yardstick import check, reference, scene, spec  # noqa: E402

W, H, SPP, BOUNCES = 24, 12, 2, 5
CFG = {
    "mesh": {"kind": "torus_knot", "segments": 16, "sides": 6, "radius": 80.0,
             "tube": 22.0, "triangles": 192},
    "model": {"scale": 0.5, "material": {
        "type": 0, "ior": 1.0, "color": [1.0, 1.0, 1.0],
        "emission_color": [0.0, 0.0, 0.0], "emission_strength": 0.0,
        "reflectiveness": 0.0, "specular_probability": 1.0}},
    "cornell_breathing_room": 100.0,
    "camera": {"position": [0.0, 150.0, 250.0], "pitch": 0.0, "yaw": 3.14,
               "roll": 0.0, "fov_degrees": 90.0},
    "render": {"seed_mode": "reference", "mega_dense": False},
}
TRAFFIC = {"width": W, "height": H, "spp": SPP, "bounces": BOUNCES}


@pytest.fixture(scope="module")
def tiny():
    pos, nrm = scene.model_triangles(CFG, BENCH)
    sspec = scene.scene_spec(CFG, pos, nrm)
    return pos, nrm, sspec, scene.pose(CFG, W, H)


def _render(sspec, pose, pix, frame, dtype=torch.float32):
    rs = reference.RefScene(sspec, "cpu", dtype)
    u8, segs, _ = reference.render(rs, [pose], np.zeros(len(pix), np.int64),
                                   pix, frame, W, H, SPP, BOUNCES)
    return u8.numpy(), segs.numpy()


def test_the_reference_agrees_with_itself(tiny):
    _, _, sspec, pose = tiny
    pix = np.arange(W * H)
    frame = np.full(W * H, 5)
    u8, segs = _render(sspec, pose, pix, frame)
    half = W * H // 2
    u8a, sa = _render(sspec, pose, pix[half:], frame[half:])
    u8b, sb = _render(sspec, pose, pix[:half][::-1].copy(), frame[:half])
    assert np.array_equal(u8[half:], u8a) and np.array_equal(segs[half:], sa)
    assert np.array_equal(u8[:half][::-1], u8b)
    assert np.array_equal(segs[:half][::-1], sb)
    assert segs.min() >= SPP and (u8 > 0).any()


def test_the_reference_agrees_with_the_programs_plain_version(tiny):
    from tpurt_torch.render.renderer import render_batch_flat
    from tpurt_torch.render.tonemap import tonemap
    from tpurt_torch.scene.builder import SceneBuilder
    from tpurt_torch.scene.presets import scene_around
    from yardstick import drivers

    pos, nrm, sspec, pose = tiny
    traffic = dict(TRAFFIC, render={"pixels_per_lane": 1, "rays_per_batch": 512,
                                    "compaction_threshold": 0})
    rcfg = drivers.render_config(CFG, traffic, pose)
    b = SceneBuilder()
    prog_scene, cam = scene_around(b, b.add_triangles(pos, nrm), rcfg,
                                   device="cpu")
    m, segs, _ = render_batch_flat(prog_scene, cam, rcfg, 0, frame_index=9)
    prog = tonemap(m[:W * H]).numpy()
    u8, rsegs = _render(sspec, pose, np.arange(W * H), np.full(W * H, 9))
    assert np.array_equal(prog, u8)
    pad = 512 - W * H  # padding lanes repeat the last pixel
    assert segs == int(rsegs.sum()) + pad * int(rsegs[-1])


def _cells():
    return [w["name"] for w in spec.benchmark(ROOT)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_the_control_fails_the_cells_limit(tiny, cell):
    """The control: the reference in bfloat16 put in the program's place,
    at the cell's own samples and bounces on a small frame of the tiny
    scene, differs from the float32 reference on more pixels than the
    cell allows. (On the card it is read at the cell's own size by
    ``benchmark/tools/readings.py``.)"""
    _, _, sspec, _ = tiny
    bench = spec.benchmark(ROOT)
    traffic = spec.traffic(BENCH, spec.cell(bench, cell)["traffic"])
    spp, bounces = int(traffic["spp"]), int(traffic["bounces"])
    w, h = (32, 16) if spp * bounces <= 64 else (24, 12)
    pose = scene.pose(CFG, w, h)
    pix = np.arange(w * h)
    args = (np.zeros(w * h, np.int64), pix, np.full(w * h, 3), w, h, spp,
            bounces)
    ref, _, _ = reference.render(reference.RefScene(sspec, "cpu"), [pose],
                                 *args)
    ctrl, _, _ = reference.render(
        reference.RefScene(sspec, "cpu", torch.bfloat16), [pose], *args)
    reading = check.px_diff_pct(ctrl.numpy(), ref.numpy())
    assert reading > spec.limits(BENCH, cell)["px_diff_pct"]
