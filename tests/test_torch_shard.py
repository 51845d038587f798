"""tpurt_torch's device mesh and sharded frames on the CPU, against the
port's own single-device frame and tpurt's render_frame_sharded
(mirroring tests/test_parallel.py and tests/test_multihost.py).

The CPU fills every mesh position (the port's counterpart of the 8
virtual host devices tests/conftest.py gives tpurt). Tolerances: the
tile axis, over-decomposition and quota lanes give the single-device
frame bit for bit (seeds are pure functions of the absolute pixel), and
tpurt's sharded frame bit for bit at this scene (the ulp-level
fused-multiply-add class of ROADMAP C does not reach it); the sample axis
is held at tpurt's atol=1e-5 (f32 reassociation of the per-position
means). Two gloo processes give one process's frame bit for bit. Every
child process is started on a free port and waited for at most 120 s;
its group times out by itself after 60 s.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpurt.config import RenderConfig
from tpurt.parallel import make_mesh as t_make_mesh
from tpurt.parallel import render_frame_sharded as t_render_frame_sharded
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt_torch import cli
from tpurt_torch.io import read_bmp
from tpurt_torch.parallel import make_mesh, mesh_info, render_frame_sharded
from tpurt_torch.render.megakernel import run_megakernel
from tpurt_torch.render.renderer import (
    _flat_batch_size, flat_batch_args, render_frame, render_image)
from tpurt_torch.scene.presets import cornell_sphere_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# tests/test_parallel.py's frame.
CFG = RenderConfig(width=16, height=20, rays_per_pixel=4, max_bounces=3,
                   tile_size=16, object_path="sphere0.obj")
CHILD_TIMEOUT_S = 120


def cpu_mesh(tile, sample=1):
    return make_mesh(tile, sample, devices=[CPU] * (tile * sample))


@pytest.fixture(scope="module")
def small():
    scene, cam, _ = cornell_sphere_scene(0, CFG, device="cpu")
    return scene, cam, render_frame(scene, cam, CFG)


def per_pixel_segments(scene, cam, cfg):
    """Each pixel's path segments: one lane a pixel, P = 1."""
    total = cfg.width * cfg.height
    lane = run_megakernel(scene, body_backend="plain", return_state=True,
                          **flat_batch_args(scene, cam, cfg.replace(
                              pixels_per_lane=1), 0, batch=total))
    return lane.segments.long().numpy()


def covered_segments(per_px, starts, launch_px):
    """The segments of flat launches of ``launch_px`` pixels at
    ``starts``, each pixel past the frame end counted as the last one
    (the lanes' clamp)."""
    last = per_px.shape[0] - 1
    return sum(int(per_px[np.minimum(np.arange(s, s + launch_px), last)].sum())
               for s in starts)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_tile_sharding_bitwise_identical(small, n):
    scene, cam, single = small
    np.testing.assert_array_equal(
        render_frame_sharded(scene, cam, CFG, mesh=cpu_mesh(n)), single)


@pytest.mark.parametrize("k", [2, 3])
def test_overdecompose_bitwise_identical(small, k):
    """k round-robin blocks a position; at k = 3 each block is 27 pixels
    of a 256-lane launch, whose rows past the block are cut off."""
    scene, cam, single = small
    np.testing.assert_array_equal(
        render_frame_sharded(scene, cam, CFG, mesh=cpu_mesh(4),
                             overdecompose=k), single)


def test_sharded_quota_lanes_bitwise_identical(small):
    """P = 2 under sharding, bit for bit the single-device frame at the
    same quota; each decomposition's segments are those of the pixels
    its launches cover (padding lanes repeat pixels)."""
    scene, cam, _ = small
    cfg = CFG.replace(pixels_per_lane=2)
    stats_1, stats_n = {}, {}
    single = render_frame(scene, cam, cfg, stats=stats_1)
    n, k = 2, 2
    sharded = render_frame_sharded(scene, cam, cfg, mesh=cpu_mesh(n),
                                   overdecompose=k, stats=stats_n)
    np.testing.assert_array_equal(single, sharded)
    per_px = per_pixel_segments(scene, cam, cfg)
    total = cfg.width * cfg.height
    b = _flat_batch_size(cfg) * 2
    assert stats_1["segments"] == covered_segments(per_px, range(0, total, b), b)
    block = -(-total // (n * k))
    launch = min(cfg.rays_per_batch, -(-block // 512) * 256) * 2
    starts = [j * block + q * launch for j in range(n * k)
              for q in range(-(-block // launch))]
    assert stats_n["segments"] == covered_segments(per_px, starts, launch) > 0


def test_sample_sharding_matches_single(small):
    scene, cam, _ = small
    cfg = CFG.replace(seed_mode="decorrelated")
    single = render_frame(scene, cam, cfg)
    sharded = render_frame_sharded(scene, cam, cfg, mesh=cpu_mesh(4, 2))
    np.testing.assert_allclose(single, sharded, atol=1e-5)


@pytest.mark.parametrize("mesh,cfg,kw,match", [
    ((4, 2), {}, {}, "decorrelated"),
    ((4, 2), {"seed_mode": "decorrelated", "rays_per_pixel": 5}, {},
     "divisible"),
    ((2, 1), {}, {"overdecompose": 0}, "overdecompose must be >= 1"),
    ((2, 1), {"engine": "modular"}, {"overdecompose": 2}, "flat path"),
])
def test_sharding_refusals(small, mesh, cfg, kw, match):
    scene, cam, _ = small
    with pytest.raises(ValueError, match=match):
        render_frame_sharded(scene, cam, CFG.replace(**cfg),
                             mesh=cpu_mesh(*mesh), **kw)


def test_mesh_shapes_and_errors():
    m = cpu_mesh(4, 2)
    assert m.shape == {"tile": 4, "sample": 2}
    assert mesh_info(m) == "mesh 4x2 (tile x sample) over 8 devices"
    assert (m.ranks == 0).all() and m.devices[3, 1] == CPU
    assert make_mesh(devices=[CPU] * 3).shape == {"tile": 3, "sample": 1}
    with pytest.raises(ValueError, match="3 x 2 != 8 devices"):
        make_mesh(3, 2, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def tpurt_small():
    tscene, tcam, _ = t_cornell(0, CFG)
    return tscene, tcam


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_matches_tpurt(small, tpurt_small, n):
    """The flat path against tpurt's on conftest's virtual devices."""
    scene, cam, single = small
    tscene, tcam = tpurt_small
    theirs = t_render_frame_sharded(
        tscene, tcam, CFG, mesh=t_make_mesh(tile_devices=n,
                                            devices=jax.devices()[:n]))
    mine = render_frame_sharded(scene, cam, CFG, mesh=cpu_mesh(n))
    np.testing.assert_array_equal(mine, np.asarray(theirs))
    np.testing.assert_array_equal(mine, single)


def test_modular_tile_path_matches_tpurt(small, tpurt_small):
    """The tile path (the modular engine): 3 row tiles of 7 rows, the
    last running past the frame, against tpurt's."""
    scene, cam, _ = small
    tscene, tcam = tpurt_small
    cfg = CFG.replace(engine="modular")
    theirs = t_render_frame_sharded(
        tscene, tcam, cfg, mesh=t_make_mesh(tile_devices=3,
                                            devices=jax.devices()[:3]))
    mine = render_frame_sharded(scene, cam, cfg, mesh=cpu_mesh(3))
    np.testing.assert_array_equal(mine, np.asarray(theirs))
    np.testing.assert_array_equal(mine, render_frame(scene, cam, cfg))


# -- several processes (gloo) -------------------------------------------------


_CHILD = r"""
import datetime
import sys

sys.path.insert(0, sys.argv[1])
import numpy as np
import torch

coordinator, num, pid, out = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
torch.distributed.init_process_group(
    "gloo", init_method=f"tcp://{coordinator}", world_size=num, rank=pid,
    timeout=datetime.timedelta(seconds=60))
try:
    from tpurt_torch.config import RenderConfig
    from tpurt_torch.parallel import make_mesh, render_frame_sharded
    from tpurt_torch.scene.presets import cornell_sphere_scene

    cfg = RenderConfig(width=16, height=20, rays_per_pixel=4, max_bounces=3,
                       tile_size=16, object_path="sphere0.obj")
    scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)  # two a process
    assert mesh.shape == {"tile": 2 * num, "sample": 1}, mesh.shape
    assert sorted(mesh.ranks.ravel().tolist()) == sorted(list(range(num)) * 2)
    stats = {}
    frame = render_frame_sharded(scene, cam, cfg, mesh=mesh, stats=stats)
    np.save(out, frame)
    print("SEGMENTS", stats["segments"], flush=True)
finally:
    torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(argvs):
    """Start one child a rank and wait for all; (rc, stdout, stderr) each.
    Kills every child when one outlives CHILD_TIMEOUT_S."""
    procs = [subprocess.Popen([sys.executable] + a, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail("a rank outlived its time limit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_gloo_processes_match_one(small, tmp_path):
    """Two processes of two positions each: a 4-position mesh over the
    group, its blocks all-gathered and segments all-reduced, gives every
    process the one-process frame bit for bit, with the one-process
    4-position mesh's segments."""
    scene, cam, single = small
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_ranks([["-c", _CHILD, ROOT, coord, "2", str(pid),
                        str(tmp_path / f"rank{pid}.npy")] for pid in (0, 1)])
    stats = {}
    render_frame_sharded(scene, cam, CFG, mesh=cpu_mesh(4), stats=stats)
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {pid} failed:\n{out}\n{err[-2000:]}"
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{pid}.npy"), single)
        assert f"SEGMENTS {stats['segments']}" in out


def test_cli_two_processes_write_the_one_process_frame(tmp_path):
    """``--coordinator`` through cli.main: each process joins the gloo
    group, renders its half of a 4x1 mesh and writes the whole frame."""
    coord = f"127.0.0.1:{_free_port()}"
    args = ["--cpu", "--width", "16", "--height", "20", "--rays-per-pixel",
            "2", "--max-bounces", "2", "--object-path", "sphere0.obj",
            "--tile-devices", "4", "--coordinator", coord, "--num-processes",
            "2", "--group-timeout", "60"]
    outs = _run_ranks([["-m", "tpurt_torch.cli"] + args + [
        "--process-id", str(pid), "--output", str(tmp_path / f"r{pid}.bmp")]
        for pid in (0, 1)])
    for rc, out, err in outs:
        assert rc == 0, f"{out}\n{err[-2000:]}"
        assert "mesh 4x1 (tile x sample) over 4 devices" in out
    cfg = RenderConfig(width=16, height=20, rays_per_pixel=2, max_bounces=2,
                       object_path="sphere0.obj")
    scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
    want = render_image(scene, cam, cfg)
    for pid in (0, 1):
        np.testing.assert_array_equal(read_bmp(str(tmp_path / f"r{pid}.bmp")), want)


def test_cli_group_that_does_not_form_fails(capsys):
    """A process whose peers never come renders nothing: the group's own
    timeout ends it with rc 2."""
    rc = cli.main(["--cpu", "--coordinator", f"127.0.0.1:{_free_port()}",
                   "--num-processes", "2", "--process-id", "0",
                   "--group-timeout", "2", "--output", os.devnull])
    assert rc == 2
    assert "the process group did not form" in capsys.readouterr().err


# -- the CLI's device flags on the CPU ----------------------------------------


@pytest.mark.parametrize("extra", [
    ["--devices", "0"],
    ["--devices", "0", "--overdecompose", "4"],
    ["--devices", "0", "--tile-devices", "4", "--overdecompose", "3"],
    ["--devices", "0", "--tile-devices", "2", "--sample-devices", "2",
     "--seed-mode", "decorrelated"],
    ["--devices", "0", "--tile-devices", "3", "--engine", "modular"],
])
def test_cli_device_flags_match_render_frame(extra, tmp_path, capsys):
    out = str(tmp_path / "o.bmp")
    base = ["--cpu", "--width", "16", "--height", "20", "--rays-per-pixel",
            "2", "--max-bounces", "2", "--object-path", "sphere0.obj"]
    assert cli.main(base + extra + ["--output", out]) == 0
    tile = int(extra[extra.index("--tile-devices") + 1]) if (
        "--tile-devices" in extra) else 1
    sample = int(extra[extra.index("--sample-devices") + 1]) if (
        "--sample-devices" in extra) else 1
    assert (f"mesh {tile}x{sample} (tile x sample) over {tile * sample} "
            "devices") in capsys.readouterr().out
    cfg = RenderConfig(width=16, height=20, rays_per_pixel=2, max_bounces=2,
                       object_path="sphere0.obj",
                       seed_mode="decorrelated" if sample > 1 else "reference",
                       engine="modular" if "modular" in extra else "mega")
    scene, cam, _ = cornell_sphere_scene(0, cfg, device="cpu")
    want = render_image(scene, cam, cfg)
    got = read_bmp(out)
    if sample > 1:  # atol=1e-5 in radiance: at most one level after tonemap
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)
