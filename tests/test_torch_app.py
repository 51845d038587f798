"""The application layer on the CPU: tpurt_torch's cli, viewer,
render.pick, scene.jsonscene, utils and parallel.mesh against tpurt's
(mirroring tests/test_features.py's picking, JSON and CLI tests and
tests/test_viewer.py).

Tolerances: pick indices and JSON banks equal (the banks bit for bit);
the CLI's BMP against tpurt's CLI within tpurt's ``assert_mostly_bitwise``
(<= 0.5% of pixels differ); the viewer's formulas to float precision, as
tpurt's tests check them, and its renders bit for bit against the port's
own frames.
"""

import dataclasses
import glob
import io
import json
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_render_golden import assert_mostly_bitwise
from test_torch_scene import bits
from tpurt import cli as t_cli
from tpurt.config import RenderConfig
from tpurt.io.bmp import read_bmp as t_read_bmp
from tpurt.render.pick import pick_mesh as t_pick_mesh
from tpurt.scene.jsonscene import scene_from_json as t_scene_from_json
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt.viewer import recolor_mesh as t_recolor_mesh
from tpurt_torch import anim, cli
from tpurt_torch.core.camera import Camera
from tpurt_torch.io import read_bmp
from tpurt_torch.parallel import mesh
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.pick import pick_mesh
from tpurt_torch.render.renderer import (
    flat_batch_args, render_frame, render_image)
from tpurt_torch.scene.jsonscene import scene_from_json
from tpurt_torch.scene.presets import (
    cornell_sphere_scene, default_scene, grid_scene)
from tpurt_torch.utils import profiling
from tpurt_torch.utils.progress import ProgressReporter, mrays_per_second
from tpurt_torch.viewer import (
    KEY_DT, MOVE_SPEED, ROT_SPEED, ViewerSession, recolor_mesh, run_terminal)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = RenderConfig(width=12, height=12, rays_per_pixel=1, max_bounces=2,
                     tile_size=12, object_path="sphere0.obj")
VIEW = RenderConfig(width=24, height=24, rays_per_pixel=1, max_bounces=3,
                    tile_size=24, object_path="sphere0.obj")
TINY = ["--cpu", "--width", "8", "--height", "8", "--rays-per-pixel", "1",
        "--max-bounces", "2", "--object-path", "sphere0.obj"]


@pytest.fixture(scope="module")
def small():
    tscene, tcam, _ = t_cornell(0, SMALL)
    scene, cam, _ = cornell_sphere_scene(0, SMALL, device="cpu")
    return tscene, tcam, scene, cam


@pytest.fixture(scope="module")
def view_scene():
    return default_scene(VIEW, device="cpu")[0]


# -- picking (render/pick.py) ----------------------------------------------


def test_pick_mesh_matches_tpurt_on_a_uv_grid(small):
    tscene, tcam, scene, cam = small
    g = (np.arange(9, dtype=np.float32) + 0.5) / 9
    uv = np.stack(np.meshgrid(g, g, indexing="xy"), -1)  # (9, 9, 2)
    mine = pick_mesh(scene, cam, uv)
    theirs = np.asarray(t_pick_mesh(tscene, tcam, jnp.asarray(uv)))
    assert mine.shape == (9, 9) and mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), theirs)
    assert (theirs >= 0).any() and len(set(theirs.ravel().tolist())) > 2
    # Looking away from the scene hits nothing (-1).
    away = Camera.create((0, 0, 10000), yaw=0.0, aspect_ratio=1.0, device="cpu")
    assert int(pick_mesh(scene, away, [0.5, 0.5])) == -1


def test_pick_passes_the_front_wall(small):
    """checkIntersectingRay culls OneSided backfaces: from outside the
    box the pick ray passes the front wall (the third box quad)."""
    _ts, _tc, scene, cam = small
    assert int(pick_mesh(scene, cam, [0.5, 0.3])) != 2


# -- JSON scenes (scene/jsonscene.py) ----------------------------------------


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "examples",
                                                                "*.json"))))
def test_json_scene_banks_match_tpurt(path):
    with open(path) as f:
        spec = json.load(f)
    cfg = RenderConfig(width=8, height=8)
    scene, cam = scene_from_json(spec, cfg, device="cpu")
    tscene, tcam = t_scene_from_json(spec, cfg)
    for f in ("mega_rows", "mega_static_rows", "tri_packed", "node_q",
              "mat_color", "mesh_pos", "mesh_yaw", "mesh_scale"):
        np.testing.assert_array_equal(bits(getattr(scene, f)),
                                      bits(getattr(tscene, f)), err_msg=f)
    assert scene.mega_chain == tscene.mega_chain
    np.testing.assert_array_equal(bits(cam.params), bits(tcam.params))
    assert scene.device.type == "cpu" and np.isfinite(
        render_frame(scene, cam, cfg.replace(rays_per_pixel=1, max_bounces=2))).all()


# -- the CLI (cli.py) -------------------------------------------------------------


def test_cli_bmp_matches_tpurt_cli(tmp_path, capsys):
    args = ["--cpu", "--width", "32", "--height", "32", "--rays-per-pixel", "2",
            "--max-bounces", "3", "--object-path", "sphere0.obj", "--single-chip"]
    mine, theirs = str(tmp_path / "mine.bmp"), str(tmp_path / "theirs.bmp")
    assert cli.main(args + ["--output", mine]) == 0
    out = capsys.readouterr().out
    assert "Found 1 device(s):" in out and "Rendered 32x32 @ 2 spp" in out
    assert t_cli.main(args + ["--output", theirs]) == 0
    assert_mostly_bitwise(read_bmp(mine), t_read_bmp(theirs))


def test_cli_list_devices(capsys):
    assert cli.main(["--cpu", "--list-devices"]) == 0
    out = capsys.readouterr().out
    assert "Found 1 device(s):" in out and "[0] cpu (cpu)" in out


def test_cli_interactive_prompts(tmp_path, monkeypatch):
    out = str(tmp_path / "o.bmp")
    # devices, width, height, spp, bounces, keep the OBJ path
    monkeypatch.setattr("sys.stdin", io.StringIO("0\n8\n6\n1\n2\n\n"))
    assert cli.main(["--cpu", "--interactive", "--object-path", "sphere0.obj",
                     "--output", out]) == 0
    assert read_bmp(out).shape == (6, 8, 3)


def test_cli_video_progressive_and_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = RenderConfig(width=8, height=8, rays_per_pixel=1, max_bounces=2,
                       object_path="sphere0.obj", video_frame_count=2,
                       video_output_dir="vid")
    assert cli.main(TINY + ["--frames", "2", "--video-dir", "vid"]) == 0
    scene, cam, _ = default_scene(cfg, device="cpu")
    for f in range(2):
        np.testing.assert_array_equal(
            read_bmp(f"vid/output_{f}.bmp"),
            render_image(anim.video_frame_scene(scene, f, 2), cam, cfg,
                         frame_index=f))
    assert cli.main(TINY + ["--progressive", "2", "--output", "p.bmp"]) == 0
    assert os.path.exists("preview.bmp") and read_bmp("p.bmp").shape == (8, 8, 3)
    ck = ["--checkpoint", "acc.npz", "--tile-size", "4"]
    assert cli.main(TINY + ck + ["--output", "a.bmp"]) == 0
    assert os.path.exists("acc.npz")
    assert cli.main(TINY + ck + ["--output", "b.bmp"]) == 0  # resumed
    np.testing.assert_array_equal(read_bmp("a.bmp"), read_bmp("b.bmp"))
    np.testing.assert_array_equal(read_bmp("a.bmp"), render_image(scene, cam, cfg))


@pytest.mark.parametrize("extra,message", [
    (["--coordinator", "h:1", "--num-processes", "2"],
     "--coordinator requires --num-processes and --process-id"),
    (["--devices", "0", "--tile-devices", "2", "--sample-devices", "2"],
     "decorrelated"),
    (["--devices", "0", "--sample-devices", "2", "--seed-mode",
      "decorrelated", "--rays-per-pixel", "3"], "not divisible"),
    (["--devices", "0", "--overdecompose", "0"], "overdecompose must be >= 1"),
    (["--devices", "0", "--overdecompose", "2", "--engine", "modular"],
     "requires the mega engine's flat path"),
    (["--devices", "1"], "no device with id 1"),
])
def test_cli_refuses_what_is_not_ported(extra, message, capsys):
    """Every flag of tpurt's CLI is ported (the mesh, sharding, several
    processes, --tuned); what the CLI still refuses is what tpurt's
    refuses, with rc 2 and the reason on stderr."""
    assert cli.main(TINY + extra) == 2
    assert message in capsys.readouterr().err


def test_cli_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(TINY[1:]) == 2  # no --cpu
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.device_inventory()


def test_select_devices_spec_errors():
    assert mesh.select_devices(None, "cpu") == [torch.device("cpu")]
    assert mesh.select_devices("0", "cpu") == [torch.device("cpu")]
    for spec, msg in (("x", "not an integer"), ("3", "no device"),
                      ("0,0", "twice"), (",", "empty")):
        with pytest.raises(ValueError, match=msg):
            mesh.select_devices(spec, "cpu")


# -- utils ---------------------------------------------------------------------------


def test_progress_and_profiling_on_the_cpu(tmp_path):
    buf = io.StringIO()
    p = ProgressReporter(4, stream=buf, live=False)
    p(2)
    assert "Finished 2/4 tiles (50.00%)" in buf.getvalue()
    assert mrays_per_second(10, 10, 2, 3.0, 0.5) == pytest.approx(1.2e-3)
    profiling.reset()
    with profiling.span("tpurt.a", frame=0):
        with profiling.span("tpurt.a.b"):
            profiling.count("tpurt.n", 2)
    spans = profiling.totals()["spans"]
    assert spans["tpurt.a"]["calls"] == spans["tpurt.a.b"]["calls"] == 1
    assert spans["tpurt.a"]["self_s"] <= spans["tpurt.a"]["total_s"]
    assert profiling.totals()["counts"] == {"tpurt.n": 2}
    assert profiling.report().splitlines()[-1].split() == ["tpurt.n", "2"]
    with profiling.device_trace(str(tmp_path / "tr"), device="cpu") as prof:
        with profiling.span("tpurt.a", frame=1):
            torch.ones(4) + 1
    assert os.path.exists(tmp_path / "tr" / "trace.json") and prof is not None
    assert profiling.totals(traced=True)["spans"]["tpurt.a"]["calls"] == 1


# -- the viewer (viewer.py) -----------------------------------------------------------


def test_move_keys_match_reference_formulas(view_scene):
    ses = ViewerSession(view_scene, VIEW)
    x0, y0, z0 = ses.position
    yaw = ses.yaw
    v = MOVE_SPEED * KEY_DT
    ses.move_key("w")  # main.cpp:487-490
    assert ses.position == pytest.approx(
        (x0 + v * math.sin(yaw), y0, z0 + v * math.cos(yaw)))
    x1, y1, z1 = ses.position
    ses.move_key("a")  # main.cpp:497-500
    assert ses.position == pytest.approx(
        (x1 - v * math.cos(yaw), y1, z1 + v * math.sin(yaw)))
    x2, y2, z2 = ses.position
    ses.move_key("e")  # main.cpp:510-513
    assert ses.position == pytest.approx((x2, y2 + v, z2))
    p0, yw0 = ses.pitch, ses.yaw
    ses.move_key("i")
    assert ses.pitch == pytest.approx(p0 - ROT_SPEED * KEY_DT)
    ses.move_key("l")
    assert ses.yaw == pytest.approx(yw0 + ROT_SPEED * KEY_DT)
    assert ses.camera().params.device == view_scene.device


def test_accumulation_resets_on_move_and_refines(view_scene):
    ses = ViewerSession(view_scene, VIEW)
    d1 = ses.render_pass()
    d2 = ses.render_pass()
    assert ses.num_passes == 2 and not np.array_equal(d1, d2)
    np.testing.assert_array_equal(d1, render_frame(view_scene, ses.camera(), VIEW))
    ses.move_key("w")
    assert ses.num_passes == 0 and np.all(ses.display() == 0.0)
    assert not np.array_equal(d1, ses.render_pass())
    ses.adjust_spp(+3)
    assert ses.cfg.rays_per_pixel == 4 and ses.num_passes == 1
    ses.adjust_bounces(+2)
    assert ses.cfg.max_bounces == 5 and ses.num_passes == 0
    ses.adjust_spp(-10)
    assert ses.cfg.rays_per_pixel == 1


def test_pick_tints_red_and_undo(view_scene):
    ses = ViewerSession(view_scene, VIEW)
    idx = ses.pick(VIEW.width // 2, int(VIEW.height * 0.75))
    assert idx is not None and idx >= 0 and ses.picked == idx
    assert tuple(ses.scene.mat_color[idx].tolist()) == (1.0, 0.0, 0.0)
    orig = view_scene.mat_color.numpy()
    mask = np.arange(len(orig)) != idx
    np.testing.assert_array_equal(ses.scene.mat_color.numpy()[mask], orig[mask])
    ses.clear_tint()
    np.testing.assert_array_equal(ses.scene.mat_color.numpy(), orig)


def test_recolor_reslots_as_tpurt_and_reaches_the_material_table():
    """On the K = 12 grid (material slots shared by instances) the tinted
    mesh gets its own slot as tpurt gives it; the recoloured scene has a
    fresh cache and its megakernel material table (packed at every
    launch) holds the tint; the original is untouched."""
    from test_many_meshes import _grid_scene

    scene = grid_scene(12, device="cpu")
    tscene = _grid_scene(12)[0]
    scene.cache["probe"] = True
    for idx in (7, 12):
        mine, theirs = recolor_mesh(scene, idx), t_recolor_mesh(tscene, idx)
        assert mine.mesh_mat_slot == theirs.mesh_mat_slot
        assert mine.mat_slot_rep == theirs.mat_slot_rep
        assert mine.mesh_mat_slot != scene.mesh_mat_slot and mine.cache == {}
        cam = Camera.create((0, 150, 250), yaw=3.14, aspect_ratio=1.0, device="cpu")
        ctx = mk.prepare(mine, **flat_batch_args(mine, cam, SMALL, 0))
        assert ctx.tables.mats[idx, 2:5].tolist() == [1.0, 0.0, 0.0]
    assert scene.cache == {"probe": True}
    assert scene.mat_color[7].tolist() != [1.0, 0.0, 0.0]


def test_terminal_session_scripted(view_scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outbuf = io.StringIO()
    ses = run_terminal(view_scene, VIEW, preview_path="preview.bmp",
                       stream=io.StringIO("ww\nl\n+\n]\np 12 12\ng 2\nu\no\nQ\n"),
                       out=outbuf)
    assert os.path.exists("preview.bmp") and os.path.exists("output.bmp")
    assert "picked mesh" in outbuf.getvalue()
    assert ses.cfg.rays_per_pixel == 2 and ses.cfg.max_bounces == 4
    assert ses.picked is None and ses.num_passes == 1  # "u" reset, one pass


def test_render_passes_double_buffered_bitwise(view_scene, monkeypatch):
    """Pass k+1 is dispatched before pass k is read back, and the result
    equals sequential render_pass calls bit for bit; a config off the
    flat path falls back to sequential passes. The fast path needs no
    compaction threshold, as tpurt's viewer gates it (its test sets 0)."""
    cfg = VIEW.replace(rays_per_batch=256, compaction_threshold=0)
    seq = ViewerSession(view_scene, cfg)
    for _ in range(3):
        seq.render_pass()
    dd = ViewerSession(view_scene, cfg)
    events = []
    dispatch, acc = ViewerSession._dispatch_pass, ViewerSession._accumulate
    monkeypatch.setattr(ViewerSession, "_dispatch_pass", lambda self, f: (
        events.append(("dispatch", f)), dispatch(self, f))[1])
    monkeypatch.setattr(ViewerSession, "_accumulate", lambda self, b: (
        events.append(("accumulate", self.num_passes)), acc(self, b))[1])
    np.testing.assert_array_equal(dd.render_passes(3), seq.display())
    assert events == [("dispatch", 0), ("dispatch", 1), ("accumulate", 0),
                      ("dispatch", 2), ("accumulate", 1), ("accumulate", 2)]
    tiled = VIEW.replace(rays_per_batch=0)
    seq = ViewerSession(view_scene, tiled)
    seq.render_pass()
    seq.render_pass()
    np.testing.assert_array_equal(
        ViewerSession(view_scene, tiled).render_passes(2), seq.display())


def test_a_transient_error_rerenders_through_the_same_backend(view_scene,
                                                             monkeypatch):
    """A dispatched pass whose read-back fails transiently is rendered
    again through render_pass, on the same config (the same backend)."""
    ses = ViewerSession(view_scene, VIEW.replace(rays_per_batch=256))
    seen = []
    real = ViewerSession.render_pass

    def spy(self):
        seen.append(self.cfg)
        return real(self)

    class Dead:
        def cpu(self):
            raise OSError("device lost")

    monkeypatch.setattr(ViewerSession, "render_pass", spy)
    ses._accumulate([Dead()])
    assert seen == [ses.cfg] and ses.num_passes == 1
    np.testing.assert_array_equal(
        ses.display(), render_frame(view_scene, ses.camera(), ses.cfg))
    assert dataclasses.asdict(ses.cfg) == dataclasses.asdict(
        VIEW.replace(rays_per_batch=256))
