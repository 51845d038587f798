"""The hand-written CUDA kernels against their plain torch versions on
the card: the megakernel (B1) and its dense instantiation — on their
persistent grid too, with fewer lanes than a block, than the resident
threads and more — B1's TLAS and bf16 instantiations on tpurt's K = 12
instance grid and a bf16 Cornell sphere, cross-frame packed launches in
every instantiation, B1's deep-stack instantiation (stacks in global
memory) on presets.deep_stack_scene, B1 with sub-pixel jitter (its
jitter library) and with list quotas, the CLI's BMP against
render_image, the dense block sweep (B2)
alone, and the exact sweep (B3) alone and in the modular engine. Marked ``cuda``: without a CUDA device every test skips (the
decision is made in a fixture, at run time). On the GPU machine, which
has no jax, run them without tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

The module imports no jax, so it also hosts the chain scene the CPU
tests build with both packages' builders.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpurt_torch.config as config
from tpurt_torch.config import RenderConfig
from tpurt_torch.core.camera import Camera
from tpurt_torch.core.v3 import V3
from tpurt_torch.render import mega_cuda, mt_sweep, plucker_fused
from tpurt_torch.render import megakernel as mk
from tpurt_torch.render.megakernel import run_megakernel
from tpurt_torch.render.renderer import (
    flat_batch_args, list_batch_args, render_batch_flat,
    render_batch_flat_frames, render_frame, render_image)
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.presets import (
    cornell_sphere_scene, deep_stack_scene, grid_scene)
from tpurt_torch.scene.types import MaterialType

pytestmark = pytest.mark.cuda

CFG = RenderConfig(width=64, height=64, rays_per_pixel=2, max_bounces=3,
                   pixels_per_lane=2, mega_tail_passes=2,
                   object_path="sphere2.obj")


def _plain_start(scene, args):
    """(the plain backend's fresh lanes, the loop invariants) of one
    launch's run_megakernel arguments."""
    return (run_megakernel(scene, max_iterations=0, return_state=True, **args),
            mk.prepare(scene, **args))


def knot_obj_text() -> str:
    pos, nrm = procedural.torus_knot(segments=24, sides=8, radius=30.0, tube=8.0)
    lines = [f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}" for v in pos.reshape(-1, 3)]
    lines += [f"vn {n[0]:.9g} {n[1]:.9g} {n[2]:.9g}" for n in nrm.reshape(-1, 3)]
    lines += [f"f {3*i+1}//{3*i+1} {3*i+2}//{3*i+2} {3*i+3}//{3*i+3}"
              for i in range(len(pos))]
    lines += ["f 1 2 3", "f 1//1 2//2 99999//1"]  # skipped: no normals / OOB
    return "\n".join(lines) + "\n"


def chain_scene(builder_cls, material_cls, mt, proc, device=None):
    """An identity icosphere big enough for the fused static chain entry,
    two transformed instances of one OBJ (Glassy, OneSided) and a light,
    built with either package's builder (the CPU tests build it with
    tpurt's too, whose freeze takes no device)."""
    b = builder_cls()
    pos, nrm = proc.icosphere(1, radius=40.0)
    ball = b.add_triangles(pos, nrm)
    ball.material = material_cls(type=mt.SOLID, color=(0.8, 0.7, 0.6),
                                 specular_probability=0.3, reflectiveness=0.5)
    b.add_mesh(ball)
    text = knot_obj_text()
    knot = b.load_obj_text(text)
    knot.material = material_cls(type=mt.GLASSY, ior=1.5, color=(0.9, 0.9, 1.0))
    knot.pos, knot.yaw, knot.scale = (60.0, 10.0, -20.0), 0.7, 1.3
    b.add_mesh(knot)
    twin = b.load_obj_text(text)
    twin.material = material_cls(type=mt.ONE_SIDED, color=(0.5, 0.9, 0.5))
    twin.pos, twin.pitch, twin.roll = (-50.0, 30.0, 10.0), 0.3, -0.2
    b.add_mesh(twin)
    light = b.add_quad((-60, 180, -60), (60, 180, -60), (60, 180, 60),
                       (-60, 180, 60), (0, -1, 0), (0, 0, 0))
    light.material = material_cls(type=mt.SOLID, color=(1, 1, 1),
                                  emission_color=(1, 1, 0.9),
                                  emission_strength=10.0)
    return b.freeze() if device is None else b.freeze(device)


def shared_geometry_scene(device):
    """Two identity instances of one icosphere's triangles, Solid (culls
    backfaces) and Glassy (does not), a light above them, and a camera
    inside the spheres looking up, so that it sees their backfaces."""
    b = SceneBuilder()
    pos, nrm = procedural.icosphere(2, radius=40.0)
    solid = b.add_triangles(pos, nrm)
    solid.material = Material(type=MaterialType.SOLID, color=(0.8, 0.7, 0.6))
    b.add_mesh(solid)
    b.add_mesh(dataclasses.replace(
        solid, material=Material(type=MaterialType.GLASSY, ior=1.5,
                                 color=(0.9, 0.9, 1.0))))
    light = b.add_quad((-30, 60, -30), (30, 60, -30), (30, 60, 30), (-30, 60, 30),
                       (0, -1, 0), (0, 0, 0))
    light.material = Material(type=MaterialType.SOLID, color=(1, 1, 1),
                              emission_color=(1, 1, 0.9), emission_strength=10.0)
    cam = Camera.create((0, 0, 0), pitch=1.2, yaw=0.0, fov_degrees=100,
                        aspect_ratio=1.0, device=device)
    return b.freeze(device), cam


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene, cam, _ = cornell_sphere_scene(2, CFG, device="cuda")
    return scene, cam


@pytest.fixture(scope="module")
def cuda_chain(cuda_scene):
    """The 3-entry chain scene on the card and a camera that sees it."""
    scene = chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cuda")
    cam = Camera.create((0, 80, 220), pitch=-0.15, yaw=3.14159,
                        fov_degrees=70, aspect_ratio=1.0, device="cuda")
    return scene, cam


@pytest.mark.parametrize("trips", [1, 4, 16])
def test_kernel_lane_state_matches_plain(cuda_scene, trips):
    scene, cam = cuda_scene
    args = flat_batch_args(scene, cam, CFG, 0)
    plain = run_megakernel(scene, body_backend="plain", max_iterations=trips,
                           return_state=True, **args)
    before = mega_cuda.LAUNCHES
    kern = run_megakernel(scene, body_backend="cuda", max_iterations=trips,
                          return_state=True, **args)
    assert mega_cuda.LAUNCHES == before + 1
    agree, _err = mega_cuda.compare_lanes(plain, kern)
    assert agree >= 0.995, agree


def test_kernel_frame_matches_plain(cuda_scene):
    scene, cam = cuda_scene
    sk, sp = {}, {}
    kern = render_frame(scene, cam, CFG.replace(mega_body="pallas"), stats=sk)
    plain = render_frame(scene, cam, CFG.replace(mega_body="xla"), stats=sp)
    assert np.isfinite(kern).all()
    assert (kern != plain).any(axis=-1).mean() <= 0.005
    assert abs(sk["segments"] - sp["segments"]) <= 0.005 * sp["segments"]


def test_kernel_rejects_a_malformed_buffer(cuda_scene):
    scene, cam = cuda_scene
    from tpurt_torch.render import megakernel as mk

    lane, ctx = _plain_start(scene, flat_batch_args(scene, cam, CFG, 0))
    buf = mega_cuda.pack(lane)
    with pytest.raises(ValueError, match="words per lane"):
        mega_cuda.launch(buf[1:].contiguous(), ctx, 1)


@pytest.mark.parametrize("dense", [False, True])
def test_kernel_matches_plain_on_a_chain_scene(cuda_chain, dense):
    """Fused static BVH entry, two transformed instances (Glassy and
    OneSided), chain skip and root expansion on three entries; in the
    dense instantiation one block holds lanes on different entries, so
    its block sweep stages several entries a trip."""
    scene, cam = cuda_chain
    cfg = CFG.replace(rays_per_pixel=3, max_bounces=6, mega_tail_passes=3,
                      mega_dense=dense)
    args = flat_batch_args(scene, cam, cfg, 0)
    for trips in (1, 4, 16, None):
        st = [run_megakernel(scene, body_backend=b, max_iterations=trips,
                             return_state=True, **args) for b in ("plain", "cuda")]
        agree, _err = mega_cuda.compare_lanes(*st)
        assert agree >= 0.995, (trips, agree)


def _regime_scene(which):
    """tpurt's K = 12 instance grid (TLAS) with u8 or bf16 node bounds,
    or the Cornell sphere with bf16 bounds (an unrolled chain whose root
    expands), on the card, and a camera that sees it."""
    old = config.MEGA_BF16_BOUNDS
    config.MEGA_BF16_BOUNDS = which.endswith("bf16")
    try:
        if which.startswith("grid"):
            scene = grid_scene(12, device="cuda")
            cam = Camera.create((0, 150, 250), yaw=3.14, fov_degrees=90,
                                aspect_ratio=1.0, device="cuda")
            return scene, cam
        scene, cam, _ = cornell_sphere_scene(2, CFG, device="cuda")
        return scene, cam
    finally:
        config.MEGA_BF16_BOUNDS = old


@pytest.mark.parametrize("which", ["grid", "grid-bf16", "cornell-bf16"])
def test_kernel_matches_plain_in_the_tlas_and_bf16_instantiations(cuda_scene,
                                                                  which):
    """Lane state after 1, 4, 16 trips and to the end, and the frame, of
    B1's TLAS and bf16 instantiations against the plain version; the TLAS
    batch enters and exits instances, counted in the work rows."""
    scene, cam = _regime_scene(which)
    assert scene.mega_tlas == which.startswith("grid")
    assert scene.mega_bounds_fmt == ("bf16" if which.endswith("bf16") else "u8")
    cfg = CFG.replace(mega_tail_passes=3)
    args = flat_batch_args(scene, cam, cfg, 0)
    for trips in (1, 4, 16, None):
        st = [run_megakernel(scene, body_backend=b, max_iterations=trips,
                             return_state=True, **args) for b in ("plain", "cuda")]
        agree, _err = mega_cuda.compare_lanes(*st)
        assert agree >= 0.995, (trips, agree)
    lane, ctx = _plain_start(scene, args)
    _trips, work = mega_cuda.launch(mega_cuda.pack(lane), ctx, None)
    assert work.shape[0] == (6 if scene.mega_tlas else 4)
    if scene.mega_tlas:
        assert int(work[3].sum()) > 0 and int(work[4].sum()) > 0
    sk, sp = {}, {}
    kern = render_frame(scene, cam, cfg.replace(mega_body="pallas"), stats=sk)
    plain = render_frame(scene, cam, cfg.replace(mega_body="xla"), stats=sp)
    assert np.isfinite(kern).all() and kern.max() > 0.0
    assert (kern != plain).any(axis=-1).mean() <= 0.005
    assert abs(sk["segments"] - sp["segments"]) <= 0.005 * sp["segments"]


def _turned(cam, d_yaw):
    p = cam.host_params()
    return Camera.create(tuple(float(v) for v in p[:3]), pitch=float(p[3]),
                         yaw=float(p[4]) + d_yaw, roll=float(p[5]),
                         fov_degrees=float(p[6]), aspect_ratio=float(p[7]),
                         device="cuda")


@pytest.mark.parametrize("form", ["per-camera", "shared"])
@pytest.mark.parametrize("which", ["cornell", "grid", "cornell-bf16", "dense"])
def test_packed_kernel_matches_plain(cuda_scene, which, form):
    """A cross-frame packed launch (F = 2 with a rotation-only second
    camera, or F = 3 with one camera and the shared direction table) in
    every instantiation: lane state after 1, 4, 16 trips and to the end
    against the plain version, and each packed frame bit for bit the
    frame rendered alone through the kernel."""
    if which == "dense":
        scene, cam = cuda_scene
        cfg = CFG.replace(mega_dense=True)
    else:
        scene, cam = _regime_scene(which)
        cfg = CFG
    cams = (cam, _turned(cam, 0.1)) if form == "per-camera" else (cam,) * 3
    args = flat_batch_args(scene, cam, cfg, 0, frames=len(cams),
                           cameras=cams if form == "per-camera" else None)
    for trips in (1, 4, 16, None):
        st = [run_megakernel(scene, body_backend=b, max_iterations=trips,
                             return_state=True, **args) for b in ("plain", "cuda")]
        agree, _err = mega_cuda.compare_lanes(*st)
        assert agree == 1.0, (trips, agree)
    kcfg = cfg.replace(mega_body="pallas")
    rows = args["pixel_index"].shape[0] * cfg.pixels_per_lane
    packed, segs, _ = render_batch_flat_frames(scene, cams, kcfg, 0, frame_index=2)
    total = 0
    for f, c in enumerate(cams):
        lone, s1, _ = render_batch_flat(scene, c, kcfg, 0, frame_index=2 + f)
        assert torch.equal(packed[f * rows:(f + 1) * rows], lone), f
        total += s1
    assert segs == total


def test_deep_stack_kernel_matches_plain(cuda_scene):
    """B1's deep-stack instantiation (a stack budget of 72 words, above
    the 64-entry array) against the plain version, whose primary rays
    hold 67 entries after trip 34: lane state after 1, 16, 34 and 100
    trips and to the end, and the frame."""
    cfg = CFG.replace(width=32, height=32)
    scene, cam = deep_stack_scene(cfg, device="cuda")
    args = flat_batch_args(scene, cam, cfg, 0)
    lane, ctx = _plain_start(scene, args)
    assert scene.mega_stack_depth > 32 and mega_cuda.deep_stack(ctx)
    assert int(mk.stack_entries(mk.run_plain(lane, ctx, 34)).max()) > 64
    for trips in (1, 16, 34, 100, None):
        st = [run_megakernel(scene, body_backend=b, max_iterations=trips,
                             return_state=True, **args) for b in ("plain", "cuda")]
        agree, _err = mega_cuda.compare_lanes(*st)
        assert agree == 1.0, (trips, agree)
    sk, sp = {}, {}
    kern = render_frame(scene, cam, cfg.replace(mega_body="pallas"), stats=sk)
    plain = render_frame(scene, cam, cfg.replace(mega_body="xla"), stats=sp)
    np.testing.assert_array_equal(kern, plain)
    assert sk["segments"] == sp["segments"] and kern.max() > 0.0


def test_deep_stack_overflow_matches_plain(cuda_scene):
    """A full stack in global memory drops its bottom entry as the plain
    version's does: the deep-stack scene with its budget cut to 66
    words (still kDeep), below the 67 entries its primary rays push."""
    cfg = CFG.replace(width=32, height=32)
    scene, cam = deep_stack_scene(cfg, device="cuda")
    lane, ctx = _plain_start(scene, flat_batch_args(scene, cam, cfg, 0))
    lane, ctx = lane._replace(stack=lane.stack[:66]), ctx._replace(s_depth=66)
    assert mega_cuda.deep_stack(ctx)
    assert int(mk.stack_entries(mk.run_plain(lane, ctx, 34)).max()) == 66
    for trips in (34, 100, None):
        buf = mega_cuda.pack(lane)
        mega_cuda.launch(buf, ctx, trips)
        kern = mega_cuda.unpack(buf, ctx, lane.iters + (trips or 0))
        agree, _err = mega_cuda.compare_lanes(mk.run_plain(lane, ctx, trips), kern)
        assert agree == 1.0, (trips, agree)


def _shared_ring_lanes(depth):
    """The deep-stack scene's lanes with their budget cut to ``depth``
    words, which the shared-memory ring holds (not kDeep)."""
    cfg = CFG.replace(width=32, height=32)
    scene, cam = deep_stack_scene(cfg, device="cuda")
    lane, ctx = _plain_start(scene, flat_batch_args(scene, cam, cfg, 0))
    lane, ctx = lane._replace(stack=lane.stack[:depth]), ctx._replace(s_depth=depth)
    assert not mega_cuda.deep_stack(ctx)
    return lane, ctx


def test_shared_ring_overflow_matches_plain(cuda_scene):
    """A full stack ring in shared memory drops its bottom entry as the
    plain version's shift register does: the deep-stack scene with its
    budget cut to 60 words, below the 67 entries its primary rays push,
    so each of those lanes' rings wraps."""
    lane, ctx = _shared_ring_lanes(60)
    assert int(mk.stack_entries(mk.run_plain(lane, ctx, 34)).max()) == 60
    for trips in (34, 100, None):
        buf = mega_cuda.pack(lane)
        mega_cuda.launch(buf, ctx, trips)
        kern = mega_cuda.unpack(buf, ctx, lane.iters + (trips or 0))
        agree, _err = mega_cuda.compare_lanes(mk.run_plain(lane, ctx, trips), kern)
        assert agree == 1.0, (trips, agree)


@pytest.mark.parametrize("trips", [1, 4, 16])
def test_resumed_mid_stack_matches_plain(cuda_scene, trips):
    """Lanes stopped at ``trips`` and resumed by the next launch from the
    state buffer, again and again, with their stacks part full (and, at
    60 words, wrapped): every field, the stack slots included, equals the
    plain version stepped as far after each launch."""
    lane, ctx = _shared_ring_lanes(60)
    buf = mega_cuda.pack(lane)
    plain = lane
    held = []
    for k in range(1, 49 // trips + 1):
        mega_cuda.launch(buf, ctx, trips)
        plain = mk.run_plain(plain, ctx, trips)
        kern = mega_cuda.unpack(buf, ctx, plain.iters)
        agree, _err = mega_cuda.compare_lanes(plain, kern)
        assert agree == 1.0, (k * trips, agree)
        held.append(int(mk.stack_entries(kern).max()))
    assert 0 < min(held) and max(held) == 60, held


@pytest.mark.parametrize("seed_mode", ["reference", "decorrelated"])
@pytest.mark.parametrize("which", ["cornell", "grid", "dense"])
def test_jittered_kernel_matches_plain(cuda_scene, which, seed_mode):
    """B1 from its jitter library (each new sample's primary ray computed
    in the kernel) in the u8, TLAS and dense instantiations against the
    plain version: every lane field after 1, 4, 16 trips and to the end,
    and the frame bit for bit with equal segments; the launches count in
    JITTER_LAUNCHES, and the frame differs from the unjittered one."""
    if which == "grid":
        scene, cam = _regime_scene("grid")
    else:
        scene, cam = cuda_scene
    cfg = CFG.replace(subpixel_jitter=True, seed_mode=seed_mode,
                      mega_dense=which == "dense")
    args = flat_batch_args(scene, cam, cfg, 0)
    for trips in (1, 4, 16, None):
        st = [run_megakernel(scene, body_backend=b, max_iterations=trips,
                             return_state=True, **args) for b in ("plain", "cuda")]
        assert st[0].c_set is None  # the primary-hit cache is off
        agree, _err = mega_cuda.compare_lanes(*st)
        assert agree == 1.0, (trips, agree)
    before = (mega_cuda.JITTER_LAUNCHES, mega_cuda.LAUNCHES, mega_cuda.DENSE_LAUNCHES)
    sk, sp = {}, {}
    kern = render_frame(scene, cam, cfg.replace(mega_body="pallas"), stats=sk)
    assert mega_cuda.JITTER_LAUNCHES > before[0]
    assert (mega_cuda.LAUNCHES, mega_cuda.DENSE_LAUNCHES) == before[1:]
    plain = render_frame(scene, cam, cfg.replace(mega_body="xla"), stats=sp)
    np.testing.assert_array_equal(kern, plain)
    assert sk["segments"] == sp["segments"]
    assert not np.array_equal(kern, render_frame(
        scene, cam, cfg.replace(subpixel_jitter=False)))


@pytest.mark.parametrize("p", [2, 4])
def test_list_quota_kernel_matches_plain(cuda_scene, p):
    """B1 with a list quota over a seeded permutation of 3,999 of the
    frame's pixels (the last lanes' later slots clamp to the last entry)
    against the plain version in every lane field after 1, 4, 16 trips
    and to the end, and its radiance rows bit for bit; the identity list
    at the flat batch's lanes gives the flat frame bit for bit."""
    scene, cam = cuda_scene
    cfg = CFG.replace(pixels_per_lane=p)
    n = cfg.width * cfg.height
    perm = np.random.default_rng(p).permutation(n)[:3999]
    args = list_batch_args(scene, cam, cfg, perm)
    for trips in (1, 4, 16, None):
        st = [run_megakernel(scene, body_backend=b, max_iterations=trips,
                             return_state=True, **args) for b in ("plain", "cuda")]
        assert torch.equal(st[1].lane0.long(), torch.arange(
            args["pixel_index"].shape[0], device="cuda"))
        agree, _err = mega_cuda.compare_lanes(*st)
        assert agree == 1.0, (trips, agree)
    kern = run_megakernel(scene, body_backend="cuda", **args)
    plain = run_megakernel(scene, body_backend="plain", **args)
    assert torch.equal(kern[0], plain[0]) and kern[1] == plain[1]
    ident = list_batch_args(scene, cam, cfg, np.arange(n),
                            lanes=flat_batch_args(scene, cam, cfg, 0)[
                                "pixel_index"].shape[0])
    mean, _segs, _ = run_megakernel(scene, body_backend="cuda", **ident)
    flat = render_frame(scene, cam, cfg.replace(mega_body="pallas"))
    np.testing.assert_array_equal(mean[:n].cpu().numpy().reshape(flat.shape), flat)


def test_cli_bmp_equals_render_image(cuda_scene, tmp_path):
    """``tpurt_torch.cli.main`` on the card (its default quota 8 and 5
    tail passes) writes the BMP of render_image's frame, bit for bit."""
    from tpurt_torch import cli
    from tpurt_torch.io import read_bmp
    from tpurt_torch.scene.presets import default_scene

    out = str(tmp_path / "o.bmp")
    assert cli.main(["--width", "48", "--height", "40", "--rays-per-pixel", "3",
                     "--max-bounces", "4", "--object-path", "sphere1.obj",
                     "--output", out]) == 0
    cfg = RenderConfig(width=48, height=40, rays_per_pixel=3, max_bounces=4,
                       object_path="sphere1.obj", pixels_per_lane=8,
                       mega_tail_passes=5)
    scene, cam, _ = default_scene(cfg, device="cuda")
    np.testing.assert_array_equal(read_bmp(out), render_image(scene, cam, cfg))


def test_tlas_scene_refuses_the_dense_mode(cuda_scene):
    scene, cam = _regime_scene("grid")
    with pytest.raises(ValueError, match="TLAS"):
        render_frame(scene, cam, CFG.replace(mega_dense=True))


def _aimed_rays(rows, n, seed, spread=60.0):
    """Rays (origins, unit directions) aimed near random triangles of
    ``rows`` (T, 18), numpy f32."""
    r = np.random.default_rng(seed)
    tri = rows[r.integers(0, len(rows), n)]
    w = r.dirichlet((1, 1, 1), n).astype(np.float32) * 1.2 - 0.1
    target = tri[:, 0:3] * w[:, :1] + tri[:, 3:6] * w[:, 1:2] + tri[:, 6:9] * w[:, 2:3]
    o = (target + r.normal(size=(n, 3)) * spread).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_dense_sweep_kernel_matches_plain(cuda_scene):
    scene = chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cuda")
    table = plucker_fused.build_dense_table(scene)
    o, d = _aimed_rays(table.rows[:table.count].cpu().numpy(), 20000, 0)
    entry = torch.from_numpy(np.random.default_rng(1).integers(0, 3, 20000)).cuda()
    lo = V3(*(torch.from_numpy(o[:, i].copy()).cuda() for i in range(3)))
    ld = V3(*(torch.from_numpy(d[:, i].copy()).cuda() for i in range(3)))
    before = plucker_fused.LAUNCHES
    t, col = plucker_fused.sweep_entry_local(lo, ld, entry, table)
    assert plucker_fused.LAUNCHES == before + 1
    tp, colp = plucker_fused.sweep_plain(lo, ld, entry, table)
    assert torch.equal(col, colp) and bool((col >= 0).any())
    assert torch.equal(t, tp)


@pytest.mark.parametrize("n", [77, 12345])
def test_block_sweep_on_mixed_entries(cuda_scene, n):
    """The block sweep on the 3-entry chain scene: lanes of one block on
    different entries (random in the first half, runs of 300 lanes on one
    entry in the second, so some blocks skip an entry); ``n`` is a
    multiple of neither the block (128) nor the column tile (256)."""
    scene = chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cuda")
    table = plucker_fused.build_dense_table(scene)
    o, d = _aimed_rays(table.rows[:table.count].cpu().numpy(), n, 5)
    r = np.random.default_rng(6)
    lane = np.arange(n)
    entry = np.where(lane < n // 2, r.integers(0, 3, n), (lane // 300) % 3)
    entry = torch.from_numpy(entry).cuda()
    lo = V3(*(torch.from_numpy(o[:, i].copy()).cuda() for i in range(3)))
    ld = V3(*(torch.from_numpy(d[:, i].copy()).cuda() for i in range(3)))
    t, col = plucker_fused.sweep_entry_local(lo, ld, entry, table)
    tp, colp = plucker_fused.sweep_plain(lo, ld, entry, table)
    assert torch.equal(col, colp) and torch.equal(t, tp)
    if n > 1000:
        assert bool((col >= 0).any()) and bool((col < 0).any())


@pytest.mark.parametrize("size", ["below_block", "below_resident",
                                  "above_resident"])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("which", ["sphere", "chain"])
def test_persistent_megakernel_matches_plain(request, which, dense, size):
    """The persistent grid against the plain version (every lane its own
    row of the torch loop), both instantiations, on the one-entry Cornell
    sphere and the 3-entry chain scene: lane state and per-lane trips
    after 1, 4 and 16 trips, and the segment row of the work count equal
    to the segments each lane added."""
    scene, cam = request.getfixturevalue(
        {"sphere": "cuda_scene", "chain": "cuda_chain"}[which])
    launch = mega_cuda.launch_config(dense, s_depth=2 * scene.mega_stack_depth)
    n = {"below_block": launch["threads"] // 2 + 3,
         "below_resident": launch["resident_lanes"] // 7 + 5,
         "above_resident": launch["resident_lanes"] + 3 * launch["threads"] + 5,
         }[size]
    side = int(np.ceil(np.sqrt(n)))
    cfg = CFG.replace(width=side, height=side, rays_per_batch=side * side,
                      mega_dense=dense)
    args = flat_batch_args(scene, cam, cfg, 0)
    for key in ("ro0", "rd0", "pixel_index"):
        args[key] = args[key][:n]
    lane, ctx = _plain_start(scene, args)
    assert (ctx.tables.dense is not None) == dense and lane.done.shape[0] == n
    buf0 = mega_cuda.pack(lane)
    plain = lane
    plain_trips = torch.zeros(n, dtype=torch.int32, device="cuda")
    for k in range(1, 17):
        plain_trips += (~plain.done).to(torch.int32)
        plain = mk.run_plain(plain, ctx, 1)
        if k not in (1, 4, 16):
            continue
        buf = buf0.clone()
        trips, work = mega_cuda.launch(buf, ctx, k)
        kern = mega_cuda.unpack(buf, ctx, lane.iters + k)
        agree, _err = mega_cuda.compare_lanes(plain, kern)
        assert agree >= 0.995, (k, agree)
        assert float((trips == plain_trips).float().mean()) >= 0.995, k
        assert torch.equal(work[2], (kern.segments - lane.segments).to(torch.int32))
        if dense:  # no node rows: row 1 counts the entry sweeps
            assert not bool(work[0].any())


def test_dense_megakernel_matches_plain(cuda_scene):
    scene, cam = cuda_scene
    cfg = CFG.replace(mega_dense=True)
    args = flat_batch_args(scene, cam, cfg, 0)
    for trips in (1, 4, 16):
        st = {b: run_megakernel(scene, body_backend=b, max_iterations=trips,
                                return_state=True, **args)
              for b in ("plain", "cuda")}
        agree, _err = mega_cuda.compare_lanes(st["plain"], st["cuda"])
        assert agree >= 0.995, (trips, agree)
    before = mega_cuda.DENSE_LAUNCHES
    sk, sp = {}, {}
    kern = render_frame(scene, cam, cfg.replace(mega_body="pallas"), stats=sk)
    assert mega_cuda.DENSE_LAUNCHES > before
    plain = render_frame(scene, cam, cfg.replace(mega_body="xla"), stats=sp)
    assert (kern != plain).any(axis=-1).mean() <= 0.005
    assert abs(sk["segments"] - sp["segments"]) <= 0.005 * sp["segments"]


def test_mt_sweep_kernel_matches_plain(cuda_scene):
    pos, nrm = procedural.icosphere(3, radius=50.0)
    rows = np.concatenate([pos.reshape(-1, 9), nrm.reshape(-1, 9)], 1).astype(np.float32)
    o, d = _aimed_rays(rows, 30000, 2, spread=150.0)
    cull = torch.from_numpy(np.arange(len(rows)) % 4 != 0).cuda()
    p_rows, flags = mt_sweep.pad_tri_rows(torch.from_numpy(rows).cuda(), cull)
    ro, rd = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    before = mt_sweep.LAUNCHES
    t, idx = mt_sweep.mt_sweep(ro, rd, p_rows, flags, len(rows))
    assert mt_sweep.LAUNCHES == before + 1
    tp, idxp = mt_sweep.mt_sweep_plain(ro, rd, p_rows, flags, len(rows))
    assert torch.equal(idx, idxp) and bool((idx >= 0).any()) and bool((idx < 0).any())
    assert torch.equal(t, tp)


def _b3_table(seed):
    """(T, 18) rows of icosphere(4) (5,120 triangles), in an order that
    repeats rows at random distances: equal rows give equal t, so the
    first minimum decides between them."""
    pos, nrm = procedural.icosphere(4, radius=50.0)
    base = np.concatenate([pos.reshape(-1, 9), nrm.reshape(-1, 9)], 1).astype(np.float32)
    r = np.random.default_rng(seed)
    pick = np.where(r.random(len(base)) < 0.3, r.integers(0, len(base), len(base)),
                    np.arange(len(base)))
    return torch.from_numpy(base[pick]).cuda()


B3_RAYS = ["1", "31", "below_block", "below_resident", "65536", "307200",
           "G2", "G1"]
B3_ROWS = [1, 2, 255, 256, 257, 1280, 4096]


def _first_rays_at(group: int) -> int:
    """The smallest power of two of rays for which the G rule picks
    ``group`` threads a ray set."""
    n = 1
    while mt_sweep.launch_config(n)["groups"] != group:
        n *= 2
        assert n < 1 << 26, group
    return n


def _b3_rays(size: str) -> int:
    c = mt_sweep.launch_config(1)
    per_block = c["threads"] * c["rays_per_thread"] // c["groups"]
    if size.startswith("G"):
        return _first_rays_at(int(size[1:]))
    return {"below_block": per_block // 2 + 3,
            "below_resident": c["resident_threads"] // 3 + 7}.get(size) or int(size)


def test_mt_sweep_rule_chooses_every_group():
    """Over ray counts from 1 to 16 x the resident threads, the G rule
    picks every power of two up to its largest, fewer threads a ray set
    as rays grow; the forms test below runs each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = mt_sweep.launch_config(1)
    n, seen = 1, []
    while n <= 16 * c["resident_threads"]:
        seen.append(mt_sweep.launch_config(n)["groups"])
        n *= 2
    assert seen == sorted(seen, reverse=True) and seen[0] == c["groups"], seen
    assert set(seen) == {1 << i for i in range(c["groups"].bit_length())}, seen
    assert {mt_sweep.launch_config(_b3_rays(s))["groups"] for s in B3_RAYS} == set(seen)


@pytest.mark.parametrize("size", B3_RAYS)
def test_mt_sweep_forms_match_plain(cuda_scene, size):
    """Kernel B3 against its plain version in every row and bit of t, at
    ray counts below a block, below the resident threads, at a tile and a
    frame, and where the G rule chooses each G, over 1 to 4,096 rows:
    the public entry (range, per-row flags, mixed), the range form with
    one flag (all culled, none) and the id-list form (ids repeat; all,
    none or mixed flags)."""
    n = _b3_rays(size)
    table = _b3_table(7)
    lay = mt_sweep.mt_layout(table)
    r = np.random.default_rng(n)
    rows = B3_ROWS[:5] if size.startswith("G") else B3_ROWS  # their plain sweeps are long
    for j, count in enumerate(rows):
        first = int(r.integers(0, table.shape[0] - count + 1))
        o, d = _aimed_rays(table[first:first + count].cpu().numpy(), n, j, spread=150.0)
        ro, rd = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
        cull = torch.from_numpy(r.random(count) < 0.5).cuda()
        p_rows, flags = mt_sweep.pad_tri_rows(table[first:first + count], cull)
        got = mt_sweep.mt_sweep(ro, rd, p_rows, flags, count)
        want = mt_sweep.mt_sweep_plain(ro, rd, p_rows, flags, count)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), ("public", count)
        whole = bool(j % 2)
        got = mt_sweep.sweep(ro, rd, lay, table, count, first=first, cull=whole)
        want = mt_sweep.sweep_plain(ro, rd, table, count, first=first, cull=whole)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), ("range", count)
        ids = torch.from_numpy(r.integers(0, table.shape[0], count).astype(np.int32)).cuda()
        flags = [cull, torch.zeros_like(cull), torch.ones_like(cull)][j % 3].float()
        got = mt_sweep.sweep(ro, rd, lay, table, count, ids=ids, cull_flags=flags)
        want = mt_sweep.sweep_plain(ro, rd, table, count, ids=ids, cull_flags=flags)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), ("ids", count)
        if n >= 65536 and count >= 256:
            assert bool((got[1] >= 0).any()) and bool((got[1] < 0).any())


def test_mt_sweep_raises_on_what_it_cannot_serve(cuda_scene):
    table = _b3_table(1)
    lay = mt_sweep.mt_layout(table)
    ro = torch.zeros((4, 3), device="cuda")
    with pytest.raises(ValueError, match="tri_mt"):
        mt_sweep.sweep(ro, ro, lay[:, :9], table, 4)
    with pytest.raises(ValueError, match="16-byte"):
        mt_sweep.sweep(ro, ro, lay.view(-1)[1:1 + 12 * 100].view(100, 12),
                       table[:100].contiguous(), 4)
    with pytest.raises(ValueError, match="ids"):
        mt_sweep.sweep(ro, ro, lay, table, 4, ids=torch.zeros(4, device="cuda"))
    with pytest.raises(ValueError, match="outside"):
        mt_sweep.sweep(ro, ro, lay, table, 4, first=table.shape[0] - 2)


def _modular_frames_equal(scene, cam, cfg):
    before = mt_sweep.LAUNCHES
    sk, se = {}, {}
    kern = render_frame(scene, cam, cfg.replace(dense_engine="pallas"), stats=sk)
    assert mt_sweep.LAUNCHES > before
    exact = render_frame(scene, cam, cfg.replace(dense_engine="exact"), stats=se)
    np.testing.assert_array_equal(kern, exact)
    assert sk["segments"] == se["segments"]


def test_modular_kernel_frame_equals_exact(cuda_scene):
    scene, cam = cuda_scene
    _modular_frames_equal(scene, cam, CFG.replace(engine="modular", tile_size=32))


def test_modular_kernel_frame_equals_exact_on_the_chain_scene(cuda_chain):
    """The fused identity pass (id-list form) and two transformed
    instances, Glassy and OneSided (range form), through kernel B3."""
    scene, cam = cuda_chain
    _modular_frames_equal(scene, cam, CFG.replace(engine="modular", tile_size=32,
                                                  max_bounces=4))


def test_modular_kernel_frame_equals_exact_with_shared_geometry(cuda_scene):
    """One triangle range in two fused instances with different cull
    policies (Solid and Glassy): B3's flags come per listed row, not per
    triangle."""
    scene, cam = shared_geometry_scene("cuda")
    _modular_frames_equal(scene, cam, CFG.replace(engine="modular", tile_size=32,
                                                  max_bounces=4))


def _lanes_packed_on_the_host(ctx, ro0, rd0, pix):
    """The fresh buffer as the launch path built it before the kernel
    wrote it: ``_initial_lane``'s torch operations, then ``pack``."""
    return mega_cuda.pack(mk._initial_lane(ctx, ro0, rd0, pix))


def _fresh_case(which, cuda_scene, cuda_chain):
    """(scene, camera, cfg, one launch's run_megakernel arguments, whether
    a frame is rendered too) for a fresh-lanes case."""
    scene, cam = cuda_scene
    cfg = CFG
    if which == "chain":
        scene, cam = cuda_chain
        cfg = CFG.replace(rays_per_pixel=3, max_bounces=6, mega_tail_passes=3)
    elif which in ("cornell-bf16", "grid"):
        scene, cam = _regime_scene(which)
    elif which == "deep":
        cfg = CFG.replace(width=32, height=32)
        scene, cam = deep_stack_scene(cfg, device="cuda")
    elif which == "dense-teapot":
        from tpurt_torch.scene.presets import scene_around

        b = SceneBuilder()
        handle = b.add_triangles(*procedural.torus_knot(96, 32, 80, 22))
        cfg = CFG.replace(width=64, height=48, mega_dense=True)
        scene, cam = scene_around(b, handle, cfg, device="cuda")
    elif which.startswith("jitter"):
        cfg = CFG.replace(subpixel_jitter=True, seed_mode=which.split("-")[1])
    elif which == "cache-off":
        cfg = CFG.replace(rays_per_pixel=1)
    if which.startswith("packed"):
        cams = (cam, _turned(cam, 0.1)) if which == "packed-per-camera" else None
        args = flat_batch_args(scene, cam, cfg, 0, frames=2, cameras=cams)
    elif which.startswith("list"):
        cfg = cfg.replace(pixels_per_lane=int(which[-1]))
        n = cfg.width * cfg.height
        args = list_batch_args(scene, cam, cfg,
                               np.random.default_rng(3).permutation(n)[:3001])
    else:
        args = flat_batch_args(scene, cam, cfg, 0)
    return scene, cam, cfg, args, not which.startswith(("packed", "list"))


@pytest.mark.parametrize("which", [
    "cornell", "chain", "cornell-bf16", "grid", "deep", "dense-teapot",
    "packed-shared", "packed-per-camera", "list-p2", "list-p4",
    "jitter-reference", "jitter-decorrelated", "cache-off"])
def test_fresh_lanes_kernel_writes_the_packed_initial_lanes(cuda_scene, cuda_chain,
                                                            monkeypatch, which):
    """The fresh-lanes kernel (mega_cuda.fresh) against the launch path
    it replaced (``_initial_lane``'s torch operations, ``pack``) in every
    instantiation and layout: the buffer word for word, counted in
    FRESH_LAUNCHES and ``fresh_lanes.device`` and in no megakernel
    launch counter; the lanes after 1 and 16 trips; the whole launch's
    radiance and segments; and the frame, bit for bit."""
    from tpurt_torch.utils import profiling as P

    scene, cam, cfg, args, frame = _fresh_case(which, cuda_scene, cuda_chain)
    assert cfg.rays_per_pixel > 1 or which == "cache-off"
    lane, ctx = _plain_start(scene, args)
    assert isinstance(lane, mk._Lane) and ctx.use_cache == (
        which != "cache-off" and not which.startswith("jitter"))
    counters = (mega_cuda.LAUNCHES, mega_cuda.DENSE_LAUNCHES, mega_cuda.JITTER_LAUNCHES)
    before = mega_cuda.FRESH_LAUNCHES
    got = mega_cuda.fresh(ctx, lane.ro0, lane.rd0, args["pixel_index"])
    assert mega_cuda.FRESH_LAUNCHES == before + 1
    assert (mega_cuda.LAUNCHES, mega_cuda.DENSE_LAUNCHES,
            mega_cuda.JITTER_LAUNCHES) == counters
    want = mega_cuda.pack(lane)
    assert got.shape == want.shape
    diff = (got != want).any(dim=1).nonzero().flatten().tolist()
    assert not diff, [mega_cuda.LANE_WORDS[k] if k < len(mega_cuda.LANE_WORDS)
                      else k for k in diff]

    def kernel_runs(**kw):
        return run_megakernel(scene, body_backend="cuda", **args, **kw)

    P.reset()
    ours = [kernel_runs(max_iterations=k, return_state=True) for k in (1, 16)]
    assert P.totals()["counts"]["fresh_lanes.device"] == 2 * lane.done.shape[0]
    assert "fresh_lanes.host" not in P.totals()["counts"]
    ours.append(kernel_runs())
    frames = [render_frame(scene, cam, cfg.replace(mega_body="pallas"))] if frame else []
    with monkeypatch.context() as m:
        m.setattr(mega_cuda, "fresh", _lanes_packed_on_the_host)
        theirs = [kernel_runs(max_iterations=k, return_state=True) for k in (1, 16)]
        theirs.append(kernel_runs())
        if frame:
            frames.append(render_frame(scene, cam, cfg.replace(mega_body="pallas")))
    for k, a, b in zip((1, 16), ours, theirs):
        assert torch.equal(mega_cuda.pack(a), mega_cuda.pack(b)), k
    assert torch.equal(ours[2][0], theirs[2][0]) and ours[2][1] == theirs[2][1]
    if frame:
        np.testing.assert_array_equal(*frames)
        assert frames[0].max() > 0.0


#: glass-cornell's model, scale and camera (benchmark/configs) on a small
#: torus knot, at a test size.
GLASS = RenderConfig(width=24, height=12, rays_per_pixel=2, max_bounces=12,
                     rays_per_batch=512, compaction_threshold=0,
                     camera_position=(0.0, 20.0, 230.0), camera_pitch=-0.08,
                     fov_degrees=45.0, model_scale=1.0, model_material={
                         "type": 3, "ior": 1.5, "color": [1.0, 1.0, 1.0]})


def test_b1_work_counters_add_up_on_a_glass_scene(cuda_scene, monkeypatch):
    """On the glass scene, a fresh launch stopped after 4 trips and the
    resumed launch that finishes it: each adds to the ``b1.*`` counters
    the sums of its own trips and work rows, the two add up to the
    segments an unbroken render returns, and the counting reads nothing
    more from the card than the launch's most trips did alone."""
    from tpurt_torch.scene.presets import scene_around
    from tpurt_torch.utils import profiling as P

    b = SceneBuilder()
    knot = b.add_triangles(*procedural.torus_knot(segments=16, sides=6,
                                                  radius=80.0, tube=22.0))
    scene, cam = scene_around(b, knot, GLASS, device="cuda")
    args = flat_batch_args(scene, cam, GLASS, 0)
    seen = []
    inner = mega_cuda.launch

    def spy(*a, **k):
        out = inner(*a, **k)
        seen.append(tuple(t.clone() for t in out))
        return out

    def expected(trips, work):
        t, w = trips.long().cpu(), work.long().cpu()
        return [int(w[0].sum()), int(w[1].sum()), int(w[2].sum()),
                int(t.sum()), int(t.max()) * t.numel(), int(w[-1].sum())]

    def groups_bound(c):  # a group holds 1 to 32 completing lanes
        return -(-c[2] // 32) <= c[5] <= c[2]

    def counters():
        c = P.totals()["counts"]
        return [c.get(n, 0) for n in mega_cuda.WORK_COUNTERS]

    monkeypatch.setattr(mega_cuda, "launch", spy)
    P.reset()
    _, whole, _ = run_megakernel(scene, body_backend="cuda", **args)
    assert counters() == expected(*seen[0]) and counters()[2] == whole
    assert groups_bound(counters())
    syncs_whole = P.totals()["counts"]["host_syncs"]

    P.reset()
    state = run_megakernel(scene, body_backend="cuda", max_iterations=4,
                           return_state=True, **args)
    fresh = counters()
    assert fresh == expected(*seen[1])
    P.reset()
    run_megakernel(scene, body_backend="cuda", initial_state=state, **args)
    resumed = counters()
    assert resumed == expected(*seen[2])
    assert fresh[2] + resumed[2] == whole
    assert groups_bound(fresh) and groups_bound(resumed) and fresh[5] > 0
    assert 0 < resumed[3] < resumed[4]  # some lanes finish before others

    monkeypatch.setattr(mega_cuda, "work_counts",
                        lambda trips, work: trips.max().long().view(1))
    P.reset()
    _, again, _ = run_megakernel(scene, body_backend="cuda", **args)
    assert again == whole and counters() == [0] * len(mega_cuda.WORK_COUNTERS)
    assert P.totals()["counts"]["host_syncs"] == syncs_whole


def _plain_walk(lane, ctx, stops):
    """The plain version's lanes stepped one trip at a time to the end:
    {stop: (lanes, trips each lane ran, its work rows)} after each of
    ``stops`` trips (None: at the end). The work rows are what B1 counts
    for those trips, from the bank rows the lanes stood at: child-box
    tests (the slots of a node row with a child, from the lane's resume
    priority on, in its direction's order), leaf rows, segments, and in
    the TLAS regime instance enters and exits."""
    ints = ctx.rows.view(torch.int32)
    slots = torch.arange(ctx.arity, device=ints.device)
    metas = ints[:, (10 + 4 * slots) if ctx.bf16 else (9 + 3 * slots)]
    axes = ints[:, 6]
    n = lane.done.shape[0]
    trips = torch.zeros(n, dtype=torch.int32, device=ints.device)
    work = torch.zeros((5 if ctx.tlas else 3, n), dtype=torch.int64,
                       device=ints.device)
    out, cur, k = {}, lane, 0
    while True:
        work[2] = (cur.segments - lane.segments).long()
        if k in stops:
            out[k] = (cur, trips.clone(), work.clone())
        if bool(cur.done.all()):
            out[None] = (cur, trips.clone(), work.clone())
            return out
        live = ~cur.done
        at = live & (cur.entry < ctx.e_count) & (cur.cur >= 0)
        inst = at & cur.cur_inst if ctx.tlas else torch.zeros_like(at)
        node = at & ~cur.cur_leaf & ~inst
        row = cur.cur.clamp(min=0).long()
        ax = axes[row]
        d = torch.where(ax == 0, cur.ld.x, torch.where(ax == 1, cur.ld.y, cur.ld.z))
        prio = torch.where((d >= 0)[:, None], slots, ctx.arity - 1 - slots)
        tested = (metas[row] != 0) & (prio >= cur.cur_slot[:, None].long())
        work[0] += node.long() * tested.sum(1)
        work[1] += (at & cur.cur_leaf & ~inst).long()
        if ctx.tlas:
            work[3] += (inst & ~cur.in_inst).long()
            work[4] += (inst & cur.in_inst).long()
        trips += live.to(torch.int32)
        cur = mk.run_plain(cur, ctx, 1)
        k += 1


@pytest.mark.parametrize("which", ["u8", "bf16", "tlas", "deep", "jitter"])
def test_kernel_matches_plain_on_a_natively_built_glass_layout(cuda_scene, which):
    """glass-cornell's layout at a test size: an identity Glassy model
    of 512 triangles and the box's two-sided quads in one fused static
    BVH, built natively, the one-sided front quad inline (with u8 or
    bf16 node bounds; "deep": its lanes with a 72-word stack budget,
    which B1's deep-stack instantiation runs; "jitter": through B1's
    jitter library); "tlas": tpurt's K = 12 instance grid of
    icosphere(1), every instance Glassy, seen from close by. A glass
    segment walks many rows, so B1's launches stopped after 1, 2, 3, 4,
    5, 8, 13 and 16 trips stop lanes mid-walk: its lanes there and at
    the end equal the plain version's in every word, each lane's trips
    and its work rows (box tests, leaf rows, segments; instance enters
    and exits) equal those the plain version's trips make, and its
    completion groups hold 1 to 32 completing lanes each. On the u8
    layout the frame is the plain version's too."""
    from tpurt_torch.scene.presets import GRID_MATERIALS, scene_around

    cfg = GLASS.replace(subpixel_jitter=which == "jitter")
    old = config.MEGA_BF16_BOUNDS
    config.MEGA_BF16_BOUNDS = which == "bf16"
    try:
        if which == "tlas":
            scene = grid_scene(12, subdivisions=1, materials=(GRID_MATERIALS[3],),
                               device="cuda")
            cam = Camera.create((40, 97, 10), yaw=3.14, fov_degrees=40,
                                aspect_ratio=cfg.aspect_ratio, device="cuda")
            assert scene.mega_tlas
        else:
            b = SceneBuilder()
            knot = b.add_triangles(*procedural.torus_knot(
                segments=32, sides=8, radius=80.0, tube=22.0))
            scene, cam = scene_around(b, knot, cfg, device="cuda")
            assert scene.mega_chain == ((-1, 0, False),) and scene.mesh_identity[7]
            assert scene.mega_static_rows.shape[0] == 2
    finally:
        config.MEGA_BF16_BOUNDS = old
    assert scene.mega_bounds_fmt == ("bf16" if which == "bf16" else "u8")
    lane, ctx = _plain_start(scene, flat_batch_args(scene, cam, cfg, 0))
    if which == "deep":
        empty = torch.full_like(lane.stack[0], 0xFFFFFFFF)
        extra = 72 - ctx.s_depth
        lane = lane._replace(stack=lane.stack + (empty,) * extra)
        ctx = ctx._replace(s_depth=72)
        assert mega_cuda.deep_stack(ctx)
    assert ctx.jitter == (which == "jitter")
    stops = (1, 2, 3, 4, 5, 8, 13, 16)
    walk = _plain_walk(lane, ctx, stops)
    assert int(walk[None][1].max()) > 16  # the batch runs past the stops
    buf0 = mega_cuda.pack(lane)
    for k in stops + (None,):
        plain, ptrips, pwork = walk[k]
        buf = buf0.clone()
        trips, work = mega_cuda.launch(buf, ctx, k)
        want = mega_cuda.pack(plain)
        diff = (buf != want).any(dim=1).nonzero().flatten().tolist()
        assert not diff, (k, [mega_cuda.LANE_WORDS[j] if j < len(
            mega_cuda.LANE_WORDS) else j for j in diff])
        assert torch.equal(trips, ptrips), k
        assert work.shape[0] == pwork.shape[0] + 1
        assert torch.equal(work[:-1].long(), pwork), k
        segs, groups = int(work[2].sum()), int(work[-1].sum())
        assert -(-segs // 32) <= groups <= segs, (k, segs, groups)
    if which == "u8":
        frames = [render_frame(scene, cam, cfg.replace(mega_body=m))
                  for m in ("xla", "pallas")]
        np.testing.assert_array_equal(*frames)
        assert frames[0].max() > 0.0
