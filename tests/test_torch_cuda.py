"""The hand-written CUDA kernels against their plain torch versions on
the card: the megakernel (B1) and its dense instantiation — on their
persistent grid too, with fewer lanes than a block, than the resident
threads and more — B1's TLAS and bf16 instantiations on tpurt's K = 12
instance grid and a bf16 Cornell sphere, cross-frame packed launches in
every instantiation, B1's deep-stack instantiation (stacks in global
memory) on presets.deep_stack_scene, the dense block sweep (B2)
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
    flat_batch_args, render_batch_flat, render_batch_flat_frames, render_frame)
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.presets import (
    cornell_sphere_scene, deep_stack_scene, grid_scene)
from tpurt_torch.scene.types import MaterialType

pytestmark = pytest.mark.cuda

CFG = RenderConfig(width=64, height=64, rays_per_pixel=2, max_bounces=3,
                   pixels_per_lane=2, mega_tail_passes=2,
                   object_path="sphere2.obj")


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

    lane, ctx = mk.prepare(scene, **flat_batch_args(scene, cam, CFG, 0))
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
    lane, ctx = mk.prepare(scene, **args)
    _trips, work = mega_cuda.launch(mega_cuda.pack(lane), ctx, None)
    assert work.shape[0] == (5 if scene.mega_tlas else 3)
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
    lane, ctx = mk.prepare(scene, **args)
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
    lane, ctx = mk.prepare(scene, **flat_batch_args(scene, cam, cfg, 0))
    lane, ctx = lane._replace(stack=lane.stack[:66]), ctx._replace(s_depth=66)
    assert mega_cuda.deep_stack(ctx)
    assert int(mk.stack_entries(mk.run_plain(lane, ctx, 34)).max()) == 66
    for trips in (34, 100, None):
        buf = mega_cuda.pack(lane)
        mega_cuda.launch(buf, ctx, trips)
        kern = mega_cuda.unpack(buf, ctx, lane.iters + (trips or 0))
        agree, _err = mega_cuda.compare_lanes(mk.run_plain(lane, ctx, trips), kern)
        assert agree == 1.0, (trips, agree)


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
    launch = mega_cuda.launch_config(dense)
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
    lane, ctx = mk.prepare(scene, **args)
    assert (ctx.dense is not None) == dense and lane.done.shape[0] == n
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
