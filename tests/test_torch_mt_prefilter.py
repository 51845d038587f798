"""Kernel B3's inputs, its division pre-test and its group reduction, on
the CPU.

* The kernel-facing layout (``mt_sweep.mt_layout``, kept per scene by
  ``scene_layout``) is a bit-exact copy of pa and of the plain version's
  edge subtractions pb - pa, pc - pa (chain scene of test_torch_cuda.py).
* The fused identity pass's ``FusedSet`` gives each listed triangle its
  owner's cull policy (``culls_backfaces``), also where two instances share
  one triangle range with different policies: the flag belongs to the
  instance, so the kernel takes it per listed row, not per triangle.
* The u pre-test (``plucker_fused.u_pretest_drops``, the torch mirror of
  csrc/sweep_common.cuh, which B3 shares with B2) never drops a pair that
  the exact Möller-Trumbore test (``intersect.mt_core``) accepts: about
  10^6 random pairs in MT's own terms (h = d x e2, det = e1 . h,
  u_num = (o - pa) . h), and adversarial ones (rays through the vertices,
  u exactly 0 and 1; |det| at EPSILON; tiny and huge coordinates; u_num
  of +0 and -0), and every pair of the chain scene's sweep. B3 applies
  the pre-test before its det test, so it is held on pairs of any det.
* A torch mirror of the kernel's group reduction (smaller t, then the
  lower row) over its split of rows among G threads equals the
  one-thread first-minimum scan (``exact_sweep``) on rows with exact
  ties.
* ``sweep``'s range and id-list forms on the CPU run the plain version,
  and agree with tpurt's ``mt_sweep_pallas`` in interpret mode.

The kernel itself is held bitwise against the plain sweep on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_cuda import chain_scene, shared_geometry_scene
from tpurt.render.pallas_kernels import mt_sweep_pallas
from tpurt.render.pallas_kernels import pad_tri_rows as t_pad
from tpurt_torch.config import EPSILON
from tpurt_torch.core import v3 as v3lib
from tpurt_torch.core.v3 import V3
from tpurt_torch.render import mt_sweep, plucker_fused
from tpurt_torch.render.intersect import _mt_single, exact_sweep, fused_set, mt_rows
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.types import MaterialType, culls_backfaces

_EPS = np.float32(EPSILON)
CSRC = os.path.join(os.path.dirname(mt_sweep.__file__), "..", "csrc")


@pytest.fixture(scope="module")
def chain():
    return chain_scene(SceneBuilder, Material, MaterialType, procedural,
                       device="cpu")


def _bits(a: torch.Tensor) -> torch.Tensor:
    return a.contiguous().view(torch.int32)


def test_layout_is_a_bit_exact_repack_of_the_rows(chain):
    lay = mt_sweep.scene_layout(chain)
    rows = chain.tri_packed
    assert lay.shape == (rows.shape[0], mt_sweep.MT_WIDTH) and lay.dtype == torch.float32
    assert lay.is_contiguous() and mt_sweep.MT_WIDTH * 4 % 16 == 0
    pa = rows[:, 0:3]
    assert torch.equal(_bits(lay[:, 0:3]), _bits(pa))
    assert torch.equal(_bits(lay[:, 3:6]), _bits(rows[:, 3:6] - pa))
    assert torch.equal(_bits(lay[:, 6:9]), _bits(rows[:, 6:9] - pa))
    assert not bool(_bits(lay[:, 9:]).any())
    # Made once per scene; a scene moved with ``to`` starts a new cache.
    assert mt_sweep.scene_layout(chain) is lay
    assert "tri_mt" not in chain.to("cpu").cache


def test_fused_set_flags_follow_each_owner(chain):
    fs = fused_set(chain, 4096)
    fused = [i for i, (_f, n) in enumerate(chain.mesh_tri_ranges)
             if chain.mesh_identity[i] and n <= 4096
             and chain.mesh_mat_types[i] != int(MaterialType.ONE_SIDED)]
    want_ids = np.concatenate([np.arange(f, f + n) for f, n in
                               (chain.mesh_tri_ranges[i] for i in fused)])
    np.testing.assert_array_equal(fs.ids.numpy(), want_ids)
    assert fs.ids.dtype == torch.int32 and fs.cull.dtype == torch.float32
    for i in fused:
        first, n = chain.mesh_tri_ranges[i]
        rows = (fs.ids >= first) & (fs.ids < first + n)
        assert bool((fs.owner[rows] == i).all())
        assert bool((fs.cull[rows] == float(culls_backfaces(chain.mesh_mat_types[i]))).all())
    # Each position's first listing of its id (distinct ids: itself).
    assert torch.equal(fs.first, torch.arange(fs.ids.shape[0]))
    # Kept per scene and threshold; none when no mesh is fused.
    assert fused_set(chain, 4096) is fs
    assert fused_set(chain, 0) is None


def test_shared_geometry_gives_one_triangle_two_flags():
    scene, _cam = shared_geometry_scene("cpu")
    fs = fused_set(scene, 4096)
    (first, n), = {scene.mesh_tri_ranges[0], scene.mesh_tri_ranges[1]}
    solid = fs.owner == 0
    glassy = fs.owner == 1
    assert torch.equal(fs.ids[solid], fs.ids[glassy])
    assert bool(fs.cull[solid].all()) and not bool(fs.cull[glassy].any())
    assert int(solid.sum()) == n and bool((fs.ids[solid] == first + torch.arange(n)).all())
    # A win on either copy maps to the first listing, as tpurt's id map does.
    assert torch.equal(fs.first[glassy], torch.nonzero(solid)[:, 0])
    assert torch.equal(fs.first[solid], torch.nonzero(solid)[:, 0])


def _mt_terms(o, d, pa, pb, pc):
    """det and u_num as the kernel computes them, on paired (N, 3) f32
    arrays, and mt_core's acceptance of the pair (no cull)."""
    t = lambda a: V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))
    o, d, pa, pb, pc = (t(np.asarray(a, np.float32)) for a in (o, d, pa, pb, pc))
    e1, e2 = pb - pa, pc - pa
    h = v3lib.cross(d, e2)
    det = v3lib.dot(e1, h)
    u_num = v3lib.dot(o - pa, h)
    ok, _t, _n, _b = _mt_single(o, d, pa, pb, pc, pa, pa, pa, False)
    u = (1.0 / det) * u_num
    u_ok = (det.abs() >= float(_EPS)) & (u >= 0.0) & (u <= 1.0)
    return det, u_num, ok, u_ok


def assert_never_drops_an_accepted_pair(o, d, pa, pb, pc):
    det, u_num, ok, u_ok = _mt_terms(o, d, pa, pb, pc)
    drops = plucker_fused.u_pretest_drops(det, u_num)
    for name, accepted in (("mt_core", ok), ("u test", u_ok)):
        bad = drops & accepted
        assert not bool(bad.any()), (name, det[bad][:5], u_num[bad][:5])
    return drops, u_ok


def _random_pairs(n, seed, scale=10.0):
    r = np.random.default_rng(seed)
    pa, pb, pc = (r.normal(size=(n, 3)) * scale for _ in range(3))
    # Aim at the triangle's plane at barycentrics around [0, 1].
    w = r.uniform(-0.6, 1.6, (n, 3))
    w[:, 0] = 1.0 - w[:, 1] - w[:, 2]
    target = pa * w[:, :1] + pb * w[:, 1:2] + pc * w[:, 2:3]
    o = target + r.normal(size=(n, 3)) * scale * 3.0
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, pa, pb, pc


def test_u_pretest_never_drops_an_accepted_random_mt_pair():
    drops, u_ok = assert_never_drops_an_accepted_pair(*_random_pairs(1 << 20, 0))
    rejected = ~u_ok
    assert 0.3 < float(rejected.float().mean()) < 0.9
    # It drops nearly every pair the exact u test rejects: the division
    # it saves is real.
    assert float((drops & rejected).sum()) >= 0.999 * float(rejected.sum())


def _ulps(x: np.ndarray, k: int) -> np.ndarray:
    """x moved k ulps (float32) away from zero (k < 0: towards it)."""
    out = np.asarray(x, np.float32)
    target = np.where(out >= 0, np.float32(np.inf), np.float32(-np.inf)) if k > 0 else np.float32(0.0)
    for _ in range(abs(k)):
        out = np.nextafter(out, target).astype(np.float32)
    return out


@pytest.mark.parametrize("family", [
    "vertex_and_edge_rays", "det_at_epsilon", "tiny_and_huge", "signed_zero_u_num",
])
def test_u_pretest_never_drops_an_accepted_adversarial_mt_pair(family):
    r = np.random.default_rng(11)
    n = 4096
    o, d, pa, pb, pc = _random_pairs(n, 12)
    if family == "vertex_and_edge_rays":
        # Rays through pa (u = v = 0), pb (u = 1), pc, and points of the
        # edges (u or v exactly 0 or 1 in exact arithmetic), each moved
        # by a few ulps.
        pts = []
        for k in range(-2, 3):
            for target in (pa, pb, pc, (pa + pb) / 2, (pb + pc) / 2, (pa + pc) / 2):
                pts.append(_ulps(target.astype(np.float32), k))
        target = np.concatenate(pts)
        rep = len(pts)
        o = np.tile(o, (rep, 1))
        pa, pb, pc = (np.tile(a, (rep, 1)) for a in (pa, pb, pc))
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif family == "det_at_epsilon":
        # e1 = (a, 0, 0), e2 = (0, b, 0), d = (0, 0, 1): det = -a b, about
        # EPSILON, a stepped by ulps; origins above the triangle.
        a = (np.float32(1e-3) * r.uniform(0.9, 1.1, n)).astype(np.float32)
        b = (np.float32(EPSILON) / a).astype(np.float32)
        b = np.concatenate([_ulps(b, k) for k in range(-3, 4)])
        a = np.tile(a, 7)
        m = len(a)
        pa = np.zeros((m, 3))
        pb = np.stack([a, np.zeros(m), np.zeros(m)], 1)
        pc = np.stack([np.zeros(m), b, np.zeros(m)], 1)
        o = np.stack([r.uniform(-0.5, 1.5, m) * a, r.uniform(-0.5, 1.5, m) * b,
                      -np.ones(m)], 1)
        tilt = r.normal(size=(m, 3)) * np.where(r.random((m, 1)) < 0.5, 0.0, 1e-3)
        d = np.array([0.0, 0.0, 1.0]) + tilt
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif family == "tiny_and_huge":
        scales = np.repeat(10.0 ** np.array([-6, -3, 3, 6, 12, 18]), n // 6 + 1)[:n]
        s = scales[:, None]
        o, pa, pb, pc = o * s, pa * s, pb * s, pc * s
    else:  # signed_zero_u_num: o = pa makes s = 0, so u_num = +0 or -0
        o = pa.astype(np.float32)
    det, u_num, _ok, _u_ok = _mt_terms(o, d, pa, pb, pc)
    if family == "det_at_epsilon":
        assert bool((det.abs() < float(_EPS)).any()) and bool((det.abs() >= float(_EPS)).any())
    if family == "signed_zero_u_num":
        zero = u_num == 0.0
        neg = torch.signbit(u_num) & zero
        assert bool(zero.all()) and bool(neg.any()) and bool((zero & ~neg).any())
    _drops, u_ok = assert_never_drops_an_accepted_pair(o, d, pa, pb, pc)
    assert bool(u_ok.any())


def test_u_pretest_on_the_chain_scene_sweep(chain):
    """Rays aimed at the chain scene's triangles against every row."""
    rows = chain.tri_packed.numpy()
    r = np.random.default_rng(3)
    tri = rows[r.integers(0, len(rows), 256)]
    w = r.dirichlet((1, 1, 1), 256).astype(np.float32)
    target = tri[:, 0:3] * w[:, :1] + tri[:, 3:6] * w[:, 1:2] + tri[:, 6:9] * w[:, 2:3]
    o = (target + r.normal(size=(256, 3)) * 60.0).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    m = len(rows)
    tile = lambda a: np.repeat(a, m, axis=0)
    every = lambda col: np.tile(rows[:, col:col + 3], (256, 1))
    drops, u_ok = assert_never_drops_an_accepted_pair(tile(o), tile(d), every(0),
                                                      every(3), every(6))
    assert bool(u_ok.any())
    assert float((drops & ~u_ok).sum()) >= 0.999 * float((~u_ok).sum())


def group_reduce(t: torch.Tensor, k: torch.Tensor):
    """The kernel's reduction over a thread group: per ray (leading axis),
    over the group's (t, position) candidates (last axis, +inf / -1 where
    a thread found none), the smaller t, then the lower position."""
    t_min = t.min(dim=-1, keepdim=True).values
    k_min = torch.where((t == t_min) & (k >= 0), k, torch.iinfo(k.dtype).max)
    k_min = k_min.min(dim=-1).values
    t_min = t_min[..., 0]
    return t_min, torch.where(t_min < float("inf"), k_min, -1)


def _kernel_constants():
    src = open(os.path.join(CSRC, "mt_sweep.cu")).read()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    return {k: get(k) for k in ("kThreads", "kRays", "kMaxGroup", "kChunk", "kWaves")}


def test_kernel_constants_fit_its_split():
    """Thread g of a group takes positions g, g + G, ... of each stage;
    kChunk a multiple of every G makes that every G-th position of the
    whole sweep, which the reduction test below emulates."""
    c = _kernel_constants()
    g = c["kMaxGroup"]
    assert g & (g - 1) == 0 and 32 % g == 0 and c["kChunk"] % g == 0
    assert c["kThreads"] % 32 == 0 and c["kRays"] >= 1 and c["kWaves"] >= 1


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_group_reduction_equals_the_one_thread_scan(groups):
    """Rows with duplicates (exact ties in t), split among ``groups``
    threads as the kernel splits them; each thread's strict-< scan, then
    the reduction, gives exact_sweep's winner and t bit for bit."""
    pos, nrm = procedural.icosphere(2, radius=50.0)
    base = np.concatenate([pos.reshape(-1, 9), nrm.reshape(-1, 9)], 1).astype(np.float32)
    r = np.random.default_rng(groups)
    rows = torch.from_numpy(base[r.integers(0, len(base), 1000)])
    cull = torch.from_numpy(r.random(1000) < 0.5)
    o = torch.from_numpy(r.uniform(-120, 120, (600, 3)).astype(np.float32))
    d = torch.from_numpy(r.uniform(-40, 40, (600, 3)).astype(np.float32)) - o
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    ro, rd = v3lib.from_rows(o), v3lib.from_rows(d)
    want_t, want_k = exact_sweep(ro, rd, rows, cull)
    assert bool((want_k >= 0).any())
    ok, t, _n, _b = mt_rows(V3(*(c[:, None] for c in ro)), V3(*(c[:, None] for c in rd)),
                            rows[None], cull[None])
    t = torch.where(ok, t, float("inf"))  # (rays, rows)
    cand_t, cand_k = [], []
    for g in range(groups):
        cols = torch.arange(g, rows.shape[0], groups)
        j = torch.argmin(t[:, cols], dim=1)  # the thread's first minimum
        tg = torch.gather(t[:, cols], 1, j[:, None])[:, 0]
        cand_t.append(tg)
        cand_k.append(torch.where(tg < float("inf"), cols[j], -1))
    got_t, got_k = group_reduce(torch.stack(cand_t, 1), torch.stack(cand_k, 1))
    assert torch.equal(_bits(got_t), _bits(want_t))
    assert torch.equal(got_k, want_k)
    # Ties cross threads: some ray's winner has a duplicate later in
    # another thread's share.
    if groups > 1:
        same = (rows[None, :, :9] == rows[want_k.clamp_min(0), None, :9]).all(-1)
        pos = torch.arange(rows.shape[0])[None]
        other = same & (pos > want_k[:, None]) & ((pos - want_k[:, None]) % groups != 0)
        assert bool((other & (t == want_t[:, None])).any())


def _sphere_case():
    pos, nrm = procedural.icosphere(1, radius=50.0)
    rows = np.concatenate([pos.reshape(-1, 9), nrm.reshape(-1, 9)], 1).astype(np.float32)
    r = np.random.default_rng(7)
    o = r.uniform(-120, 120, (64, 3)).astype(np.float32)
    d = r.uniform(-80, 80, (64, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return rows, o, d


@pytest.mark.parametrize("form", ["range", "ids"])
def test_sweep_forms_on_the_cpu_match_tpurt_interpret(form):
    """``sweep`` on CPU tensors runs the plain version (no launch), by
    range or through an id list with per-row flags, and agrees with
    tpurt's Pallas sweep in interpret mode on the same rows: rows equal,
    t within rtol 1e-4 (test_torch_modular.py's bound)."""
    rows, o, d = _sphere_case()
    table = torch.from_numpy(np.concatenate([rows[::-1], rows]).copy())
    r = np.random.default_rng(5)
    if form == "range":
        first, count, ids = len(rows), len(rows), None
        flags, cull = None, True
        picked = rows
        picked_cull = np.ones(count, bool)
    else:
        idx = r.integers(0, table.shape[0], 50)
        first, count = 0, len(idx)
        ids = torch.from_numpy(idx.astype(np.int32))
        picked_cull = r.random(count) < 0.5
        flags, cull = torch.from_numpy(picked_cull.astype(np.float32)), False
        picked = table.numpy()[idx]
    lay = mt_sweep.mt_layout(table)
    before = mt_sweep.LAUNCHES
    t, k = mt_sweep.sweep(torch.from_numpy(o), torch.from_numpy(d), lay, table, count,
                          first=first, ids=ids, cull_flags=flags, cull=cull)
    assert mt_sweep.LAUNCHES == before and k.dtype == torch.int32
    t_rows, t_flags = t_pad(picked, picked_cull)
    t_t, t_i = mt_sweep_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_rows),
                               jnp.asarray(t_flags), count, interpret=True)
    np.testing.assert_array_equal(k.numpy(), np.asarray(t_i))
    hit = k.numpy() >= 0
    assert 0 < hit.sum() < len(hit)
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(t_t)[hit], rtol=1e-4)
    # And exactly the public entry's result on the same rows, padded.
    p_rows, p_flags = mt_sweep.pad_tri_rows(torch.from_numpy(picked),
                                            torch.from_numpy(picked_cull))
    t1, k1 = mt_sweep.mt_sweep(torch.from_numpy(o), torch.from_numpy(d), p_rows,
                               p_flags, count)
    assert torch.equal(_bits(t), _bits(t1)) and torch.equal(k, k1)
