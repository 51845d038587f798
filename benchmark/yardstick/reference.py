"""The plain reference: the reference renderer's algorithm (Trace.cl) in
plain torch, brute force over every triangle, one lane a pixel.

It is a vectorised transcription of the repository's scalar oracle
(``tests/oracle.py``, frozen as it stood when the benchmark was
written): the same exact 32-bit RNG stream (Trace.cl:158-217), Möller-
Trumbore with smooth normals and the backface policy (276-317), the
scene loop over meshes in their local frames with the first minimum
winning (434-485), the bounce loop with the five materials and Russian
roulette (487-594), MakeRay and the entry kernel's sample loop and
tonemap (596-653). It imports nothing of the program and takes nothing
the program made: it gets the configuration's triangles, box, materials
and camera from ``scene.py`` and traces them again.

Lanes are pixels of any frame and any camera; all lanes advance one
segment a step, a lane whose sample ends starts its next sample in the
same step, and only live lanes are worked on. Floats are ``dtype``:
float32 as the configuration states, or a lower precision for the
control. Division is IEEE division of two tensors; square roots are
taken in float64 and rounded once, so a CPU and a card give the same
bits; a vector is normalised as ``v * (1 / sqrt(v . v))``, Trace.cl's
form (the scalar oracle divides instead, which moves a few knife-edge
paths by an ulp). Dot products add left to right.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from yardstick.scene import (CHECKER, GLASSY, INVISIBLE, ONE_SIDED, SOLID,
                             Pose, SceneSpec, euler)

M32 = 0xFFFFFFFF
EPS = 1e-6
TAU = float(np.float32(6.283185307179586))
INV_2_32 = 1.0 / 4294967296.0
GAMMA = float(np.float32(1.0 / 2.2))
#: Pair tests held at once by the brute force (rays x triangles).
PAIRS = 1 << 25

V3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# -- arithmetic ---------------------------------------------------------------


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


def dot(a: V3, b: V3) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: V3, b: V3) -> V3:
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def add(a: V3, b: V3) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a: V3, b: V3) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(a: V3, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def div(a: V3, s: torch.Tensor) -> V3:
    return (a[0] / s, a[1] / s, a[2] / s)


def normalize(a: V3) -> V3:
    return scale(a, torch.reciprocal(_sqrt(dot(a, a))))


def where(m: torch.Tensor, a: V3, b: V3) -> V3:
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def take(a: V3, idx) -> V3:
    return tuple(x[idx] for x in a)


def rot_fwd(r, v: V3) -> V3:
    """out_i = sum_j r[i][j] v_j; ``r`` a (3, 3) host array or 9 tensors."""
    return tuple(r[i][0] * v[0] + r[i][1] * v[1] + r[i][2] * v[2]
                 for i in range(3))


def rot_t(r, v: V3) -> V3:
    """out_i = sum_j r[j][i] v_j."""
    return tuple(r[0][i] * v[0] + r[1][i] * v[1] + r[2][i] * v[2]
                 for i in range(3))


def reflect(d: V3, n: V3) -> V3:
    return sub(d, scale(n, 2.0 * dot(d, n)))


def refract(d: V3, n: V3, ior_a, ior_b) -> V3:
    ratio = ior_a / ior_b
    cos_in = -dot(d, n)
    sin_sqr = ratio * ratio * (1.0 - cos_in * cos_in)
    k = ratio * cos_in - _sqrt(torch.clamp_min(1.0 - sin_sqr, 0.0))
    out = add(scale(d, ratio), scale(n, k))
    tir = sin_sqr > 1.0
    return tuple(torch.where(tir, torch.zeros_like(c), c) for c in out)


def reflectance(d: V3, n: V3, ior_a, ior_b) -> torch.Tensor:
    ratio = ior_a / ior_b
    cos_in = -dot(d, n)
    sin_sqr = ratio * ratio * (1.0 - cos_in * cos_in)
    cos_out = _sqrt(torch.clamp_min(1.0 - sin_sqr, 0.0))
    denom = ior_a * cos_in + ior_b * cos_out
    r_perp = (ior_a * cos_in - ior_b * cos_out) / denom
    r_par = (ior_b * cos_in - ior_a * cos_out) / denom
    two = torch.full_like(denom, 2.0)
    r = (r_perp * r_perp + r_par * r_par) / two
    one = (cos_in <= 0) | (sin_sqr >= 1.0) | (denom < EPS)
    return torch.where(one, torch.ones_like(r), r)


# -- the RNG (exact integer arithmetic on int64 holding u32) ------------------


def _map(s: torch.Tensor, dtype) -> torch.Tensor:
    return (((s + 1) & M32).to(torch.float32) * INV_2_32).to(dtype)


def _mul(a, c: int):
    """(a * c) mod 2^32 for u32 values held in int64, with no product
    above 2^48 (so no int64 product overflows on any device)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _lcg(state):
    return (_mul(state, 747796405) + 2891336453) & M32


def random_value(state, dtype):
    state = _lcg(state)
    shift = ((state >> 28) + 4) & 31
    r = _mul((state >> shift) ^ state, 277803737)
    r = ((r >> 22) ^ r) & M32
    return state, _map(r, dtype)


def rand01(state, dtype):
    state = _lcg(state)
    z = state
    z = _mul(z ^ (z >> 16), 0x7FEB352D)
    z = _mul(z ^ (z >> 15), 0x846CA68B)
    z = (z ^ (z >> 16)) & M32
    return state, _map(z, dtype)


def make_seed(pix, frame, ray_idx: int = 0):
    s = (_mul(pix & M32, 1664525) + _mul(frame & M32, 1013904223)) & M32
    s = s ^ ((ray_idx + 0x9E3779B9) & M32)
    return (_mul(s, 22695477) + 1) & M32


def random_normal(state, dtype):
    state, u1 = random_value(state, dtype)
    state, u2 = random_value(state, dtype)
    u1 = torch.clamp_min(u1, EPS)
    r = _sqrt(-2.0 * torch.log(u1))
    return state, r * torch.cos(TAU * u2)


def random_direction(state, dtype):
    state, x = random_normal(state, dtype)
    state, y = random_normal(state, dtype)
    state, z = random_normal(state, dtype)
    inv = torch.reciprocal(_sqrt(x * x + y * y + z * z))
    v = (x * inv, y * inv, z * inv)
    bad = ~(torch.isfinite(v[0]) & torch.isfinite(v[1]) & torch.isfinite(v[2]))
    return state, (torch.where(bad, 0.0, v[0]), torch.where(bad, 1.0, v[1]),
                   torch.where(bad, 0.0, v[2]))


# -- the scene ----------------------------------------------------------------


@dataclass
class _Group:
    """Meshes that share one local ray: a run of meshes with the identity
    transform, or one transformed mesh. Triangle columns are in mesh
    order; ``tri_mesh`` is each column's index within the group."""

    meshes: List[int]
    rot: np.ndarray
    pos: np.ndarray
    scale: float
    pa: V3
    e1: V3
    e2: V3
    na: V3
    nb: V3
    nc: V3
    cull: torch.Tensor
    tri_mesh: torch.Tensor


def _identity(m) -> bool:
    return (tuple(m.offset) == (0.0, 0.0, 0.0) and m.pitch == 0.0
            and m.yaw == 0.0 and m.roll == 0.0 and m.scale == 1.0)


class RefScene:
    """The scene's triangles, transforms and materials on ``device``."""

    def __init__(self, spec: SceneSpec, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        meshes = spec.meshes
        runs: List[List[int]] = []
        for i, m in enumerate(meshes):
            if m.scale <= EPS:
                continue
            if _identity(m) and runs and _identity(meshes[runs[-1][-1]]):
                runs[-1].append(i)
            else:
                runs.append([i])
        self.groups = [self._group(meshes, run) for run in runs]
        mats = [m.material for m in meshes]
        t = lambda rows: torch.tensor(np.asarray(rows, np.float32),
                                      device=self.device).to(dtype)
        self.mat_type = torch.tensor([m.type for m in mats], device=self.device)
        self.mat_color = t([m.color for m in mats])
        self.mat_em = t([m.emission_color for m in mats])
        self.mat_ems = t([m.emission_strength for m in mats])
        self.mat_refl = t([m.reflectiveness for m in mats])
        self.mat_spec = t([m.specular_probability for m in mats])
        self.mat_ior = t([m.ior for m in mats])

    def _group(self, meshes, run) -> _Group:
        m0 = meshes[run[0]]
        pos = np.concatenate([meshes[i].pos for i in run]).astype(np.float32)
        nrm = np.concatenate([meshes[i].nrm for i in run]).astype(np.float32)
        owner = np.concatenate([np.full(len(meshes[i].pos), k)
                                for k, i in enumerate(run)])
        cull = np.concatenate([
            np.full(len(meshes[i].pos),
                    meshes[i].material.type not in (GLASSY, INVISIBLE,
                                                    ONE_SIDED))
            for i in run])
        d = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, c]))
                            .to(self.device).to(self.dtype) for c in range(3))
        pa, pb, pc = pos[:, 0], pos[:, 1], pos[:, 2]
        return _Group(
            meshes=list(run),
            rot=euler(m0.pitch, m0.yaw, m0.roll), pos=np.asarray(m0.offset,
                                                                np.float32),
            scale=float(np.float32(m0.scale)),
            pa=d(pa), e1=d(pb - pa), e2=d(pc - pa),
            na=d(nrm[:, 0]), nb=d(nrm[:, 1]), nc=d(nrm[:, 2]),
            cull=torch.from_numpy(cull).to(self.device),
            tri_mesh=torch.from_numpy(owner).to(self.device),
        )

    # -- intersection ---------------------------------------------------------

    def _local_ray(self, g: _Group, ro: V3, rd: V3):
        dt = self.dtype
        pos = [float(x) for x in g.pos]
        rot = [[float(x) for x in row] for row in g.rot]
        lo = rot_t(rot, (ro[0] - pos[0], ro[1] - pos[1], ro[2] - pos[2]))
        ld = rot_t(rot, rd)
        if abs(g.scale) > EPS:
            s = torch.tensor(g.scale, dtype=dt, device=self.device)
            lo, ld = div(lo, s), div(ld, s)
        return lo, normalize(ld)

    @staticmethod
    def _mt(lo: V3, ld: V3, pa: V3, e1: V3, e2: V3):
        """Möller-Trumbore, broadcasting rays against triangles:
        (ok, t, u, v) before the backface policy."""
        h = cross(ld, e2)
        det = dot(e1, h)
        ok = torch.abs(det) >= EPS
        f = torch.reciprocal(det)
        s = sub(lo, pa)
        u = f * dot(s, h)
        del h
        ok &= (u >= 0.0) & (u <= 1.0)
        q = cross(s, e1)
        del s
        v = f * dot(ld, q)
        ok &= (v >= 0.0) & (u + v <= 1.0)
        t = f * dot(e2, q)
        ok &= t > EPS
        return ok, t, u, v

    @staticmethod
    def _tris(g: _Group, cols, dim=None):
        """Triangle columns ``cols`` as (pa, e1, e2), with a leading axis
        of 1 where ``dim`` is 0."""
        out = [take(v, cols) for v in (g.pa, g.e1, g.e2)]
        if dim is not None:
            out = [tuple(x.unsqueeze(dim) for x in v) for v in out]
        return out

    def _normal(self, g: _Group, col, u, v, ld: V3):
        """The smooth normal at (u, v) of each triangle ``col``, normalised,
        flipped to the ray's side, and whether the ray hit its back."""
        w = 1.0 - u - v
        na, nb, nc = (take(x, col) for x in (g.na, g.nb, g.nc))
        n = normalize(tuple(na[k] * w + nb[k] * u + nc[k] * v
                            for k in range(3)))
        back = dot(ld, n) > EPS
        return tuple(torch.where(back, -c, c) for c in n), back

    def _closest(self, g: _Group, lo: V3, ld: V3):
        """Per ray and group mesh, the first minimum among the triangles
        that pass the test and the backface policy: (t (R, Mg), col (R, Mg),
        -1 where none)."""
        r = lo[0].shape[0]
        mg = len(g.meshes)
        n_tri = g.pa[0].shape[0]
        dev = self.device
        best_t = torch.full((r * mg,), math.inf, dtype=self.dtype, device=dev)
        best_c = torch.full((r * mg,), -1, dtype=torch.int64, device=dev)
        big = torch.iinfo(torch.int64).max
        chunk = max(1, PAIRS // max(r, 1))
        lo1 = tuple(x.unsqueeze(1) for x in lo)
        ld1 = tuple(x.unsqueeze(1) for x in ld)
        for c0 in range(0, n_tri, chunk):
            cols = torch.arange(c0, min(n_tri, c0 + chunk), device=dev)
            ok, t, u, v = self._mt(lo1, ld1, *self._tris(g, cols, 0))
            ri, ci = ok.nonzero(as_tuple=True)
            del ok
            if ri.numel() == 0:
                continue
            tt, uu, vv = t[ri, ci], u[ri, ci], v[ri, ci]
            del t, u, v
            col = cols[ci]
            _, back = self._normal(g, col, uu, vv, take(ld, ri))
            keep = ~(g.cull[col] & back)
            ri, col, tt = ri[keep], col[keep], tt[keep]
            key = ri * mg + g.tri_mesh[col]
            tmin = torch.full_like(best_t, math.inf).scatter_reduce(
                0, key, tt, "amin")
            at = tt == tmin[key]
            cmin = torch.full_like(best_c, big).scatter_reduce(
                0, key[at], col[at], "amin")
            better = tmin < best_t
            best_t = torch.where(better, tmin, best_t)
            best_c = torch.where(better, cmin, best_c)
        return best_t.view(r, mg), best_c.view(r, mg)

    def intersect(self, ro: V3, rd: V3):
        """The scene loop: (valid, point, normal, backface, mesh) of each
        ray's closest hit in world space."""
        r = ro[0].shape[0]
        dev, dt = self.device, self.dtype
        best_d = torch.full((r,), math.inf, dtype=dt, device=dev)
        zeros = torch.zeros(r, dtype=dt, device=dev)
        best_p = best_n = (zeros, zeros, zeros)
        best_b = torch.zeros(r, dtype=torch.bool, device=dev)
        best_m = torch.full((r,), -1, dtype=torch.int64, device=dev)
        for g in self.groups:
            lo, ld = self._local_ray(g, ro, rd)
            t, col = self._closest(g, lo, ld)
            mg = len(g.meshes)
            lo_m = tuple(x.unsqueeze(1).expand(r, mg) for x in lo)
            ld_m = tuple(x.unsqueeze(1).expand(r, mg) for x in ld)
            found = col >= 0
            c = torch.clamp_min(col, 0)
            # The winner's u, v and normal again, by the same operations.
            _, _, uw, vw = self._mt(lo_m, ld_m, *self._tris(g, c))
            n_l, back = self._normal(g, c, uw, vw, ld_m)
            onesided = torch.tensor(
                [self._mat(m) == ONE_SIDED for m in g.meshes], device=dev)
            found &= ~(onesided.unsqueeze(0) & back)
            tt = torch.where(found, t, torch.zeros_like(t))
            p_l = add(lo_m, scale(ld_m, tt))
            rot = [[float(x) for x in row] for row in g.rot]
            pos = [float(x) for x in g.pos]
            p_w = rot_fwd(rot, scale(p_l, g.scale))
            p_w = (p_w[0] + pos[0], p_w[1] + pos[1], p_w[2] + pos[2])
            n_w = normalize(rot_fwd(rot, n_l))
            ro_m = tuple(x.unsqueeze(1) for x in ro)
            dd = sub(p_w, ro_m)
            dst = torch.where(found, _sqrt(dot(dd, dd)),
                              torch.full_like(tt, math.inf))
            k = torch.argmin(dst, dim=1)
            gather = lambda a: a.gather(1, k.unsqueeze(1)).squeeze(1)
            dk = gather(dst)
            better = dk < best_d
            best_d = torch.where(better, dk, best_d)
            best_p = where(better, tuple(gather(x) for x in p_w), best_p)
            best_n = where(better, tuple(gather(x) for x in n_w), best_n)
            best_b = torch.where(better, gather(back), best_b)
            mesh_ids = torch.tensor(g.meshes, device=dev)
            best_m = torch.where(better, mesh_ids[k], best_m)
        return best_m >= 0, best_p, best_n, best_b, torch.clamp_min(best_m, 0)

    def _mat(self, mesh: int) -> int:
        return int(self.mat_type[mesh])


# -- the renderer ---------------------------------------------------------------


def primary_rays(poses: List[Pose], pose_of, pix, width: int, height: int,
                 device, dtype) -> Tuple[V3, V3]:
    """MakeRay (Trace.cl:596-621) for each lane's pixel under its pose."""
    cams = [p.scalars() for p in poses]
    tab = lambda f: torch.tensor(np.asarray([f(c) for c in cams], np.float32),
                                 device=device).to(dtype)[pose_of]
    cpos = tab(lambda c: c[0])
    rot = tab(lambda c: c[1].reshape(9))
    tan = tab(lambda c: c[2])
    aspect = tab(lambda c: c[3])
    w = torch.tensor(float(width), dtype=dtype, device=device)
    h = torch.tensor(float(height), dtype=dtype, device=device)
    x = (pix % width).to(dtype)
    y = (pix // width).to(dtype)
    u = x / w
    v = 1.0 - y / h
    ndc_x = (u * 2.0 - 1.0) * aspect
    ndc_y = v * 2.0 - 1.0
    d = normalize((ndc_x * tan, ndc_y * tan, torch.ones_like(ndc_x)))
    e = [[rot[:, 3 * i + j] for j in range(3)] for i in range(3)]
    d = normalize(rot_t(e, d))  # the camera applies makeRotation transposed
    return (cpos[:, 0], cpos[:, 1], cpos[:, 2]), d


def render(scene: RefScene, poses: List[Pose], pose_of, pix, frame,
           width: int, height: int, spp: int, max_bounces: int):
    """Trace each lane's pixel: ``pix`` (N,) pixel indices, ``frame`` (N,)
    frame indices, ``pose_of`` (N,) indices into ``poses``. Returns
    (uint8 (N, 3) display pixels, segments (N,) int64, mean radiance
    (N, 3)), each on the scene's device."""
    dev, dt = scene.device, scene.dtype
    pix = torch.as_tensor(pix, dtype=torch.int64, device=dev)
    frame = torch.as_tensor(frame, dtype=torch.int64, device=dev)
    pose_of = torch.as_tensor(pose_of, dtype=torch.int64, device=dev)
    n = pix.shape[0]
    ro0, rd0 = primary_rays(poses, pose_of, pix, width, height, dev, dt)
    z = torch.zeros(n, dtype=dt, device=dev)
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    st = {
        "ro": ro0, "rd": rd0, "rng": make_seed(pix, frame),
        "light": (z, z, z), "thr": (z + 1, z + 1, z + 1), "acc": (z, z, z),
        "sample": zi, "bounce": zi, "guard": zi, "segs": zi,
    }
    # Lanes are updated in place: every field gets storage of its own.
    st = {k: (tuple(x.clone() for x in v) if isinstance(v, tuple)
              else v.clone()) for k, v in st.items()}
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    if max_bounces <= 0 or spp <= 0:
        done[:] = True
    while True:
        act = (~done).nonzero(as_tuple=True)[0]
        if act.numel() == 0:
            break
        sub_st = {k: (tuple(x[act] for x in v) if isinstance(v, tuple)
                      else v[act]) for k, v in st.items()}
        sub_st, fin = _step(scene, sub_st, take(ro0, act), take(rd0, act),
                            spp, max_bounces)
        for k, v in sub_st.items():
            if isinstance(v, tuple):
                for full, part in zip(st[k], v):
                    full[act] = part
            else:
                st[k][act] = v
        done[act] = fin
    mean = div(st["acc"], torch.tensor(float(spp), dtype=dt, device=dev))
    rgb = torch.stack(mean, dim=-1)
    c = torch.pow(torch.clamp(rgb, 0.0, 1.0), GAMMA)
    return (c * 255.0).to(torch.uint8), st["segs"], rgb


def _step(scene: RefScene, s: dict, ro0: V3, rd0: V3, spp: int,
          max_bounces: int):
    """One segment of every lane given (the body of Trace.cl's bounce
    loop), then the end of each lane's sample where its path ended."""
    dt = scene.dtype
    ro, rd, state = s["ro"], s["rd"], s["rng"]
    thr, light = s["thr"], s["light"]
    bounce, guard = s["bounce"], s["guard"] + 1
    segs = s["segs"] + 1
    valid, point, normal, back, mesh = scene.intersect(ro, rd)
    mt = scene.mat_type[mesh]
    invisible = valid & (mt == INVISIBLE)
    shade = valid & ~invisible
    color = tuple(scene.mat_color[mesh, k] for k in range(3))
    em = tuple(scene.mat_em[mesh, k] for k in range(3))
    ems = scene.mat_ems[mesh]

    checker = shade & (mt == CHECKER)
    if bool(checker.any()):
        cell = ems
        xi = torch.floor(point[0] / cell).to(torch.int64)
        zi = torch.floor(point[2] / cell).to(torch.int64)
        odd = ((xi + zi) & 1) == 1
        color = where(checker & odd, em, color)
        ems = torch.where(checker, torch.zeros_like(ems), ems)

    diffuse_like = shade & ((mt == SOLID) | (mt == CHECKER))
    new_state, rv = random_value(state, dt)
    state = torch.where(diffuse_like, new_state, state)
    is_spec = scene.mat_spec[mesh] >= rv
    new_state, rdir = random_direction(state, dt)
    state = torch.where(diffuse_like, new_state, state)
    diffuse = normalize(add(normal, rdir))
    specular = reflect(rd, normal)
    tl = scene.mat_refl[mesh] * is_spec.to(dt)
    scattered = normalize(add(scale(diffuse, 1.0 - tl), scale(specular, tl)))
    rd_new = where(diffuse_like, scattered, rd)

    glassy = shade & (mt == GLASSY)
    if bool(glassy.any()):
        ior = scene.mat_ior[mesh]
        one = torch.ones_like(ior)
        ior_cur = torch.where(back, ior, one)
        ior_next = torch.where(back, one, ior)
        refl_dir = reflect(rd, normal)
        refr_dir = refract(rd, normal, ior_cur, ior_next)
        rw = reflectance(rd, normal, ior_cur, ior_next)
        new_state, r01 = rand01(state, dt)
        state = torch.where(glassy, new_state, state)
        will = r01 < rw
        rd_new = where(glassy, where(will, refl_dir, refr_dir), rd_new)
        wgt = torch.where(will, rw, 1.0 - rw)
        thr = where(glassy, scale(thr, wgt), thr)

    emitted = scale(em, ems)
    light = where(shade, add(light, tuple(a * b for a, b in zip(thr, emitted))),
                  light)
    ro = where(valid, add(point, scale(rd_new, EPS)), ro)
    thr = where(shade, tuple(a * b for a, b in zip(thr, color)), thr)
    p = torch.maximum(torch.maximum(thr[0], thr[1]), thr[2])
    rr = shade & (bounce > 3)
    q = torch.clamp_min(1.0 - p, 0.05)
    new_state, r01 = rand01(state, dt)
    state = torch.where(rr, new_state, state)
    die = rr & (r01 < q)
    keep = rr & ~die
    thr = where(keep, div(thr, 1.0 - q), thr)
    bounce = torch.where(shade & ~die, bounce + 1, bounce)
    end = (~valid) | die | (shade & (bounce >= max_bounces)) | (
        guard > max_bounces + 10000)

    acc = where(end, add(s["acc"], light), s["acc"])
    sample = torch.where(end, s["sample"] + 1, s["sample"])
    z = torch.zeros_like(p)
    out = {
        "ro": where(end, ro0, ro), "rd": where(end, rd0, rd_new),
        "rng": state, "light": where(end, (z, z, z), light),
        "thr": where(end, (z + 1, z + 1, z + 1), thr), "acc": acc,
        "sample": sample, "bounce": torch.where(end, 0, bounce),
        "guard": torch.where(end, 0, guard), "segs": segs,
    }
    return out, sample >= spp
