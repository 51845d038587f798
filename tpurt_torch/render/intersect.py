"""Closest-hit scene intersection over ray lanes: the modular engine's
(torch port of tpurt/render/intersect.py; Trace.cl:434-485).

Per mesh instance the ray goes to local space (WorldToLocalRay), the
closest triangle is found, OneSided backfaces are rejected, the hit goes
back to world space (LocalToWorldHit) and the strictly closest world hit
wins, earlier meshes winning ties. As in tpurt:

  * identity-transform meshes at or under ``bruteforce_threshold``
    triangles (not OneSided) are swept together in one world-space pass
    with per-triangle cull flags (``_fused_identity_pass``);
  * every other mesh is swept by brute force when small and walks its
    threaded BVH (``node_q`` rows, ``tri_packed`` triangles) otherwise
    (``_transformed_mesh_pass``).

The brute-force sweep has three engines (``dense_engine``): "exact",
the first-minimum Möller-Trumbore sweep in ``_mt_single``'s op order
(bit-identical to the per-pair test and the scalar oracle); "plucker",
the Plücker form of render/plucker.py; "pallas", render/mt_sweep.py —
kernel B3 for rays on the card, its plain version (the exact sweep) for
rays on the CPU. Eager torch does not fuse the (rays, triangles)
broadcast as XLA does, so the exact sweep works in chunks of pairs.
The kernel reads the scene's own triangle layout, by range for one mesh
or through the fused pass's id list (``fused_set``); both, and the
per-mesh policy tables, are made once per scene and kept in its cache.

Hits keep tpurt's (R, 3) row layout at this module's boundary; the
arithmetic inside runs on V3 component triples in the same association
order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.config import EPSILON
from tpurt_torch.core import v3 as v3lib
from tpurt_torch.core.v3 import V3
from tpurt_torch.core.vecmath import euler_rotation
from tpurt_torch.scene.types import MaterialType, Scene, culls_backfaces

_F32 = torch.float32
_INF = float("inf")
_EPS = float(np.float32(EPSILON))
_GROW = float(np.float32(1.001))
#: Ray-triangle pairs per chunk of the exact sweep (each of its ~40
#: intermediates holds this many f32 values).
SWEEP_PAIRS = 1 << 22


class Hit(NamedTuple):
    """World-space closest hit per ray (HitInfo, Trace.cl:67-74, with the
    material replaced by the winning mesh index)."""

    valid: torch.Tensor  # (R,) bool
    dst: torch.Tensor  # (R,) f32
    point: torch.Tensor  # (R, 3) f32
    normal: torch.Tensor  # (R, 3) f32
    backface: torch.Tensor  # (R,) bool
    mesh_idx: torch.Tensor  # (R,) i32, -1 if none


class LocalBest(NamedTuple):
    t: torch.Tensor  # (R,) f32 local distance, inf if none
    tri: torch.Tensor  # (R,) int64 winning triangle, -1 if none


# ---------------------------------------------------------------------------
# Möller-Trumbore
# ---------------------------------------------------------------------------


def mt_core(lo: V3, ld: V3, pa: V3, e1: V3, e2: V3, na: V3, nb: V3, nc: V3,
            cull):
    """Exact Möller-Trumbore (Trace.cl:276-317) in tpurt's op order, with
    ``e1 = pb - pa`` and ``e2 = pc - pa`` given. Components broadcast, so
    (R, 1) rays against (1, C) triangles sweep. ``cull`` is a Python bool
    or a bool tensor. Returns (ok, t, normal flipped to the ray's side,
    backface)."""
    h = v3lib.cross(ld, e2)
    det = v3lib.dot(e1, h)
    ok = torch.abs(det) >= _EPS
    f = 1.0 / det
    s = lo - pa
    u = f * v3lib.dot(s, h)
    ok &= (u >= 0.0) & (u <= 1.0)
    q = v3lib.cross(s, e1)
    v = f * v3lib.dot(ld, q)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = f * v3lib.dot(e2, q)
    ok &= t > _EPS
    w = 1.0 - u - v
    n = v3lib.normalize(V3(
        na.x * w + nb.x * u + nc.x * v,
        na.y * w + nb.y * u + nc.y * v,
        na.z * w + nb.z * u + nc.z * v,
    ))
    backface = v3lib.dot(ld, n) > _EPS
    if isinstance(cull, bool):
        if cull:
            ok = ok & ~backface
    else:
        ok = ok & ~(cull & backface)
    n = v3lib.where(backface, -n, n)
    return ok, t, n, backface


def _mt_single(ro: V3, rd: V3, pa: V3, pb: V3, pc: V3, na: V3, nb: V3,
               nc: V3, cull):
    """Exact MT on paired rays and triangles (tpurt's ``_mt_single``)."""
    return mt_core(ro, rd, pa, pb - pa, pc - pa, na, nb, nc, cull)


def _tri_v3(rows: torch.Tensor, col: int) -> V3:
    """Columns col..col+2 of (..., 18) triangle rows as a V3."""
    return V3(rows[..., col], rows[..., col + 1], rows[..., col + 2])


def mt_rows(ro: V3, rd: V3, rows: torch.Tensor, cull):
    """Exact MT of rays against ``tri_packed``-layout rows (pa pb pc na nb
    nc) of the same leading shape, or broadcast against them."""
    return _mt_single(ro, rd, *(_tri_v3(rows, 3 * k) for k in range(6)), cull)


def exact_sweep(ro: V3, rd: V3, rows: torch.Tensor, cull: torch.Tensor):
    """First-minimum exact sweep of R rays over C triangle rows (C, 18)
    with per-row cull flags (C,) bool -> (t (R,) f32, col (R,) int64 in
    [0, C) or -1). The lowest column wins among equal distances, the
    reference's strict-< update in index order (Trace.cl:352-357)."""
    r, c = ro.x.shape[0], rows.shape[0]
    t_best = torch.full((r,), _INF, dtype=_F32, device=ro.x.device)
    col = torch.full((r,), -1, dtype=torch.int64, device=ro.x.device)
    if c == 0 or r == 0:
        return t_best, col
    cc = min(c, 2048)
    rc = max(1, SWEEP_PAIRS // cc)
    for c0 in range(0, c, cc):
        chunk = rows[c0:c0 + cc][None]  # (1, C', 18)
        cull_c = cull[c0:c0 + cc][None]
        for r0 in range(0, r, rc):
            sl = slice(r0, r0 + rc)
            o = V3(*(a[sl, None] for a in ro))
            d = V3(*(a[sl, None] for a in rd))
            ok, t, _, _ = mt_rows(o, d, chunk, cull_c)
            t = torch.where(ok, t, _INF)
            j = torch.argmin(t, dim=1)  # the first minimum
            t_min = torch.gather(t, 1, j[:, None])[:, 0]
            closer = t_min < t_best[sl]
            t_best[sl] = torch.where(closer, t_min, t_best[sl])
            col[sl] = torch.where(closer, j + c0, col[sl])
    return t_best, col


# ---------------------------------------------------------------------------
# Brute force over triangle sets
# ---------------------------------------------------------------------------


def _empty_best(ro: V3) -> LocalBest:
    r = ro.x.shape[0]
    dev = ro.x.device
    return LocalBest(t=torch.full((r,), _INF, dtype=_F32, device=dev),
                     tri=torch.full((r,), -1, dtype=torch.int64, device=dev))


def _sweep_ids(scene: Scene, ro: V3, rd: V3, ids: torch.Tensor,
               cull: torch.Tensor, dense_engine: str) -> LocalBest:
    """Closest hit over triangles ``ids`` with per-row cull flags (a row
    culls where its flag is nonzero), by ``dense_engine``; ``tri`` is the
    winning position in ``ids``."""
    cull = cull != 0
    if dense_engine == "plucker":
        from tpurt_torch.render.plucker import build_plucker_table, plucker_sweep

        best = _empty_best(ro)
        table = build_plucker_table(
            scene.tri_pos_a[ids], scene.tri_pos_b[ids], scene.tri_pos_c[ids],
            cull=cull, tri_id=torch.arange(ids.shape[0], device=ids.device),
            na=scene.tri_nrm_a[ids], nb=scene.tri_nrm_b[ids], nc=scene.tri_nrm_c[ids])
        t, pos = plucker_sweep(v3lib.to_rows(ro), v3lib.to_rows(rd), table,
                               best.t, best.tri)
        return LocalBest(t=t, tri=pos)
    t, col = exact_sweep(ro, rd, scene.tri_packed[ids], cull)
    return LocalBest(t=t, tri=col)


def _bruteforce_range(scene: Scene, ro: V3, rd: V3, first: int, count: int,
                      cull: bool, dense_engine: str = "exact") -> LocalBest:
    """Brute force over one mesh's triangles ``first`` .. ``first + count
    - 1`` with one cull policy — a transformed or OneSided mesh's pass."""
    if dense_engine == "pallas":
        from tpurt_torch.render import mt_sweep

        t, j = mt_sweep.sweep(v3lib.to_rows(ro), v3lib.to_rows(rd),
                              mt_sweep.scene_layout(scene), scene.tri_packed,
                              count, first=first, cull=cull)
        return LocalBest(t=t, tri=torch.where(j >= 0, j.long() + first, -1))
    ids = torch.arange(first, first + count, device=ro.x.device)
    flags = torch.full((count,), bool(cull), device=ro.x.device)
    lb = _sweep_ids(scene, ro, rd, ids, flags, dense_engine)
    return lb._replace(tri=torch.where(lb.tri >= 0, lb.tri + first, -1))


def _bruteforce_fused(scene: Scene, ro: V3, rd: V3, fused: FusedSet,
                      dense_engine: str = "exact") -> LocalBest:
    """Brute force over the fused static meshes' triangles, each with its
    owner's cull policy — the fused identity pass; ``tri`` is the
    winning position in ``fused.ids``."""
    if dense_engine == "pallas":
        from tpurt_torch.render import mt_sweep

        t, j = mt_sweep.sweep(v3lib.to_rows(ro), v3lib.to_rows(rd),
                              mt_sweep.scene_layout(scene), scene.tri_packed,
                              fused.ids.shape[0], ids=fused.ids,
                              cull_flags=fused.cull)
        return LocalBest(t=t, tri=j.long())
    return _sweep_ids(scene, ro, rd, fused.ids, fused.cull, dense_engine)


# ---------------------------------------------------------------------------
# Threaded BVH traversal
# ---------------------------------------------------------------------------


def _aabb(ro: V3, invd: V3, bmin: V3, bmax: V3):
    """Slab test (RayBoundingBox, Trace.cl:259-274) -> (hit, entry t). A
    NaN slab (a ray in a face's plane, 0 * inf) widens to (-inf, inf):
    the box never rejects a hit the exact test would accept."""
    t0 = (bmin - ro) * invd
    t1 = (bmax - ro) * invd
    lo = [torch.nan_to_num(torch.minimum(a, b), nan=-_INF, posinf=_INF,
                           neginf=-_INF) for a, b in zip(t0, t1)]
    hi = [torch.nan_to_num(torch.maximum(a, b), nan=_INF, posinf=_INF,
                           neginf=-_INF) for a, b in zip(t0, t1)]
    tmin = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
    tmax = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
    return tmax >= torch.clamp_min(tmin, 0.0), tmin


def _bvh_traverse(scene: Scene, root: int, ro: V3, rd: V3, cull: bool,
                  max_leaf: int, qmin, qscale, t_limit=None) -> LocalBest:
    """Stackless threaded walk, one cursor per lane (tpurt's
    ``_bvh_traverse``): descent steps read one packed ``node_q`` row and
    slab-test its u16 box on the mesh's grid, pruning boxes not closer
    than the lane's best (Trace.cl:348-349, seeded with ``t_limit``);
    lanes park on the leaf they land on until every lane has parked or
    finished, then all leaves are drained with exact MT on their
    ``tri_packed`` rows."""
    invd = V3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    r = ro.x.shape[0]
    dev = ro.x.device
    qmin = V3(*(float(x) for x in qmin))
    qscale = V3(*(float(x) for x in qscale))
    node_q = scene.node_q.view(torch.int32)
    cur = torch.full((r,), int(root), dtype=torch.int64, device=dev)
    parked = torch.zeros(r, dtype=torch.bool, device=dev)
    lf = torch.zeros(r, dtype=torch.int64, device=dev)  # leaf first tri
    ln = torch.zeros_like(lf)  # leaf tri count
    lm = lf - 1  # leaf miss link
    best = _empty_best(ro)
    if t_limit is not None:
        best = best._replace(t=t_limit.clone())
    b16 = lambda w: w.to(_F32)
    while bool((cur >= 0).any()):
        while True:
            walking = (cur >= 0) & ~parked
            if not bool(walking.any()):
                break
            row = node_q[torch.where(walking, cur, 0)].to(torch.int64) & 0xFFFFFFFF
            u0, u1, u2 = row[:, 0], row[:, 1], row[:, 2]
            q_lo = V3(b16(u0 & 0xFFFF), b16(u0 >> 16), b16(u1 & 0xFFFF))
            q_hi = V3(b16(u1 >> 16), b16(u2 & 0xFFFF), b16(u2 >> 16))
            bmin = qmin + q_lo * qscale
            bmax = qmin + q_hi * qscale
            w6 = torch.where(row[:, 3] >= 2 ** 31, row[:, 3] - 2 ** 32, row[:, 3])
            miss = (row[:, 4] & 0xFFFFFF) - 1
            ntris = row[:, 4] >> 24
            box_hit, tmin = _aabb(ro, invd, bmin, bmax)
            enter = walking & box_hit & (tmin < best.t)
            is_leaf = ntris > 0
            land = enter & is_leaf
            parked = parked | land
            lf = torch.where(land, w6, lf)
            ln = torch.where(land, ntris, ln)
            lm = torch.where(land, miss, lm)
            nxt = torch.where(enter & ~is_leaf, w6, miss)
            cur = torch.where(walking & ~land, nxt, cur)
        on = (cur >= 0) & parked
        t_acc, tri_acc = best
        for i in range(max_leaf):
            live = on & (i < ln)
            tri = torch.where(live, lf + i, 0)
            ok, t, _, _ = mt_rows(ro, rd, scene.tri_packed[tri], cull)
            win = live & ok & (t < t_acc)
            t_acc = torch.where(win, t, t_acc)
            tri_acc = torch.where(win, tri, tri_acc)
        best = LocalBest(t=t_acc, tri=tri_acc)
        cur = torch.where(on, lm, cur)
        parked = parked & ~on
    return best


# ---------------------------------------------------------------------------
# Full scene
# ---------------------------------------------------------------------------


class FusedSet(NamedTuple):
    """The triangles of the fused identity pass on the scene's device,
    mesh by mesh, made once per scene and threshold (``fused_set``)."""

    ids: torch.Tensor  # (N,) int32 global triangle ids, kernel B3's id list
    owner: torch.Tensor  # (N,) int64 owning mesh
    cull: torch.Tensor  # (N,) f32 1 where the owner culls backfaces, B3's flags
    first: torch.Tensor  # (N,) int64 the first position listing the same id


def _partition(scene: Scene, bruteforce_threshold: int):
    """(fused mesh ids, separate mesh ids): identity-transform small
    meshes sweep together in world space; OneSided meshes keep per-mesh
    closest-hit semantics (their backface rejection follows the mesh's
    own query, Trace.cl:466-471)."""
    fused, separate = [], []
    for i, (_first, count) in enumerate(scene.mesh_tri_ranges):
        if (scene.mesh_identity[i] and count <= bruteforce_threshold
                and scene.mesh_mat_types[i] != int(MaterialType.ONE_SIDED)):
            fused.append(i)
        else:
            separate.append(i)
    return fused, separate


def fused_set(scene: Scene, bruteforce_threshold: int):
    """The fused identity pass's ``FusedSet`` (None when it has no
    triangles), made on first use and kept in the scene's cache."""
    key = ("fused_set", bruteforce_threshold)
    if key not in scene.cache:
        fused, _separate = _partition(scene, bruteforce_threshold)
        ranges = [scene.mesh_tri_ranges[i] for i in fused]
        n = sum(c for _f, c in ranges)
        fs = None
        if n:
            ids = np.concatenate([np.arange(f, f + c) for f, c in ranges])
            owner = np.concatenate([np.full(c, i, np.int64)
                                    for i, (_f, c) in zip(fused, ranges)])
            cull = np.array([culls_backfaces(scene.mesh_mat_types[i]) for i in owner])
            uniq, first = np.unique(ids, return_index=True)
            dev = scene.device
            t = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=dev)
            fs = FusedSet(ids=t(ids, torch.int32), owner=t(owner, torch.int64),
                          cull=t(cull, _F32),
                          first=t(first[np.searchsorted(uniq, ids)], torch.int64))
        scene.cache[key] = fs
    return scene.cache[key]


def _mesh_tables(scene: Scene):
    """(cull policy, OneSided) per mesh, (K,) bool on the scene's device,
    made on first use and kept in the scene's cache."""
    if "mesh_tables" not in scene.cache:
        mts = [int(m) for m in scene.mesh_mat_types]
        scene.cache["mesh_tables"] = tuple(
            torch.tensor(v, dtype=torch.bool, device=scene.device) for v in (
                [culls_backfaces(m) for m in mts],
                [m == int(MaterialType.ONE_SIDED) for m in mts]))
    return scene.cache["mesh_tables"]


def intersect_scene(scene: Scene, ro: torch.Tensor, rd: torch.Tensor,
                    bruteforce_threshold: int = 4096,
                    dense_engine: str = "exact") -> Hit:
    """Closest hit of world rays (R, 3) against every mesh instance."""
    r = ro.shape[0]
    dev = ro.device
    best = Hit(
        valid=torch.zeros(r, dtype=torch.bool, device=dev),
        dst=torch.full((r,), _INF, dtype=_F32, device=dev),
        point=torch.zeros((r, 3), dtype=_F32, device=dev),
        normal=torch.zeros((r, 3), dtype=_F32, device=dev),
        backface=torch.zeros(r, dtype=torch.bool, device=dev),
        mesh_idx=torch.full((r,), -1, dtype=torch.int32, device=dev),
    )
    o, d = v3lib.from_rows(ro), v3lib.from_rows(rd)
    fs = fused_set(scene, bruteforce_threshold)
    if fs is not None:
        best = _fused_identity_pass(scene, o, d, fs, best, dense_engine)
    for i in _partition(scene, bruteforce_threshold)[1]:
        best = _transformed_mesh_pass(scene, o, d, i, bruteforce_threshold,
                                      best, dense_engine)
    return best


def _finalize_local(scene: Scene, lo: V3, ld: V3, lb: LocalBest, cull):
    """The winner's exact normal and backface by one paired MT."""
    rows = scene.tri_packed[torch.clamp_min(lb.tri, 0)]
    ok, _t, n, backface = mt_rows(lo, ld, rows, cull)
    valid = (lb.tri >= 0) & ok
    return valid, lo + ld * lb.t, n, backface


def _closer(best: Hit, closer, dst, point: V3, normal: V3, backface, mesh):
    return Hit(
        valid=best.valid | closer,
        dst=torch.where(closer, dst, best.dst),
        point=torch.where(closer[:, None], v3lib.to_rows(point), best.point),
        normal=torch.where(closer[:, None], v3lib.to_rows(normal), best.normal),
        backface=torch.where(closer, backface, best.backface),
        mesh_idx=torch.where(closer, mesh.to(torch.int32), best.mesh_idx),
    )


def _fused_identity_pass(scene: Scene, ro: V3, rd: V3, fs: FusedSet,
                         best: Hit, dense_engine: str = "exact") -> Hit:
    # WorldToLocalRay with an identity transform still renormalises the
    # direction (Trace.cl:130); kept so distances match exactly.
    ld = v3lib.normalize(rd)
    lb = _bruteforce_fused(scene, ro, ld, fs, dense_engine)
    # The winner's owner is that of the first position listing its id, as
    # tpurt maps a winning id back to the list (instances may share one
    # triangle range).
    hit = lb.tri >= 0
    k = torch.clamp_min(lb.tri, 0)
    win_owner = torch.where(hit, fs.owner[fs.first[k]], 0)
    lb = lb._replace(tri=torch.where(hit, fs.ids[k].long(), -1))
    mesh_cull, mesh_one_sided = _mesh_tables(scene)
    valid, point, n, backface = _finalize_local(scene, ro, ld, lb,
                                                mesh_cull[win_owner])
    valid &= ~(mesh_one_sided[win_owner] & backface)  # Trace.cl:468-471
    dst = v3lib.length(point - ro)
    return _closer(best, valid & (dst < best.dst), dst, point,
                   v3lib.normalize(n), backface, win_owner)


def _rotate(m, v: V3) -> V3:
    """mul_mat_vec(m, v): out_i = sum_j m[i][j] * v_j."""
    m = [[float(m[i][j]) for j in range(3)] for i in range(3)]
    return V3(*[m[i][0] * v.x + m[i][1] * v.y + m[i][2] * v.z for i in range(3)])


def _rotate_t(m, v: V3) -> V3:
    """mul_mat_vec(transpose(m), v): out_i = sum_j m[j][i] * v_j."""
    m = [[float(m[i][j]) for j in range(3)] for i in range(3)]
    return V3(*[m[0][i] * v.x + m[1][i] * v.y + m[2][i] * v.z for i in range(3)])


def _mesh_frame(scene: Scene, i: int):
    """Mesh instance i's (rotation (3, 3) numpy f32, position V3 of
    floats, scale float)."""
    pos = V3(*(float(x) for x in scene.mesh_pos[i].cpu().numpy()))
    rot = euler_rotation(*(float(getattr(scene, f"mesh_{a}")[i].cpu())
                           for a in ("pitch", "yaw", "roll")))
    return rot, pos, float(scene.mesh_scale[i].cpu())


def local_rays(scene: Scene, i: int, ro: V3, rd: V3):
    """WorldToLocalRay (Trace.cl:118-137) into mesh instance i: rotate by
    R^T, translate, divide by the (guarded) uniform scale, renormalise."""
    rot, pos, scale = _mesh_frame(scene, i)
    safe = scale if abs(scale) > _EPS else 1.0
    return (_rotate_t(rot, ro - pos) / safe,
            v3lib.normalize(_rotate_t(rot, rd) / safe))


def _transformed_mesh_pass(scene: Scene, ro: V3, rd: V3, i: int,
                           bruteforce_threshold: int, best: Hit,
                           dense_engine: str = "exact") -> Hit:
    first, count = scene.mesh_tri_ranges[i]
    rot, pos, scale = _mesh_frame(scene, i)
    safe = scale if abs(scale) > _EPS else 1.0
    cull = culls_backfaces(scene.mesh_mat_types[i])
    lo, ld = local_rays(scene, i, ro, rd)
    if count <= bruteforce_threshold:
        lb = _bruteforce_range(scene, lo, ld, first, count, cull, dense_engine)
    else:
        # Earlier meshes' best, in local distance with a relative margin,
        # prunes the walk (result-invariant: the world comparison below
        # is exact).
        lb = _bvh_traverse(
            scene, int(scene.mesh_root[i]), lo, ld, cull, scene.max_leaf_tris,
            scene.mesh_qmin[i].cpu().numpy(), scene.mesh_qscale[i].cpu().numpy(),
            t_limit=best.dst / safe * _GROW)
    valid, point_l, n_l, backface = _finalize_local(scene, lo, ld, lb, cull)
    if not scale > _EPS:  # degenerate mesh (Trace.cl:448-449)
        valid = torch.zeros_like(valid)
    if scene.mesh_mat_types[i] == int(MaterialType.ONE_SIDED):
        valid &= ~backface
    point_w = _rotate(rot, point_l * scale) + pos  # LocalToWorldHit
    n_w = v3lib.normalize(_rotate(rot, n_l))
    dst = v3lib.length(point_w - ro)
    return _closer(best, valid & (dst < best.dst), dst, point_w, n_w, backface,
                   torch.full_like(best.mesh_idx, i))
