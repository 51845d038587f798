"""Plücker-form dense Möller-Trumbore (torch port of tpurt/render/plucker.py).

Möller-Trumbore refactored so that the four per-candidate decision
quantities are linear in a 10-component ray feature vector
F = [d, w = d x o, o, 1] against per-triangle constant columns:

    det   = d . (e2 x e1)
    u_num = d . (pa x e2) - w . e2
    v_num = w . e1        - d . (pa x e1)
    t_num = o . Ng        - pa . Ng          (Ng = e1 x e2)

``component_rows`` builds the four (10, T) coefficient blocks; it is
shared by ``plucker_sweep`` (the modular engine's dense_engine="plucker",
a plain matrix product as tpurt leaves it to XLA) and the dense
megakernel's table (render/plucker_fused.py).

Like tpurt's, this is the FAST dense form: u/v/t land within ~1 ulp of
the sequential math, acceptance knife-edges may differ, backfaces are
culled by the geometric orientation (sign of det against the authored
normals' side), and the winner's shading data is recomputed exactly by
the caller (intersect._finalize_local).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.config import EPSILON
from tpurt_torch.core.vecmath import cross3

_F32 = torch.float32
_INF = float("inf")
_EPS = float(np.float32(EPSILON))
#: Ray feature count (10 used; no padding — no matrix unit to feed).
K_FEATURES = 10
#: Ray rows per product block (bounds the (RB, 4*TC) epilogue temporaries).
_RAY_BLOCK = 8192
#: Triangle columns per product block.
_TRI_CHUNK = 4096


class PluckerTable(NamedTuple):
    """Per-triangle coefficients, component-major: columns [0, T) det,
    [T, 2T) u_num, [2T, 3T) v_num, [3T, 4T) t_num."""

    coeffs: torch.Tensor  # (K_FEATURES, 4*Tpad) f32
    cull: torch.Tensor  # (Tpad,) bool backface-cull policy per triangle
    orient: torch.Tensor  # (Tpad,) f32 ±1 authored-normal vs winding sign
    tri_id: torch.Tensor  # (Tpad,) int64 global triangle id (-1 = pad)
    count: int


def _sum3(a: torch.Tensor) -> torch.Tensor:
    return a[..., 0] + a[..., 1] + a[..., 2]


def component_rows(pa, e1, e2, ng):
    """The four per-triangle coefficient blocks, each (10, T) f32, in the
    feature basis [d, w, o, 1]: rows 0:3 d, 3:6 w, 6:9 o, 9 the constant."""
    t = pa.shape[0]
    z = lambda k: torch.zeros((k, t), dtype=_F32, device=pa.device)
    det_c = torch.cat([cross3(e2, e1).T, z(7)])
    u_c = torch.cat([cross3(pa, e2).T, (-e2).T, z(4)])
    v_c = torch.cat([(-cross3(pa, e1)).T, e1.T, z(4)])
    t_c = torch.cat([z(6), ng.T, (-_sum3(pa * ng))[None]])
    return det_c, u_c, v_c, t_c


def orientation(na, nb, nc, ng) -> torch.Tensor:
    """±1 per triangle: the side of the authored normals against the
    winding's geometric normal (sign of dot(na + nb + nc, Ng))."""
    osign = _sum3((na + nb + nc) * ng)
    return torch.where(osign < 0.0, -1.0, 1.0).to(_F32)


def build_plucker_table(pa, pb, pc, cull, tri_id, na=None, nb=None, nc=None
                        ) -> PluckerTable:
    """Coefficient matrix for a triangle set, all (T, 3) / (T,) tensors.
    With authored normals the backface orientation follows them (the
    reference tests the interpolated normal, Trace.cl:304-311)."""
    t = pa.shape[0]
    tpad = max(-(-t // 128) * 128, 128)
    e1, e2 = pb - pa, pc - pa
    ng = cross3(e1, e2)
    orient = (orientation(na, nb, nc, ng) if na is not None
              else torch.ones(t, dtype=_F32, device=pa.device))
    pad = lambda m: torch.nn.functional.pad(m, (0, tpad - t))
    coeffs = torch.cat([pad(c) for c in component_rows(pa, e1, e2, ng)], dim=1)
    return PluckerTable(
        coeffs=coeffs,
        cull=pad(torch.as_tensor(cull, device=pa.device).to(torch.bool)),
        orient=torch.nn.functional.pad(orient, (0, tpad - t), value=1.0),
        tri_id=torch.nn.functional.pad(
            torch.as_tensor(tri_id, device=pa.device).to(torch.int64),
            (0, tpad - t), value=-1),
        count=int(t))


def ray_features(ro: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """(R, K_FEATURES) f32: [d, d x o, o, 1]."""
    ones = torch.ones(ro.shape[:-1] + (1,), dtype=_F32, device=ro.device)
    return torch.cat([rd, cross3(rd, ro), ro, ones], dim=-1)


def plucker_sweep(ro, rd, table: PluckerTable, t_best, tri_best):
    """Closest accepted hit of rays (R, 3) against the table, folded into
    the running (t_best (R,), tri_best (R,)). The lowest column wins among
    equal distances."""
    r = ro.shape[0]
    tpad = table.cull.shape[0]
    feats = ray_features(ro, rd)
    t_best, tri_best = t_best.clone(), tri_best.clone()
    for r0 in range(0, r, _RAY_BLOCK):
        f_blk = feats[r0:r0 + _RAY_BLOCK]
        for c0 in range(0, tpad, _TRI_CHUNK):
            tc = min(_TRI_CHUNK, tpad - c0)
            cols = torch.cat([table.coeffs[:, k * tpad + c0:k * tpad + c0 + tc]
                              for k in range(4)], dim=1)
            out = f_blk @ cols  # (rb, 4*tc)
            det, u_num, v_num, t_num = (out[:, k * tc:(k + 1) * tc]
                                        for k in range(4))
            f = 1.0 / det
            u, v, t = f * u_num, f * v_num, f * t_num
            ok = torch.abs(det) >= _EPS
            ok &= (u >= 0.0) & (u <= 1.0)
            ok &= (v >= 0.0) & (u + v <= 1.0)
            ok &= t > _EPS
            # det = -d.Ng: the ray meets the back when orient * det < 0.
            backface = det * table.orient[None, c0:c0 + tc] < 0.0
            ok &= ~(table.cull[None, c0:c0 + tc] & backface)
            ids = table.tri_id[c0:c0 + tc]
            ok &= ids[None] >= 0
            t = torch.where(ok, t, _INF)
            j = torch.argmin(t, dim=1)
            t_min = torch.gather(t, 1, j[:, None])[:, 0]
            closer = t_min < t_best[r0:r0 + _RAY_BLOCK]
            t_best[r0:r0 + _RAY_BLOCK] = torch.where(
                closer, t_min, t_best[r0:r0 + _RAY_BLOCK])
            tri_best[r0:r0 + _RAY_BLOCK] = torch.where(
                closer, ids[j], tri_best[r0:r0 + _RAY_BLOCK])
    return t_best, tri_best
