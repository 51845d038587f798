"""The dense Plücker sweep of the brute-force megakernel: its table,
kernel B2 (csrc/dense_sweep.cuh, launched alone from csrc/dense_sweep.cu
and fused into the dense instantiation of csrc/megakernel.cu) and its
plain torch version. Counterpart of tpurt/render/plucker_fused.py
(``sweep_entry_local`` -> ``_sweep_kernel``, ``pallas_call`` at :251).

The brute-force mode is the reference's UseBVH=false loop (Trace.cl:
276-317 + 444-482): each loop trip resolves a lane's whole current chain
entry by testing its local ray against every triangle of that entry, in
the Plücker form of render/plucker.py — four plane values per pair, each
a dot product of the ray's features [d, w = d x o, o, 1] with the
triangle's coefficient column. Acceptance and t come from the sweep; the
winner's shading data is recomputed exactly by the caller
(megakernel._dense_hit), as tpurt does.

The planes are explicit sums in a fixed order (``_planes``), the same
in the kernel: no matrix product, whose summation order (cuBLAS, or
tpurt's MXU with its zero-padded K = 128) would differ from the kernel.
Against tpurt the sweep is the fast-dense contract: u/v/t within about
one ulp, so acceptance knife-edges may differ. Against the kernel it is
bit for bit (``-fmad=false``, IEEE division).

The kernel is a block sweep: it stages the det and u rows through
shared memory from ``det_u``, a per-column repack of ``coeffs``, and
drops before its division the pairs whose u cannot pass
(``u_pretest_drops`` mirrors that test for the CPU tests).

``sweep_entry_local`` is the wrapper: the kernel for tensors on the card
(counted in ``LAUNCHES``), the plain version for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.config import EPSILON
from tpurt_torch.core.v3 import V3
from tpurt_torch.core.vecmath import cross3
from tpurt_torch.render.plucker import component_rows, orientation
from tpurt_torch.scene.types import Scene, culls_backfaces

_F32 = torch.float32
_INF = float("inf")
_EPS = float(np.float32(EPSILON))
#: Coefficient rows per plane: the 10 features, unpadded (the kernel
#: reads the rows each plane uses; there is no matrix unit to feed).
K_ROWS = 10
#: Table columns are padded to a multiple of this (the plain version's
#: column chunk).
COL_CHUNK = 256
#: Ray-column pairs per chunk of the plain version.
SWEEP_PAIRS = 1 << 24
#: Floats per column of the kernel-facing ``det_u`` array: det rows 0-2,
#: u rows 0-5, then zeros to three 16-byte vectors.
DET_U_WIDTH = 12
#: The kernels' u pre-test constants (csrc/sweep_common.cuh, where the
#: argument for them is written out): 1 + 2^-20 and 2^-100.
U_MARGIN = 1.0 + 2.0 ** -20
U_TINY = 2.0 ** -100
#: Kernel launches made by ``sweep_entry_local`` (where a launch is made).
LAUNCHES = 0


class DenseTable(NamedTuple):
    """Per-triangle sweep data over the union of all chain entries'
    triangles, entry by entry, padded to whole chunks (pad: id -1,
    entry -1)."""

    coeffs: torch.Tensor  # (4, K_ROWS, Tpad) f32: det/u/v/t rows
    det_u: torch.Tensor  # (Tpad, DET_U_WIDTH) f32: the kernel's staged columns
    ids: torch.Tensor  # (Tpad,) int32 soup triangle id
    owner: torch.Tensor  # (Tpad,) int32 owner mesh id
    entry: torch.Tensor  # (Tpad,) int32 owning chain entry
    cull: torch.Tensor  # (Tpad,) f32 0/1 backface-cull policy
    orient: torch.Tensor  # (Tpad,) f32 ±1 authored-normal orientation
    rows: torch.Tensor  # (Tpad, 18) f32 the column's exact triangle row
    entry_range: torch.Tensor  # (E, 2) int32 [first, end) columns of entry e
    count: int


def build_dense_table(scene: Scene) -> DenseTable:
    """The table of ``scene``'s chain (tpurt's build_dense_table): the
    members' triangles entry by entry, with their owner's backface-cull
    policy (``culls_backfaces``)."""
    ids, owner, entry, cull, ranges = [], [], [], [], []
    for e, members in enumerate(scene.mega_chain_members):
        start = len(ids)
        for i in members:
            first, count = scene.mesh_tri_ranges[i]
            ids.extend(range(first, first + count))
            owner.extend([i] * count)
            entry.extend([e] * count)
            cull.extend([culls_backfaces(scene.mesh_mat_types[i])] * count)
        ranges.append((start, len(ids)))
    t = len(ids)
    if t == 0:
        raise ValueError("the dense megakernel needs at least one chain triangle")
    tpad = -(-t // COL_CHUNK) * COL_CHUNK
    dev = scene.device
    idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
    rows = torch.zeros((tpad, 18), dtype=_F32, device=dev)
    rows[:t] = scene.tri_packed[idx]
    pa, pb, pc = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    e1, e2 = pb - pa, pc - pa
    ng = cross3(e1, e2)
    orient = orientation(rows[:, 9:12], rows[:, 12:15], rows[:, 15:18], ng)

    def pad(vals, fill, dtype):
        a = torch.full((tpad,), fill, dtype=dtype, device=dev)
        a[:t] = torch.as_tensor(vals, dtype=dtype, device=dev)
        return a

    coeffs = torch.stack(component_rows(pa, e1, e2, ng)).contiguous()
    return DenseTable(
        coeffs=coeffs, det_u=det_u_columns(coeffs),
        ids=pad(ids, -1, torch.int32), owner=pad(owner, 0, torch.int32),
        entry=pad(entry, -1, torch.int32), cull=pad(cull, 0.0, _F32),
        orient=orient.contiguous(), rows=rows,
        entry_range=torch.as_tensor(ranges, dtype=torch.int32,
                                    device=dev).reshape(-1, 2),
        count=t)


def det_u_columns(coeffs: torch.Tensor) -> torch.Tensor:
    """The kernel-facing repack of ``coeffs`` (4, K_ROWS, Tpad): per
    column, contiguous, the det rows 0-2 and the u rows 0-5 every pair
    reads, zero-padded to DET_U_WIDTH floats. Copies bits only."""
    tpad = coeffs.shape[2]
    out = torch.zeros((tpad, DET_U_WIDTH), dtype=_F32, device=coeffs.device)
    out[:, 0:3] = coeffs[0, 0:3].T
    out[:, 3:9] = coeffs[1, 0:6].T
    return out


def u_pretest_drops(det: torch.Tensor, u_num: torch.Tensor) -> torch.Tensor:
    """The kernels' u pre-test (sweep_common.cuh u_pretest_keeps, shared by
    B2 and B3, negated, in the kernel's form): True where a pair with
    |det| >= EPSILON is dropped before the division, because its exact
    u = (1 / det) * u_num cannot pass 0 <= u <= 1. ``us`` is u_num with
    det's sign bit folded in; the pair is kept where -(|det| U_TINY) <
    us <= |det| U_MARGIN."""
    ad = det.abs()
    sign = det.view(torch.int32) & torch.tensor(-(2 ** 31), dtype=torch.int32)
    us = (u_num.view(torch.int32) ^ sign).view(_F32)
    scale = lambda k: ad * torch.tensor(k, dtype=_F32, device=ad.device)
    return ~((us <= scale(U_MARGIN)) & (us > -scale(U_TINY)))


def _planes(lo: V3, ld: V3, c: torch.Tensor):
    """det, u_num, v_num, t_num of rays (R', 1) against coefficient
    columns c (4, K_ROWS, C'), each a left-to-right sum over the rows the
    plane uses — the kernel's order."""
    w = V3(ld.y * lo.z - ld.z * lo.y, ld.z * lo.x - ld.x * lo.z,
           ld.x * lo.y - ld.y * lo.x)
    d_terms = (ld.x, ld.y, ld.z)
    dw_terms = d_terms + (w.x, w.y, w.z)

    def dot(feats, k, first_row):
        acc = feats[0] * c[k, first_row][None]
        for i, f in enumerate(feats[1:], first_row + 1):
            acc = acc + f * c[k, i][None]
        return acc

    det = dot(d_terms, 0, 0)
    u_num = dot(dw_terms, 1, 0)
    v_num = dot(dw_terms, 2, 0)
    t_num = dot((lo.x, lo.y, lo.z), 3, 6) + c[3, 9][None]
    return det, u_num, v_num, t_num


def sweep_plain(lo: V3, ld: V3, lane_entry: torch.Tensor, table: DenseTable):
    """The kernel's function in torch: closest accepted hit of each lane's
    local ray against ITS chain entry's columns -> (t (R,) f32, +inf on a
    miss; column (R,) int64, -1 on a miss). Strict < in column order: the
    lowest column wins among equal t."""
    r = lo.x.shape[0]
    dev = lo.x.device
    t_best = torch.full((r,), _INF, dtype=_F32, device=dev)
    col = torch.full((r,), -1, dtype=torch.int64, device=dev)
    tpad = table.ids.shape[0]
    cc = min(tpad, 2048)
    rc = max(1, SWEEP_PAIRS // cc)
    lane_entry = lane_entry.to(torch.int32)
    for c0 in range(0, tpad, cc):
        c = table.coeffs[:, :, c0:c0 + cc]
        keep = (table.ids[c0:c0 + cc] >= 0)[None]
        ent = table.entry[c0:c0 + cc][None]
        cull = (table.cull[c0:c0 + cc] != 0.0)[None]
        orient = table.orient[c0:c0 + cc][None]
        for r0 in range(0, r, rc):
            sl = slice(r0, r0 + rc)
            o = V3(*(a[sl, None] for a in lo))
            d = V3(*(a[sl, None] for a in ld))
            det, u_num, v_num, t_num = _planes(o, d, c)
            f = 1.0 / det
            u, v, t = f * u_num, f * v_num, f * t_num
            ok = torch.abs(det) >= _EPS
            ok &= (u >= 0.0) & (u <= 1.0)
            ok &= (v >= 0.0) & (u + v <= 1.0)
            ok &= t > _EPS
            ok &= keep & (ent == lane_entry[sl, None])
            # Geometric backface: the ray meets the back when orient*det < 0.
            ok &= ~(cull & (det * orient < 0.0))
            t = torch.where(ok, t, _INF)
            j = torch.argmin(t, dim=1)
            t_min = torch.gather(t, 1, j[:, None])[:, 0]
            closer = t_min < t_best[sl]
            t_best[sl] = torch.where(closer, t_min, t_best[sl])
            col[sl] = torch.where(closer, j + c0, col[sl])
    return t_best, col


class _Dense(ctypes.Structure):
    """struct DenseTable of csrc/dense_sweep.cuh."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "coeffs", "det_u", "ids", "owner", "cull", "orient", "rows",
        "entry_range")] + [
        ("tpad", ctypes.c_int), ("n_entries", ctypes.c_int)]


def check_table(table: DenseTable, device) -> _Dense:
    """The table as the kernels' struct, after checking it lies on
    ``device`` with the types and shapes they read."""
    tpad = table.ids.shape[0]
    want = dict(coeffs=(_F32, (4, K_ROWS, tpad)),
                det_u=(_F32, (tpad, DET_U_WIDTH)), ids=(torch.int32, (tpad,)),
                owner=(torch.int32, (tpad,)), cull=(_F32, (tpad,)),
                orient=(_F32, (tpad,)), rows=(_F32, (tpad, 18)),
                entry_range=(torch.int32, (table.entry_range.shape[0], 2)))
    for name, (dtype, shape) in want.items():
        a = getattr(table, name)
        if (a.device != device or a.dtype != dtype or tuple(a.shape) != shape
                or not a.is_contiguous()):
            raise ValueError(f"dense table {name}: expected a contiguous "
                             f"{dtype} {shape} tensor on {device}")
    return _Dense(*(ctypes.c_void_p(getattr(table, n).data_ptr())
                    for n, _ in _Dense._fields_[:8]),
                  tpad, table.entry_range.shape[0])


def _lib():
    from tpurt_torch import _build

    lib = _build.load("dense_sweep")
    if not getattr(lib, "_tpurt_ready", False):
        vp = ctypes.c_void_p
        lib.tpurt_dense_sweep_launch.argtypes = [
            ctypes.POINTER(_Dense), vp, vp, vp, ctypes.c_int, vp, vp, vp]
        lib.tpurt_dense_sweep_launch.restype = ctypes.c_int
        lib._tpurt_ready = True
    return lib


def sweep_entry_local(lo: V3, ld: V3, lane_entry: torch.Tensor,
                      table: DenseTable):
    """Closest accepted hit of each lane's local ray (lo, ld V3 of (R,)
    f32) against its chain entry ``lane_entry`` (R,) -> (t (R,) f32,
    column (R,), -1 on a miss): kernel B2 on the card, the plain version
    on the CPU."""
    global LAUNCHES
    if lo.x.device.type == "cpu":
        return sweep_plain(lo, ld, lane_entry, table)
    if lo.x.device.type != "cuda":
        raise ValueError(f"sweep_entry_local runs on CPU or CUDA, got {lo.x.device}")
    dense = check_table(table, lo.x.device)
    r = lo.x.shape[0]
    lo_rows = torch.stack(list(lo)).contiguous()  # (3, R)
    ld_rows = torch.stack(list(ld)).contiguous()
    ent = lane_entry.to(torch.int32).contiguous()
    if r and (int(ent.min()) < 0 or int(ent.max()) >= dense.n_entries):
        raise ValueError("lane_entry outside the table's chain entries")
    t = torch.empty(r, dtype=_F32, device=lo.x.device)
    col = torch.empty(r, dtype=torch.int32, device=lo.x.device)
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    lib = _lib()
    with torch.cuda.device(lo.x.device):
        stream = torch.cuda.current_stream(lo.x.device).cuda_stream
        err = lib.tpurt_dense_sweep_launch(
            ctypes.byref(dense), ptr(lo_rows), ptr(ld_rows), ptr(ent), r,
            ptr(t), ptr(col), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dense sweep launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, col.to(torch.int64)
