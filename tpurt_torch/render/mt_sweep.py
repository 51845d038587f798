"""The exact brute-force closest-hit sweep: kernel B3 (csrc/mt_sweep.cu)
and its plain torch version. Counterpart of tpurt/render/pallas_kernels.py
(``mt_sweep_pallas`` -> ``_mt_sweep_kernel``, ``pallas_call`` at :156),
the modular engine's ``dense_engine="pallas"``.

Two entry points, each the kernel for rays on the card (counted in
``LAUNCHES``, raising where the kernel cannot serve) and its plain
version for rays on the CPU, the exact first-minimum Möller-Trumbore
sweep of render/intersect.py, because CPU tensors are what it was given.
tpurt degrades its Pallas sweep to the exact XLA sweep off the TPU
(intersect._pallas_available); the port never switches on the card.

* ``sweep`` is the engine's: rays against rows of a scene's triangles,
  read by range or through an id list, from the scene's kernel-facing
  layout (``scene_layout``, made once per scene), with no gather, pad or
  copy of rows per call.
* ``mt_sweep`` is tpurt's signature, on padded (T_pad, 18) rows and
  (T_pad, 1) flags; it builds the layout of its rows on each call.

The kernel keeps the plain version's numbers: ``mt_core``'s op order,
``1.0f / sqrtf`` where it normalises, ``-fmad=false``, strict ``<`` in
row order (the first minimum wins), -1 on a miss; the layout's edges are
the same subtractions the plain version makes. It is bit-identical to
the plain version on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpurt_torch.core import v3 as v3lib
from tpurt_torch.render.intersect import exact_sweep
from tpurt_torch.scene.types import Scene

#: Kernel launches made by ``sweep`` and ``mt_sweep`` (incremented where a
#: launch is made).
LAUNCHES = 0
#: Triangle rows per padded chunk of ``mt_sweep``'s rows (tpurt's
#: _TRI_CHUNK).
TRI_CHUNK = 256
#: Floats per row of the kernel-facing layout: pa, e1 = pb - pa,
#: e2 = pc - pa, then zeros to three 16-byte vectors.
MT_WIDTH = 12


def mt_layout(tri_rows: torch.Tensor) -> torch.Tensor:
    """The kernel-facing layout (T, MT_WIDTH) f32 of (T, 18) triangle
    rows (pa pb pc na nb nc): pa, pb - pa, pc - pa, three zeros. The
    edges are the IEEE subtractions the plain version makes per pair."""
    pa = tri_rows[:, 0:3]
    out = torch.zeros((tri_rows.shape[0], MT_WIDTH), dtype=torch.float32,
                      device=tri_rows.device)
    out[:, 0:3] = pa
    out[:, 3:6] = tri_rows[:, 3:6] - pa
    out[:, 6:9] = tri_rows[:, 6:9] - pa
    return out


def scene_layout(scene: Scene) -> torch.Tensor:
    """``mt_layout`` of the scene's ``tri_packed``, made on first use and
    kept in the scene's cache."""
    if "tri_mt" not in scene.cache:
        scene.cache["tri_mt"] = mt_layout(scene.tri_packed)
    return scene.cache["tri_mt"]


def pad_tri_rows(tri_rows: torch.Tensor, cull: torch.Tensor):
    """(T, 18) triangle rows and (T,) cull flags -> rows and (T_pad, 1)
    f32 flags zero-padded to a whole number of chunks (at least one)."""
    t = tri_rows.shape[0]
    t_pad = max(-(-t // TRI_CHUNK) * TRI_CHUNK, TRI_CHUNK)
    rows = torch.zeros((t_pad, 18), dtype=torch.float32, device=tri_rows.device)
    rows[:t] = tri_rows
    flags = torch.zeros((t_pad, 1), dtype=torch.float32, device=tri_rows.device)
    flags[:t, 0] = cull.to(torch.float32)
    return rows, flags


def sweep_plain(ro: torch.Tensor, rd: torch.Tensor, tri_rows: torch.Tensor,
                count: int, first: int = 0, ids: Optional[torch.Tensor] = None,
                cull_flags: Optional[torch.Tensor] = None, cull: bool = False):
    """``sweep``'s function in torch, on the (T, 18) rows themselves."""
    rows = (tri_rows[ids[:count].long()] if ids is not None
            else tri_rows[first:first + count])
    flags = (cull_flags[:count] != 0.0 if cull_flags is not None else
             torch.full((count,), bool(cull), device=tri_rows.device))
    t, col = exact_sweep(v3lib.from_rows(ro), v3lib.from_rows(rd), rows, flags)
    return t, torch.where(t < float("inf"), col, -1).to(torch.int32)


def mt_sweep_plain(ro: torch.Tensor, rd: torch.Tensor, tri_rows: torch.Tensor,
                   cull_flags: torch.Tensor, tri_count: int):
    """``mt_sweep``'s function in torch: (best t (R,), best row (R,)
    int32, -1 on a miss)."""
    return sweep_plain(ro, rd, tri_rows, tri_count, cull_flags=cull_flags[:tri_count, 0])


def _lib():
    from tpurt_torch import _build

    lib = _build.load("mt_sweep")
    if not getattr(lib, "_tpurt_ready", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tpurt_mt_sweep_launch.argtypes = [vp] * 6 + [i32] * 4 + [vp] * 3
        lib.tpurt_mt_sweep_launch.restype = i32
        lib.tpurt_mt_sweep_config.argtypes = [i32, ctypes.POINTER(i32)]
        lib.tpurt_mt_sweep_config.restype = i32
        lib._tpurt_ready = True
    return lib


def launch_config(n_rays: int) -> dict:
    """The kernel's launch for ``n_rays`` rays on the current card:
    threads a block, rays a thread, threads a ray set (G), the resident
    threads the G rule compares with, and blocks."""
    out = (ctypes.c_int * 5)()
    err = _lib().tpurt_mt_sweep_config(int(n_rays), out)
    if err != 0:
        raise RuntimeError(f"mt_sweep config failed: CUDA error {err}")
    return dict(zip(("threads", "rays_per_thread", "groups", "resident_threads",
                     "blocks"), out))


def _check(name: str, a: torch.Tensor, dtype, shape, device):
    if (a.device != device or a.dtype != dtype or tuple(a.shape) != shape
            or not a.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} {shape} tensor "
                         f"on {device}")


def sweep(ro: torch.Tensor, rd: torch.Tensor, tri_mt: torch.Tensor,
          tri_rows: torch.Tensor, count: int, first: int = 0,
          ids: Optional[torch.Tensor] = None,
          cull_flags: Optional[torch.Tensor] = None, cull: bool = False):
    """Closest accepted hit of rays ro, rd (R, 3) f32 against ``count``
    triangles of ``tri_rows`` (T, 18) f32 (pa pb pc na nb nc), whose
    layout ``tri_mt`` (T, MT_WIDTH) is ``mt_layout(tri_rows)``: rows
    ``first`` .. ``first + count - 1``, or rows ``ids[k]`` (int32 (count,))
    where ``ids`` is given. Backfaces are culled where ``cull_flags``
    ((count,) f32, per position) is nonzero, or everywhere if ``cull``
    where no flags are given. Returns (t (R,) f32, inf on a miss; the
    winning position k in [0, count) (R,) int32, -1 on a miss)."""
    global LAUNCHES
    if ro.device.type == "cpu":
        return sweep_plain(ro, rd, tri_rows, count, first, ids, cull_flags, cull)
    if ro.device.type != "cuda":
        raise ValueError(f"sweep runs on CPU or CUDA tensors, got {ro.device}")
    dev, r, n_tri = ro.device, ro.shape[0], tri_rows.shape[0]
    _check("ro", ro, torch.float32, (r, 3), dev)
    _check("rd", rd, torch.float32, (r, 3), dev)
    _check("tri_mt", tri_mt, torch.float32, (n_tri, MT_WIDTH), dev)
    _check("tri_rows", tri_rows, torch.float32, (n_tri, 18), dev)
    if tri_mt.data_ptr() % 16:
        raise ValueError("tri_mt: its rows must start on 16-byte boundaries")
    if ids is not None:
        _check("ids", ids, torch.int32, (count,), dev)
    elif not 0 <= first <= first + count <= n_tri:
        raise ValueError(f"rows {first} .. {first + count} outside {n_tri} rows")
    if cull_flags is not None:
        _check("cull_flags", cull_flags, torch.float32, (count,), dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    lib = _lib()
    ptr = lambda a: ctypes.c_void_p(None if a is None else a.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpurt_mt_sweep_launch(
            ptr(ro), ptr(rd), ptr(tri_mt), ptr(tri_rows), ptr(ids), ptr(cull_flags),
            int(first), int(count), int(bool(cull)), r, ptr(t), ptr(idx),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mt_sweep launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, idx


def mt_sweep(ro: torch.Tensor, rd: torch.Tensor, tri_rows: torch.Tensor,
             cull_flags: torch.Tensor, tri_count: int):
    """Closest accepted hit of rays ro, rd (R, 3) f32 against the first
    ``tri_count`` of ``tri_rows`` (T_pad, 18) f32 (pa pb pc na nb nc),
    backfaces culled where ``cull_flags`` (T_pad, 1) f32 is nonzero.
    Returns (t (R,) f32, inf on a miss; row (R,) int32, -1 on a miss)."""
    if ro.device.type == "cpu":
        return mt_sweep_plain(ro, rd, tri_rows, cull_flags, tri_count)
    n_tri = tri_rows.shape[0]
    _check("cull_flags", cull_flags, torch.float32, (n_tri, 1), ro.device)
    if not 0 <= tri_count <= n_tri or n_tri % TRI_CHUNK:
        raise ValueError(f"tri_count {tri_count} / rows {n_tri}: "
                         f"rows must be padded to {TRI_CHUNK}")
    _check("tri_rows", tri_rows, torch.float32, (n_tri, 18), ro.device)
    return sweep(ro, rd, mt_layout(tri_rows), tri_rows, tri_count,
                 cull_flags=cull_flags[:tri_count, 0])
