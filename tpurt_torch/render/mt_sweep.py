"""The exact brute-force closest-hit sweep: kernel B3 (csrc/mt_sweep.cu)
and its plain torch version. Counterpart of tpurt/render/pallas_kernels.py
(``mt_sweep_pallas`` -> ``_mt_sweep_kernel``, ``pallas_call`` at :156),
the modular engine's ``dense_engine="pallas"``.

``mt_sweep`` is the one entry point. On rays on the card it launches the
kernel — counted in ``LAUNCHES`` — or raises; on rays on the CPU it runs
the plain version, the exact first-minimum Möller-Trumbore sweep of
render/intersect.py, because CPU tensors are what it was given. tpurt
degrades its Pallas sweep to the exact XLA sweep off the TPU
(intersect._pallas_available); the port never switches on the card.

The kernel keeps the plain version's numbers: ``_mt_single``'s op order,
``1.0f / sqrtf`` where it normalises, ``-fmad=false``, strict ``<`` in
row order (the first minimum wins), padded rows masked, -1 on a miss. It
is bit-identical to the plain version on the card.
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch.core import v3 as v3lib
from tpurt_torch.render.intersect import exact_sweep

#: Kernel launches made by ``mt_sweep`` (incremented where a launch is made).
LAUNCHES = 0
#: Triangle rows per padded chunk (tpurt's _TRI_CHUNK; the kernel stages
#: this many rows through shared memory at a time).
TRI_CHUNK = 256


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


def mt_sweep_plain(ro: torch.Tensor, rd: torch.Tensor, tri_rows: torch.Tensor,
                   cull_flags: torch.Tensor, tri_count: int):
    """The kernel's function in torch: (best t (R,), best row (R,) int32,
    -1 on a miss)."""
    t, col = exact_sweep(v3lib.from_rows(ro), v3lib.from_rows(rd),
                         tri_rows[:tri_count], cull_flags[:tri_count, 0] != 0.0)
    return t, torch.where(t < float("inf"), col, -1).to(torch.int32)


def _lib():
    from tpurt_torch import _build

    lib = _build.load("mt_sweep")
    if not getattr(lib, "_tpurt_ready", False):
        vp = ctypes.c_void_p
        lib.tpurt_mt_sweep_launch.argtypes = [vp, vp, vp, vp, ctypes.c_int,
                                              ctypes.c_int, vp, vp, vp]
        lib.tpurt_mt_sweep_launch.restype = ctypes.c_int
        lib._tpurt_ready = True
    return lib


def mt_sweep(ro: torch.Tensor, rd: torch.Tensor, tri_rows: torch.Tensor,
             cull_flags: torch.Tensor, tri_count: int):
    """Closest accepted hit of rays ro, rd (R, 3) f32 against the first
    ``tri_count`` of ``tri_rows`` (T_pad, 18) f32 (pa pb pc na nb nc),
    backfaces culled where ``cull_flags`` (T_pad, 1) f32 is nonzero.
    Returns (t (R,) f32, inf on a miss; row (R,) int32, -1 on a miss)."""
    global LAUNCHES
    if ro.device.type == "cpu":
        return mt_sweep_plain(ro, rd, tri_rows, cull_flags, tri_count)
    if ro.device.type != "cuda":
        raise ValueError(f"mt_sweep runs on CPU or CUDA tensors, got {ro.device}")
    r = ro.shape[0]
    for name, a, shape in (("ro", ro, (r, 3)), ("rd", rd, (r, 3)),
                           ("tri_rows", tri_rows, (tri_rows.shape[0], 18)),
                           ("cull_flags", cull_flags, (tri_rows.shape[0], 1))):
        if (a.device != ro.device or a.dtype != torch.float32
                or tuple(a.shape) != shape or not a.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous f32 {shape} tensor "
                             f"on {ro.device}")
    if not 0 <= tri_count <= tri_rows.shape[0] or tri_rows.shape[0] % TRI_CHUNK:
        raise ValueError(f"tri_count {tri_count} / rows {tri_rows.shape[0]}: "
                         f"rows must be padded to {TRI_CHUNK}")
    t = torch.empty(r, dtype=torch.float32, device=ro.device)
    idx = torch.empty(r, dtype=torch.int32, device=ro.device)
    lib = _lib()
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    with torch.cuda.device(ro.device):
        stream = torch.cuda.current_stream(ro.device).cuda_stream
        err = lib.tpurt_mt_sweep_launch(
            ptr(ro), ptr(rd), ptr(tri_rows), ptr(cull_flags), r, int(tri_count),
            ptr(t), ptr(idx), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"mt_sweep launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, idx
