"""Wrapper of the Hopper megakernel (csrc/megakernel.cu).

The kernel replaces tpurt/render/mega_pallas.py:make_pallas_body (the
fused Pallas loop body, ``pallas_call`` at mega_pallas.py:237) together
with the XLA row gather that fed it (megakernel.py:2050-2074): one CUDA
thread per lane runs the whole persistent lane loop with its lane state
in registers, loading its own bank row each trip. The grid is as many
blocks as stay resident; a thread whose lane retires takes the next
from a queue (a counter this wrapper zeroes). The source's header says
what bounds it on the card and why one thread per lane.

``run`` is the one entry point. On a CUDA lane state it launches the
kernel — one launch per call, counted in ``LAUNCHES`` — or raises; on a
CPU lane state it runs the kernel's plain version,
``megakernel.run_plain``, because a CPU tensor is what it was given.
A brute-force context (``ctx.dense`` set, RenderConfig.mega_dense)
launches the kernel's dense instantiation, whose traversal step is
kernel B2's sweep (render/plucker_fused.py); those launches are counted
in ``DENSE_LAUNCHES``. A TLAS scene (``ctx.tlas``) and a bf16 bank
(``ctx.bf16``) launch the instantiations compiled for them, and a stack
budget above the kernel's ``kMaxStack`` (``MAX_REGISTER_STACK``) entries
the one whose stacks live in a global scratch buffer (``kDeep``); their
launches count in ``LAUNCHES``. A cross-frame pack (``ctx.frames`` > 1)
runs in any of them: the kernel reads its slot pixels
(``ctx.slot_pix``) and periodic direction table where a lane advances.

The lane state crosses the C boundary as one contiguous (n_words, R)
int32 buffer: ``LANE_WORDS`` (the kernel's ``enum Field``, word for
word), then in the TLAS regime ``TLAS_WORDS`` (``enum TlasField``), then
3*P quota accumulators when P > 1, then the S stack slots top first.
Bools travel as 0/1 words, u32 fields as their bits, floats by bit view.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

from tpurt_torch.core.v3 import V3
from tpurt_torch.render import megakernel as mk

#: Kernel launches made by ``launch`` (incremented where a launch is
#: made): the BVH instantiation and the dense one.
LAUNCHES = 0
DENSE_LAUNCHES = 0

#: kMaxStack in the kernel: deeper stacks take the kDeep instantiation,
#: which ``launch`` names in MkCfg.deep (the kernel refuses a deeper
#: budget without it).
MAX_REGISTER_STACK = 64

# (lane field, kind): kind f/i/u/b = f32 / i32 / u32 / bool; V3 fields
# list x, y, z. Expanded to LANE_WORDS below.
_FIELDS = [
    ("ro0", "v"), ("rd0", "v"), ("pix", "u"), ("pixno", "i"),
    ("sample", "i"), ("acc", "v"), ("rng", "u"), ("done", "b"),
    ("segments", "i"), ("origin", "v"), ("direction", "v"),
    ("throughput", "v"), ("light", "v"), ("bounces", "i"), ("invis", "i"),
    ("entry", "i"), ("cur", "i"), ("cur_leaf", "b"), ("cur_slot", "i"),
    ("lo", "v"), ("ld", "v"), ("lid", "v"), ("lt", "f"), ("lnrm", "v"),
    ("lback", "b"), ("lmesh", "i"), ("w_valid", "b"), ("w_dst", "f"),
    ("w_point", "v"), ("w_normal", "v"), ("w_back", "b"), ("w_mesh", "i"),
    ("c_set", "b"), ("c_valid", "b"), ("c_point", "v"), ("c_normal", "v"),
    ("c_back", "b"), ("c_mesh", "i"), ("c_dst", "f"),
]
#: One name per 32-bit word of the fixed part, in buffer order.
LANE_WORDS: List[str] = [
    w for name, kind in _FIELDS
    for w in ([f"{name}.{c}" for c in "xyz"] if kind == "v" else [name])
]
#: The TLAS regime's lane fields, one word each, after LANE_WORDS.
_TLAS_FIELDS = [("in_inst", "b"), ("cur_inst", "b"), ("inst_mesh", "i"),
                ("inst_scale", "f"), ("inst_cull", "b"), ("inst_os", "b")]
TLAS_WORDS: List[str] = [name for name, _kind in _TLAS_FIELDS]
#: Rows of the per-lane work count a launch returns: the first three, and
#: in the TLAS regime all five.
WORK_ROWS = ("box tests", "leaf rows", "segments", "instance enters",
             "instance exits")
_CACHE_FIELDS = ("c_set", "c_valid", "c_point", "c_normal", "c_back",
                 "c_mesh", "c_dst")


class _Cfg(ctypes.Structure):
    """struct MkCfg of the kernel."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "n_lanes", "max_trips", "e_count", "s_depth", "num_meshes",
        "n_static", "max_bounces", "rays_per_pixel", "seed_reference",
        "invisible_budget", "use_cache", "p_count", "pixel_stride", "width",
        "height", "tail_passes", "expand_passes", "n_skip", "leaf_tris",
        "arity", "row_width", "frame_index", "sample_offset", "tlas", "bf16",
        "deep", "frames", "ppf", "rd_rows",
    )]


def _word(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A lane field as int32 words (bits preserved)."""
    if kind == "f":
        return t.contiguous().view(torch.int32)
    if kind == "u":  # u32 value held in int64 -> the same 32 bits
        return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)
    return t.to(torch.int32)


def _unword(w: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "f":
        return w.view(torch.float32)
    if kind == "u":
        return w.to(torch.int64) & 0xFFFFFFFF
    if kind == "b":
        return w != 0
    return w


def pack(lane: mk._Lane) -> torch.Tensor:
    """Lane state -> (n_words, R) int32 buffer."""
    r = lane.done.shape[0]
    rows = []
    for name, kind in _FIELDS:
        val = getattr(lane, name)
        if val is None:  # cache fields when the cache is off
            val = V3(*([torch.zeros(r, device=lane.done.device)] * 3)) \
                if kind == "v" else torch.zeros(r, dtype=torch.int32,
                                                device=lane.done.device)
        if kind == "v":
            rows.extend(_word(c, "f") for c in val)
        else:
            rows.append(_word(val, kind))
    if lane.in_inst is not None:
        rows.extend(_word(getattr(lane, n), kind) for n, kind in _TLAS_FIELDS)
    for acc in lane.accs:
        rows.extend(_word(c, "f") for c in acc)
    rows.extend(_word(s, "u") for s in lane.stack)
    return torch.stack(rows).contiguous()


def unpack(buf: torch.Tensor, ctx: mk._Ctx, iters: int) -> mk._Lane:
    """(n_words, R) int32 buffer -> lane state."""
    vals = {}
    k = 0
    for name, kind in _FIELDS:
        if kind == "v":
            vals[name] = V3(*(_unword(buf[k + j], "f") for j in range(3)))
            k += 3
        else:
            vals[name] = _unword(buf[k], kind)
            k += 1
    if ctx.tlas:
        for name, kind in _TLAS_FIELDS:
            vals[name] = _unword(buf[k], kind)
            k += 1
    accs = []
    if ctx.p_count > 1:
        for _ in range(ctx.p_count):
            accs.append(V3(*(_unword(buf[k + j], "f") for j in range(3))))
            k += 3
    stack = tuple(_unword(buf[k + j], "u") for j in range(ctx.s_depth))
    if not ctx.use_cache:
        for name in _CACHE_FIELDS:
            vals[name] = None
    return mk._Lane(iters=iters, accs=tuple(accs), stack=stack, **vals)


def compare_lanes(a: mk._Lane, b: mk._Lane):
    """(fraction of lanes whose integer, u32 and bool fields — the stack
    included — all agree, largest |a - b| over the float fields of those
    lanes where both are finite)."""
    same = torch.ones_like(a.done)
    floats = []
    for name, kind in _FIELDS + _TLAS_FIELDS:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None:
            continue
        if kind in "vf":
            floats.extend(zip(va, vb) if kind == "v" else [(va, vb)])
        else:
            same &= va.to(torch.int64) == vb.to(torch.int64)
    for sa, sb in zip(a.stack, b.stack):
        same &= sa == sb
    for acc_a, acc_b in zip(a.accs, b.accs):
        floats.extend(zip(acc_a, acc_b))
    err = 0.0
    for fa, fb in floats:
        ok = same & torch.isfinite(fa) & torch.isfinite(fb)
        if ok.any():
            err = max(err, float((fa - fb).abs()[ok].max()))
    return float(same.float().mean()), err


def _tables(ctx: mk._Ctx, dev):
    """The kernel's small read-only tables, on ``dev``."""
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    p = ctx.params
    e = ctx.e_count
    arity = ctx.arity
    chain = p.table_np if e else np.zeros((1, mk.CP_WIDTH), np.float32)
    roots_f = p.roots_f if e and p.roots_f is not None else np.zeros(
        (max(e, 1), 1 + 6 * arity), np.float32)
    roots_i = p.roots_i if e and p.roots_i is not None else np.zeros(
        (max(e, 1), arity), np.int32)
    meta = np.concatenate([
        np.asarray(p.root if e else (), np.int32),
        np.asarray(p.root_leaf if e else (), np.int32),
        np.asarray(p.mesh if e else (), np.int32),
        np.asarray(p.expand if e else (), np.int32),
        np.asarray(ctx.s_cull, np.int32), np.asarray(ctx.s_onesided, np.int32),
        np.asarray(ctx.s_owner, np.int32),
        ctx.mesh_cull.cpu().numpy().astype(np.int32), np.zeros(1, np.int32),
    ]).astype(np.int32)
    if ctx.slot_rd is not None:
        slot_rd = torch.stack(list(ctx.slot_rd)).contiguous()  # (3, rows, R)
    else:
        slot_rd = torch.zeros(1, dtype=torch.float32, device=dev)
    if ctx.slot_pix is not None:
        slot_pix = _word(ctx.slot_pix, "u").contiguous()  # (ppf, R)
    else:
        slot_pix = torch.zeros(1, dtype=torch.int32, device=dev)
    srows = ctx.srows if len(ctx.srows) else np.zeros((1, 19), np.float32)
    return dict(
        chain=f32(chain), mats=ctx.mats.contiguous(), srows=f32(srows),
        roots_f=f32(roots_f),
        roots_i=torch.as_tensor(np.ascontiguousarray(roots_i, np.int32), device=dev),
        meta=torch.as_tensor(meta, device=dev), slot_rd=slot_rd,
        slot_pix=slot_pix,
    )


def _lib():
    from tpurt_torch import _build

    lib = _build.load("megakernel")
    if not getattr(lib, "_tpurt_ready", False):
        vp = ctypes.c_void_p
        lib.tpurt_mk_launch.argtypes = [ctypes.POINTER(_Cfg)] + [vp] * 16
        lib.tpurt_mk_launch.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.tpurt_mk_occupancy.argtypes = [ctypes.c_int, ip, ip, ip]
        lib.tpurt_mk_occupancy.restype = ctypes.c_int
        lib.tpurt_mk_fixed_words.argtypes = []
        lib.tpurt_mk_fixed_words.restype = ctypes.c_int
        lib.tpurt_mk_error_string.argtypes = [ctypes.c_int]
        lib.tpurt_mk_error_string.restype = ctypes.c_char_p
        if lib.tpurt_mk_fixed_words() != len(LANE_WORDS) + len(TLAS_WORDS):
            raise RuntimeError("csrc/megakernel.cu enum Field / TlasField and "
                               "LANE_WORDS / TLAS_WORDS disagree")
        lib._tpurt_ready = True
    return lib


def _variant(dense: bool, tlas: bool, bf16: bool, deep: bool = False) -> int:
    """The kernel's instantiation as the C interface names it."""
    return int(dense) | int(tlas) << 1 | int(bf16) << 2 | int(deep) << 3


def deep_stack(ctx: mk._Ctx) -> bool:
    """Whether ``ctx`` launches the kDeep instantiation (stacks in global
    scratch): a BVH walk whose stack budget exceeds MAX_REGISTER_STACK."""
    return ctx.dense is None and ctx.s_depth > MAX_REGISTER_STACK


def launch_config(dense: bool, device=None, tlas: bool = False,
                  bf16: bool = False, deep: bool = False) -> dict:
    """The persistent launch of one instantiation on ``device``: threads
    a block, resident blocks per SM, SMs, and the resident lanes."""
    lib = _lib()
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.tpurt_mk_occupancy(_variant(dense, tlas, bf16, deep),
                                     *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError("megakernel occupancy query failed: "
                           + lib.tpurt_mk_error_string(err).decode())
    threads, per_sm, sms = (v.value for v in vals)
    return dict(threads=threads, blocks_per_sm=per_sm, sms=sms,
                resident_lanes=threads * per_sm * sms)


def launch(buf: torch.Tensor, ctx: mk._Ctx, max_trips: Optional[int]):
    """Run the kernel in place on a packed CUDA lane buffer; returns the
    (R,) int32 trips each lane ran and the (3, R) int32 work of each
    lane in this launch (``WORK_ROWS``): child-box tests in node rows,
    leaf rows (dense: entry sweeps), segment completions; in the TLAS
    regime (5, R), with instance enters and exits."""
    global LAUNCHES, DENSE_LAUNCHES
    if buf.device.type != "cuda":
        raise ValueError(f"the megakernel needs a CUDA buffer, got {buf.device}")
    if buf.dtype != torch.int32 or buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError("lane buffer must be a contiguous (n_words, R) int32 tensor")
    r = buf.shape[1]
    acc_words = 3 * ctx.p_count if ctx.p_count > 1 else 0
    tlas_words = len(TLAS_WORDS) if ctx.tlas else 0
    if buf.shape[0] != len(LANE_WORDS) + tlas_words + acc_words + ctx.s_depth:
        raise ValueError(f"lane buffer has {buf.shape[0]} words per lane")
    rows = ctx.rows
    if rows.device != buf.device or rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("row bank must be a contiguous f32 tensor on the buffer's device")
    dev = buf.device
    # Freed when this returns, before the kernel ends: safe, because the
    # caching allocator reuses the memory only for later work on this
    # same stream.
    tabs = _tables(ctx, dev)
    trips = torch.empty(r, dtype=torch.int32, device=dev)
    work = torch.empty((5 if ctx.tlas else 3, r), dtype=torch.int32, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    deep = deep_stack(ctx)
    stack = torch.empty((ctx.s_depth, r) if deep else (1,),
                        dtype=torch.int32, device=dev)
    cfg = _Cfg(
        n_lanes=r, max_trips=2 ** 31 - 1 if max_trips is None else int(max_trips),
        e_count=ctx.e_count, s_depth=ctx.s_depth,
        num_meshes=ctx.mats.shape[0], n_static=len(ctx.s_cull),
        max_bounces=ctx.max_bounces, rays_per_pixel=ctx.rays_per_pixel,
        seed_reference=int(ctx.seed_mode == "reference"),
        invisible_budget=ctx.invisible_budget, use_cache=int(ctx.use_cache),
        p_count=ctx.p_count, pixel_stride=ctx.pixel_stride, width=ctx.width,
        height=ctx.height, tail_passes=ctx.tail_passes,
        expand_passes=ctx.expand_passes, n_skip=ctx.n_skip,
        leaf_tris=ctx.leaf_tris, arity=ctx.arity, row_width=rows.shape[1],
        frame_index=ctx.frame_index, sample_offset=ctx.sample_offset,
        tlas=int(ctx.tlas), bf16=int(ctx.bf16), deep=int(deep), frames=ctx.frames,
        ppf=ctx.ppf, rd_rows=0 if ctx.slot_rd is None else ctx.slot_rd.x.shape[0],
    )
    dense = None
    if ctx.dense is not None:
        from tpurt_torch.render.plucker_fused import check_table

        dense = check_table(ctx.dense, dev)
    lib = _lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpurt_mk_launch(
            ctypes.byref(cfg), ptr(rows), ptr(tabs["chain"]), ptr(tabs["mats"]),
            ptr(tabs["srows"]), ptr(tabs["roots_f"]), ptr(tabs["roots_i"]),
            ptr(tabs["meta"]), ptr(tabs["slot_rd"]), ptr(tabs["slot_pix"]),
            ptr(stack), ptr(buf), ptr(trips),
            ptr(work), ptr(queue),
            None if dense is None else ctypes.c_void_p(ctypes.addressof(dense)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError("megakernel launch failed: "
                           + lib.tpurt_mk_error_string(err).decode())
    if dense is None:
        LAUNCHES += 1
    else:
        DENSE_LAUNCHES += 1
    return trips, work


def run(lane: mk._Lane, ctx: mk._Ctx, max_iterations: Optional[int]) -> mk._Lane:
    """The lane loop until every lane is done or ``max_iterations`` more
    trips ran: the kernel for a CUDA lane state, its plain version
    (megakernel.run_plain) for a CPU one."""
    if lane.done.device.type == "cpu":
        return mk.run_plain(lane, ctx, max_iterations)
    buf = pack(lane)
    trips, _work = launch(buf, ctx, max_iterations)
    iters = lane.iters + int(trips.max()) if trips.numel() else lane.iters
    return unpack(buf, ctx, iters)
