"""Wrapper of the Hopper megakernel (csrc/megakernel.cu).

The kernel replaces tpurt/render/mega_pallas.py:make_pallas_body (the
fused Pallas loop body, ``pallas_call`` at mega_pallas.py:237) together
with the XLA row gather that fed it (megakernel.py:2050-2074): one CUDA
thread per lane runs the whole persistent lane loop, loading its own
bank row each trip with 128-bit loads. The words the traversal step
touches every trip stay in registers; the others live in rows of the
block's dynamic shared memory (the dense instantiation: in registers),
copied from the state buffer when a thread takes a lane and back when
it retires it; the traversal stack is a ring in that shared memory too
(``shared_stack_bytes``), or for budgets above ``MAX_SHARED_STACK``
words in a global scratch buffer (``deep_stack``). The grid is as many
blocks as stay resident with that shared memory; a thread whose lane
retires takes the next from a queue (a counter this wrapper zeroes). The
source's header says what bounds it on the card and why one thread per
lane.

``run`` is the loop's entry point, which ``megakernel.run_megakernel``
calls for the "cuda" backend: on a lane buffer or a CUDA lane state it
launches the kernel — one launch per call, counted in ``LAUNCHES`` — and
it raises ValueError for a CPU lane state (the plain loop is
``megakernel.run_plain``). Its tables are the context's
(``megakernel.scene_tables``, the slot tables of ``megakernel.prepare``).
A brute-force context (``ctx.tables.dense`` set, RenderConfig.mega_dense)
launches the kernel's dense instantiation, whose traversal step is
kernel B2's sweep (render/plucker_fused.py); those launches are counted
in ``DENSE_LAUNCHES``. A TLAS scene (``ctx.tlas``) and a bf16 bank
(``ctx.bf16``) launch the instantiations compiled for them, and a stack
budget above the kernel's ``kMaxSharedStack`` (``MAX_SHARED_STACK``)
words the one whose stacks live in a global scratch buffer (``kDeep``);
their launches count in ``LAUNCHES``. A cross-frame pack (``ctx.frames`` > 1)
runs in any of them: the kernel reads its slot pixels
(``ctx.slot_pix``) and periodic direction table where a lane advances;
a list quota (``ctx.pix_list``) reads its (P, R) slot pixels the same
way. A jittered context (``ctx.jitter``) launches the same
instantiations from the library built with jitter
(csrc/megakernel_jitter.cu), which computes each new sample's primary
ray in the kernel; those launches count in ``JITTER_LAUNCHES``.

Fresh lanes (``fresh``) are written on the card by a second kernel of
the same library, fresh_lanes, from the entry rays and pixels: the
buffer ``pack(megakernel._initial_lane(...))`` would give, word for
word, built by B1's own restart code; ``run`` takes that buffer without
a pack. Its launches count in ``FRESH_LAUNCHES``, not in the
megakernel's counters.

The lane state crosses the C boundary as one contiguous (n_words, R)
int32 buffer of ``lane_words`` words a lane: ``LANE_WORDS`` (the
kernel's ``enum Field``, word for word), then in the TLAS regime
``TLAS_WORDS`` (``enum TlasField``), then 3*P quota accumulators when
P > 1, then the S stack slots top first, then in a list quota the
lane's ``lane0`` (which the megakernel never reads or writes; fresh
lanes get theirs from fresh_lanes). Bools travel as 0/1 words, u32
fields as their bits, floats by bit view.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from tpurt_torch.core.camera import camera_scalars
from tpurt_torch.core.v3 import V3
from tpurt_torch.render import megakernel as mk
from tpurt_torch.scene.builder import MEGA_SLOT_BITS
from tpurt_torch.utils.profiling import count, host_read, span

#: Kernel launches made by ``launch`` (incremented where a launch is
#: made): the BVH instantiations, the dense one, and any instantiation of
#: the jitter library.
LAUNCHES = 0
DENSE_LAUNCHES = 0
JITTER_LAUNCHES = 0
#: Launches of the fresh-lanes kernel (``fresh``), in either library.
FRESH_LAUNCHES = 0

#: kMaxSharedStack in the kernel: a stack budget up to this many words a
#: lane is a ring in the block's dynamic shared memory; a deeper one
#: takes the kDeep instantiation (its rings in global scratch), which
#: ``launch`` names in MkCfg.deep (the kernel refuses a deeper budget
#: without it).
MAX_SHARED_STACK = 64
#: kSlotMask in the kernel: a stack entry keeps a node row's next child
#: slot in MEGA_SLOT_BITS (6) bits, so a row holds at most 63 children.
MAX_ARITY = (1 << MEGA_SLOT_BITS) - 1

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
#: in the TLAS regime all five; then in either the completion groups, the
#: segment completions a lane's thread counted as the lowest thread of
#: the group of its warp's threads that completed them together, so that
#: the row's sum is the launch's groups and the segments over it the
#: lanes a group (1 to 32).
WORK_ROWS = ("box tests", "leaf rows", "segments", "instance enters",
             "instance exits")
#: Counters of B1's own work a launch adds (``work_counts``): the sums
#: of its first three ``WORK_ROWS`` over the lanes, the trips the lanes
#: ran, the lanes times the most trips a lane ran (the lane-trip slots
#: of the launch, finished lanes' too), and the sum of the completion
#: groups (the last row).
WORK_COUNTERS = ("b1.box_tests", "b1.leaf_rows", "b1.segments",
                 "b1.lane_trips", "b1.lane_trip_slots", "b1.completion_warps")
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


class _JitterCfg(_Cfg):
    """struct MkCfg of the jitter library: the camera's scalars follow."""

    _fields_ = [("cam_pos", ctypes.c_float * 3), ("cam_rot", ctypes.c_float * 9),
                ("cam_tan", ctypes.c_float), ("cam_aspect", ctypes.c_float)]


class _FreshIn(ctypes.Structure):
    """struct FreshIn of the kernel."""

    _fields_ = [("ray", ctypes.c_void_p * 6), ("stride", ctypes.c_longlong * 6),
                ("pix", ctypes.c_void_p), ("pix_stride", ctypes.c_longlong),
                ("pix_bytes", ctypes.c_int), ("lane0", ctypes.c_int)]


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
    if lane.lane0 is not None:
        rows.append(_word(lane.lane0, "i"))
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
    if ctx.pix_list:
        vals["lane0"] = buf[k + ctx.s_depth]
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
    for name, kind in _FIELDS + _TLAS_FIELDS + [("lane0", "i")]:
        va, vb = getattr(a, name), getattr(b, name)
        if va is None or vb is None:
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


def _lib(jitter: bool = False):
    """The kernel's library: csrc/megakernel.cu, or its jitter build."""
    from tpurt_torch import _build

    lib = _build.load("megakernel_jitter" if jitter else "megakernel")
    if not getattr(lib, "_tpurt_ready", False):
        vp = ctypes.c_void_p
        lib.tpurt_mk_launch.argtypes = [ctypes.POINTER(_Cfg)] + [vp] * 16
        lib.tpurt_mk_launch.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.tpurt_mk_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ip, ip, ip, ip]
        lib.tpurt_mk_occupancy.restype = ctypes.c_int
        lib.tpurt_mk_fixed_words.argtypes = []
        lib.tpurt_mk_fixed_words.restype = ctypes.c_int
        lib.tpurt_mk_error_string.argtypes = [ctypes.c_int]
        lib.tpurt_mk_error_string.restype = ctypes.c_char_p
        lib.tpurt_mk_jitter.argtypes = []
        lib.tpurt_mk_jitter.restype = ctypes.c_int
        lib.tpurt_mk_fresh.argtypes = [ctypes.POINTER(_Cfg)] + [vp] * 5 + [
            ctypes.POINTER(_FreshIn), vp, vp]
        lib.tpurt_mk_fresh.restype = ctypes.c_int
        if lib.tpurt_mk_fixed_words() != len(LANE_WORDS) + len(TLAS_WORDS):
            raise RuntimeError("csrc/megakernel.cu enum Field / TlasField and "
                               "LANE_WORDS / TLAS_WORDS disagree")
        if lib.tpurt_mk_jitter() != int(jitter):
            raise RuntimeError("the megakernel library's jitter build is not "
                               "the one asked for")
        lib._tpurt_ready = True
    return lib


def _variant(dense: bool, tlas: bool, bf16: bool, deep: bool = False) -> int:
    """The kernel's instantiation as the C interface names it."""
    return int(dense) | int(tlas) << 1 | int(bf16) << 2 | int(deep) << 3


def deep_stack(ctx: mk._Ctx) -> bool:
    """Whether ``ctx`` launches the kDeep instantiation (stacks in global
    scratch): a BVH walk whose stack budget exceeds MAX_SHARED_STACK."""
    return ctx.tables.dense is None and ctx.s_depth > MAX_SHARED_STACK


def shared_stack_bytes(ctx: mk._Ctx, threads: int) -> int:
    """The dynamic shared memory a block of ``threads`` takes for its
    stack rings, s_depth words a thread; 0 where the stacks are in global
    scratch (``deep_stack``)."""
    return 0 if deep_stack(ctx) else 4 * ctx.s_depth * threads


def check_bank(ctx: mk._Ctx):
    """Raise ValueError for a bank shape the kernel cannot take, on the
    host before a launch: an illegal access on the card would poison the
    context for every later launch (an autotune sweep's legs too), where
    a ValueError leaves it usable. A node row above MAX_ARITY children,
    and a stack budget above MAX_SHARED_STACK outside the kDeep
    instantiation (which the dense sweep does not have)."""
    if not 2 <= ctx.arity <= MAX_ARITY:
        raise ValueError(f"node arity {ctx.arity}: the megakernel takes 2 to "
                         f"{MAX_ARITY} children a row")
    if ctx.s_depth > MAX_SHARED_STACK and not deep_stack(ctx):
        raise ValueError(f"a stack budget of {ctx.s_depth} words needs the "
                         "deep-stack instantiation, which the dense sweep "
                         "does not have")


def launch_config(dense: bool, device=None, tlas: bool = False,
                  bf16: bool = False, deep: bool = False,
                  jitter: bool = False, s_depth: int = 0) -> dict:
    """The persistent launch of one instantiation on ``device`` for a
    stack budget of ``s_depth`` words: threads a block, resident blocks
    per SM, SMs, the resident lanes, and a block's dynamic shared memory
    in bytes (its stack rings where not ``deep``, and in the BVH
    instantiations its lanes' cold words)."""
    lib = _lib(jitter)
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        err = lib.tpurt_mk_occupancy(_variant(dense, tlas, bf16, deep), int(s_depth),
                                     *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError("megakernel occupancy query failed: "
                           + lib.tpurt_mk_error_string(err).decode())
    threads, per_sm, sms, smem = (v.value for v in vals)
    return dict(threads=threads, blocks_per_sm=per_sm, sms=sms,
                resident_lanes=threads * per_sm * sms, smem_bytes=smem)


def lane_words(ctx: mk._Ctx) -> int:
    """Words a lane takes in the buffer: LANE_WORDS, TLAS_WORDS in the
    TLAS regime, 3*P quota accumulators where P > 1, the stack, and
    ``lane0`` in a list quota."""
    return (len(LANE_WORDS) + (len(TLAS_WORDS) if ctx.tlas else 0)
            + (3 * ctx.p_count if ctx.p_count > 1 else 0) + ctx.s_depth
            + int(ctx.pix_list))


def _launch_inputs(ctx: mk._Ctx, dev, r: int):
    """The launch configuration (``_launch_cfg``) of a launch of ``r``
    lanes on ``dev``, after raising ValueError for what such a launch
    cannot take: a jittered context without its camera, a bank shape the
    kernel refuses (``check_bank``), a bank that is not 16-byte rows of
    f32 on ``dev``."""
    if ctx.jitter and ctx.camera is None:
        raise ValueError("a jittered launch needs the context's camera")
    check_bank(ctx)
    rows = ctx.rows
    if rows.device != dev or rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError("row bank must be a contiguous f32 tensor on the buffer's device")
    if rows.data_ptr() % 16 or rows.shape[1] % 4:
        raise ValueError("the kernel reads bank rows as 16-byte words: the bank must "
                         "start 16-byte aligned and its rows be a multiple of 4 words")
    return _launch_cfg(ctx, r)


def _launch_cfg(ctx: mk._Ctx, r: int):
    """The launch configuration (struct MkCfg) of ``r`` lanes, its
    ``max_trips`` and, under jitter, the camera's scalars left for the
    megakernel's launch to set (fresh_lanes reads neither)."""
    return (_JitterCfg if ctx.jitter else _Cfg)(
        n_lanes=r, e_count=ctx.e_count, s_depth=ctx.s_depth,
        num_meshes=ctx.tables.mats.shape[0], n_static=len(ctx.tables.s_cull),
        max_bounces=ctx.max_bounces, rays_per_pixel=ctx.rays_per_pixel,
        seed_reference=int(ctx.seed_mode == "reference"),
        invisible_budget=ctx.invisible_budget, use_cache=int(ctx.use_cache),
        p_count=ctx.p_count, pixel_stride=ctx.pixel_stride, width=ctx.width,
        height=ctx.height, tail_passes=ctx.tail_passes,
        expand_passes=ctx.expand_passes, n_skip=ctx.n_skip,
        leaf_tris=ctx.leaf_tris, arity=ctx.arity, row_width=ctx.rows.shape[1],
        frame_index=ctx.frame_index, sample_offset=ctx.sample_offset,
        tlas=int(ctx.tlas), bf16=int(ctx.bf16), deep=int(deep_stack(ctx)),
        # A list quota takes the kernel's table advance as one frame of P
        # slots (frames = ppf = P: row pixno, no frame offset).
        frames=ctx.p_count if ctx.pix_list else ctx.frames,
        ppf=ctx.p_count if ctx.pix_list else ctx.ppf,
        rd_rows=0 if ctx.slot_rd is None else ctx.slot_rd.shape[1],
    )


def _check_buffer(buf: torch.Tensor, ctx: mk._Ctx):
    """Raise ValueError for a lane buffer the kernel cannot take."""
    if buf.device.type != "cuda":
        raise ValueError(f"the megakernel needs a CUDA buffer, got {buf.device}")
    if buf.dtype != torch.int32 or buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError("lane buffer must be a contiguous (n_words, R) int32 tensor")
    words = lane_words(ctx)
    if buf.shape[0] != words:
        raise ValueError(f"lane buffer has {buf.shape[0]} words per lane, "
                         f"not {words}")


def launch(buf: torch.Tensor, ctx: mk._Ctx, max_trips: Optional[int]):
    """Run the kernel in place on a packed CUDA lane buffer; returns the
    (R,) int32 trips each lane ran and the (4, R) int32 work of each
    lane in this launch (``WORK_ROWS``): child-box tests in node rows,
    leaf rows (dense: entry sweeps), segment completions, completion
    groups; in the TLAS regime (6, R), with instance enters and exits
    before the completion groups."""
    global LAUNCHES, DENSE_LAUNCHES, JITTER_LAUNCHES
    _check_buffer(buf, ctx)
    r = buf.shape[1]
    dev = buf.device
    cfg = _launch_inputs(ctx, dev, r)
    cfg.max_trips = 2 ** 31 - 1 if max_trips is None else int(max_trips)
    if ctx.jitter:  # the camera's scalars, for the kernel's jittered rays
        pos, rot, tan, aspect = camera_scalars(ctx.camera)
        cfg.cam_pos[:] = [float(v) for v in pos]
        cfg.cam_rot[:] = [float(v) for v in rot.reshape(9)]
        cfg.cam_tan, cfg.cam_aspect = float(tan), float(aspect)
    trips = torch.empty(r, dtype=torch.int32, device=dev)
    work = torch.empty((6 if ctx.tlas else 4, r), dtype=torch.int32, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    stack = torch.empty((ctx.s_depth, r) if cfg.deep else (1,),
                        dtype=torch.int32, device=dev)
    slot_rd, slot_pix = ctx.slot_rd, ctx.slot_pix
    if slot_rd is None:
        slot_rd = torch.zeros(1, dtype=torch.float32, device=dev)
    if slot_pix is None:
        slot_pix = torch.zeros(1, dtype=torch.int32, device=dev)
    dense = None
    if ctx.tables.dense is not None:
        from tpurt_torch.render.plucker_fused import check_table

        dense = check_table(ctx.tables.dense, dev)
    tabs = ctx.tables.kernel
    lib = _lib(ctx.jitter)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with span("tpurt.launch.call"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpurt_mk_launch(
            ctypes.byref(cfg), ptr(ctx.rows), ptr(tabs["chain"]),
            ptr(ctx.tables.mats), ptr(tabs["srows"]), ptr(tabs["roots_f"]),
            ptr(tabs["roots_i"]), ptr(tabs["meta"]), ptr(slot_rd), ptr(slot_pix),
            ptr(stack), ptr(buf), ptr(trips),
            ptr(work), ptr(queue),
            None if dense is None else ctypes.c_void_p(ctypes.addressof(dense)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError("megakernel launch failed: "
                           + lib.tpurt_mk_error_string(err).decode())
    if ctx.jitter:
        JITTER_LAUNCHES += 1
    elif dense is None:
        LAUNCHES += 1
    else:
        DENSE_LAUNCHES += 1
    return trips, work


def fresh(ctx: mk._Ctx, ro0: V3, rd0: V3, pix: torch.Tensor) -> torch.Tensor:
    """megakernel._initial_lane's lanes for entry rays ``ro0``, ``rd0``
    and pixel ids ``pix`` (int32 or int64, their low 32 bits), written
    packed -- the (n_words, R) buffer of ``pack``'s words, ``lane0`` too
    in a list quota -- by one launch of the library's fresh_lanes kernel,
    counted in ``FRESH_LAUNCHES``."""
    global FRESH_LAUNCHES
    dev = pix.device
    r = pix.shape[0]
    comps = list(ro0) + list(rd0)
    if dev.type != "cuda" or pix.dtype not in (torch.int32, torch.int64) or pix.dim() != 1:
        raise ValueError("fresh lanes need (R,) int32 or int64 pixel ids on a CUDA device")
    if any(c.device != dev or c.dtype != torch.float32 or c.shape != (r,) for c in comps):
        raise ValueError("fresh lanes need (R,) f32 ray components on the pixels' device")
    cfg = _launch_inputs(ctx, dev, r)
    tabs = ctx.tables.kernel
    buf = torch.empty((lane_words(ctx), r), dtype=torch.int32, device=dev)
    inp = _FreshIn(pix=pix.data_ptr(), pix_stride=pix.stride(0),
                   pix_bytes=pix.element_size(), lane0=int(ctx.pix_list))
    inp.ray[:] = [c.data_ptr() for c in comps]
    inp.stride[:] = [c.stride(0) for c in comps]
    lib = _lib(ctx.jitter)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.tpurt_mk_fresh(
            ctypes.byref(cfg), ptr(tabs["chain"]), ptr(tabs["srows"]),
            ptr(tabs["roots_f"]), ptr(tabs["roots_i"]), ptr(tabs["meta"]),
            ctypes.byref(inp), ptr(buf),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError("fresh lanes launch failed: "
                           + lib.tpurt_mk_error_string(err).decode())
    FRESH_LAUNCHES += 1
    return buf


def work_counts(trips: torch.Tensor, work: torch.Tensor) -> torch.Tensor:
    """(7,) int64 on the launch's device, from its (R,) ``trips`` and
    (4 or 6, R) ``work`` (R > 0): the most trips a lane ran, then the
    ``WORK_COUNTERS``' launch totals."""
    t = trips.to(torch.int64)
    top = t.max().view(1)
    sums = torch.cat([work[:3].to(torch.int64), t.view(1, -1)]).sum(1)
    groups = work[-1].to(torch.int64).sum().view(1)
    return torch.cat([top, sums, top * t.numel(), groups])


def run(lane, ctx: mk._Ctx, max_iterations: Optional[int]) -> mk._Lane:
    """The kernel's lane loop until every lane is done or
    ``max_iterations`` more trips ran, from the lane buffer ``fresh``
    wrote or from a lane state on the card (ValueError for one on the
    CPU, where the loop is megakernel.run_plain). The launch adds its
    ``WORK_COUNTERS``, read with its most trips in one host read."""
    if isinstance(lane, torch.Tensor):
        buf, iters = lane, 0
    else:
        if lane.done.device.type != "cuda":
            raise ValueError("mega_cuda.run takes lanes on a CUDA device; the "
                             "plain loop is megakernel.run_plain")
        with span("tpurt.launch.pack"):
            buf = pack(lane)
        iters = lane.iters
    trips, work = launch(buf, ctx, max_iterations)
    if trips.numel():
        top, *totals = host_read(work_counts(trips, work), "trips").tolist()
        iters += top
        for name, n in zip(WORK_COUNTERS, totals):
            count(name, n)
    with span("tpurt.launch.unpack"):
        return unpack(buf, ctx, iters)
