"""Persistent-lane megakernel integrator: the plain PyTorch version, the
lane state both backends share, and ``run_megakernel`` (port of
tpurt/render/megakernel.py: the unrolled chain and the many-instance
(TLAS) regime, u8 and bf16 node bounds).

Each lane owns its whole task — pixel quota, sample loop, bounce loop,
mesh chain, BVH cursor — as a state machine, and one loop trip advances
every live lane by one step: traverse the lane's current bank row (node:
slab-test the children and push the nearest hits on a tagged stack;
leaf: exact Möller-Trumbore on the inline triangles), fold a finished
chain entry to world space, then ``tail_passes`` times shade ->
accumulate/advance -> restart -> inline static stage -> chain enter with
root pretest, chain skip and root expansion. ``_body_math`` below is
that trip as tensor ops over (R,) lanes — the same transcription as
tpurt's ``_body_math``, op for op and in the same association order,
minus the regimes not ported yet (jitter, list quotas).

Cross-frame packing (``frames_per_batch`` F > 1): a lane's P quota
slots span F frames of P/F slots each; slot k renders within-frame slot
k mod P/F of frame ``frame_index + k // (P/F)``, its pixel and primary
direction read from per-slot tables (``_Ctx.slot_pix``, ``slot_rd``)
because the lane has overwritten its slot-0 pixel and direction by the
time it reaches the next frame.

In the TLAS regime (``Scene.mega_tlas``) the instanced meshes are
instance rows under a top-level BVH reached through one ``-2`` chain
entry: a traversal step on an instance row enters it (the instance's
transform and root pretest, pushing an exit marker) or, once the marker
pops, exits it (the fold of the instance's best hit to world space and
the return to the world ray). Six lane fields (``in_inst`` ...
``inst_os``) carry the instance frame; they are None otherwise.

The brute-force mode (``dense=True``, RenderConfig.mega_dense) replaces
the traversal step: each trip resolves a lane's whole chain entry with
the dense Plücker sweep (render/plucker_fused.py) and recomputes the
winner exactly (``_dense_hit``); root expansion is off.

Two backends run the loop (``run_megakernel(body_backend=...)``):

  "plain"  this module: a Python loop of torch ops on any device. It is
           the parity anchor (held against tpurt's XLA body on the CPU).
  "cuda"   render/mega_cuda.py: csrc/megakernel.cu, one CUDA thread per
           lane running the whole loop in registers (its dense
           instantiation runs kernel B2's sweep in the traversal step).

Setup — lane init, primary rays, the quota slots' direction tables, the
chain and root tables — is plain torch on the scene's device and shared
by both. Differences from tpurt's array types: u32 lane fields (pix,
rng, stack entries) are int64 tensors holding values in [0, 2^32), and
``iters`` is a Python int.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

import tpurt_torch.config as _cfg
from tpurt_torch.config import EPSILON
from tpurt_torch.core import rng as rnglib
from tpurt_torch.core import v3 as v3lib
from tpurt_torch.core.camera import make_ray, pixel_uv
from tpurt_torch.core.v3 import V3
from tpurt_torch.core.vecmath import euler_rotation
from tpurt_torch.render.intersect import mt_core as _mt_core
from tpurt_torch.render.intersect import mt_rows
from tpurt_torch.render.shading import pack_materials, shade_hit_soa
from tpurt_torch.scene.builder import MEGA_ITAG, MEGA_SLOT_BITS
from tpurt_torch.scene.types import MaterialType, Scene

_F32 = torch.float32
_I32 = torch.int32
_INF = float("inf")
_EPS = float(np.float32(EPSILON))
_GROW = float(np.float32(1.001))  # pretest / traversal bound slack
_EMPTY = 0xFFFFFFFF  # empty stack slot
#: Stack-entry tag: set = a resolved child meta (target<<1 | is_leaf),
#: clear = a (row << SLOT_BITS | slot) parent resume.
_TAG = 0x80000000
_SLOT_MASK = (1 << MEGA_SLOT_BITS) - 1
#: TLAS regime: meta bit 28 marks an instance-row target in child slots
#: and resolved stack entries; on a resolved entry popped inside an
#: instance it is the exit marker. Targets stay below 2^27.
_ITAG = MEGA_ITAG
_META_T = MEGA_ITAG - 1  # meta target bits: target << 1 | is_leaf
_HI16 = 0xFFFF0000  # bf16 bounds: the top half of a word

# Packed chain-parameter table columns (tpurt's (E, 21) layout).
_CP_POS = 0  # 3 columns
_CP_ROT = 3  # 9 columns, row-major: rot[i][j] at 3 + 3*i + j
_CP_SCALE = 12
_CP_OS = 13  # one_sided as 0.0/1.0
_CP_CULL = 14  # backface-cull policy as 0.0/1.0
_CP_RMIN = 15  # 3 columns
_CP_RMAX = 18  # 3 columns
CP_WIDTH = 21


class _Lane(NamedTuple):
    iters: int  # loop trips executed so far
    ro0: V3  # primary origin
    rd0: V3  # primary direction of the current quota pixel
    pix: torch.Tensor  # (R,) u32 (int64) current pixel
    pixno: torch.Tensor  # (R,) i32 index of the current pixel in the quota
    sample: torch.Tensor  # (R,) i32
    acc: V3  # current pixel's radiance accumulator
    accs: Tuple[V3, ...]  # per-quota-slot results (empty at quota 1)
    rng: torch.Tensor  # (R,) u32 (int64)
    done: torch.Tensor  # (R,) bool
    segments: torch.Tensor  # (R,) i32
    origin: V3
    direction: V3
    throughput: V3
    light: V3
    bounces: torch.Tensor  # (R,) i32
    invis: torch.Tensor  # (R,) i32
    entry: torch.Tensor  # (R,) i32 in [0, E]; E == shading stage
    cur: torch.Tensor  # (R,) i32 row; -1 = entry exhausted
    cur_leaf: torch.Tensor  # (R,) bool
    cur_slot: torch.Tensor  # (R,) i32 first child priority to consider
    stack: Tuple[torch.Tensor, ...]  # S x (R,) u32 (int64), top first
    lo: V3  # local ray
    ld: V3
    lid: V3
    lt: torch.Tensor  # (R,) local best distance
    lnrm: V3
    lback: torch.Tensor
    lmesh: torch.Tensor
    w_valid: torch.Tensor  # world-space best across the chain
    w_dst: torch.Tensor
    w_point: V3
    w_normal: V3
    w_back: torch.Tensor
    w_mesh: torch.Tensor
    c_set: Optional[torch.Tensor] = None  # primary-hit cache (None when off)
    c_valid: Optional[torch.Tensor] = None
    c_point: Optional[V3] = None
    c_normal: Optional[V3] = None
    c_back: Optional[torch.Tensor] = None
    c_mesh: Optional[torch.Tensor] = None
    c_dst: Optional[torch.Tensor] = None
    # TLAS regime only (None otherwise)
    in_inst: Optional[torch.Tensor] = None  # (R,) bool inside an instance
    cur_inst: Optional[torch.Tensor] = None  # (R,) bool cur is an instance row
    inst_mesh: Optional[torch.Tensor] = None  # (R,) i32 owner, set at enter
    inst_scale: Optional[torch.Tensor] = None  # (R,) f32 (1.0 outside)
    inst_cull: Optional[torch.Tensor] = None  # (R,) bool backface-cull policy
    inst_os: Optional[torch.Tensor] = None  # (R,) bool OneSided at exit


class _ChainParams(NamedTuple):
    """Per-entry transform/material constants: the packed (E, 21) f32
    table (as a tensor and as host numpy), static root targets, and the
    root-expansion tables (None when no entry expands)."""

    table: torch.Tensor  # (E, CP_WIDTH) f32
    table_np: np.ndarray
    root: Tuple[int, ...]
    root_leaf: Tuple[bool, ...]
    mesh: Tuple[int, ...]  # -1 = fused static entry
    root_t: torch.Tensor  # the three tuples above as (E,) tensors
    root_leaf_t: torch.Tensor
    mesh_t: torch.Tensor
    roots_f: Optional[np.ndarray] = None  # (E, 1 + 6*arity) f32
    roots_i: Optional[np.ndarray] = None  # (E, arity) i32
    expand: Tuple[bool, ...] = ()


class _Ctx(NamedTuple):
    """Loop invariants of one run_megakernel call (both backends)."""

    rows: torch.Tensor  # (N, W) f32 bank
    rows_i: torch.Tensor  # the same bits as i32
    srows: np.ndarray  # (S, 19) f32 static triangle rows
    s_cull: Tuple[bool, ...]
    s_onesided: Tuple[bool, ...]
    s_owner: Tuple[int, ...]
    mats: torch.Tensor  # (K, 11)
    mesh_cull: torch.Tensor  # (K,) bool backface-cull policy per mesh
    params: Optional[_ChainParams]
    # Quota slots' primary directions: (P-1, R), row k-1 for slot k; in a
    # cross-frame pack (n, R), row (k-1) % n for slot k (see prepare).
    slot_rd: Optional[V3]
    frame_index: int
    sample_offset: int
    e_count: int
    s_depth: int
    max_bounces: int
    rays_per_pixel: int
    seed_mode: str
    invisible_budget: int
    use_cache: bool
    p_count: int
    pixel_stride: int
    width: int
    height: int
    tail_passes: int
    expand_passes: int
    n_skip: int
    leaf_tris: int
    arity: int
    dense: Optional["DenseTable"] = None  # the brute-force sweep's table
    tlas: bool = False  # the many-instance regime (Scene.mega_tlas)
    bf16: bool = False  # bf16 node-row child bounds
    # (mesh -> slot, slot -> representative mesh) as (K,) and (U,) i32
    # tensors: the shade fetch's material slots (TLAS regime).
    mat_slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    # Cross-frame packing: frames in the pack, slots a frame (P / frames)
    # and the (ppf, R) int64 pixel of each within-frame slot.
    frames: int = 1
    ppf: int = 1
    slot_pix: Optional[torch.Tensor] = None


def _cull_policy(mt: int) -> bool:
    return mt not in (int(MaterialType.GLASSY), int(MaterialType.INVISIBLE),
                      int(MaterialType.ONE_SIDED))


def _chain_params(scene: Scene) -> _ChainParams:
    """tpurt's _chain_params on the host, in numpy float32."""
    rows = []
    mesh_pos = scene.mesh_pos.cpu().numpy()
    angles = [t.cpu().numpy() for t in
              (scene.mesh_pitch, scene.mesh_yaw, scene.mesh_roll)]
    mesh_scale = scene.mesh_scale.cpu().numpy()
    mat_type = scene.mat_type.cpu().numpy()
    qmin = scene.mesh_qmin.cpu().numpy()
    qscale = scene.mesh_qscale.cpu().numpy()
    for mesh_idx, _root, _leaf in scene.mega_chain:
        if mesh_idx == -2:  # TLAS entry: identity transform, the union of
            # the instances' world boxes as its pretest box
            rows.append(np.array(
                [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0,
                 1.0, 0.0, 1.0, *scene.mega_tlas_bounds], np.float32))
            continue
        if mesh_idx < 0:  # fused static entry: identity transform
            rows.append(np.array(
                [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0,
                 1.0, 0.0, 1.0, -_INF, -_INF, -_INF, _INF, _INF, _INF],
                np.float32))
            continue
        i = mesh_idx
        rot = euler_rotation(angles[0][i], angles[1][i], angles[2][i])
        mt = int(mat_type[i])
        rmin = qmin[i]
        rmax = qmin[i] + np.float32(65535.0) * qscale[i]
        rows.append(np.concatenate([
            mesh_pos[i], rot.reshape(9),
            np.array([mesh_scale[i], float(mt == int(MaterialType.ONE_SIDED)),
                      float(_cull_policy(mt))], np.float32),
            rmin, rmax,
        ]).astype(np.float32))
    chain = scene.mega_chain
    # A TLAS root holds ITAG-tagged instance metas, which the expansion
    # does not decode: it is entered through its root row.
    expand = tuple(
        bool(_cfg.MEGA_ROOT_EXPAND) and len(chain) <= _cfg.MEGA_ROOT_EXPAND_MAX_E
        and not leaf and m != -2
        for m, _r, leaf in chain
    )
    table = np.stack(rows)
    roots_f = roots_i = None
    if any(expand):
        roots_f, roots_i = _root_tables(scene, [r for _, r, _ in chain], expand)
    dev = scene.device
    root = tuple(r for _, r, _ in chain)
    root_leaf = tuple(bool(l) for _, _, l in chain)
    mesh = tuple(m for m, _, _ in chain)
    return _ChainParams(
        table=torch.from_numpy(table).to(dev), table_np=table,
        root=root, root_leaf=root_leaf, mesh=mesh,
        root_t=torch.tensor(root, dtype=_I32, device=dev),
        root_leaf_t=torch.tensor(root_leaf, dtype=torch.bool, device=dev),
        mesh_t=torch.tensor(mesh, dtype=_I32, device=dev),
        roots_f=roots_f, roots_i=roots_i, expand=expand,
    )


def _bf16_halves(w0, w1, w2):
    """A bf16 child slot's three words (u32 values held in a wider
    integer type) -> the six f32 bit patterns bmin.xyz, bmax.xyz: each
    word holds two bf16 values, decoded as the top half of an f32 with a
    zero low half (tpurt's shift/mask decode)."""
    return [h for w in (w0, w1, w2) for h in ((w << 16) & _HI16, w & _HI16)]


def _root_tables(scene: Scene, chain_roots, expand):
    """Each expanded entry's root-node test inputs: the sort axis, the
    per-slot child bounds DECODED as the in-loop decode computes them
    (u8: ``grid_o + q * grid_s`` in f32; bf16: the word halves as f32
    top halves), and the child metas."""
    arity = scene.mega_arity
    roots = scene.mega_rows[list(chain_roots)].cpu().numpy()  # just these rows
    bf16 = scene.mega_bounds_fmt == "bf16"
    f_rows, i_rows = [], []
    for e in range(len(chain_roots)):
        if not expand[e]:
            f_rows.append(np.zeros(1 + 6 * arity, np.float32))
            i_rows.append(np.zeros(arity, np.int32))
            continue
        row = roots[e]
        bits, ints = row.view(np.uint32), row.view(np.int32)
        grid_o, grid_s = row[0:3], row[3:6]
        cols = [np.float32(ints[6])]
        metas = []
        for slot in range(arity):
            if bf16:
                base = 7 + 4 * slot
                metas.append(ints[base + 3])
                cols.extend(np.array(
                    _bf16_halves(*bits[base:base + 3].astype(np.uint64)),
                    np.uint64).astype(np.uint32).view(np.float32))
                continue
            base = 7 + 3 * slot
            w0, w1 = bits[base], bits[base + 1]
            metas.append(ints[base + 2])
            q_lo = np.array([w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255],
                            np.float32)
            q_hi = np.array([(w0 >> 24) & 255, w1 & 255, (w1 >> 8) & 255],
                            np.float32)
            cols.extend(grid_o + q_lo * grid_s)
            cols.extend(grid_o + q_hi * grid_s)
        f_rows.append(np.array(cols, np.float32))
        i_rows.append(np.array(metas, np.int32))
    return np.stack(f_rows), np.stack(i_rows)


# ---------------------------------------------------------------------------
# Per-lane pieces (tensor transcriptions of tpurt's)
# ---------------------------------------------------------------------------


def _tab_v3(tab, ec, col: int) -> V3:
    return V3(tab[ec, col], tab[ec, col + 1], tab[ec, col + 2])


def _rot_fwd(tab, ec, v: V3) -> V3:
    """out_i = sum_j rot[i][j] * v_j, summed j = 0, 1, 2."""
    return V3(*[
        tab[ec, _CP_ROT + 3 * i] * v.x + tab[ec, _CP_ROT + 3 * i + 1] * v.y
        + tab[ec, _CP_ROT + 3 * i + 2] * v.z
        for i in range(3)
    ])


def _rot_t(tab, ec, v: V3) -> V3:
    """out_i = sum_j rot[j][i] * v_j."""
    return V3(*[
        tab[ec, _CP_ROT + i] * v.x + tab[ec, _CP_ROT + 3 + i] * v.y
        + tab[ec, _CP_ROT + 6 + i] * v.z
        for i in range(3)
    ])


def _safe(scale):
    return torch.where(torch.abs(scale) > _EPS, scale, 1.0)


def _enter(ctx: _Ctx, entry, origin: V3, direction: V3):
    """WorldToLocalRay (Trace.cl:118-137) for each lane's chain entry."""
    p = ctx.params
    ec = torch.clamp_max(entry, ctx.e_count - 1).long()
    tab = p.table
    safe = _safe(tab[ec, _CP_SCALE])
    lo = _rot_t(tab, ec, origin - _tab_v3(tab, ec, _CP_POS)) / safe
    ld = v3lib.normalize(_rot_t(tab, ec, direction) / safe)
    return (lo, ld, V3(1.0 / ld.x, 1.0 / ld.y, 1.0 / ld.z), p.root_t[ec],
            p.root_leaf_t[ec])


def _static_tri(srow: np.ndarray):
    """A static triangle row as f32 Python scalars (pa, e1, e2, na, nb,
    nc), the edge vectors subtracted in f32."""
    r = srow.astype(np.float32)
    v = lambda b: r[b:b + 3]
    f = lambda a: V3(*(float(x) for x in a))
    return (f(v(0)), f(v(3) - v(0)), f(v(6) - v(0)), f(v(9)), f(v(12)),
            f(v(15)))


def _static_stage(ctx: _Ctx, enabled, origin: V3, direction: V3):
    """Dense MT of the inline static triangles for lanes with a fresh
    ray -> the seeded world-space best (valid, dst, point, normal, back,
    mesh). Candidates fold in order with strict <."""
    zeros = torch.zeros_like(enabled, dtype=_F32)
    zero3 = V3(zeros, zeros, zeros)
    falses = torch.zeros_like(enabled)
    if len(ctx.s_cull) == 0:
        return (falses, zeros + _INF, zero3, zero3, falses,
                torch.full_like(enabled, -1, dtype=_I32))
    ld = v3lib.normalize(direction)
    lt = zeros + _INF
    lnrm = zero3
    lback = falses
    lmesh = torch.full_like(enabled, -1, dtype=_I32)
    for s_idx in range(len(ctx.s_cull)):
        pa, e1, e2, na, nb, nc = _static_tri(ctx.srows[s_idx])
        ok, t, n, backface = _mt_core(origin, ld, pa, e1, e2, na, nb, nc,
                                      bool(ctx.s_cull[s_idx]))
        if ctx.s_onesided[s_idx]:
            ok &= ~backface
        win = enabled & ok & (t < lt)
        lt = torch.where(win, t, lt)
        lnrm = v3lib.where(win, n, lnrm)
        lback = torch.where(win, backface, lback)
        lmesh = torch.where(win, int(ctx.s_owner[s_idx]), lmesh)
    valid = enabled & (lmesh >= 0)
    point = origin + ld * lt
    n_w = v3lib.normalize(lnrm)
    dst = v3lib.length(point - origin)
    return (
        valid,
        torch.where(valid, dst, _INF),
        v3lib.where(valid, point, zero3),
        v3lib.where(valid, n_w, zero3),
        valid & lback,
        torch.where(valid, lmesh, -1),
    )


def _aabb_soa(lo: V3, lid: V3, bmin: V3, bmax: V3, limit):
    """Slab test with a distance bound; NaN slabs (0 * inf) are open."""
    t0 = (bmin - lo) * lid
    t1 = (bmax - lo) * lid
    sx, sy, sz = (torch.nan_to_num(torch.minimum(a, b), nan=-_INF,
                                   posinf=_INF, neginf=-_INF)
                  for a, b in zip(t0, t1))
    bx, by, bz = (torch.nan_to_num(torch.maximum(a, b), nan=_INF,
                                   posinf=_INF, neginf=-_INF)
                  for a, b in zip(t0, t1))
    tmin = torch.maximum(torch.maximum(sx, sy), sz)
    tmax = torch.minimum(torch.minimum(bx, by), bz)
    return (tmax >= torch.clamp_min(tmin, 0.0)) & (tmin < limit)


def _pretest(ctx: _Ctx, entry, lo: V3, lid: V3, w_dst):
    """Root pretest: slab the entry's local root box against the bound."""
    tab = ctx.params.table
    ec = torch.clamp_max(entry, ctx.e_count - 1).long()
    safe = _safe(tab[ec, _CP_SCALE])
    return _aabb_soa(lo, lid, _tab_v3(tab, ec, _CP_RMIN),
                     _tab_v3(tab, ec, _CP_RMAX), w_dst / safe * _GROW)


def _two_best(hit, prio, meta, best):
    """Two-best child tracking: a new best demotes the old best."""
    best_prio, first_meta, second_prio, second_meta, hit_count = best
    better = hit & (prio < best_prio)
    second = hit & ~better & (prio < second_prio)
    second_prio = torch.where(better, best_prio,
                              torch.where(second, prio, second_prio))
    second_meta = torch.where(better, first_meta,
                              torch.where(second, meta, second_meta))
    best_prio = torch.where(better, prio, best_prio)
    first_meta = torch.where(better, meta, first_meta)
    return (best_prio, first_meta, second_prio, second_meta,
            hit_count + hit.to(_I32))


def _expand_root(ctx: _Ctx, e: int, mask, lo: V3, ld: V3, lid: V3, lt, w_dst,
                 cur, cur_leaf, stack):
    """Entry ``e``'s root-node test at enter time from the precomputed
    tables: descend straight to the first hit child and push the second
    child / parent resume exactly as the node step would."""
    p = ctx.params
    arity = ctx.arity
    rf, ri = p.roots_f[e], p.roots_i[e]
    scale = float(p.table_np[e, _CP_SCALE])
    safe = scale if abs(scale) > _EPS else 1.0
    limit = torch.minimum(lt, w_dst / safe * _GROW)
    axis = float(rf[0])
    dcomp = ld.x if axis == 0.0 else (ld.y if axis == 1.0 else ld.z)
    fwd = dcomp >= 0.0
    zeros_i = torch.zeros_like(cur)
    best = (zeros_i + arity, zeros_i, zeros_i + arity, zeros_i, zeros_i)
    for slot in range(arity):
        meta = int(ri[slot])
        if meta == 0:  # empty slot: never hits
            continue
        b = 1 + 6 * slot
        bmin = V3(*(float(x) for x in rf[b:b + 3]))
        bmax = V3(*(float(x) for x in rf[b + 3:b + 6]))
        hit = _aabb_soa(lo, lid, bmin, bmax, limit)
        prio = torch.where(fwd, slot, arity - 1 - slot).to(_I32)
        best = _two_best(hit, prio, zeros_i + meta, best)
    best_prio, first_meta, second_prio, second_meta, hit_count = best
    desc = mask & (best_prio < arity)
    push_child = desc & (hit_count >= 2)
    push_resume = desc & (hit_count >= 3)
    resume_entry = (p.root[e] << MEGA_SLOT_BITS) | (second_prio + 1).long()
    child_entry = _TAG | second_meta.long()
    cur = torch.where(desc, first_meta >> 1, torch.where(mask, -1, cur))
    cur_leaf = torch.where(desc, (first_meta & 1) == 1, cur_leaf & ~mask)
    # Entering lanes hold an empty stack (restart resets it; a chain
    # advance happens only once the previous entry's stack drained).
    return cur, cur_leaf, (
        torch.where(push_child, child_entry, stack[0]),
        torch.where(push_resume, resume_entry, stack[1]),
    ) + tuple(stack[2:])


def _seed(ctx: _Ctx, pix, sample_u, f_off=0):
    """The lane's seed; ``f_off`` is its quota slot's frame offset in a
    cross-frame pack (a tensor or 0)."""
    frame = ctx.frame_index + f_off
    if ctx.seed_mode == "reference":
        return rnglib.make_seed(pix, frame, 0)
    return rnglib.make_seed(pix, frame,
                            (sample_u + ctx.sample_offset) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# One loop trip
# ---------------------------------------------------------------------------


class _Inst(NamedTuple):
    """A trip's instance-row step (TLAS regime): enter and exit lanes and
    what each needs (tpurt _body_math's instance branch)."""

    on: torch.Tensor  # the lane's row is an instance row
    enter_ok: torch.Tensor  # entering: pretest passed, scale not degenerate
    skip: torch.Tensor  # entering, but the instance is skipped
    exit: torch.Tensor  # the exit marker brought the lane back
    lo: V3  # the instance's local ray (enter)
    ld: V3
    lid: V3
    mesh: torch.Tensor  # owner mesh, flags and root meta of the row
    scale: torch.Tensor
    flags: torch.Tensor
    rootmeta: torch.Tensor
    fold: torch.Tensor  # exit lanes whose local best folds to world space
    point: V3  # that best in world space
    normal: V3
    dst: torch.Tensor


def _f32_of_u32(v):
    """int64 tensor of u32 bit patterns -> f32 tensor of those bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(_I32).view(_F32)


def _instance_step(s: _Lane, ctx: _Ctx, trav, col, coli) -> _Inst:
    """An instance row read by the lane (builder.MEGA_INST_ROW_WORDS):
    enter = WorldToLocalRay with the baked transform, in _enter's op
    order, then the root pretest (a degenerate scale skips the instance,
    Trace.cl:448-449); exit = LocalToWorldHit of the local best, in the
    fold's op order (Trace.cl:139-156)."""
    on = trav & s.cur_inst
    enter, leave = on & ~s.in_inst, on & s.in_inst

    def rot_t(v: V3) -> V3:  # out_i = sum_j rot[j][i] * v_j
        return V3(*(col(3 + i) * v.x + col(6 + i) * v.y + col(9 + i) * v.z
                    for i in range(3)))

    def rot_f(v: V3) -> V3:  # out_i = sum_j rot[i][j] * v_j
        return V3(*(col(3 + 3 * i) * v.x + col(4 + 3 * i) * v.y
                    + col(5 + 3 * i) * v.z for i in range(3)))

    pos = V3(col(0), col(1), col(2))
    scale = col(12)
    safe = _safe(scale)
    lo = rot_t(s.origin - pos) / safe
    ld = v3lib.normalize(rot_t(s.direction) / safe)
    lid = V3(1.0 / ld.x, 1.0 / ld.y, 1.0 / ld.z)
    pre = _aabb_soa(lo, lid, V3(col(16), col(17), col(18)),
                    V3(col(19), col(20), col(21)), s.w_dst / safe * _GROW)
    ok = pre & (scale > _EPS)
    point = rot_f((s.lo + s.ld * s.lt) * scale) + pos
    point_dst = v3lib.length(point - s.origin)
    return _Inst(
        on=on, enter_ok=enter & ok, skip=enter & ~ok, exit=leave, lo=lo,
        ld=ld, lid=lid, mesh=coli(14), scale=scale, flags=coli(13),
        rootmeta=coli(15),
        fold=leave & (s.lmesh >= 0) & ~(s.inst_os & s.lback),
        point=point, normal=v3lib.normalize(rot_f(s.lnrm)), dst=point_dst,
    )


def _traverse(s: _Lane, ctx: _Ctx):
    """The trip's traversal step (one bank row per lane) and the chain
    fold of entries that finished. Returns the post-traversal lane and
    the in_chain mask (lanes that advanced to another chain entry)."""
    e_count = ctx.e_count
    p = ctx.params
    tab = p.table
    tlas = ctx.tlas
    trav = ~s.done & (s.entry < e_count) & (s.cur >= 0)
    ec = torch.clamp_max(s.entry, e_count - 1).long()
    idx = torch.where(trav, s.cur, 0).long()
    row, row_i = ctx.rows[idx], ctx.rows_i[idx]
    col = lambda j: row[:, j]
    coli = lambda j: row_i[:, j]
    scale_e = tab[ec, _CP_SCALE]
    if tlas:  # the lane's current frame: the instance's inside one
        scale_e = torch.where(s.in_inst, s.inst_scale, scale_e)
    limit = torch.minimum(s.lt, s.w_dst / _safe(scale_e) * _GROW)
    inst = _instance_step(s, ctx, trav, col, coli) if tlas else None

    # --- leaf branch: inline exact MT tests ---------------------------
    leaf_on = trav & s.cur_leaf
    entry_mesh = p.mesh_t[ec]
    is_static = entry_mesh < 0
    cull_mesh_e = tab[ec, _CP_CULL] != 0.0
    k_meshes = ctx.mesh_cull.shape[0]
    lt, lnrm, lback, lmesh = s.lt, s.lnrm, s.lback, s.lmesh
    for k in range(ctx.leaf_tris):
        b = 19 * k
        aux = coli(b + 18)
        owner_cull = torch.where(
            (aux >= 0) & (aux < k_meshes),
            ctx.mesh_cull[torch.clamp(aux, 0, k_meshes - 1).long()], True)
        cull = torch.where(is_static, owner_cull, cull_mesh_e)
        cand_mesh = torch.where(is_static, aux, entry_mesh)
        if tlas:  # inside an instance, its own policy and owner
            cull = torch.where(s.in_inst, s.inst_cull, cull)
            cand_mesh = torch.where(s.in_inst, s.inst_mesh, cand_mesh)
        cv = lambda j: V3(col(j), col(j + 1), col(j + 2))
        pa = cv(b)
        ok, t, n, backface = _mt_core(s.lo, s.ld, pa, cv(b + 3) - pa,
                                      cv(b + 6) - pa, cv(b + 9), cv(b + 12),
                                      cv(b + 15), cull)
        win = leaf_on & ok & (t < lt)
        lt = torch.where(win, t, lt)
        lnrm = v3lib.where(win, n, lnrm)
        lback = torch.where(win, backface, lback)
        lmesh = torch.where(win, cand_mesh, lmesh)

    # --- node branch: arity quantised children, nearest first ---------
    node_on = trav & ~s.cur_leaf
    if tlas:  # instance rows are not node rows
        node_on &= ~s.cur_inst
    grid_o = V3(col(0), col(1), col(2))
    grid_s = V3(col(3), col(4), col(5))
    sort_axis = coli(6)
    dcomp = torch.where(sort_axis == 0, s.ld.x,
                        torch.where(sort_axis == 1, s.ld.y, s.ld.z))
    fwd = dcomp >= 0.0
    arity = ctx.arity
    zeros_i = torch.zeros_like(s.cur)
    best = (zeros_i + arity, zeros_i, zeros_i + arity, zeros_i, zeros_i)
    b2f = lambda w: w.to(_F32)
    for slot in range(arity):
        if ctx.bf16:  # absolute bounds, two bf16 a word
            base = 7 + 4 * slot
            meta = coli(base + 3)
            h = [_f32_of_u32(x) for x in _bf16_halves(
                *(coli(base + j).long() & 0xFFFFFFFF for j in range(3)))]
            bmin, bmax = V3(*h[:3]), V3(*h[3:])
        else:  # u8 on the node's grid
            base = 7 + 3 * slot
            w0, w1, meta = coli(base), coli(base + 1), coli(base + 2)
            q_lo = V3(b2f(w0 & 255), b2f((w0 >> 8) & 255),
                      b2f((w0 >> 16) & 255))
            q_hi = V3(b2f((w0 >> 24) & 255), b2f(w1 & 255),
                      b2f((w1 >> 8) & 255))
            bmin, bmax = grid_o + q_lo * grid_s, grid_o + q_hi * grid_s
        hit = _aabb_soa(s.lo, s.lid, bmin, bmax, limit)
        prio = torch.where(fwd, slot, arity - 1 - slot).to(_I32)
        hit &= (meta != 0) & (prio >= s.cur_slot)
        best = _two_best(hit, prio, meta, best)
    best_prio, first_meta, second_prio, second_meta, hit_count = best

    first_found = best_prio < arity
    descend = node_on & first_found
    # The 2nd-nearest hit child is pushed RESOLVED (tag set); a (row,
    # slot) resume entry only when a third hit child exists.
    push_child = descend & (hit_count >= 2)
    push_resume = descend & (hit_count >= 3)
    pop = (node_on & ~first_found) | leaf_on
    resume_entry = ((torch.where(trav, s.cur, 0).long() << MEGA_SLOT_BITS)
                    | (second_prio + 1).long())
    child_entry = _TAG | second_meta.long()
    if tlas:
        # A passing enter pushes the exit marker (a resolved entry that
        # targets this instance row); a skipped enter or an exit pops.
        marker = _TAG | _ITAG | (torch.where(inst.on, s.cur, 0).long() << 1)
        child_entry = torch.where(inst.enter_ok, marker, child_entry)
        push_child = push_child | inst.enter_ok
        pop = pop | inst.skip | inst.exit
    top = s.stack[0]
    top_empty = top == _EMPTY
    pop_shift = pop & ~top_empty
    s_depth = ctx.s_depth
    empty = torch.full_like(top, _EMPTY)
    stack1 = [
        torch.where(push_resume, s.stack[i - 1] if i > 0 else resume_entry,
                    torch.where(pop_shift,
                                s.stack[i + 1] if i + 1 < s_depth else empty,
                                s.stack[i]))
        for i in range(s_depth)
    ]
    stack = tuple(
        torch.where(push_child, stack1[i - 1] if i > 0 else child_entry,
                    stack1[i])
        for i in range(s_depth)
    )
    # Targets are below 2^27, so masking the meta's ITAG bit changes
    # nothing outside the TLAS regime.
    cur = torch.where(descend, (first_meta & _META_T) >> 1, s.cur)
    cur_leaf = torch.where(descend, (first_meta & 1) == 1, s.cur_leaf)
    cur_slot = torch.where(descend, 0, s.cur_slot)
    resume = pop & ~top_empty
    top_resolved = (top & _TAG) != 0
    top_meta = top & 0x7FFFFFFF
    cur_popped = torch.where(top_resolved, (top_meta & _META_T) >> 1,
                             top >> MEGA_SLOT_BITS).to(_I32)
    slot_popped = torch.where(top_resolved, 0, top & _SLOT_MASK).to(_I32)
    cur = torch.where(resume, cur_popped, cur)
    cur_slot = torch.where(resume, slot_popped, cur_slot)
    cur_leaf = torch.where(resume, top_resolved & ((top_meta & 1) == 1),
                           cur_leaf)
    cur = torch.where(pop & top_empty, -1, cur)
    if not tlas:
        return _fold(s, ctx, ec, scale_e, lt, lnrm, lback, lmesh, cur,
                     cur_leaf, cur_slot, stack)

    # Instance enter (descend to the mesh root in the instance's frame)
    # and exit (fold its best hit into the world best, then back to the
    # world ray, recomputed with _enter's exact ops).
    ok = inst.enter_ok
    cur = torch.where(ok, (inst.rootmeta & _META_T) >> 1, cur)
    cur_leaf = torch.where(ok, (inst.rootmeta & 1) == 1, cur_leaf)
    cur_slot = torch.where(ok, 0, cur_slot)
    cur_inst = torch.where(descend, (first_meta & _ITAG) != 0, s.cur_inst)
    cur_inst = torch.where(resume, top_resolved & ((top_meta & _ITAG) != 0),
                           cur_inst)
    cur_inst = cur_inst & ~ok & ~(pop & top_empty)
    lo_w, ld_w, lid_w, _root, _leaf = _enter(ctx, s.entry, s.origin,
                                             s.direction)
    closer = inst.fold & (inst.dst < s.w_dst)
    base = s._replace(
        w_valid=s.w_valid | closer,
        w_dst=torch.where(closer, inst.dst, s.w_dst),
        w_point=v3lib.where(closer, inst.point, s.w_point),
        w_normal=v3lib.where(closer, inst.normal, s.w_normal),
        w_back=torch.where(closer, s.lback, s.w_back),
        w_mesh=torch.where(closer, s.lmesh, s.w_mesh),
    )
    out = inst.exit
    zeros = torch.zeros_like(lt)
    t, in_chain = _fold(
        base, ctx, ec, scale_e, torch.where(out, _INF, lt),
        v3lib.where(out, V3(zeros, zeros, zeros), lnrm), lback & ~out,
        torch.where(out, -1, lmesh), cur, cur_leaf, cur_slot, stack)
    frame = lambda a, b, c: v3lib.where(ok, a, v3lib.where(out, b, c))
    return t._replace(
        lo=frame(inst.lo, lo_w, s.lo), ld=frame(inst.ld, ld_w, s.ld),
        lid=frame(inst.lid, lid_w, s.lid), cur_inst=cur_inst,
        in_inst=(s.in_inst | ok) & ~out,
        inst_mesh=torch.where(ok, inst.mesh, s.inst_mesh),
        inst_scale=torch.where(ok, inst.scale, s.inst_scale),
        inst_cull=torch.where(ok, (inst.flags & 2) != 0, s.inst_cull),
        inst_os=torch.where(ok, (inst.flags & 1) != 0, s.inst_os),
    ), in_chain


def _dense_hit(s: _Lane, ctx: _Ctx, ec):
    """Brute-force traversal step: the plain dense sweep of the lane's
    whole entry, then the exact MT recompute of the winner -> (t, normal,
    backface, mesh or -1). Acceptance and t come from the sweep, shading
    data from the exact test (tpurt's _dense_hit, Trace.cl:276-317)."""
    from tpurt_torch.render.plucker_fused import sweep_plain

    table = ctx.dense
    t_sw, col = sweep_plain(s.lo, s.ld, ec, table)
    cc = torch.clamp_min(col, 0)
    ok, _t, n, back = mt_rows(s.lo, s.ld, table.rows[cc], table.cull[cc] != 0.0)
    return t_sw, n, back, torch.where((col >= 0) & ok, table.owner[cc], -1)


def _traverse_dense(s: _Lane, ctx: _Ctx):
    """The dense trip's traversal step: every traversing lane adopts its
    entry's winner and finishes the entry (cur = -1), then the fold."""
    e_count = ctx.e_count
    trav = ~s.done & (s.entry < e_count) & (s.cur >= 0)
    ec = torch.clamp_max(s.entry, e_count - 1).long()
    d_t, d_nrm, d_back, d_mesh = _dense_hit(s, ctx, ec)
    return _fold(
        s, ctx, ec, ctx.params.table[ec, _CP_SCALE],
        torch.where(trav, d_t, s.lt), v3lib.where(trav, d_nrm, s.lnrm),
        torch.where(trav, d_back, s.lback), torch.where(trav, d_mesh, s.lmesh),
        torch.where(trav, -1, s.cur), s.cur_leaf, s.cur_slot, s.stack)


def _fold(s: _Lane, ctx: _Ctx, ec, scale_e, lt, lnrm, lback, lmesh, cur,
          cur_leaf, cur_slot, stack):
    """Next mesh: fold entries that finished (cur < 0) to world space and
    advance them. Returns the lane and the in_chain mask."""
    e_count = ctx.e_count
    tab = ctx.params.table
    fin = ~s.done & (s.entry < e_count) & (cur < 0)
    lvalid = fin & (lmesh >= 0)
    lvalid &= ~((tab[ec, _CP_OS] != 0.0) & lback)
    lvalid &= scale_e > _EPS
    point_l = s.lo + s.ld * lt
    point_w = _rot_fwd(tab, ec, point_l * scale_e) + _tab_v3(tab, ec, _CP_POS)
    n_w = v3lib.normalize(_rot_fwd(tab, ec, lnrm))
    dst = v3lib.length(point_w - s.origin)
    closer = lvalid & (dst < s.w_dst)
    entry = torch.where(fin, s.entry + 1, s.entry)
    zeros = torch.zeros_like(lt)
    t = s._replace(
        entry=entry, cur=cur, cur_leaf=cur_leaf, cur_slot=cur_slot,
        stack=stack,
        lt=torch.where(fin, _INF, lt),
        lnrm=v3lib.where(fin, V3(zeros, zeros, zeros), lnrm),
        lback=lback & ~fin,
        lmesh=torch.where(fin, -1, lmesh),
        w_valid=torch.where(fin, s.w_valid | closer, s.w_valid),
        w_dst=torch.where(closer, dst, s.w_dst),
        w_point=v3lib.where(closer, point_w, s.w_point),
        w_normal=v3lib.where(closer, n_w, s.w_normal),
        w_back=torch.where(closer, lback, s.w_back),
        w_mesh=torch.where(closer, lmesh, s.w_mesh),
    )
    return t, fin & (entry < e_count)


def _tail(t: _Lane, ctx: _Ctx, entering_in, do_expand: bool) -> _Lane:
    """Segment completion: shade -> accumulate/advance -> restart ->
    static stage -> chain enter (pretest, chain skip, root expansion).
    Lanes not at the shading stage pass through unchanged, so running it
    again completes segments that need no traversal."""
    e_count, p_count = ctx.e_count, ctx.p_count
    shade = ~t.done & (t.entry >= e_count)
    segments = t.segments + shade.to(_I32)
    res = shade_hit_soa(
        ctx.mats, shade, t.w_valid, t.w_point, t.w_normal, t.w_back,
        t.w_mesh, t.origin, t.direction, t.throughput, t.light, t.rng,
        t.bounces, ctx.max_bounces, mat_slots=ctx.mat_slots,
    )
    invis = t.invis + (shade & res.invisible).to(_I32)
    continuing = res.continuing & ~(res.invisible & (invis > ctx.invisible_budget))

    opt = {}
    if ctx.use_cache:  # primary-hit cache store (sample 0, bounce 0)
        store = shade & ~t.c_set & (t.bounces == 0) & (t.sample == 0)
        opt = dict(
            c_set=t.c_set | store,
            c_valid=torch.where(store, t.w_valid, t.c_valid),
            c_point=v3lib.where(store, t.w_point, t.c_point),
            c_normal=v3lib.where(store, t.w_normal, t.c_normal),
            c_back=torch.where(store, t.w_back, t.c_back),
            c_mesh=torch.where(store, t.w_mesh, t.c_mesh),
            c_dst=torch.where(store, t.w_dst, t.c_dst),
        )

    cont = shade & continuing
    path_end = shade & ~continuing
    acc = t.acc + V3(*(torch.where(path_end, c, 0.0) for c in res.light))
    sample = t.sample + path_end.to(_I32)
    pix_done = path_end & (sample >= ctx.rays_per_pixel)
    if p_count > 1:
        # Quota mode: a finished pixel banks into its slot and the lane
        # advances to its next quota pixel (stride = pixel_stride).
        last_pix = t.pixno >= (p_count - 1)
        retire = pix_done & last_pix
        advance = pix_done & ~last_pix
        accs = tuple(
            V3(*(torch.where(pix_done & (t.pixno == k), a, b)
                 for a, b in zip(acc, t.accs[k])))
            for k in range(p_count)
        )
        acc = V3(*(torch.where(pix_done, 0.0, c) for c in acc))
        pixno = t.pixno + advance.to(_I32)
        if ctx.frames > 1:
            # Cross-frame pack: the slot's pixel from the within-frame
            # table, its direction from the periodic table, its frame
            # offset into the seed.
            kk = (pixno % ctx.ppf).long()[None]
            adv_pix = torch.gather(ctx.slot_pix, 0, kk)[0]
            k = ((pixno - 1).clamp_min(0) % ctx.slot_rd.x.shape[0]).long()[None]
            f_off = (pixno // ctx.ppf).long()
        else:
            adv_pix = torch.clamp_max(t.pix + ctx.pixel_stride,
                                      ctx.width * ctx.height - 1)
            k = (pixno - 1).clamp(0, p_count - 2).long()[None]
            f_off = 0
        pix = torch.where(advance, adv_pix, t.pix)
        sample = torch.where(pix_done, 0, sample)
        # The new pixel's precomputed primary direction (slot pixno).
        rd_n = V3(*(torch.gather(c, 0, k)[0] for c in ctx.slot_rd))
        rd0 = v3lib.where(advance, rd_n, t.rd0)
    else:
        retire = pix_done
        advance = torch.zeros_like(pix_done)
        accs, pixno, pix, rd0 = t.accs, t.pixno, t.pix, t.rd0
        f_off = 0
    done = t.done | retire
    new_sample = path_end & ~retire

    ro0 = t.ro0
    rng = res.rng
    if ctx.seed_mode != "reference":
        rng = torch.where(new_sample, _seed(ctx, pix, sample.long(), f_off),
                          rng)
    elif p_count > 1:
        # Reference mode draws one seed per PIXEL (the stream runs across
        # its samples, Trace.cl:632-641): re-seed on advance only.
        rng = torch.where(advance, _seed(ctx, pix, 0, f_off), rng)

    origin = v3lib.where(new_sample, ro0, res.origin)
    direction = v3lib.where(new_sample, rd0, res.direction)
    throughput = V3(*(torch.where(new_sample, 1.0, c) for c in res.throughput))
    light = V3(*(torch.where(new_sample, 0.0, c) for c in res.light))
    bounces = torch.where(new_sample, 0, res.bounces)
    invis = torch.where(new_sample, 0, invis)

    # Cached primary replay: new samples with a cache skip the chain (a
    # quota advance invalidates the cache — it belongs to the old pixel).
    if ctx.use_cache:
        opt["c_set"] = opt["c_set"] & ~advance
        replay = new_sample & opt["c_set"]
    else:
        replay = torch.zeros_like(new_sample)
    restart = cont | (new_sample & ~replay)
    entry = torch.where(restart, 0, t.entry)
    stack = tuple(torch.where(restart, _EMPTY, a) for a in t.stack)

    # World-best reset + static stage + cached replay (before entering,
    # so the root pretest sees the seeded w_dst).
    sv, sd, sp, sn, sb, sm = _static_stage(ctx, restart, origin, direction)
    w_valid = torch.where(restart, sv, t.w_valid & ~shade)
    w_dst = torch.where(restart, sd, torch.where(shade, _INF, t.w_dst))
    w_point = v3lib.where(restart, sp, t.w_point)
    w_normal = v3lib.where(restart, sn, t.w_normal)
    w_back = torch.where(restart, sb, t.w_back)
    w_mesh = torch.where(restart, sm, torch.where(shade, -1, t.w_mesh))
    if ctx.use_cache:
        entry = torch.where(replay, e_count, entry)
        w_valid = torch.where(replay, opt["c_valid"], w_valid)
        w_dst = torch.where(replay, opt["c_dst"], w_dst)
        w_point = v3lib.where(replay, opt["c_point"], w_point)
        w_normal = v3lib.where(replay, opt["c_normal"], w_normal)
        w_back = torch.where(replay, opt["c_back"], w_back)
        w_mesh = torch.where(replay, opt["c_mesh"], w_mesh)

    cur, cur_leaf, cur_slot = t.cur, t.cur_leaf, t.cur_slot
    lo, ld, lid = t.lo, t.ld, t.lid
    if e_count:
        entering = entering_in | restart
        lo_e, ld_e, lid_e, root_e, leaf_e = _enter(ctx, entry, origin, direction)
        ok_e = _pretest(ctx, entry, lo_e, lid_e, w_dst)
        # Chain skip: a failed pretest advances the entry in place, up to
        # n_skip more entries in this pass.
        cur_e = entry
        pend = entering & ~ok_e
        for _ in range(ctx.n_skip):
            cur_e = torch.where(pend, cur_e + 1, cur_e)
            valid2 = pend & (cur_e < e_count)
            lo3, ld3, lid3, root3, leaf3 = _enter(ctx, cur_e, origin, direction)
            ok3 = _pretest(ctx, cur_e, lo3, lid3, w_dst)
            lo_e = v3lib.where(valid2, lo3, lo_e)
            ld_e = v3lib.where(valid2, ld3, ld_e)
            lid_e = v3lib.where(valid2, lid3, lid_e)
            root_e = torch.where(valid2, root3, root_e)
            leaf_e = torch.where(valid2, leaf3, leaf_e)
            ok_e = torch.where(valid2, ok3, ok_e)
            pend = valid2 & ~ok3
        # A failure at the last entry leaves the lane shade-ready now.
        cur_e = torch.where(pend & (cur_e == e_count - 1), cur_e + 1, cur_e)
        entry = torch.where(entering, cur_e, entry)
        lo = v3lib.where(entering, lo_e, lo)
        ld = v3lib.where(entering, ld_e, ld)
        lid = v3lib.where(entering, lid_e, lid)
        cur = torch.where(entering, torch.where(ok_e, root_e, -1), cur)
        cur_leaf = torch.where(entering, leaf_e & ok_e, cur_leaf)
        cur_slot = torch.where(entering, 0, cur_slot)
        for e_x in range(e_count):
            if not do_expand:
                break
            if ctx.params.expand[e_x]:
                cur, cur_leaf, stack = _expand_root(
                    ctx, e_x, entering & ok_e & (entry == e_x), lo, ld, lid,
                    t.lt, w_dst, cur, cur_leaf, stack,
                )
        if ctx.tlas:
            # An entering lane starts at the entry's root (a node row) in
            # the world frame.
            opt.update(cur_inst=t.cur_inst & ~entering,
                         in_inst=t.in_inst & ~entering)

    return t._replace(
        ro0=ro0, rd0=rd0, pix=pix, pixno=pixno, sample=sample, acc=acc,
        accs=accs, rng=rng, done=done, segments=segments, origin=origin,
        direction=direction, throughput=throughput, light=light,
        bounces=bounces, invis=invis, entry=entry, cur=cur,
        cur_leaf=cur_leaf, cur_slot=cur_slot, stack=stack, lo=lo, ld=ld,
        lid=lid, w_valid=w_valid, w_dst=w_dst, w_point=w_point,
        w_normal=w_normal, w_back=w_back, w_mesh=w_mesh, **opt,
    )


def _body_math(s: _Lane, ctx: _Ctx) -> _Lane:
    """One loop trip (tpurt _body_math): traversal, fold, then the tail
    ``tail_passes`` times. Does not advance ``iters``."""
    if ctx.e_count:
        step = _traverse if ctx.dense is None else _traverse_dense
        t, in_chain = step(s, ctx)
    else:
        t, in_chain = s, torch.zeros_like(s.done)
    t = _tail(t, ctx, in_chain, do_expand=ctx.expand_passes >= 1)
    no_lanes = torch.zeros_like(s.done)
    for p in range(1, ctx.tail_passes):
        t = _tail(t, ctx, no_lanes, do_expand=p < ctx.expand_passes)
    return t


def stack_entries(lane: _Lane) -> torch.Tensor:
    """(R,) int64: the traversal stack entries each lane holds."""
    return sum((s != _EMPTY).long() for s in lane.stack)


def run_plain(lane: _Lane, ctx: _Ctx, max_iterations: Optional[int]) -> _Lane:
    """The loop as torch ops: trips until every lane is done or
    ``max_iterations`` more trips ran."""
    cap = None if max_iterations is None else lane.iters + int(max_iterations)
    while bool((~lane.done).any()) and (cap is None or lane.iters < cap):
        lane = _body_math(lane, ctx)._replace(iters=lane.iters + 1)
    return lane


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def run_megakernel(
    scene: Scene,
    ro0,  # (R, 3) primary origins (or V3)
    rd0,  # (R, 3) primary directions (or V3)
    pixel_index: torch.Tensor,  # (R,) pixel ids
    frame_index: int,
    rays_per_pixel: int,
    max_bounces: int,
    seed_mode: str,
    invisible_budget: int,
    sample_offset: int = 0,
    subpixel_jitter: bool = False,
    camera=None,
    width: int = 0,
    height: int = 0,
    initial_state: Optional[_Lane] = None,
    max_iterations: Optional[int] = None,
    return_state: bool = False,
    body_backend: str = "plain",
    pixels_per_lane: int = 1,
    pixel_stride: Optional[int] = None,
    tail_passes: int = 1,
    dense: bool = False,
    pixel_list=None,
    frames_per_batch: int = 1,
    cameras=None,
):
    """Returns (mean radiance (R*pixels_per_lane, 3), exact path segment
    count (int), loop trips) — or the raw lane state when
    ``return_state``. Semantics as tpurt's run_megakernel: with
    ``pixels_per_lane`` P > 1 lane i renders pixels pix[i] + k*stride
    (stride defaults to R) and radiance row k*R+i is its quota slot k.

    ``frames_per_batch`` F > 1 packs F frames into the launch: slot k
    covers frame ``frame_index + k // (P/F)`` at pixel pix + (k mod
    P/F)*stride (clamped to the frame), its primary direction from
    ``cameras[k // (P/F)]`` (a per-frame Camera tuple; None = ``camera``
    for every frame, whose slots share one frame's direction table).
    Radiance rows for frame f are [f*(P/F)*R, (f+1)*(P/F)*R), each
    bitwise what rendering that frame alone gives. The cameras must
    share a position (origins are not slotted); jitter, list quotas and
    ``initial_state`` are refused, as tpurt refuses them.

    ``body_backend``: "plain" (this module's torch loop, any device) or
    "cuda" (render/mega_cuda.py). ``dense``: the brute-force mode (a
    scene without chain entries has nothing to sweep and runs the
    ordinary loop). ``max_iterations`` caps the trips run
    from ``initial_state`` (or from the fresh lanes), which is how the
    two backends and tpurt are held against each other trip by trip.
    """
    if subpixel_jitter:
        _unsupported("subpixel_jitter", "A.4")
    if pixel_list is not None:
        _unsupported("pixel_list (list-quota mode)", "A.4")
    frames_per_batch = max(1, int(frames_per_batch))
    if frames_per_batch > 1:
        if pixels_per_lane % frames_per_batch:
            raise ValueError("pixels_per_lane must split evenly over "
                             "frames_per_batch")
        if initial_state is not None:
            raise ValueError("cross-frame packing: a resumed lane state "
                             "is not taken (tpurt refuses it too)")
        if cameras is not None and len(cameras) != frames_per_batch:
            raise ValueError("cameras: one per packed frame")
    if body_backend not in ("plain", "cuda"):
        raise ValueError(f"unknown body_backend: {body_backend!r}")
    if max_bounces <= 0 and not return_state:
        r = ro0.x.shape[0] if isinstance(ro0, V3) else ro0.shape[0]
        return (torch.zeros((r * pixels_per_lane, 3), dtype=_F32,
                            device=scene.device), 0, 0)
    lane, ctx = prepare(
        scene, ro0, rd0, pixel_index, frame_index, rays_per_pixel,
        max_bounces, seed_mode, invisible_budget, sample_offset, camera,
        width, height, pixels_per_lane, pixel_stride, tail_passes, dense,
        frames_per_batch, cameras,
    )
    if initial_state is not None:
        lane = initial_state
    if body_backend == "cuda":
        from tpurt_torch.render import mega_cuda

        final = mega_cuda.run(lane, ctx, max_iterations)
    else:
        final = run_plain(lane, ctx, max_iterations)
    if return_state:
        return final
    return finish(final, ctx)


def prepare(scene: Scene, ro0, rd0, pixel_index, frame_index: int,
            rays_per_pixel: int, max_bounces: int, seed_mode: str,
            invisible_budget: int, sample_offset: int = 0, camera=None,
            width: int = 0, height: int = 0, pixels_per_lane: int = 1,
            pixel_stride: Optional[int] = None, tail_passes: int = 1,
            dense: bool = False, frames_per_batch: int = 1, cameras=None):
    """The shared setup of both backends -> (fresh lane state, loop
    invariants): chain and root tables (the dense sweep's table in
    brute-force mode, where no root expands), quota slot directions (and
    in a cross-frame pack the within-frame slot pixels), and lanes seeded
    by the static stage and entered at chain entry 0."""
    if not isinstance(ro0, V3):
        ro0 = v3lib.from_rows(ro0)
    if not isinstance(rd0, V3):
        rd0 = v3lib.from_rows(rd0)
    dev = scene.device
    r = ro0.x.shape[0]
    p_count = int(pixels_per_lane)
    e_count = len(scene.mega_chain)
    params = _chain_params(scene) if e_count else None
    table = None
    if dense and e_count:
        from tpurt_torch.render.plucker_fused import build_dense_table

        # Dense mode never walks rows: cur >= 0 only flags an entry for
        # the sweep, so no root expands (tpurt: megakernel.py:1499-1501).
        params = params._replace(expand=(False,) * e_count, roots_f=None,
                                 roots_i=None)
        table = build_dense_table(scene)
    use_cache = rays_per_pixel > 1
    tlas = bool(scene.mega_tlas)
    if tlas and dense:
        raise ValueError(
            "dense (brute-force) mode walks chain entries per mesh; freeze "
            "TLAS scenes with MEGA_TLAS_THRESHOLD above the instance count "
            "to use it")
    mat_slots = None
    if tlas and scene.mesh_mat_slot:
        mat_slots = tuple(torch.tensor(v, dtype=_I32, device=dev) for v in (
            scene.mesh_mat_slot, scene.mat_slot_rep))
    mat_type = scene.mat_type.cpu().numpy()
    stride = r if pixel_stride is None else int(pixel_stride)
    ctx = _Ctx(
        rows=scene.mega_rows, rows_i=scene.mega_rows.view(_I32),
        srows=scene.mega_static_rows.cpu().numpy(),
        s_cull=scene.mega_static_cull, s_onesided=scene.mega_static_onesided,
        s_owner=scene.mega_static_owner,
        mats=pack_materials(scene),
        mesh_cull=torch.tensor([_cull_policy(int(m)) for m in mat_type],
                               dtype=torch.bool, device=dev),
        params=params, slot_rd=None,
        frame_index=int(frame_index), sample_offset=int(sample_offset),
        e_count=e_count, s_depth=2 * scene.mega_stack_depth,
        max_bounces=int(max_bounces), rays_per_pixel=int(rays_per_pixel),
        seed_mode=seed_mode, invisible_budget=int(invisible_budget),
        use_cache=use_cache, p_count=p_count, pixel_stride=stride,
        width=int(width), height=int(height),
        tail_passes=max(1, int(tail_passes)),
        expand_passes=int(_cfg.MEGA_EXPAND_PASSES),
        n_skip=(min(e_count - 1, _cfg.MEGA_SKIP_CAP)
                if e_count <= _cfg.SELECT_GATHER_THRESHOLD else 0),
        leaf_tris=scene.mega_leaf_tris, arity=scene.mega_arity, dense=table,
        tlas=tlas, bf16=scene.mega_bounds_fmt == "bf16", mat_slots=mat_slots,
    )

    if p_count > 1:
        # Quota slots' primary directions, from the same pixel_uv +
        # make_ray chain as the entry rays.
        pi0 = pixel_index.to(torch.int64)
        frames = max(1, int(frames_per_batch))
        ppf = p_count // frames

        def slot_pixel(kk):
            return torch.clamp_max(pi0 + kk * stride, width * height - 1)

        def slot_dir(pk, cam):
            return make_ray(cam, pixel_uv(pk % width, pk // width, width,
                                          height))[1]

        if frames > 1:
            # Cross-frame pack: slot k's pixel is within-frame slot
            # k mod ppf's (one (ppf, R) table); its direction is row
            # (k-1) % rows of the table. One camera: the rows are one
            # frame's slots 1..ppf-1 then slot 0 (the entry direction
            # itself, so a frame start is bit-identical to a lone
            # frame's), ppf rows. A camera a frame: slots 1..P-1.
            pix_tab = torch.stack([slot_pixel(kk) for kk in range(ppf)])
            if cameras is None:
                rows = [slot_dir(slot_pixel(kk), camera)
                        for kk in range(1, ppf)] + [v3lib.to_rows(rd0)]
            else:
                rows = [slot_dir(slot_pixel(k % ppf), cameras[k // ppf])
                        for k in range(1, p_count)]
            ctx = ctx._replace(frames=frames, ppf=ppf,
                               slot_pix=(pix_tab & 0xFFFFFFFF).contiguous())
        else:
            rows = [slot_dir(slot_pixel(k), camera) for k in range(1, p_count)]
        ctx = ctx._replace(slot_rd=v3lib.from_rows(
            torch.stack(rows).contiguous()))
    pix = pixel_index.to(torch.int64) & 0xFFFFFFFF
    return _initial_lane(ctx, ro0, rd0, pix), ctx


def finish(final: _Lane, ctx: _Ctx):
    """(mean radiance rows, exact segment count, trips) of a final state."""
    accs = final.accs if ctx.p_count > 1 else (final.acc,)
    mean = torch.cat([v3lib.to_rows(a) for a in accs]) / float(ctx.rays_per_pixel)
    return mean, int(final.segments.sum()), final.iters


def _initial_lane(ctx: _Ctx, ro0: V3, rd0: V3, pix: torch.Tensor) -> _Lane:
    """Fresh lanes: the static stage seeds the primary segment's world
    best, then the lane enters chain entry 0 (pretest + root expansion)."""
    r = pix.shape[0]
    dev = pix.device
    zeros = torch.zeros(r, dtype=_F32, device=dev)
    zero3 = V3(zeros, zeros, zeros)
    zeros_i = torch.zeros(r, dtype=_I32, device=dev)
    falses = torch.zeros(r, dtype=torch.bool, device=dev)
    ones = zeros + 1.0
    stack = tuple(torch.full((r,), _EMPTY, dtype=torch.int64, device=dev)
                  for _ in range(ctx.s_depth))
    sv, sd, sp, sn, sb, sm = _static_stage(ctx, ~falses, ro0, rd0)
    if ctx.e_count:
        lo0, ld0, lid0, root0, leaf0 = _enter(ctx, zeros_i, ro0, rd0)
        pre_ok = _pretest(ctx, zeros_i, lo0, lid0, sd)
        cur0 = torch.where(pre_ok, root0, -1)
        cur_leaf0 = leaf0 & (cur0 >= 0)
        if ctx.params.expand and ctx.params.expand[0]:
            cur0, cur_leaf0, stack = _expand_root(
                ctx, 0, pre_ok, lo0, ld0, lid0, zeros + _INF, sd, cur0,
                cur_leaf0, stack,
            )
    else:
        lo0, ld0, lid0 = ro0, rd0, V3(1.0 / rd0.x, 1.0 / rd0.y, 1.0 / rd0.z)
        cur0, cur_leaf0 = zeros_i - 1, falses
    opt = {}
    if ctx.use_cache:
        opt = dict(c_set=falses, c_valid=falses, c_point=zero3,
                     c_normal=zero3, c_back=falses, c_mesh=zeros_i - 1,
                     c_dst=zeros + _INF)
    if ctx.tlas:  # lanes start outside any instance, at a node row
        opt.update(in_inst=falses, cur_inst=falses, inst_mesh=zeros_i - 1,
                     inst_scale=ones, inst_cull=falses, inst_os=falses)
    return _Lane(
        iters=0, ro0=ro0, rd0=rd0, pix=pix, pixno=zeros_i, sample=zeros_i,
        acc=zero3,
        accs=tuple(zero3 for _ in range(ctx.p_count)) if ctx.p_count > 1 else (),
        rng=_seed(ctx, pix, 0), done=falses, segments=zeros_i,
        origin=ro0, direction=rd0, throughput=V3(ones, ones, ones),
        light=zero3, bounces=zeros_i, invis=zeros_i, entry=zeros_i,
        cur=cur0, cur_leaf=cur_leaf0, cur_slot=zeros_i, stack=stack,
        lo=lo0, ld=ld0, lid=lid0, lt=zeros + _INF, lnrm=zero3, lback=falses,
        lmesh=zeros_i - 1, w_valid=sv, w_dst=sd, w_point=sp, w_normal=sn,
        w_back=sb, w_mesh=sm, **opt,
    )
