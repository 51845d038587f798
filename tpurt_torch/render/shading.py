"""Shared material shading step (torch port of tpurt/render/shading.py;
Trace.cl:502-591): five materials, full Fresnel, Russian roulette.

Materials are fetched with an indexed read of the packed (K, 11) table —
the same values tpurt's select chains produce — or, given the scene's
material slots (``Scene.mesh_mat_slot`` / ``mat_slot_rep``, the
freeze-time dedup by value), through the two-level index
``mats[rep[slot[mesh]]]``, which reads the same fields. tpurt's
material-set pruning only saves code size on the TPU and is
bitwise-neutral, so the port keeps every branch.

``shade_hit_soa`` carries vectors as V3 component triples (the
megakernel's layout); ``shade_hit`` is the (R, 3)-row wrapper the modular
integrator calls, numerically identical (it only repacks).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.config import EPSILON, IOR_AIR
from tpurt_torch.core import rng as rnglib
from tpurt_torch.core import v3 as v3lib
from tpurt_torch.core.v3 import V3
from tpurt_torch.scene.types import MaterialType, Scene

_EPS = float(np.float32(EPSILON))

# Packed material table columns (tpurt's pack_materials layout).
MAT_TYPE, MAT_IOR = 0, 1
MAT_COLOR, MAT_EMC = 2, 5  # 3 columns each
MAT_EMS, MAT_REFL, MAT_SPEC = 8, 9, 10
MAT_WIDTH = 11


class ShadeResult(NamedTuple):
    origin: torch.Tensor  # (R, 3)
    direction: torch.Tensor
    throughput: torch.Tensor
    light: torch.Tensor
    rng: torch.Tensor  # u32 in int64
    bounces: torch.Tensor  # i32
    continuing: torch.Tensor  # bool
    invisible: torch.Tensor  # bool


class ShadeResultSoA(NamedTuple):
    origin: V3
    direction: V3
    throughput: V3
    light: V3
    rng: torch.Tensor  # u32 in int64
    bounces: torch.Tensor  # i32
    continuing: torch.Tensor  # bool
    invisible: torch.Tensor  # bool


def pack_materials(scene: Scene) -> torch.Tensor:
    """(K, 11) f32 material table from the Scene's per-mesh columns."""
    return torch.stack([
        scene.mat_type.to(torch.float32), scene.mat_ior,
        scene.mat_color[:, 0], scene.mat_color[:, 1], scene.mat_color[:, 2],
        scene.mat_emission_color[:, 0], scene.mat_emission_color[:, 1],
        scene.mat_emission_color[:, 2],
        scene.mat_emission_strength, scene.mat_reflectiveness,
        scene.mat_specular_prob,
    ], dim=1)


def select_material_soa(mats: torch.Tensor, mesh_idx: torch.Tensor,
                        mat_slots=None):
    """Per-lane material fields for mesh ids in [0, K) (colors as V3;
    mtype stays f32, exact small ints). ``mat_slots``: (mesh -> slot,
    slot -> representative mesh) as sequences or i32 tensors; the fetch
    then reads the slot's representative (tpurt's two-level fetch)."""
    idx = mesh_idx.long()
    if mat_slots is not None:
        slot, rep = (torch.as_tensor(m, device=mats.device).long()
                     for m in mat_slots)
        idx = rep[slot[idx]]
    rows = mats[idx]  # (R, 11)
    c = lambda j: rows[:, j]
    return (
        c(MAT_TYPE), c(MAT_IOR),
        V3(c(MAT_COLOR), c(MAT_COLOR + 1), c(MAT_COLOR + 2)),
        V3(c(MAT_EMC), c(MAT_EMC + 1), c(MAT_EMC + 2)),
        c(MAT_EMS), c(MAT_REFL), c(MAT_SPEC),
    )


def shade_hit_soa(
    mats: torch.Tensor,
    enabled: torch.Tensor,
    hit_valid: torch.Tensor,
    hit_point: V3,
    hit_normal: V3,
    hit_backface: torch.Tensor,
    hit_mesh: torch.Tensor,
    origin: V3,
    direction: V3,
    throughput: V3,
    light: V3,
    rng: torch.Tensor,
    bounces: torch.Tensor,
    max_bounces: int,
    mat_slots=None,
) -> ShadeResultSoA:
    """One material interaction for lanes where ``enabled``; all other
    lanes pass through untouched, RNG stream included. ``mat_slots`` as
    for ``select_material_soa``."""
    mtype, ior, color, em_color, em_strength, refl, spec_prob = (
        select_material_soa(mats, torch.clamp_min(hit_mesh, 0), mat_slots)
    )
    a_hit = enabled & hit_valid
    invisible = a_hit & (mtype == float(MaterialType.INVISIBLE))
    scatter = a_hit & ~invisible

    # Checker cell selection (Trace.cl:509-524); cell size 1 when the
    # strength is 0 (tpurt's deliberate deviation, see its README).
    is_checker = scatter & (mtype == float(MaterialType.CHECKER))
    checker_size = torch.where(em_strength != 0.0, em_strength, 1.0)
    xi = torch.floor(hit_point.x / checker_size).to(torch.int32)
    zi = torch.floor(hit_point.z / checker_size).to(torch.int32)
    is_even = ((xi + zi) & 1) == 0
    color = v3lib.where(is_checker, v3lib.where(is_even, color, em_color), color)
    em_strength = torch.where(is_checker, 0.0, em_strength)

    # Diffuse/specular scatter: Checker + Solid (Trace.cl:525-533,559-567).
    mask_cs = is_checker | (scatter & (mtype == float(MaterialType.SOLID)))
    new_rng, rv = rnglib.random_value_masked(rng, mask_cs)
    new_rng, (rdx, rdy, rdz) = rnglib.random_direction_masked_soa(new_rng, mask_cs)
    is_specular = spec_prob >= rv
    diffuse_dir = v3lib.normalize(hit_normal + V3(rdx, rdy, rdz))
    specular_dir = v3lib.reflect(direction, hit_normal)
    dir_cs = v3lib.normalize(
        v3lib.lerp(diffuse_dir, specular_dir, refl * is_specular.to(torch.float32))
    )

    # Glassy (Trace.cl:534-558).
    is_glassy = scatter & (mtype == float(MaterialType.GLASSY))
    ior_cur = torch.where(hit_backface, ior, IOR_AIR)
    ior_next = torch.where(hit_backface, IOR_AIR, ior)
    reflect_dir = v3lib.reflect(direction, hit_normal)
    refract_dir = v3lib.refract(direction, hit_normal, ior_cur, ior_next)
    reflect_w = v3lib.fresnel_reflectance(direction, hit_normal, ior_cur, ior_next)
    new_rng, r01 = rnglib.rand01_masked(new_rng, is_glassy)
    will_reflect = r01 < reflect_w
    dir_glassy = v3lib.where(will_reflect, reflect_dir, refract_dir)
    glassy_w = torch.where(will_reflect, reflect_w, 1.0 - reflect_w)
    new_dir = v3lib.where(
        is_glassy, dir_glassy, v3lib.where(mask_cs, dir_cs, direction)
    )
    throughput_new = throughput * torch.where(is_glassy, glassy_w, 1.0)

    # Common tail (Trace.cl:574-591); masked contributions keep the
    # add-zero / mul-one forms of tpurt so signed zeros agree.
    emission = em_color * em_strength
    contrib = throughput_new * emission
    light_new = light + V3(
        torch.where(scatter, contrib.x, 0.0),
        torch.where(scatter, contrib.y, 0.0),
        torch.where(scatter, contrib.z, 0.0),
    )
    origin_new = v3lib.where(scatter, hit_point + new_dir * _EPS, origin)
    origin_new = v3lib.where(invisible, hit_point + direction * _EPS, origin_new)
    throughput_new = throughput_new * V3(
        torch.where(scatter, color.x, 1.0),
        torch.where(scatter, color.y, 1.0),
        torch.where(scatter, color.z, 1.0),
    )

    # Russian roulette after bounce 3 (Trace.cl:583-590).
    p = torch.maximum(torch.maximum(throughput_new.x, throughput_new.y),
                      throughput_new.z)
    rr = scatter & (bounces > 3)
    q = torch.clamp_min(1.0 - p, float(np.float32(0.05)))
    new_rng, r01_rr = rnglib.rand01_masked(new_rng, rr)
    killed = rr & (r01_rr < q)
    surv = rr & ~killed
    throughput_new = v3lib.where(surv, throughput_new / (1.0 - q), throughput_new)

    bounces_new = bounces + scatter.to(torch.int32)
    continuing = a_hit & ~killed & (bounces_new < max_bounces)
    return ShadeResultSoA(
        origin=v3lib.where(enabled, origin_new, origin),
        direction=v3lib.where(scatter, new_dir, direction),
        throughput=v3lib.where(enabled, throughput_new, throughput),
        light=v3lib.where(enabled, light_new, light),
        rng=new_rng,
        bounces=torch.where(enabled, bounces_new, bounces),
        continuing=continuing,
        invisible=invisible,
    )


def select_material(scene: Scene, mesh_idx: torch.Tensor):
    """Row-layout material fetch: (mtype i32, ior, color (R, 3), emission
    color (R, 3), emission strength, reflectiveness, specular prob)."""
    mtype, ior, color, em_color, em_strength, refl, spec = select_material_soa(
        pack_materials(scene), mesh_idx)
    return (mtype.to(torch.int32), ior, v3lib.to_rows(color),
            v3lib.to_rows(em_color), em_strength, refl, spec)


def shade_hit(scene: Scene, enabled, hit_valid, hit_point, hit_normal,
              hit_backface, hit_mesh, origin, direction, throughput, light,
              rng, bounces, max_bounces: int) -> ShadeResult:
    """(R, 3)-layout wrapper over ``shade_hit_soa`` (the modular engine's
    calling convention)."""
    rows = v3lib.from_rows
    res = shade_hit_soa(
        pack_materials(scene), enabled, hit_valid, rows(hit_point),
        rows(hit_normal), hit_backface, hit_mesh, rows(origin), rows(direction),
        rows(throughput), rows(light), rng, bounces, max_bounces)
    return ShadeResult(
        origin=v3lib.to_rows(res.origin), direction=v3lib.to_rows(res.direction),
        throughput=v3lib.to_rows(res.throughput), light=v3lib.to_rows(res.light),
        rng=res.rng, bounces=res.bounces, continuing=res.continuing,
        invisible=res.invisible)
