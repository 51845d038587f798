"""Kernel B2's inputs and its division pre-test, on the CPU.

* ``det_u``, the kernel-facing repack of the dense table, is a bit-exact
  copy of the det rows 0-2 and u rows 0-5 of ``coeffs``, column by
  column, zero-padded (chain scene: three entries, padded columns).
* ``u_pretest_drops``, the torch mirror of the kernel's pre-test
  (csrc/sweep_common.cuh), never drops a pair that the exact test
  (f = 1 / det, u = f * u_num, 0 <= u <= 1, in f32) accepts: about 10^6
  random pairs and the adversarial ones (u_num = ±0, subnormal u_num,
  |u_num| = |det| (1 ± k ulp) for k <= 4, |det| at EPSILON and at 1e6,
  huge and infinite det, both signs). It does drop nearly every pair the
  exact test rejects, so the division it saves is real.
* The kernel sources carry the mirror's constants (csrc/sweep_common.cuh,
  which B2 and B3 include).

The kernel itself is held bitwise against the plain sweep on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_cuda import chain_scene
from tpurt_torch.config import EPSILON
from tpurt_torch.core.v3 import V3
from tpurt_torch.render import plucker_fused
from tpurt_torch.scene import procedural
from tpurt_torch.scene.builder import Material, SceneBuilder
from tpurt_torch.scene.types import MaterialType

_EPS = np.float32(EPSILON)


def exact_u_passes(det: torch.Tensor, u_num: torch.Tensor) -> torch.Tensor:
    f = 1.0 / det
    u = f * u_num
    return (u >= 0.0) & (u <= 1.0)


def assert_never_drops_an_accepted_pair(det, u_num):
    det = torch.as_tensor(np.asarray(det, np.float32))
    u_num = torch.as_tensor(np.asarray(u_num, np.float32))
    live = det.abs() >= float(_EPS)  # the pre-test runs after the det test
    det, u_num = det[live], u_num[live]
    drops = plucker_fused.u_pretest_drops(det, u_num)
    passes = exact_u_passes(det, u_num)
    bad = drops & passes
    assert not bool(bad.any()), (det[bad][:5], u_num[bad][:5])
    return drops, passes


@pytest.fixture(scope="module")
def chain_table():
    scene = chain_scene(SceneBuilder, Material, MaterialType, procedural,
                        device="cpu")
    return plucker_fused.build_dense_table(scene)


def test_det_u_is_a_bit_exact_repack_of_coeffs(chain_table):
    t = chain_table
    tpad = t.ids.shape[0]
    assert t.entry_range.shape[0] == 3 and tpad > t.count
    assert t.det_u.shape == (tpad, plucker_fused.DET_U_WIDTH)
    assert t.det_u.dtype == torch.float32 and t.det_u.is_contiguous()
    bits = lambda a: a.contiguous().view(torch.int32)
    assert torch.equal(bits(t.det_u[:, 0:3]), bits(t.coeffs[0, 0:3].T))
    assert torch.equal(bits(t.det_u[:, 3:9]), bits(t.coeffs[1, 0:6].T))
    assert not bool(bits(t.det_u[:, 9:]).any())
    # The kernels' struct takes it, checked like the other arrays.
    dense = plucker_fused.check_table(t, torch.device("cpu"))
    assert dense.det_u == t.det_u.data_ptr()
    with pytest.raises(ValueError, match="det_u"):
        plucker_fused.check_table(t._replace(det_u=t.det_u[:, :9]),
                                  torch.device("cpu"))


def test_u_pretest_never_drops_an_accepted_random_pair():
    r = np.random.default_rng(0)
    n = 1 << 20
    ad = 10.0 ** r.uniform(np.log10(_EPS), 6.0, n)
    det = (ad * r.choice([-1.0, 1.0], n)).astype(np.float32)
    # u = u_num / det around [0, 1], with log-spread ratios as well.
    ratio = np.where(r.random(n) < 0.7, r.uniform(-0.5, 1.5, n),
                     r.choice([-1.0, 1.0], n) * 10.0 ** r.uniform(-12, 4, n))
    u_num = (det.astype(np.float64) * ratio).astype(np.float32)
    drops, passes = assert_never_drops_an_accepted_pair(det, u_num)
    rejected = ~passes
    assert 0.3 < float(rejected.float().mean()) < 0.8
    # Only pairs within about 2^-20 of u = 1 or with |u| tinier than
    # 2^-100 are left for the division.
    assert float((drops & rejected).sum()) >= 0.999 * float(rejected.sum())


def _ulp_steps(x: np.ndarray, k: int) -> np.ndarray:
    """x moved k ulps away from zero (k < 0: towards it)."""
    out = np.abs(x).astype(np.float32)
    target = np.float32(np.inf if k > 0 else 0.0)
    with np.errstate(over="ignore"):
        for _ in range(abs(k)):
            out = np.nextafter(out, target, dtype=np.float32)
    return out


@pytest.mark.parametrize("family", [
    "zero_u_num", "subnormal_u_num", "u_num_at_det_ulps", "extreme_det",
])
def test_u_pretest_never_drops_an_accepted_adversarial_pair(family):
    f32 = np.float32
    dets = np.array([_EPS, np.nextafter(_EPS, f32(1)), f32(1e-3), f32(0.7),
                     f32(1.0), f32(3.0), f32(1e6), f32(1e30), f32(2.0 ** 127),
                     np.finfo(f32).max, f32(np.inf)], f32)
    dets = np.concatenate([dets, -dets])
    if family == "zero_u_num":
        u = np.array([0.0, -0.0], f32)
    elif family == "subnormal_u_num":
        tiny = np.finfo(f32).smallest_subnormal
        u = np.array([tiny, 7 * tiny, np.finfo(f32).tiny * f32(0.5),
                      np.finfo(f32).tiny, f32(2.0 ** -100), f32(2.0 ** -80)], f32)
        u = np.concatenate([u, -u])
    elif family == "u_num_at_det_ulps":
        # |u_num| = |det| (1 ± k ulp), every sign combination: the knife
        # edge u = ±1 of pre-test (a), at the listed dets and at 4,096
        # random ones (other mantissas round 1 / det otherwise).
        r = np.random.default_rng(4)
        spread = (10.0 ** r.uniform(np.log10(_EPS), 6.0, 4096)).astype(f32)
        dets = np.concatenate([dets, spread, -spread])
        det_k, u_k = [], []
        for k in range(-4, 5):
            for s in (1.0, -1.0):
                det_k.append(dets)
                u_k.append(f32(s) * _ulp_steps(dets, k) * np.sign(dets))
        det = np.concatenate(det_k)
        u_num = np.concatenate(u_k).astype(f32)
        drops, passes = assert_never_drops_an_accepted_pair(det, u_num)
        assert bool(passes.any()) and bool(drops.any())
        return
    else:  # extreme_det: near the 2^-100 scale of pre-test (b), inf, NaN
        u = np.array([1.0, 0.5, 2.0, 1e-30, 1e30, np.finfo(f32).max, np.inf,
                      np.nan], f32)
        u = np.concatenate([u, -u, dets * f32(2.0 ** -100),
                            _ulp_steps(dets * f32(2.0 ** -100), -1),
                            _ulp_steps(dets * f32(2.0 ** -100), 1)])
    det = np.repeat(dets, len(u))
    u_num = np.tile(u, len(dets))
    drops, passes = assert_never_drops_an_accepted_pair(det, u_num)
    assert bool(passes.any())


def test_u_pretest_on_the_chain_scene_sweep(chain_table):
    """Real pairs: rays aimed at the chain scene's triangles against every
    column of their entry, through the plain version's plane sums."""
    t = chain_table
    r = np.random.default_rng(3)
    rows = t.rows[:t.count].numpy()
    tri = rows[r.integers(0, t.count, 512)]
    w = r.dirichlet((1, 1, 1), 512).astype(np.float32)
    target = tri[:, 0:3] * w[:, :1] + tri[:, 3:6] * w[:, 1:2] + tri[:, 6:9] * w[:, 2:3]
    o = (target + r.normal(size=(512, 3)) * 60.0).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    lo = V3(*(torch.from_numpy(o[:, i, None].copy()) for i in range(3)))
    ld = V3(*(torch.from_numpy(d[:, i, None].copy()) for i in range(3)))
    det, u_num, _v, _t = plucker_fused._planes(lo, ld, t.coeffs[:, :, :t.count])
    drops, passes = assert_never_drops_an_accepted_pair(det.numpy(), u_num.numpy())
    rejected = ~passes
    assert float((drops & rejected).sum()) >= 0.999 * float(rejected.sum())


def test_kernel_source_carries_the_mirrors_constants():
    csrc = os.path.join(os.path.dirname(plucker_fused.__file__), "..", "csrc")
    common = open(os.path.join(csrc, "sweep_common.cuh")).read()
    src = open(os.path.join(csrc, "dense_sweep.cuh")).read()
    assert '#include "sweep_common.cuh"' in src
    margin = re.search(r"kUMargin = 1\.0f \+ 0x1p(-?\d+)f;", common).group(1)
    tiny = re.search(r"kUTiny = 0x1p(-?\d+)f;", common).group(1)
    assert plucker_fused.U_MARGIN == 1.0 + 2.0 ** int(margin)
    assert plucker_fused.U_TINY == 2.0 ** int(tiny)
    assert re.search(r"kSweepTile = (\d+);", src).group(1) == "256"
    assert plucker_fused.DET_U_WIDTH * 4 % 16 == 0  # whole 16-byte vectors
