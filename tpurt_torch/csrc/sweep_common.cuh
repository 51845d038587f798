// What the two brute-force sweeps share: kernel B2's block sweep
// (dense_sweep.cuh) and kernel B3 (mt_sweep.cu). Both stage triangle
// data through shared memory with cp.async, and both compute
// u = RN(RN(1 / det) * u_num) and test 0 <= u <= 1, so one pre-test lets
// both skip the IEEE division for the pairs whose u must fail.

#pragma once

#include <cuda_runtime.h>

namespace sweep_common {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The u pre-test: true drops the pair before the division, only where
// the exact u = RN(RN(1/det) * u_num) cannot pass 0 <= u <= 1. Here
// |det| >= 1e-6 (the det test passed) and det is finite or infinite.
// RN(1/det) is within 2^-22 of 1/det relatively, even where it is
// subnormal (|det| <= FLT_MAX < 2^128 puts the worst case, an absolute
// error of 2^-150, at relative 2^-22), and it is 0 only for det = ±inf.
//  (a) |u_num| > RN(|det| * M), M = 1 + 2^-20. Then |u_num| >
//      |det| M (1 - 2^-24) (the product is normal, or +inf and the test
//      fails), so |f u_num| > M (1 - 2^-24)(1 - 2^-22) > 1 + 2^-21,
//      which rounds to at least 1 + 2^-23: |u| > 1, so u > 1 or u < -1.
//      An infinite det makes the right side infinite: never dropped.
//  (b) u_num and det of opposite signs and |u_num| >= |det| * 2^-100
//      (exact: |det| >= 2^-20, so the product is normal). For a finite
//      det, |f u_num| >= 2^-100 (1 - 2^-22), far above 2^-150, the
//      largest magnitude that rounds to zero: u is strictly negative,
//      never -0 (which would pass u >= 0). For det = ±inf only
//      |u_num| = inf qualifies, and then u = 0 * inf is NaN.
// In the kernel both are two compares of us, u_num with det's sign bit
// folded in (its sign bit is set exactly where the signs differ): (a)
// is us > |det| M or us < -|det| M, (b) is us <= -(|det| 2^-100), which
// contains the second half of (a). So the pair is kept exactly where
// -(|det| 2^-100) < us <= |det| M; a NaN u_num fails both compares and
// is dropped, rightly: its exact u is NaN and fails. Mirrored by
// plucker_fused.u_pretest_drops, which CPU tests hold against the exact
// test, with B2's plane sums and with B3's Möller-Trumbore terms.
constexpr float kUMargin = 1.0f + 0x1p-20f;
constexpr float kUTiny = 0x1p-100f;

__device__ __forceinline__ bool u_pretest_keeps(float det, float u_num) {
  const float ad = fabsf(det);
  const float us = __uint_as_float(__float_as_uint(u_num) ^ (__float_as_uint(det) & 0x80000000u));
  return (us <= ad * kUMargin) & (us > -(ad * kUTiny));
}

}  // namespace sweep_common
