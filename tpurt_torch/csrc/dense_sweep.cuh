// Kernel B2's sweep as a __device__ function: the closest accepted hit of
// one lane's local ray against its chain entry's triangle columns, in
// the Plücker form (tpurt_torch/render/plucker_fused.py). Used by the
// standalone kernel in dense_sweep.cu and by the dense instantiation of
// the megakernel (megakernel.cu), which calls it in place of the BVH
// step.
//
// Replaces tpurt/render/plucker_fused.py:_sweep_kernel (pallas_call at
// :251). The TPU kernel ran (256 rays x 1024 columns) blocks as four MXU
// products with K zero-padded to 128, masked every column that was not
// the ray's entry and reduced with two min passes. A pair here costs a
// 10-term dot product per plane: no tile-wide product for a tensor
// core to take in exact f32 (TF32 would break the one-ulp contract), so
// each thread loops over its entry's columns on its own, and a column
// leaves the loop at its first failed test.
//
// What bounds it on the card: operations — per pair 19 multiplies and 15
// adds for the planes, then a division and a few more. The table (4 x 10
// x 6,144 x 4 B for the teapot) sits in L2 and L1; when a warp's lanes
// share an entry their loop is uniform and every coefficient load is one
// broadcast.
//
// Numerics: the plain version's order (_planes: each plane a
// left-to-right sum over the rows it uses), built with -fmad=false and
// without fast math; strict < in column order keeps the lowest column
// among equal t. Bit-identical to the plain version.

#pragma once

#include <cuda_runtime.h>

// The table; mirrored by plucker_fused._Dense (ctypes).
struct DenseTable {
  const float* coeffs;      // (4, 10, tpad) det/u/v/t coefficient rows
  const int* ids;           // (tpad,) soup triangle id, -1 = padding
  const int* owner;         // (tpad,) owner mesh id
  const float* cull;        // (tpad,) 0/1 backface-cull policy
  const float* orient;      // (tpad,) ±1 authored-normal orientation
  const float* rows;        // (tpad, 18) the column's exact triangle row
  const int* entry_range;   // (E, 2) [first, end) columns of entry e
  int tpad, n_entries;
};

// Sweep entry ``entry`` with the local ray (o, d); returns the winning
// column (-1 on a miss) and its t in ``t_out`` (+inf on a miss).
__device__ __forceinline__ int dense_sweep(const DenseTable& tb, int entry, float ox,
                                           float oy, float oz, float dx, float dy,
                                           float dz, float& t_out) {
  constexpr float kEps = 1e-6f;
  const float wx = dy * oz - dz * oy;
  const float wy = dz * ox - dx * oz;
  const float wz = dx * oy - dy * ox;
  const size_t T = (size_t)tb.tpad;
  const float* c = tb.coeffs;
  const int end = tb.entry_range[2 * entry + 1];
  float best = INFINITY;
  int best_col = -1;
  for (int j = tb.entry_range[2 * entry]; j < end; ++j) {
    const float* cd = c + j;            // det rows: 0..2
    const float* cu = c + 10 * T + j;   // u rows: 0..5
    const float* cv = c + 20 * T + j;   // v rows: 0..5
    const float* ct = c + 30 * T + j;   // t rows: 6..9
    const float det = (dx * __ldg(cd) + dy * __ldg(cd + T)) + dz * __ldg(cd + 2 * T);
    if (!(fabsf(det) >= kEps)) continue;
    const float f = 1.0f / det;
    const float u_num = ((((dx * __ldg(cu) + dy * __ldg(cu + T)) + dz * __ldg(cu + 2 * T)) +
                          wx * __ldg(cu + 3 * T)) + wy * __ldg(cu + 4 * T)) +
                        wz * __ldg(cu + 5 * T);
    const float u = f * u_num;
    if (!(u >= 0.0f && u <= 1.0f)) continue;
    const float v_num = ((((dx * __ldg(cv) + dy * __ldg(cv + T)) + dz * __ldg(cv + 2 * T)) +
                          wx * __ldg(cv + 3 * T)) + wy * __ldg(cv + 4 * T)) +
                        wz * __ldg(cv + 5 * T);
    const float v = f * v_num;
    if (!(v >= 0.0f && u + v <= 1.0f)) continue;
    const float t_num =
        ((ox * __ldg(ct + 6 * T) + oy * __ldg(ct + 7 * T)) + oz * __ldg(ct + 8 * T)) +
        __ldg(ct + 9 * T);
    const float t = f * t_num;
    if (!(t > kEps) || !(t < best)) continue;
    // Geometric backface: the ray meets the back when orient * det < 0.
    if (__ldg(tb.cull + j) != 0.0f && det * __ldg(tb.orient + j) < 0.0f) continue;
    best = t;
    best_col = j;
  }
  t_out = best;
  return best_col;
}
