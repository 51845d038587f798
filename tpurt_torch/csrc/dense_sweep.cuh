// Kernel B2's sweep as a block-level __device__ function: the closest
// accepted hit of each thread's local ray against its chain entry's
// triangle columns, in the Plücker form (tpurt_torch/render/
// plucker_fused.py). Used by the standalone kernel in dense_sweep.cu and
// by the dense instantiation of the megakernel (megakernel.cu), which
// calls it once per loop trip in place of the BVH step.
//
// Replaces tpurt/render/plucker_fused.py:_sweep_kernel (pallas_call at
// :251). The TPU kernel ran (256 rays x 1024 columns) blocks as four MXU
// products with K zero-padded to 128, masked every column that was not
// the ray's entry and reduced with two min passes. A pair here costs a
// 10-term dot product per plane: no tile-wide product for a tensor
// core to take in exact f32 (TF32 would break the one-ulp contract), so
// each ray's columns are scanned by one thread (or, when few rays sweep,
// by a small group of threads), and a column leaves the loop at its
// first failed test.
//
// What bounds it on the card: operations — per pair 3 multiplies and 2
// adds for det, then for nearly every pair 6 multiplies and 5 adds for
// the u numerator, after which ~99.5% of pairs fail the u test. The
// design keeps the issue slots on that arithmetic:
//  - the block stages its entry's det and u coefficients (the kernel-
//    facing `det_u` array, 12 floats = three 16-byte vectors a column)
//    through shared memory, kSweepTile columns a stage, double-buffered
//    with cp.async so the next tile loads while this one is swept; every
//    thread reads a column with three broadcast shared loads instead of
//    nine scalar loads from L1/L2;
//  - a pre-test on u_num and det (sweep_common.cuh, shared with kernel
//    B3) drops a pair whose exact u is certain to fail before the IEEE
//    division (a multi-instruction sequence without fast math), so only
//    the ~0.5% of pairs that may pass divide;
//  - the v and t rows, cull and orient are read from global memory by
//    those survivors only;
//  - the block compacts the rays of the entry it sweeps into its first
//    threads, so that the warps that sweep are full, and when few rays
//    sweep (the megakernel's blocks late in a batch) splits each ray's
//    columns over a group of threads, so one sweep takes less time.
//
// Numerics: the plain version's order (_planes: each plane a
// left-to-right sum over the rows it uses), built with -fmad=false and
// without fast math; the survivors of the pre-test take exactly the
// plain version's path (division, u, v, t, cull); strict < in column
// order keeps the lowest column among equal t. Bit-identical to the
// plain version.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "sweep_common.cuh"

// The table; mirrored by plucker_fused._Dense (ctypes).
struct DenseTable {
  const float* coeffs;      // (4, 10, tpad) det/u/v/t coefficient rows
  const float* det_u;       // (tpad, 12) per column: det rows 0-2, u rows 0-5, 3 zeros
  const int* ids;           // (tpad,) soup triangle id, -1 = padding
  const int* owner;         // (tpad,) owner mesh id
  const float* cull;        // (tpad,) 0/1 backface-cull policy
  const float* orient;      // (tpad,) ±1 authored-normal orientation
  const float* rows;        // (tpad, 18) the column's exact triangle row
  const int* entry_range;   // (E, 2) [first, end) columns of entry e
  int tpad, n_entries;
};

// Columns staged per stage: 256 x 48 B = 12 KB, two stages.
constexpr int kSweepTile = 256;

// The block sweep's shared memory for blocks of kBlock threads: the two
// column stages, the compacted rays of the entry being swept (then their
// results), and each warp's count of them.
template <int kBlock>
struct SweepSmem {
  float4 tile[2][kSweepTile * 3];
  float ray[6][kBlock];
  int warp_count[2][kBlock / 32];
};

namespace dense_detail {

using namespace sweep_common;

// Every thread of the block copies its share of columns [c0, c0 + n)
// into ``dst`` and commits the group (an empty one when n == 0).
__device__ __forceinline__ void stage(const DenseTable& tb, float4* dst, int c0, int n) {
  const float4* src = reinterpret_cast<const float4*>(tb.det_u) + 3 * (size_t)c0;
  for (int q = threadIdx.x; q < 3 * n; q += blockDim.x) cp_async16(dst + q, src + q);
  cp_async_commit();
}

// One thread's sweep of staged columns first, first + stride, ... < n
// (global columns j0 + k), in column order; the loop unrolled kUnroll
// times (each caller's measured choice).
template <int kUnroll>
__device__ __forceinline__ void sweep_tile(const DenseTable& tb, const float4* s, int j0, int n,
                                           int first, int stride, float ox, float oy, float oz,
                                           float dx, float dy, float dz, float wx, float wy,
                                           float wz, float& best, int& best_col) {
  constexpr float kEps = 1e-6f;
  const size_t T = (size_t)tb.tpad;
  const float* cv0 = tb.coeffs + 20 * T + j0;  // v rows 0..5 of column j0
  const float* ct0 = tb.coeffs + 36 * T + j0;  // t rows 6..9 of column j0
#pragma unroll kUnroll
  for (int k = first; k < n; k += stride) {
    const float4 a = s[3 * k];      // det rows 0-2, u row 0
    const float4 b = s[3 * k + 1];  // u rows 1-4
    const float u5 = s[3 * k + 2].x;  // u row 5
    const float det = (dx * a.x + dy * a.y) + dz * a.z;
    // Nearly every pair passes the det test, so u_num is computed for
    // all and the det test and the pre-test make one branch, which
    // ~99.5% of the pairs take.
    const float u_num = ((((dx * a.w + dy * b.x) + dz * b.y) + wx * b.z) + wy * b.w) + wz * u5;
    if (!((fabsf(det) >= kEps) & u_pretest_keeps(det, u_num))) continue;
    const float f = 1.0f / det;
    const float u = f * u_num;
    if (!(u >= 0.0f && u <= 1.0f)) continue;
    const float* cv = cv0 + k;
    const float* ct = ct0 + k;
    const float v_num = ((((dx * __ldg(cv) + dy * __ldg(cv + T)) + dz * __ldg(cv + 2 * T)) +
                          wx * __ldg(cv + 3 * T)) + wy * __ldg(cv + 4 * T)) +
                        wz * __ldg(cv + 5 * T);
    const float v = f * v_num;
    if (!(v >= 0.0f && u + v <= 1.0f)) continue;
    const float t_num =
        ((ox * __ldg(ct) + oy * __ldg(ct + T)) + oz * __ldg(ct + 2 * T)) + __ldg(ct + 3 * T);
    const float t = f * t_num;
    if (!(t > kEps) || !(t < best)) continue;
    // Geometric backface: the ray meets the back when orient * det < 0.
    const int j = j0 + k;
    if (__ldg(tb.cull + j) != 0.0f && det * __ldg(tb.orient + j) < 0.0f) continue;
    best = t;
    best_col = j;
  }
}

}  // namespace dense_detail

// Every thread of the block calls this (it holds barriers). ``entry`` is
// the chain entry this thread's local ray (o, d) sweeps, or -1 for a
// thread with nothing to sweep, which still helps stage. Returns the
// winning column (-1 on a miss) and its t in ``t_out`` (+inf on a miss).
// Entries are taken in order; the block stages an entry's columns only
// when one of its threads needs them. The rays of an entry are compacted
// into the block's first threads (in thread order), so that the warps
// which sweep are full however few of the block's lanes sweep on this
// trip; each ray's (t, column) goes back to the thread that owns it.
// When the entry has few rays, each takes a group of k threads (a power
// of two up to a warp, as many as the block holds), thread i of the
// group sweeping columns i, i + k, ...; the group then keeps the
// smaller t and, among equal t, the lower column — the winner of the
// one-thread scan with strict < in column order, bit for bit. A sweep's
// latency, which bounds a block whose few live lanes wait on it, falls
// by k.
template <int kUnroll, int kBlock>
__device__ __forceinline__ int block_sweep(const DenseTable& tb, int entry, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float& t_out,
                                           SweepSmem<kBlock>& sm) {
  using namespace dense_detail;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float best = INFINITY;
  int best_col = -1;
  for (int e = 0; e < tb.n_entries; ++e) {
    const bool mine = entry == e;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, mine);
    int* counts = sm.warp_count[e & 1];  // alternate: the last entry's readers may lag
    if (lane == 0) counts[warp] = __popc(ballot);
    const int n_e = __syncthreads_count(mine);
    const int first = tb.entry_range[2 * e], end = tb.entry_range[2 * e + 1];
    if (n_e == 0 || end <= first) continue;
    int rank = __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) rank += counts[w];
    if (mine) {
      sm.ray[0][rank] = ox; sm.ray[1][rank] = oy; sm.ray[2][rank] = oz;
      sm.ray[3][rank] = dx; sm.ray[4][rank] = dy; sm.ray[5][rank] = dz;
    }
    __syncthreads();
    int group = 1;  // threads per ray
    while (group < 32 && 2 * group * n_e <= kBlock) group *= 2;
    const int slot = tid / group, sub = tid % group;
    const bool sweeper = slot < n_e;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    if (sweeper)
      for (int c = 0; c < 3; ++c) { o[c] = sm.ray[c][slot]; d[c] = sm.ray[3 + c][slot]; }
    const float wx = d[1] * o[2] - d[2] * o[1];
    const float wy = d[2] * o[0] - d[0] * o[2];
    const float wz = d[0] * o[1] - d[1] * o[0];
    float t_e = INFINITY;
    int col_e = -1;
    const int n_tiles = (end - first + kSweepTile - 1) / kSweepTile;
    stage(tb, sm.tile[0], first, min(kSweepTile, end - first));
    for (int k = 0; k < n_tiles; ++k) {
      // Tile k + 1 loads into the other buffer while tile k is swept.
      const int c1 = first + (k + 1) * kSweepTile;
      stage(tb, sm.tile[(k + 1) & 1], c1, max(0, min(kSweepTile, end - c1)));
      cp_async_wait_one();
      __syncthreads();
      const int c0 = first + k * kSweepTile;
      if (sweeper)
        sweep_tile<kUnroll>(tb, sm.tile[k & 1], c0, min(kSweepTile, end - c0), sub, group,
                            o[0], o[1], o[2], d[0], d[1], d[2], wx, wy, wz, t_e, col_e);
      __syncthreads();  // tile k's buffer is staged into again at k + 2
    }
    // A group's lanes are adjacent in one warp: keep the smaller t, then
    // the lower column (equal t are finite, so both columns are real).
    for (int m = 1; m < group; m <<= 1) {
      const float t2 = __shfl_xor_sync(0xFFFFFFFFu, t_e, m);
      const int c2 = __shfl_xor_sync(0xFFFFFFFFu, col_e, m);
      if (t2 < t_e || (t2 == t_e && c2 < col_e)) {
        t_e = t2;
        col_e = c2;
      }
    }
    // The rays were read before the first tile's barrier: their slots
    // now carry the results back.
    if (sweeper && sub == 0) {
      sm.ray[0][slot] = t_e;
      sm.ray[1][slot] = __int_as_float(col_e);
    }
    __syncthreads();
    if (mine) {
      best = sm.ray[0][rank];
      best_col = __float_as_int(sm.ray[1][rank]);
    }
  }
  t_out = best;
  return best_col;
}
