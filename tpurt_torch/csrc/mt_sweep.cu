// Kernel B3: the exact brute-force closest-hit sweep of the modular
// engine (dense_engine="pallas"), bound with ctypes by
// tpurt_torch/render/mt_sweep.py.
//
// Replaces tpurt/render/pallas_kernels.py:_mt_sweep_kernel (pallas_call
// at :156): every ray against every triangle row, exact Möller-Trumbore
// with the smooth-normal backface cull, the first minimum winning. The
// TPU kernel computed every (ray, row) pair of a (256 x 256) block and
// reduced with two min passes; here a pair leaves at its first failed
// test, and only a closer candidate whose backface matters reads its
// normals.
//
// What bounds it on the card: issued f32 operations, unfused (the build
// keeps -fmad=false so that it stays bit-identical to the plain
// version, which halves the f32 peak against fused multiply-adds). A
// pair that fails, as nearly all do, costs h = d x e2 (9), det (5),
// s = o - pa (3), the u numerator (5) and the u pre-test (5). The design
// keeps the issue slots on those:
//  - the rows come from the scene's kernel-facing layout (render/
//    mt_sweep.py mt_layout: pa, e1 = pb - pa, e2 = pc - pa, 12 floats,
//    three 16-byte vectors a row), made once per scene: the edges are
//    not recomputed per pair, and a row is three vector loads from
//    shared memory, staged kChunk rows at a time with a cp.async double
//    buffer (the next stage loads while this one is swept). Staging a
//    whole set at once (4,096 rows would take 196,608 B) would leave room
//    for one or two blocks an SM, and larger stages measured slower
//    than this one (PERF.md);
//  - each thread sweeps kRays rays against each staged row, so one set
//    of three shared loads serves kRays pairs;
//  - the u pre-test of sweep_common.cuh (shared with kernel B2) drops a
//    pair whose exact u must fail before the IEEE division; the rays'
//    pre-tests make one branch, and the det test waits behind it with
//    the division for the few pairs it keeps (a pair with |det| < eps
//    fails the exact test whatever the pre-test said of it);
//  - G threads of a warp can share a ray set, thread g sweeping rows g,
//    g + G, ... of each stage; the group then keeps the smaller t, then
//    the lower row: bit for bit the one-thread scan with strict <. G
//    comes per launch from groups_for below, so that a launch, a tile of
//    65,536 rays as much as a frame's 307,200, has enough equal blocks to
//    fill every SM in several waves.
// The rows are read by range (rows first .. first + count - 1 of the
// layout) or through an id list (the engine's fused identity pass); the
// cull flag is a property of the mesh instance, not of the triangle
// (instances may share a triangle range), so it comes per launch: one
// flag for a range, or one per listed row.
//
// Numerics: the plain version's op order (render/intersect.py mt_core),
// built with -fmad=false and without fast math, so each a*b+c is a
// rounded multiply and a rounded add, 1.0f/det and sqrtf are IEEE and
// normalisation is x * (1.0f / sqrtf(x.x)); the layout's edges are the
// same IEEE subtractions the plain version makes. Strict < in row order
// keeps the lowest row among equal distances. The result is
// bit-identical to the plain version.

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using namespace sweep_common;

// Launch constants, the fastest of the variants kernel_variants.py times
// on a frame's and a tile's rays (PERF.md).
constexpr int kThreads = 128;  // threads a block
constexpr int kRays = 4;       // rays a thread
constexpr int kMaxGroup = 4;   // most threads that share a ray set
constexpr int kChunk = 256;    // layout rows a stage (48 B each, two stages)
constexpr int kUnroll = 2;     // unroll factor of the row loop
constexpr int kMinBlocks = 7;  // resident blocks an SM __launch_bounds__ asks for
constexpr int kWaves = 4;      // the G rule fills at most kWaves x the resident threads
constexpr float kEps = 1e-6f;

struct V {
  float x, y, z;
};
__device__ __forceinline__ V sub(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V cross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V row3(const float* p) { return {p[0], p[1], p[2]}; }

// One launch; mirrored by the arguments of tpurt_mt_sweep_launch.
struct Sweep {
  const float* ro;     // (n_rays, 3) ray origins
  const float* rd;     // (n_rays, 3) ray directions
  const float4* tri;   // (T, 3) layout rows: pa e1.x | e1.y e1.z e2.x e2.y | e2.z 0 0 0
  const float* rows;   // (T, 18) the exact triangle rows (normals at 9-17)
  const int* ids;      // (count,) layout row of position k; null: row first + k
  const float* cull;   // (count,) cull flag of position k; null: cull_all
  int first, count, cull_all, n_rays;
  float* t_out;        // (n_rays,) closest t, inf on a miss
  int* idx_out;        // (n_rays,) its position k in [0, count), -1 on a miss
};

// Every thread copies its share of positions [c0, c0 + n) into ``dst``
// and commits the group (an empty one when n <= 0).
__device__ __forceinline__ void stage(const Sweep& a, float4* dst, int c0, int n) {
  for (int q = threadIdx.x; q < 3 * n; q += kThreads) {
    const int k = q / 3;
    const int row = a.ids ? a.ids[c0 + k] : a.first + c0 + k;
    cp_async16(dst + q, a.tri + 3 * (size_t)row + (q - 3 * k));
  }
  cp_async_commit();
}

// The rest of the exact test for a pair that the u pre-test kept: the
// plain version's path from the det test on.
__device__ __forceinline__ void accept(const Sweep& a, V o, V d, V pa, V e1, V e2, int k,
                                       float& best, int& best_k) {
  const V h = cross(d, e2);
  const float det = dot(e1, h);
  if (!(fabsf(det) >= kEps)) return;
  const float f = 1.0f / det;
  const V s = sub(o, pa);
  const float u = f * dot(s, h);
  if (!(u >= 0.0f && u <= 1.0f)) return;
  const V q = cross(s, e1);
  const float v = f * dot(d, q);
  if (!(v >= 0.0f && u + v <= 1.0f)) return;
  const float t = f * dot(e2, q);
  if (!(t > kEps) || !(t < best)) return;
  if (a.cull ? a.cull[k] != 0.0f : a.cull_all != 0) {
    const float* r = a.rows + 18 * (size_t)(a.ids ? a.ids[k] : a.first + k);
    const float w = 1.0f - u - v;
    const V na = row3(r + 9), nb = row3(r + 12), nc = row3(r + 15);
    V nn = {na.x * w + nb.x * u + nc.x * v, na.y * w + nb.y * u + nc.y * v,
            na.z * w + nb.z * u + nc.z * v};
    const float inv = 1.0f / sqrtf(dot(nn, nn));
    nn = {nn.x * inv, nn.y * inv, nn.z * inv};
    if (dot(d, nn) > kEps) return;  // culled backface
  }
  best = t;
  best_k = k;
}

// G threads share each ray set (a power of two up to kMaxGroup).
template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mt_sweep(Sweep a) {
  __shared__ float4 tile[2][kChunk * 3];
  constexpr int kSets = 32 / G;  // ray sets a warp
  const int lane = threadIdx.x & 31;
  const int sub_k = lane & (G - 1);  // this thread's first row of a stage
  // Slot r of a warp's sets holds kSets consecutive rays, so the lanes of
  // a warp test neighbouring rays (which tend to agree on the rare branch
  // past the pre-test).
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int ray0 = warp * kSets * kRays + lane / G;
  V o[kRays], d[kRays];
  float best[kRays];
  int best_k[kRays];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = ray0 + r * kSets;
    const bool live = i < a.n_rays;
    o[r] = live ? row3(a.ro + 3 * (size_t)i) : V{0.0f, 0.0f, 0.0f};
    d[r] = live ? row3(a.rd + 3 * (size_t)i) : V{0.0f, 0.0f, 1.0f};
    best[r] = INFINITY;
    best_k[r] = -1;
    any |= live;
  }
  const int n_stages = (a.count + kChunk - 1) / kChunk;
  stage(a, tile[0], 0, min(kChunk, a.count));
  for (int st = 0; st < n_stages; ++st) {
    // Stage st + 1 loads into the other buffer while stage st is swept.
    stage(a, tile[(st + 1) & 1], (st + 1) * kChunk, min(kChunk, a.count - (st + 1) * kChunk));
    cp_async_wait_one();
    __syncthreads();
    const int c0 = st * kChunk;
    const float4* const base = tile[st & 1];
    if (any) {
      // Thread sub_k of a group takes positions c0 + sub_k, + G, ...
      const int n3 = 3 * min(kChunk, a.count - c0);
#pragma unroll kUnroll
      for (int j = 3 * sub_k; j < n3; j += 3 * G) {
        const float4 r0 = base[j], r1 = base[j + 1], r2 = base[j + 2];
        const V pa = {r0.x, r0.y, r0.z}, e1 = {r0.w, r1.x, r1.y}, e2 = {r1.z, r1.w, r2.x};
        // Nearly every pair fails the pre-test: one predicate a ray, and
        // the rays one branch. The det test waits for the pairs it keeps
        // (a pair with |det| < eps fails whatever the pre-test says).
        bool keep[kRays], any_keep = false;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          const V h = cross(d[r], e2);
          const float det = dot(e1, h);
          keep[r] = u_pretest_keeps(det, dot(sub(o[r], pa), h));
          any_keep |= keep[r];
        }
        if (!any_keep) continue;
#pragma unroll
        for (int r = 0; r < kRays; ++r)
          if (keep[r]) accept(a, o[r], d[r], pa, e1, e2, c0 + j / 3, best[r], best_k[r]);
      }
    }
    __syncthreads();  // stage st's buffer is staged into again at st + 2
  }
  // A group's lanes are adjacent in one warp: keep the smaller t, then
  // the lower position (equal t are finite, so both positions are real).
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
      const float t2 = __shfl_xor_sync(0xFFFFFFFFu, best[r], m);
      const int k2 = __shfl_xor_sync(0xFFFFFFFFu, best_k[r], m);
      if (t2 < best[r] || (t2 == best[r] && k2 < best_k[r])) {
        best[r] = t2;
        best_k[r] = k2;
      }
    }
    const int i = ray0 + r * kSets;
    if (sub_k == 0 && i < a.n_rays) {
      a.t_out[i] = best[r];
      a.idx_out[i] = best[r] < INFINITY ? best_k[r] : -1;
    }
  }
}

// Resident blocks an SM holds of mt_sweep<G>, the fewest over G <= kG.
template <int kG>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mt_sweep<kG>, kThreads, 0);
  if constexpr (kG > 1) n = min(n, blocks_per_sm<kG / 2>());
  return n;
}

// Threads that can be resident at once for this kernel on the current
// device (queried once per process).
int resident_threads() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident = blocks_per_sm<kMaxGroup>() * kThreads * sms;
  }
  return resident;
}

// The G rule: the most threads a ray set (a power of two up to
// kMaxGroup) such that the launch's threads, ray sets times G, are at
// most kWaves times the threads the card holds at once. Splitting a ray
// set's rows over G threads leaves each pair's work as it was and makes
// G times the blocks, and many equal blocks spread evenly over the SMs
// in several waves, where a few leave some SMs a block more than others.
// So the parity frame's 307,200 rays and a tile's 65,536 both run at
// G = 4; only a launch of more than kWaves x kRays / kMaxGroup rays a
// resident thread takes a smaller one.
int groups_for(int n_rays) {
  const long long sets = (n_rays + kRays - 1) / kRays;
  const long long resident = (long long)kWaves * resident_threads();
  int g = 1;
  while (g < kMaxGroup && 2 * g * sets <= resident) g *= 2;
  return g;
}

int blocks_for(int n_rays, int g) {
  const long long per_block = (long long)kThreads / g * kRays;  // rays a block
  return (int)((n_rays + per_block - 1) / per_block);
}

// mt_sweep<g> for the g the rule chose.
template <int kG>
void launch(int g, const Sweep& a, cudaStream_t stream) {
  if constexpr (kG > 1) {
    if (g < kG) return launch<kG / 2>(g, a, stream);
  }
  mt_sweep<kG><<<blocks_for(a.n_rays, kG), kThreads, 0, stream>>>(a);
}

}  // namespace

// The launch configuration for ``n_rays`` rays: out = {threads a block,
// rays a thread, G, resident threads, blocks}. Returns cudaGetLastError().
extern "C" int tpurt_mt_sweep_config(int n_rays, int* out) {
  const int g = groups_for(n_rays);
  out[0] = kThreads;
  out[1] = kRays;
  out[2] = g;
  out[3] = resident_threads();
  out[4] = blocks_for(n_rays, g);
  return (int)cudaGetLastError();
}

// Launches the sweep on ``stream``; returns cudaGetLastError().
extern "C" int tpurt_mt_sweep_launch(const float* ro, const float* rd, const float* tri,
                                     const float* rows, const int* ids, const float* cull,
                                     int first, int count, int cull_all, int n_rays,
                                     float* t_out, int* idx_out, void* stream) {
  if (n_rays > 0) {
    const Sweep a = {ro, rd, reinterpret_cast<const float4*>(tri), rows, ids, cull, first,
                     count, cull_all, n_rays, t_out, idx_out};
    launch<kMaxGroup>(groups_for(n_rays), a, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
