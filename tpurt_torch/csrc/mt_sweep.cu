// Kernel B3: the exact brute-force closest-hit sweep of the modular
// engine (dense_engine="pallas"), bound with ctypes by
// tpurt_torch/render/mt_sweep.py.
//
// Replaces tpurt/render/pallas_kernels.py:_mt_sweep_kernel (pallas_call
// at :156): every ray against every triangle row, exact Möller-Trumbore
// with the smooth-normal backface cull, the first minimum winning.
//
// Design: one thread per ray, 256 rays per block. The (T_pad, 18)
// triangle rows and their cull flags pass through shared memory in
// chunks of 256 rows (18 KB + 1 KB), loaded cooperatively between two
// __syncthreads; every thread then reads the same row at the same time,
// a broadcast. The TPU kernel computed every (ray, row) pair of a chunk
// and reduced with two min passes; a GPU thread has its own branches,
// so a row leaves the test at its first failed condition and the
// interpolated normal is computed only for a candidate that is closer
// and whose backface matters.
//
// What bounds it on the card: operations. Each pair costs ~40 f32 adds
// and multiplies and a division before its first rejection test that
// can fail often; the rows come from shared memory and the rays from
// registers, so device memory sees each input once.
//
// Numerics: the plain version's op order (render/intersect.py mt_core),
// built with -fmad=false and without fast math, so each a*b+c is a
// rounded multiply and a rounded add, 1.0f/det and sqrtf are IEEE and
// normalisation is x * (1.0f / sqrtf(x.x)). Strict < in row order keeps
// the lowest row among equal distances. The result is bit-identical to
// the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kRays = 256;   // rays (threads) per block
constexpr int kChunk = 256;  // triangle rows staged per pass
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

__global__ void __launch_bounds__(kRays) mt_sweep(const float* __restrict__ ro,
                                                  const float* __restrict__ rd,
                                                  const float* __restrict__ rows,
                                                  const float* __restrict__ cull, int n_rays,
                                                  int tri_count, float* __restrict__ t_out,
                                                  int* __restrict__ idx_out) {
  __shared__ float s_rows[kChunk * 18];
  __shared__ float s_cull[kChunk];
  const int i = blockIdx.x * kRays + threadIdx.x;
  const bool active = i < n_rays;
  const V o = active ? row3(ro + 3 * i) : V{0.0f, 0.0f, 0.0f};
  const V d = active ? row3(rd + 3 * i) : V{0.0f, 0.0f, 1.0f};
  float best = INFINITY;
  int best_i = -1;
  for (int base = 0; base < tri_count; base += kChunk) {
    __syncthreads();
    for (int k = threadIdx.x; k < kChunk * 18; k += kRays)
      s_rows[k] = rows[(size_t)base * 18 + k];
    s_cull[threadIdx.x] = cull[base + threadIdx.x];
    __syncthreads();
    const int n = min(kChunk, tri_count - base);  // padded rows masked
    for (int j = 0; j < n; ++j) {
      const float* r = s_rows + 18 * j;
      const V pa = row3(r);
      const V e1 = sub(row3(r + 3), pa);
      const V e2 = sub(row3(r + 6), pa);
      const V h = cross(d, e2);
      const float det = dot(e1, h);
      if (!(fabsf(det) >= kEps)) continue;
      const float f = 1.0f / det;
      const V s = sub(o, pa);
      const float u = f * dot(s, h);
      if (!(u >= 0.0f && u <= 1.0f)) continue;
      const V q = cross(s, e1);
      const float v = f * dot(d, q);
      if (!(v >= 0.0f && u + v <= 1.0f)) continue;
      const float t = f * dot(e2, q);
      if (!(t > kEps) || !(t < best)) continue;
      if (s_cull[j] != 0.0f) {
        const float w = 1.0f - u - v;
        const V na = row3(r + 9), nb = row3(r + 12), nc = row3(r + 15);
        V nn = {na.x * w + nb.x * u + nc.x * v, na.y * w + nb.y * u + nc.y * v,
                na.z * w + nb.z * u + nc.z * v};
        const float inv = 1.0f / sqrtf(dot(nn, nn));
        nn = {nn.x * inv, nn.y * inv, nn.z * inv};
        if (dot(d, nn) > kEps) continue;  // culled backface
      }
      best = t;
      best_i = base + j;
    }
  }
  if (active) {
    t_out[i] = best;
    idx_out[i] = best < INFINITY ? best_i : -1;
  }
}

}  // namespace

// Launches the sweep on ``stream``; returns cudaGetLastError().
extern "C" int tpurt_mt_sweep_launch(const float* ro, const float* rd, const float* rows,
                                     const float* cull, int n_rays, int tri_count,
                                     float* t_out, int* idx_out, void* stream) {
  const int blocks = (n_rays + kRays - 1) / kRays;
  if (blocks > 0)
    mt_sweep<<<blocks, kRays, 0, (cudaStream_t)stream>>>(ro, rd, rows, cull, n_rays,
                                                         tri_count, t_out, idx_out);
  return (int)cudaGetLastError();
}
