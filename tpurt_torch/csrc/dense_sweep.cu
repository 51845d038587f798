// Kernel B2 launched on its own: one thread per ray, the sweep of
// dense_sweep.cuh against the ray's chain entry. Bound with ctypes by
// tpurt_torch/render/plucker_fused.py (sweep_entry_local); the header
// says what it replaces and what bounds it. The megakernel's dense
// instantiation runs the same function inside its lane loop.

#include <cuda_runtime.h>

#include "dense_sweep.cuh"

namespace {

constexpr int kThreads = 128;

// lo, ld: (3, R) component-major local rays; entry: (R,) chain entries.
__global__ void __launch_bounds__(kThreads) dense_sweep_kernel(DenseTable tb,
                                                               const float* __restrict__ lo,
                                                               const float* __restrict__ ld,
                                                               const int* __restrict__ entry,
                                                               int n, float* __restrict__ t_out,
                                                               int* __restrict__ col_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float t;
  col_out[i] = dense_sweep(tb, entry[i], lo[i], lo[n + i], lo[2 * n + i], ld[i], ld[n + i],
                           ld[2 * n + i], t);
  t_out[i] = t;
}

}  // namespace

// Launches the sweep on ``stream``; returns cudaGetLastError().
extern "C" int tpurt_dense_sweep_launch(const DenseTable* tb, const float* lo, const float* ld,
                                        const int* entry, int n, float* t_out, int* col_out,
                                        void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0)
    dense_sweep_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*tb, lo, ld, entry, n,
                                                                       t_out, col_out);
  return (int)cudaGetLastError();
}
