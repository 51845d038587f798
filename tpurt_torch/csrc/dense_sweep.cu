// Kernel B2 launched on its own: one thread per ray, kThreads rays a
// block, the block sweep of dense_sweep.cuh against each ray's chain
// entry. Bound with ctypes by tpurt_torch/render/plucker_fused.py
// (sweep_entry_local); the header says what it replaces and what bounds
// it. The megakernel's dense instantiation runs the same function inside
// its lane loop.

#include <cuda_runtime.h>

#include "dense_sweep.cuh"

namespace {

constexpr int kThreads = 128;
// Unroll factor of the sweep's column loop: the fastest of the variants
// timed alone (kernel_variants.py; PERF.md).
constexpr int kUnroll = 4;

// lo, ld: (3, R) component-major local rays; entry: (R,) chain entries.
// Threads past the last ray sweep nothing but take part in the staging.
__global__ void __launch_bounds__(kThreads) dense_sweep_kernel(DenseTable tb,
                                                               const float* __restrict__ lo,
                                                               const float* __restrict__ ld,
                                                               const int* __restrict__ entry,
                                                               int n, float* __restrict__ t_out,
                                                               int* __restrict__ col_out) {
  __shared__ SweepSmem<kThreads> sm;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool mine = i < n;
  float t;
  const int col = block_sweep<kUnroll>(
      tb, mine ? entry[i] : -1, mine ? lo[i] : 0.0f, mine ? lo[n + i] : 0.0f,
      mine ? lo[2 * n + i] : 0.0f, mine ? ld[i] : 0.0f, mine ? ld[n + i] : 0.0f,
      mine ? ld[2 * n + i] : 0.0f, t, sm);
  if (mine) {
    col_out[i] = col;
    t_out[i] = t;
  }
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
