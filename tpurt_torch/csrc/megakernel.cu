// The megakernel path tracer for Hopper: one CUDA thread per lane runs
// the whole persistent lane loop of tpurt_torch/render/megakernel.py.
//
// Replaces tpurt/render/mega_pallas.py:make_pallas_body (the fused
// Pallas body, one launch per loop trip over blocks of 4096 lanes) AND
// the XLA row gather between those launches (megakernel.py _gather):
// here each thread loads its own lane's bank row straight from global
// memory, so one launch renders a whole flat batch. This is the
// per-thread form of the reference kernel (Trace.cl:319-594) rather
// than the TPU's block-of-lanes transcription: a GPU thread has real
// branches and its own registers, so a lane runs only the branch it
// takes (node OR leaf, the materials it hits) instead of computing every
// branch and selecting, and a retired lane costs nothing.
//
// Persistent lanes: the grid is as many blocks as stay resident on the
// card, and each thread takes lane indices from a global queue (a
// counter the wrapper zeroes; warp-aggregated atomicAdd). A thread whose
// lane retires (done, or max_trips reached) stores it and takes the next
// unstarted lane, so an SM's slots stay busy until the queue is empty
// instead of waiting for a block's slowest lane (the bunny batch's
// slowest lane runs ~9x the mean trips). A lane's evolution depends only
// on its own words, so which thread runs it, and when, changes no bit.
//
// What bounds it on the card: a trip is a chain of dependent loads at
// data-dependent addresses (the lane's bank row; the bank, ~7 MB for the
// 69k-triangle mesh, stays in the 50 MB L2), and under load the lanes
// wait on the SM's memory path (L1, local memory, shared memory), not on
// arithmetic. The earlier design kept the whole ~75-word lane and a
// 64-entry stack array in registers and local memory (a 920-byte stack
// frame at 56 registers), which spilled through L1 to L2. So:
//  - the traversal stack is a ring of s_depth words a thread in the
//    block's dynamic shared memory, laid out [entry][thread] (conflict-
//    free whatever depths a warp's lanes hold). A push onto a full ring
//    overwrites its bottom entry, tpurt's drop-bottom rule, without
//    shifting. Budgets above kMaxSharedStack words keep the ring in a
//    global scratch buffer instead (kDeep, below);
//  - only the 17 lane words that the traversal step touches every trip
//    live in registers (is_hot; the TLAS frame too). The 52 others
//    (ray origins and directions, the accumulators, the path's state,
//    the hit records, the cache), which only a chain entry's fold, an
//    instance step and the tail passes touch, live in [word][thread]
//    rows of shared memory after the rings (kColdAt), each an immediate
//    offset from one register, copied in when a thread takes a lane and
//    out when it retires it. The dense instantiation's 256 threads keep
//    them in registers and local memory, as before (kDenseColdAt);
//  - a bank row is read with 128-bit read-only loads and decoded from
//    registers: a u8 node row in 2 + 3 per 4 children loads (a bf16 one
//    in 2 + 1 a child), a leaf row in 19 per 4 triangles (rows are 32-
//    byte aligned, and every fourth triangle starts a 16-byte word);
//  - everything a trip runs is inlined into the trip loop: calls (the
//    shading, the static stage) cost more in spills around them than
//    they save.
// kernel_variants.py times each of these against the alternative it
// replaced; PERF.md (§5, §6) has those times, ptxas's registers and
// spills and the static memory instructions of each instantiation. The
// remaining limit is divergence: a warp's lanes take different branches
// and rows. Against the costliest of it, a segment completion run for the
// few lanes of a warp whose walks just ended, the warp steps its walking
// lanes on while enough of them walk (kMinWalkers), and its lanes then
// complete their segments together. Reordering rays into coherent
// wavefronts is later work.
//
// Numerics: built with -fmad=false and without fast math, so every
// a*b+c stays a rounded multiply and a rounded add, divisions and
// square roots are IEEE, and normalisation is 1.0f/sqrtf(x) — exactly
// the plain torch version's operations on the card. logf/cosf are the
// CUDA math library's, as torch's own CUDA log/cos are. Integer words
// of the bank are read as bits (__float_as_int), never converted.
//
// Lane state crosses the C boundary as one (n_fields, R) buffer of
// 32-bit words; the field order is enum Field below, mirrored by
// LANE_WORDS in render/mega_cuda.py (a CPU test holds the two equal).
// Beside it the kernel writes each lane's trips and a (4, R) count of
// its work in this launch: child-box tests in node rows, leaf rows (in
// dense mode: entry sweeps), segment completions — from which the
// caller computes the launch's operation count — and the completion
// groups its thread counted (the TLAS instantiation: (6, R), instance
// enters and exits before the groups).
//
// The brute-force mode (RenderConfig.mega_dense) is a second
// instantiation of the same kernel, megakernel<true, ...>: its traversal
// step resolves the lane's whole chain entry with kernel B2's block sweep
// (dense_sweep.cuh) plus the exact Möller-Trumbore recompute of the
// winner, where megakernel<false, ...> steps one bank row. The block sweep
// holds barriers, so in the dense kernel the trip loop is block-uniform:
// it runs while any thread of the block holds a live lane, and a thread
// without one still helps stage the sweep's tiles. The choice is a
// template parameter, made on the host at launch, so the BVH kernel's
// code has no barriers.
//
// Two more template parameters give the BVH kernel tpurt's other bank
// regimes (its _body_math with ``tlas`` and ``bounds_fmt``), each
// compiled only where a scene needs it, so the u8 unrolled-chain kernel
// runs the code it ran before them:
//   kBf16  node rows hold absolute bf16 child bounds, two to a word as
//          f32 top halves (4 words a slot): decoded by shift and mask,
//          no grid arithmetic.
//   kTlas  the many-instance regime: the instanced meshes are instance
//          rows under a top-level BVH in the bank, reached through one
//          chain entry. A node slot whose meta carries kITag targets an
//          instance row; a trip on one either enters it (the baked
//          transform gives the local ray, the root pretest may skip it,
//          else an exit marker -- a resolved kITag entry naming the row --
//          goes on the stack and the lane descends to the mesh root) or,
//          when the marker pops, exits it (the instance's best hit folds
//          to world space, and the world ray is recomputed with the
//          enter step's exact operations). Six lane words after N_FIXED
//          (enum TlasField) carry the instance frame, in registers.
//   kDeep  the traversal stack's ring lives in a scratch buffer in
//          global memory, (s_depth, R) words, instead of shared memory:
//          for scenes whose stack budget (2 * mega_stack_depth) exceeds
//          kMaxSharedStack (mega_cuda.MAX_SHARED_STACK).
//
// Cross-frame packing (frames > 1, render_batch_flat_frames) is read at
// run time from the launch configuration, only where a lane advances to
// its next quota slot: the slot's pixel comes from a (ppf, R) table, its
// direction from the periodic slot table, and its frame offset pixno /
// ppf enters the seed. A list quota (run_megakernel(pixel_list=)) takes
// the same table advance, its (P, R) pixel table read at row pixno (the
// host passes it as frames = ppf = P). An unpacked launch takes the
// affine advance.
//
// Fresh lanes are written by a second kernel, fresh_lanes (at the end of
// this file), one thread a lane, from the entry rays and pixels into the
// state buffer the megakernel launch then runs: megakernel._initial_lane's
// words through this file's own restart code.
//
// Sub-pixel jitter is a compile-time parameter, TPURT_MK_JITTER, set per
// library: this file builds the library without it, and
// megakernel_jitter.cu, which includes this file with TPURT_MK_JITTER 1,
// the one with it, so no unjittered instantiation holds its code or its
// launch configuration's camera fields. Under jitter each new
// sample's primary ray is computed here from the lane's current pixel and
// sample (primary_ray below: the jitter stream, pixel uv, make_ray with
// the camera's scalars from the launch configuration) -- it cannot come
// from the host, since a sample's pixel is known only after the quota
// advance -- in the plain version's operations and order, with IEEE
// divisions.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "dense_sweep.cuh"

#ifndef TPURT_MK_JITTER
#define TPURT_MK_JITTER 0
#endif
// How the per-segment work that takes no lane registers (shading, the
// static stage) is compiled into the trip loop.
#define TPURT_MK_RARE __device__ __forceinline__

namespace {

// Stack budgets up to this many words a lane take the ring in shared
// memory; deeper ones the kDeep instantiation (mega_cuda.MAX_SHARED_STACK).
constexpr int kMaxSharedStack = 64;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kTag = 0x80000000u;
constexpr uint32_t kITag = 1u << 28;  // TLAS: an instance-row target
constexpr uint32_t kMetaT = kITag - 1u;  // meta target bits
constexpr int kSlotBits = 6;
constexpr uint32_t kSlotMask = (1u << kSlotBits) - 1u;
constexpr int kCpWidth = 21;
constexpr int kMatWidth = 11;
constexpr float kEps = 1e-6f;
constexpr float kGrow = 1.001f;
constexpr float kTau = 6.28318530717958647692f;

// Threads a block, and the least resident blocks per SM that
// __launch_bounds__ asks of the register allocator, for each
// instantiation, and the unroll factor of the block sweep's column loop
// in megakernel<true>: the fastest of the variants timed on the bunny
// and teapot batches (kernel_variants.py; PERF.md).
constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;
// The BVH kernel's warps keep stepping the lanes that are mid-walk
// (their trip's tail passes complete no segment) while at least this
// many of the warp's lanes are, so that the lanes whose walks ended
// complete their segments together (the trip loop in megakernel<false>).
// 33: never, a lane's tail follows each of its steps; 1: until every
// walk of the warp has ended. The fastest of the variants timed on the
// glass and bunny batches (kernel_variants.py "b1-walkers-<k>"; PERF.md).
constexpr int kMinWalkers = 10;
constexpr int kDenseThreads = 256;
constexpr int kDenseMinBlocks = 4;
constexpr int kDenseSweepUnroll = 1;
// Where a lane's cold words (those that are not is_hot below) live while
// a thread runs it: in the state buffer, read and written in place; in
// [word][thread] rows of the block's dynamic shared memory after the
// stack rings; or in a per-thread array that the compiler keeps in
// registers and local memory. The shared and register placements copy
// them in when the thread takes the lane and out when it retires it.
// The dense instantiation's 256 threads leave no shared memory for them
// beside the block sweep's.
enum ColdAt : int { kColdInBuffer, kColdInShared, kColdInRegisters };
constexpr ColdAt kColdAt = kColdInShared;
constexpr ColdAt kDenseColdAt = kColdInRegisters;

// One enumerator per 32-bit word of a lane, in buffer order. After
// N_FIXED come 3*P quota accumulators (P > 1 only) and the S stack
// slots, top first.
enum Field : int {
  RO0_X, RO0_Y, RO0_Z, RD0_X, RD0_Y, RD0_Z,
  PIX, PIXNO, SAMPLE,
  ACC_X, ACC_Y, ACC_Z,
  RNG, DONE, SEGMENTS,
  ORIGIN_X, ORIGIN_Y, ORIGIN_Z, DIRECTION_X, DIRECTION_Y, DIRECTION_Z,
  THROUGHPUT_X, THROUGHPUT_Y, THROUGHPUT_Z, LIGHT_X, LIGHT_Y, LIGHT_Z,
  BOUNCES, INVIS, ENTRY, CUR, CUR_LEAF, CUR_SLOT,
  LO_X, LO_Y, LO_Z, LD_X, LD_Y, LD_Z, LID_X, LID_Y, LID_Z,
  LT, LNRM_X, LNRM_Y, LNRM_Z, LBACK, LMESH,
  W_VALID, W_DST, W_POINT_X, W_POINT_Y, W_POINT_Z,
  W_NORMAL_X, W_NORMAL_Y, W_NORMAL_Z, W_BACK, W_MESH,
  C_SET, C_VALID, C_POINT_X, C_POINT_Y, C_POINT_Z,
  C_NORMAL_X, C_NORMAL_Y, C_NORMAL_Z, C_BACK, C_MESH, C_DST,
  N_FIXED
};
// The TLAS instantiation's lane words, after N_FIXED (TLAS_WORDS in
// render/mega_cuda.py).
enum TlasField : int {
  IN_INST = N_FIXED, CUR_INST, INST_MESH, INST_SCALE, INST_CULL, INST_OS,
  N_TLAS_END
};
// Where the quota accumulators start.
template <bool kTlas>
constexpr int kAccBase = kTlas ? N_TLAS_END : N_FIXED;

// The words of enum Field that the traversal step reads or writes on
// every trip, held in registers (struct Lane) from a lane's load to its
// retirement; the TLAS words are hot too. The others are cold.
__host__ __device__ constexpr bool is_hot(int f) {
  return f == DONE || (f >= ENTRY && f <= LT) || f == LMESH || f == W_DST;
}
// A cold word's row among the cold words, in buffer order.
__host__ __device__ constexpr int cold_row(int f) {
  return f - (f > DONE) - (f > LT ? LT - ENTRY + 1 : 0) - (f > LMESH) - (f > W_DST);
}
constexpr int kColdWords = cold_row(N_FIXED);

}  // namespace

// Launch configuration; mirrored by mega_cuda._Cfg (ctypes).
struct MkCfg {
  int n_lanes, max_trips;
  int e_count, s_depth, num_meshes, n_static;
  int max_bounces, rays_per_pixel, seed_reference, invisible_budget;
  int use_cache, p_count, pixel_stride, width, height;
  int tail_passes, expand_passes, n_skip, leaf_tris, arity, row_width;
  int frame_index, sample_offset;
  // The instantiation (launch only; the kernel is compiled for it):
  // deep = the stacks in the (s_depth, R) scratch the host allocated.
  int tlas, bf16, deep;
  // The table advance (frames > 1): an advancing lane reads its slot's
  // pixel from the (ppf, R) table at row pixno % ppf and its direction
  // from row (pixno - 1) % rd_rows, and its seeds take the frame offset
  // pixno / ppf. A cross-frame pack passes its frames and slots a frame;
  // a list quota passes frames = ppf = P (one frame of P slots, no
  // offset). frames = 1: the affine advance.
  int frames, ppf, rd_rows;
#if TPURT_MK_JITTER
  // The camera's scalars for jittered rays (core/camera.camera_scalars):
  // position, rotation row-major, tan of the half fov, aspect. Only the
  // jitter library's configuration has them, so the other's kernels see
  // the configuration they saw before jitter.
  float cam_pos[3], cam_rot[9], cam_tan, cam_aspect;
#endif
};

// Fresh lanes' inputs (tpurt_mk_fresh), mirrored by mega_cuda._FreshIn:
// the components of ro0 and rd0 and the pixel ids at their element
// strides (an origin that every lane shares has stride 0), the ids as
// 4- or 8-byte integers (their low 32 bits are the pixel), and whether
// the lanes carry lane0 (a list quota).
struct FreshIn {
  const float* ray[6];  // ro0.x, ro0.y, ro0.z, rd0.x, rd0.y, rd0.z
  long long stride[6];
  const void* pix;
  long long pix_stride;
  int pix_bytes;
  int lane0;
};

namespace {

struct Tables {
  const float* rows;     // (N, row_width) bank, rows 16-byte aligned
  const float* chain;    // (E, 21) chain params
  const float* mats;     // (K, 11) materials
  const float* srows;    // (n_static, 19) static triangles
  const float* roots_f;  // (E, 1 + 6*arity) decoded root child bounds
  const int* roots_i;    // (E, arity) root child metas
  const int* meta;       // root[E] leaf[E] mesh[E] expand[E]
                         // s_cull[S] s_onesided[S] s_owner[S] mesh_cull[K]
  const float* slot_rd;  // (3, rd_rows, R) quota slot directions
  const uint32_t* slot_pix;  // (ppf, R) slot pixels (packed or list)
  uint32_t* stack;       // (s_depth, R) traversal stacks (kDeep only)
  DenseTable dt;         // the dense sweep's table (megakernel<true> only)
};

struct V {
  float x, y, z;
};
__device__ __forceinline__ V v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V operator+(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V operator*(V a, V b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V operator*(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V operator/(V a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V cross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ V normalize(V a) { return a * rsq(dot(a, a)); }
__device__ __forceinline__ float length(V a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V sel(bool c, V a, V b) { return c ? a : b; }

// torch.minimum / torch.maximum / clamp_min: a NaN operand wins.
__device__ __forceinline__ float minp(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}
__device__ __forceinline__ float maxp(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// ---------------------------------------------------------------- RNG
// Exact u32 transcription of Trace.cl:158-217 (rng.py).

__device__ __forceinline__ float unit_float(uint32_t s) {
  return __uint2float_rn(s + 1u) * 2.3283064365386963e-10f;
}
__device__ __forceinline__ uint32_t lcg(uint32_t s) { return s * 747796405u + 2891336453u; }
__device__ __forceinline__ uint32_t make_seed(uint32_t pix, int frame, uint32_t ray) {
  uint32_t s = pix * 1664525u + (uint32_t)frame * 1013904223u;
  s ^= ray + 0x9E3779B9u;
  return s * 22695477u + 1u;
}
__device__ __forceinline__ uint32_t random_value(uint32_t s, float& out) {
  s = lcg(s);
  uint32_t shift = (s >> 28) + 4u;
  uint32_t r = ((s >> shift) ^ s) * 277803737u;
  r = (r >> 22) ^ r;
  out = unit_float(r);
  return s;
}
__device__ __forceinline__ uint32_t rand01(uint32_t s, float& out) {
  s = lcg(s);
  uint32_t z = s;
  z = (z ^ (z >> 16)) * 0x7FEB352Du;
  z = (z ^ (z >> 15)) * 0x846CA68Bu;
  z = z ^ (z >> 16);
  out = unit_float(z);
  return s;
}
__device__ __forceinline__ uint32_t random_normal(uint32_t s, float& out) {
  float u1, u2;
  s = random_value(s, u1);
  s = random_value(s, u2);
  u1 = maxp(u1, kEps);
  float r = sqrtf(-2.0f * logf(u1));
  out = r * cosf(kTau * u2);
  return s;
}
__device__ __forceinline__ uint32_t random_direction(uint32_t s, V& d) {
  float x, y, z;
  s = random_normal(s, x);
  s = random_normal(s, y);
  s = random_normal(s, z);
  float inv = rsq(x * x + y * y + z * z);
  d = v3(x * inv, y * inv, z * inv);
  if (!(isfinite(d.x) && isfinite(d.y) && isfinite(d.z))) d = v3(0.0f, 1.0f, 0.0f);
  return s;
}

// ------------------------------------------------------------ geometry

// Exact Möller-Trumbore (megakernel._mt_core); false = no valid hit.
__device__ __forceinline__ bool mt(V lo, V ld, V pa, V e1, V e2, V na, V nb, V nc,
                                   bool cull, float& t, V& n, bool& back) {
  V h = cross(ld, e2);
  float det = dot(e1, h);
  if (!(fabsf(det) >= kEps)) return false;
  float f = 1.0f / det;
  V s = lo - pa;
  float u = f * dot(s, h);
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  V q = cross(s, e1);
  float v = f * dot(ld, q);
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  t = f * dot(e2, q);
  if (!(t > kEps)) return false;
  float w = 1.0f - u - v;
  n = normalize(v3(na.x * w + nb.x * u + nc.x * v, na.y * w + nb.y * u + nc.y * v,
                   na.z * w + nb.z * u + nc.z * v));
  back = dot(ld, n) > kEps;
  if (cull && back) return false;
  if (back) n = -n;
  return true;
}

// Slab test with a distance bound; a NaN slab (0 * inf) is open.
__device__ __forceinline__ float slab_lo(float a, float b) {
  return (a != a || b != b) ? -INFINITY : fminf(a, b);
}
__device__ __forceinline__ float slab_hi(float a, float b) {
  return (a != a || b != b) ? INFINITY : fmaxf(a, b);
}
__device__ __forceinline__ bool aabb(V lo, V lid, V bmin, V bmax, float limit) {
  V t0 = (bmin - lo) * lid;
  V t1 = (bmax - lo) * lid;
  float tmin = fmaxf(fmaxf(slab_lo(t0.x, t1.x), slab_lo(t0.y, t1.y)), slab_lo(t0.z, t1.z));
  float tmax = fminf(fminf(slab_hi(t0.x, t1.x), slab_hi(t0.y, t1.y)), slab_hi(t0.z, t1.z));
  return tmax >= fmaxf(tmin, 0.0f) && tmin < limit;
}

__device__ __forceinline__ float safe_scale(float s) { return fabsf(s) > kEps ? s : 1.0f; }

// out_i = sum_j rot[j][i] * v_j  /  out_i = sum_j rot[i][j] * v_j
__device__ __forceinline__ V rot_t(const float* r, V v) {
  return v3(r[0] * v.x + r[3] * v.y + r[6] * v.z, r[1] * v.x + r[4] * v.y + r[7] * v.z,
            r[2] * v.x + r[5] * v.y + r[8] * v.z);
}
__device__ __forceinline__ V rot_fwd(const float* r, V v) {
  return v3(r[0] * v.x + r[1] * v.y + r[2] * v.z, r[3] * v.x + r[4] * v.y + r[5] * v.z,
            r[6] * v.x + r[7] * v.y + r[8] * v.z);
}

__device__ __forceinline__ V reflect(V d, V n) {
  float k = 2.0f * dot(d, n);
  return v3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z);
}
__device__ __forceinline__ V refract(V d, V n, float a, float b) {
  float ratio = a / b;
  float cos_in = -dot(d, n);
  float sin_sqr = ratio * ratio * (1.0f - cos_in * cos_in);
  if (sin_sqr > 1.0f) return v3(0.0f, 0.0f, 0.0f);
  float root = sqrtf(maxp(1.0f - sin_sqr, 0.0f));
  float k = ratio * cos_in - root;
  return v3(ratio * d.x + k * n.x, ratio * d.y + k * n.y, ratio * d.z + k * n.z);
}
__device__ __forceinline__ float fresnel(V d, V n, float a, float b) {
  float ratio = a / b;
  float cos_in = -dot(d, n);
  float sin_sqr = ratio * ratio * (1.0f - cos_in * cos_in);
  float cos_refr = sqrtf(maxp(1.0f - sin_sqr, 0.0f));
  float denom = a * cos_in + b * cos_refr;
  float r_perp = (a * cos_in - b * cos_refr) / denom;
  float r_par = (b * cos_in - a * cos_refr) / denom;
  float refl = 0.5f * (r_perp * r_perp + r_par * r_par);
  bool degenerate = (cos_in <= 0.0f) || (sin_sqr >= 1.0f) || (denom < kEps);
  return degenerate ? 1.0f : refl;
}

// ---------------------------------------------------------- lane state

// A lane's words where they are kept (ColdAt kAt). The state buffer:
// word f of lane i at p[f * n + i]. The cold rows in shared memory: word
// f at p[cold_row(f) * kThreads], p already at the thread's column, so
// that every word is an immediate offset from one register. Registers:
// a[cold_row(f)].
template <int kAt>
struct Cols {
  uint32_t* p;
  int n;  // the row stride (the state buffer)
  int i;  // this lane's column (the state buffer)
  mutable uint32_t a[kAt == kColdInRegisters ? kColdWords : 1];
  __device__ uint32_t& w(int f) const {
    if constexpr (kAt == kColdInShared) {
      return p[cold_row(f) * kThreads];
    } else if constexpr (kAt == kColdInRegisters) {
      return a[cold_row(f)];
    } else {
      return p[(size_t)f * n + i];
    }
  }
  __device__ float f(int f) const { return __uint_as_float(w(f)); }
  __device__ V v(int f) const { return v3(this->f(f), this->f(f + 1), this->f(f + 2)); }
  __device__ void put(int f, float x) const { w(f) = __float_as_uint(x); }
  __device__ void put(int f, V a) const { put(f, a.x); put(f + 1, a.y); put(f + 2, a.z); }
};
using Words = Cols<kColdInBuffer>;

// A lane's hot words (is_hot) in registers, its traversal stack, and
// this launch's work on it. kStride: the block's threads, the stride of
// the shared stack rings.
template <bool kDeep, int kStride>
struct Lane {
  V lo, ld, lid;
  float lt, w_dst;
  int entry, cur, cur_slot, lmesh;
  bool done, cur_leaf;
  // Whether the cold acc words may differ from acc + 0: the plain
  // version adds a zero contribution to acc on every tail pass that ends
  // no path, and x + 0 turns -0 into +0. True from the lane's load and
  // after a path's end; the next such pass adds the zero once and clears
  // it, since x + 0 + 0 == x + 0.
  bool acc_raw;
  // TLAS regime (kTlas only): inside an instance; cur is an instance
  // row; the instance's owner mesh, scale, cull policy and OneSided flag.
  bool in_inst, cur_inst, inst_cull, inst_os;
  int inst_mesh;
  float inst_scale;
  // The traversal stack, a ring of s_depth entries: entry k at
  // stk[k * kStride] (the thread's column of the block's shared ring
  // array) or kDeep stk[k * stride] (the lane's column of the global
  // scratch). head is the entry the next push writes, sp the entries
  // held.
  uint32_t* stk;
  int stride, head, sp;
  // This launch's work on the lane (not lane state): child-box tests,
  // leaf rows (dense: entry sweeps), segment completions, instance
  // enters and exits, and the completion groups its thread counted
  // (tail(): the lowest thread of each group of a warp's threads that
  // complete a segment together counts one).
  int n_box, n_leaf, n_seg, n_enter, n_exit, n_group;
  __device__ uint32_t& slot(int k) {
    if constexpr (kDeep) {
      return stk[(size_t)k * stride];
    } else {
      return stk[k * kStride];
    }
  }
};

// Push on top. A full ring's next entry is its bottom, so a push onto a
// full stack overwrites the bottom entry: tpurt's fixed-depth shift
// register drops it the same way.
template <class Ln>
__device__ __forceinline__ void push(Ln& L, uint32_t e, int depth) {
  L.slot(L.head) = e;
  L.head = L.head + 1 == depth ? 0 : L.head + 1;
  L.sp += L.sp < depth ? 1 : 0;
}
template <class Ln>
__device__ __forceinline__ uint32_t pop(Ln& L, int depth) {
  L.head = L.head == 0 ? depth - 1 : L.head - 1;
  --L.sp;
  return L.slot(L.head);
}

// What a trip reads and writes besides the lane's registers: the launch
// configuration, the tables, the state buffer at the lane's column, and
// the lane's cold words (kAt).
template <int kAt>
struct Ctx {
  static constexpr bool kColdRows = kAt != kColdInBuffer;
  const MkCfg& c;
  const Tables& tb;
  Words s;
  Cols<kAt> cold;
  __device__ void take(int i) {
    s.i = i;
    if constexpr (kAt == kColdInBuffer) cold.i = i;
  }
  __device__ const int* chain_root() const { return tb.meta; }
  __device__ const int* chain_leaf() const { return tb.meta + c.e_count; }
  __device__ const int* chain_mesh() const { return tb.meta + 2 * c.e_count; }
  __device__ const int* expand() const { return tb.meta + 3 * c.e_count; }
  __device__ const int* s_cull() const { return tb.meta + 4 * c.e_count; }
  __device__ const int* s_onesided() const { return s_cull() + c.n_static; }
  __device__ const int* s_owner() const { return s_onesided() + c.n_static; }
  __device__ const int* mesh_cull() const { return s_owner() + c.n_static; }
};

// Loads the lane at x.s's column: its hot words into registers, its cold
// words into their rows (shared memory or registers), its stack into the ring
// (``ring``; kDeep: the scratch column).
template <bool kTlas, bool kDeep, int kS, class X>
__device__ __forceinline__ void load_lane(Lane<kDeep, kS>& L, const X& x, int stack_base,
                                          uint32_t* ring) {
  const Words& s = x.s;
  L.done = s.w(DONE) != 0;
  L.entry = (int)s.w(ENTRY); L.cur = (int)s.w(CUR);
  L.cur_leaf = s.w(CUR_LEAF) != 0; L.cur_slot = (int)s.w(CUR_SLOT);
  L.lo = s.v(LO_X); L.ld = s.v(LD_X); L.lid = s.v(LID_X);
  L.lt = s.f(LT); L.lmesh = (int)s.w(LMESH); L.w_dst = s.f(W_DST);
  L.acc_raw = true;
  if constexpr (kTlas) {
    L.in_inst = s.w(IN_INST) != 0; L.cur_inst = s.w(CUR_INST) != 0;
    L.inst_mesh = (int)s.w(INST_MESH); L.inst_scale = s.f(INST_SCALE);
    L.inst_cull = s.w(INST_CULL) != 0; L.inst_os = s.w(INST_OS) != 0;
  }
  if constexpr (X::kColdRows) {
#pragma unroll
    for (int f = 0; f < N_FIXED; ++f)
      if (!is_hot(f)) x.cold.w(f) = s.w(f);
  }
  if constexpr (kDeep) {
    L.stk = x.tb.stack + s.i;
    L.stride = s.n;
  } else {
    L.stk = ring;
  }
  // Slot k of the buffer is the k-th entry from the top; the entries
  // are contiguous from slot 0. The top goes to ring entry sp - 1.
  const int depth = x.c.s_depth;
  int sp = 0;
  while (sp < depth && s.w(stack_base + sp) != kEmpty) ++sp;
  for (int k = 0; k < sp; ++k) L.slot(sp - 1 - k) = s.w(stack_base + k);
  L.sp = sp;
  L.head = sp == depth ? 0 : sp;
  L.n_box = L.n_leaf = L.n_seg = L.n_enter = L.n_exit = L.n_group = 0;
}

template <bool kTlas, bool kDeep, int kS, class X>
__device__ __forceinline__ void store_lane(Lane<kDeep, kS>& L, const X& x, int stack_base) {
  const Words& s = x.s;
  s.w(DONE) = L.done;
  s.w(ENTRY) = (uint32_t)L.entry; s.w(CUR) = (uint32_t)L.cur;
  s.w(CUR_LEAF) = L.cur_leaf; s.w(CUR_SLOT) = (uint32_t)L.cur_slot;
  s.put(LO_X, L.lo); s.put(LD_X, L.ld); s.put(LID_X, L.lid);
  s.put(LT, L.lt); s.w(LMESH) = (uint32_t)L.lmesh; s.put(W_DST, L.w_dst);
  if constexpr (kTlas) {
    s.w(IN_INST) = L.in_inst; s.w(CUR_INST) = L.cur_inst;
    s.w(INST_MESH) = (uint32_t)L.inst_mesh; s.put(INST_SCALE, L.inst_scale);
    s.w(INST_CULL) = L.inst_cull; s.w(INST_OS) = L.inst_os;
  }
  if constexpr (X::kColdRows) {
#pragma unroll
    for (int f = 0; f < N_FIXED; ++f)
      if (!is_hot(f)) s.w(f) = x.cold.w(f);
  }
  const int depth = x.c.s_depth;
  int e = L.head;
  for (int k = 0; k < depth; ++k) {
    e = e == 0 ? depth - 1 : e - 1;  // the k-th entry from the top
    s.w(stack_base + k) = k < L.sp ? L.slot(e) : kEmpty;
  }
}

// WorldToLocalRay (Trace.cl:118-137) for chain entry ``entry``.
template <class X>
__device__ __forceinline__ void enter(const X& x, int entry, V origin, V direction,
                                      V& lo, V& ld, V& lid, int& root, bool& leaf) {
  int ec = min(entry, x.c.e_count - 1);
  const float* cp = x.tb.chain + ec * kCpWidth;
  float safe = safe_scale(cp[12]);
  lo = rot_t(cp + 3, origin - ld3(cp)) / safe;
  ld = normalize(rot_t(cp + 3, direction) / safe);
  lid = v3(1.0f / ld.x, 1.0f / ld.y, 1.0f / ld.z);
  root = x.chain_root()[ec];
  leaf = x.chain_leaf()[ec] != 0;
}

template <class X>
__device__ __forceinline__ bool pretest(const X& x, int entry, V lo, V lid, float w_dst) {
  const float* cp = x.tb.chain + min(entry, x.c.e_count - 1) * kCpWidth;
  return aabb(lo, lid, ld3(cp + 15), ld3(cp + 18), w_dst / safe_scale(cp[12]) * kGrow);
}

struct TwoBest {
  int best_prio, first_meta, second_prio, second_meta, hits;
  __device__ void init(int arity) {
    best_prio = second_prio = arity;
    first_meta = second_meta = hits = 0;
  }
  // A new best demotes the old best to second.
  __device__ void add(int prio, int meta) {
    if (prio < best_prio) {
      second_prio = best_prio; second_meta = first_meta;
      best_prio = prio; first_meta = meta;
    } else if (prio < second_prio) {
      second_prio = prio; second_meta = meta;
    }
    ++hits;
  }
};

// Root-node test of expanded entry ``e`` at enter time (_expand_root).
template <class Ln, class X>
__device__ __forceinline__ void expand_root(const X& x, Ln& L, int e) {
  const int arity = x.c.arity;
  const float* rf = x.tb.roots_f + e * (1 + 6 * arity);
  const int* ri = x.tb.roots_i + e * arity;
  float limit = minp(L.lt, L.w_dst / safe_scale(x.tb.chain[e * kCpWidth + 12]) * kGrow);
  float axis = rf[0];
  float dcomp = axis == 0.0f ? L.ld.x : (axis == 1.0f ? L.ld.y : L.ld.z);
  bool fwd = dcomp >= 0.0f;
  TwoBest b;
  b.init(arity);
  for (int slot = 0; slot < arity; ++slot) {
    int meta = ri[slot];
    if (meta == 0) continue;
    const float* bb = rf + 1 + 6 * slot;
    if (aabb(L.lo, L.lid, ld3(bb), ld3(bb + 3), limit))
      b.add(fwd ? slot : arity - 1 - slot, meta);
  }
  if (b.best_prio < arity) {
    L.cur = b.first_meta >> 1;
    L.cur_leaf = (b.first_meta & 1) == 1;
    // Entering lanes hold an empty stack (see megakernel._expand_root).
    L.sp = 0;
    L.head = 0;
    if (b.hits >= 3)
      push(L, ((uint32_t)x.chain_root()[e] << kSlotBits) | (uint32_t)(b.second_prio + 1),
           x.c.s_depth);
    if (b.hits >= 2) push(L, kTag | (uint32_t)b.second_meta, x.c.s_depth);
  } else {
    L.cur = -1;
    L.cur_leaf = false;
  }
}

// Dense MT of the inline static triangles for a fresh ray: the w words
// of its nearest static hit (none: invalid at infinity); returns its
// distance.
template <class X>
TPURT_MK_RARE float static_stage(const X& x, V origin, V direction) {
  const auto& C = x.cold;
  C.w(W_VALID) = 0u; C.put(W_POINT_X, v3(0.0f, 0.0f, 0.0f));
  C.put(W_NORMAL_X, v3(0.0f, 0.0f, 0.0f)); C.w(W_BACK) = 0u; C.w(W_MESH) = (uint32_t)-1;
  if (x.c.n_static == 0) return INFINITY;
  V ld = normalize(direction);
  float lt = INFINITY;
  V lnrm = v3(0.0f, 0.0f, 0.0f);
  bool lback = false;
  int lmesh = -1;
  for (int s = 0; s < x.c.n_static; ++s) {
    const float* r = x.tb.srows + 19 * s;
    V pa = ld3(r);
    float t;
    V n;
    bool bf;
    if (!mt(origin, ld, pa, ld3(r + 3) - pa, ld3(r + 6) - pa, ld3(r + 9), ld3(r + 12),
            ld3(r + 15), x.s_cull()[s] != 0, t, n, bf))
      continue;
    if (x.s_onesided()[s] && bf) continue;
    if (t < lt) { lt = t; lnrm = n; lback = bf; lmesh = x.s_owner()[s]; }
  }
  if (lmesh < 0) return INFINITY;
  const V point = origin + ld * lt;
  C.w(W_VALID) = 1u; C.put(W_POINT_X, point); C.put(W_NORMAL_X, normalize(lnrm));
  C.w(W_BACK) = lback; C.w(W_MESH) = (uint32_t)lmesh;
  return length(point - origin);
}

// One material interaction of a lane at the shading stage
// (shading.shade_hit_soa with enabled = true), on its cold words.
// Returns kContinuing | kInvisible flags.
constexpr int kContinuing = 1, kInvisible = 2;
template <class X>
TPURT_MK_RARE int shade_hit(const X& x) {
  const auto& C = x.cold;
  const float* m = x.tb.mats + kMatWidth * max((int)C.w(W_MESH), 0);
  float mtype = m[0], ior = m[1];
  V color = ld3(m + 2), em_color = ld3(m + 5);
  float em_strength = m[8], refl = m[9], spec_prob = m[10];
  V hp = C.v(W_POINT_X), hn = C.v(W_NORMAL_X), dir = C.v(DIRECTION_X);

  bool a_hit = C.w(W_VALID) != 0;
  const bool invisible = a_hit && mtype == 2.0f;
  bool scatter = a_hit && !invisible;
  bool is_checker = scatter && mtype == 1.0f;
  if (is_checker) {
    float size = em_strength != 0.0f ? em_strength : 1.0f;
    int xi = (int)floorf(hp.x / size);
    int zi = (int)floorf(hp.z / size);
    if (((xi + zi) & 1) != 0) color = em_color;
    em_strength = 0.0f;
  }
  bool mask_cs = is_checker || (scatter && mtype == 0.0f);
  uint32_t rng = C.w(RNG);
  V dir_cs = dir;
  if (mask_cs) {
    float rv;
    V rd;
    rng = random_value(rng, rv);
    rng = random_direction(rng, rd);
    float t = refl * (spec_prob >= rv ? 1.0f : 0.0f);
    V diffuse = normalize(hn + rd);
    V specular = reflect(dir, hn);
    float w = 1.0f - t;
    dir_cs = normalize(v3(diffuse.x * w + specular.x * t, diffuse.y * w + specular.y * t,
                          diffuse.z * w + specular.z * t));
  }
  bool is_glassy = scatter && mtype == 3.0f;
  V new_dir = mask_cs ? dir_cs : dir;
  float glassy_w = 1.0f;
  if (is_glassy) {
    const bool w_back = C.w(W_BACK) != 0;
    float ior_cur = w_back ? ior : 1.0f;
    float ior_next = w_back ? 1.0f : ior;
    float rw = fresnel(dir, hn, ior_cur, ior_next);
    float r01;
    rng = rand01(rng, r01);
    bool will_reflect = r01 < rw;
    new_dir = will_reflect ? reflect(dir, hn) : refract(dir, hn, ior_cur, ior_next);
    glassy_w = will_reflect ? rw : 1.0f - rw;
  }
  V tn = C.v(THROUGHPUT_X) * glassy_w;

  // Common tail (Trace.cl:574-591), add-zero / mul-one forms kept.
  V contrib = tn * (em_color * em_strength);
  V zero = v3(0.0f, 0.0f, 0.0f);
  V light_new = C.v(LIGHT_X) + sel(scatter, contrib, zero);
  V origin_new = scatter ? hp + new_dir * kEps : C.v(ORIGIN_X);
  if (invisible) origin_new = hp + dir * kEps;
  tn = tn * sel(scatter, color, v3(1.0f, 1.0f, 1.0f));
  float p = maxp(maxp(tn.x, tn.y), tn.z);
  const int bounces = (int)C.w(BOUNCES);
  bool rr = scatter && bounces > 3;
  float q = maxp(1.0f - p, 0.05f);
  bool killed = false;
  if (rr) {
    float r01;
    rng = rand01(rng, r01);
    killed = r01 < q;
    if (!killed) tn = tn / (1.0f - q);
  }
  int bounces_new = bounces + (scatter ? 1 : 0);
  const bool continuing = a_hit && !killed && bounces_new < x.c.max_bounces;
  C.put(ORIGIN_X, origin_new);
  if (scatter) C.put(DIRECTION_X, new_dir);
  C.put(THROUGHPUT_X, tn);
  C.put(LIGHT_X, light_new);
  C.w(RNG) = rng;
  C.w(BOUNCES) = (uint32_t)bounces_new;
  return (continuing ? kContinuing : 0) | (invisible ? kInvisible : 0);
}

// A candidate hit folded to world space: kept where it is nearer than
// the lane's best (the w words).
template <class Ln, class X>
__device__ __forceinline__ void keep_nearer(const X& x, Ln& L, V point_w, V n_w) {
  const auto& C = x.cold;
  float dst = length(point_w - C.v(ORIGIN_X));
  if (dst < L.w_dst) {
    C.w(W_VALID) = 1u; L.w_dst = dst; C.put(W_POINT_X, point_w); C.put(W_NORMAL_X, n_w);
    C.w(W_BACK) = C.w(LBACK); C.w(W_MESH) = (uint32_t)L.lmesh;
  }
}

// The l words' reset after a fold or an instance exit.
template <class Ln, class X>
__device__ __forceinline__ void clear_local_hit(const X& x, Ln& L) {
  L.lt = INFINITY;
  x.cold.put(LNRM_X, v3(0.0f, 0.0f, 0.0f));
  x.cold.w(LBACK) = 0u;
  L.lmesh = -1;
}

// Next mesh: fold a finished entry (cur < 0) to world space and advance
// the lane to the next entry. The scale is that of the lane's frame at
// the start of the trip: the entry's, or in the TLAS regime the
// instance's where the lane was inside one (``in_inst``, ``inst_scale``
// as they were then). Returns in_chain.
template <bool kTlas, class Ln, class X>
__device__ __forceinline__ bool fold(const X& x, Ln& L, bool in_inst, float inst_scale) {
  const int E = x.c.e_count;
  if (!(L.entry < E && L.cur < 0)) return false;
  const float* cp = x.tb.chain + min(L.entry, E - 1) * kCpWidth;
  float scale_e = cp[12];
  if constexpr (kTlas) {
    if (in_inst) scale_e = inst_scale;
  }
  bool lvalid = L.lmesh >= 0 && !(cp[13] != 0.0f && x.cold.w(LBACK) != 0) && scale_e > kEps;
  if (lvalid)
    keep_nearer(x, L, rot_fwd(cp + 3, (L.lo + L.ld * L.lt) * scale_e) + ld3(cp),
                normalize(rot_fwd(cp + 3, x.cold.v(LNRM_X))));
  L.entry += 1;
  clear_local_hit(x, L);
  return L.entry < E;
}

// A trip on an instance row (kTlas; megakernel._instance_step): enter
// it or, when its exit marker brought the lane back, exit it. Returns
// whether the lane pops its stack.
template <class Ln, class X>
__device__ __forceinline__ bool instance_step(const X& x, Ln& L, const float* row) {
  const auto& C = x.cold;
  const float scale = row[12];
  const float safe = safe_scale(scale);
  if (!L.in_inst) {
    ++L.n_enter;
    // WorldToLocalRay with the baked transform, in enter()'s op order,
    // then the root pretest; a degenerate scale skips the instance.
    V lo = rot_t(row + 3, C.v(ORIGIN_X) - ld3(row)) / safe;
    V ld = normalize(rot_t(row + 3, C.v(DIRECTION_X)) / safe);
    V lid = v3(1.0f / ld.x, 1.0f / ld.y, 1.0f / ld.z);
    if (!(aabb(lo, lid, ld3(row + 16), ld3(row + 19), L.w_dst / safe * kGrow) &&
          scale > kEps))
      return true;
    push(L, kTag | kITag | ((uint32_t)L.cur << 1), x.c.s_depth);  // the exit marker
    const int root = __float_as_int(row[15]), flags = __float_as_int(row[13]);
    L.cur = (int)((uint32_t)root & kMetaT) >> 1;
    L.cur_leaf = (root & 1) == 1;
    L.cur_slot = 0;
    L.cur_inst = false;
    L.in_inst = true;
    L.inst_mesh = __float_as_int(row[14]);
    L.inst_scale = scale;
    L.inst_cull = (flags & 2) != 0;
    L.inst_os = (flags & 1) != 0;
    L.lo = lo; L.ld = ld; L.lid = lid;
    return false;
  }
  ++L.n_exit;
  // LocalToWorldHit of the instance's best, in fold()'s op order.
  if (L.lmesh >= 0 && !(L.inst_os && C.w(LBACK) != 0))
    keep_nearer(x, L, rot_fwd(row + 3, (L.lo + L.ld * L.lt) * scale) + ld3(row),
                normalize(rot_fwd(row + 3, C.v(LNRM_X))));
  L.in_inst = false;
  int root;
  bool leaf;
  enter(x, L.entry, C.v(ORIGIN_X), C.v(DIRECTION_X), L.lo, L.ld, L.lid, root, leaf);
  clear_local_hit(x, L);
  return true;
}

// A 16-byte word of a bank row, through the read-only data path.
__device__ __forceinline__ float4 ld_row4(const float4* p) { return __ldg(p); }

// Triangle J (0-3) of a group of four in a leaf row: words [19 J, 19 J +
// 19) of the group's 76, which start at ``g4`` (every fourth triangle
// starts a 16-byte word). Its float4s are loaded, the first from
// ``carry`` where the previous triangle's last one holds it, and the
// triangle is tested against the lane's nearest in the plain version's
// order; a nearer hit goes to lt, lmesh and (hn, hb).
template <int J, bool kTlas, class Ln, class X>
__device__ __forceinline__ void leaf_tri(const X& x, Ln& L, const float4* g4, float4& carry,
                                         bool is_static, bool cull_mesh_e, int entry_mesh,
                                         bool in_inst, bool& hit, V& hn, bool& hb) {
  constexpr int w0 = 19 * J, first = w0 / 4, last = (w0 + 18) / 4, o = w0 - 4 * first;
  float t[4 * (last - first + 1)];
#pragma unroll
  for (int q = 0; q <= last - first; ++q) {
    const float4 v = (J > 0 && q == 0) ? carry : ld_row4(g4 + first + q);
    t[4 * q] = v.x; t[4 * q + 1] = v.y; t[4 * q + 2] = v.z; t[4 * q + 3] = v.w;
    carry = v;
  }
  int aux = __float_as_int(t[o + 18]);
  bool cull = cull_mesh_e;
  if (is_static)
    cull = (aux >= 0 && aux < x.c.num_meshes) ? x.mesh_cull()[aux] != 0 : true;
  if constexpr (kTlas) {
    if (in_inst) cull = L.inst_cull;
  }
  const V pa = v3(t[o], t[o + 1], t[o + 2]);
  float tt;
  V n;
  bool bf;
  if (mt(L.lo, L.ld, pa, v3(t[o + 3], t[o + 4], t[o + 5]) - pa,
         v3(t[o + 6], t[o + 7], t[o + 8]) - pa, v3(t[o + 9], t[o + 10], t[o + 11]),
         v3(t[o + 12], t[o + 13], t[o + 14]), v3(t[o + 15], t[o + 16], t[o + 17]), cull, tt,
         n, bf) &&
      tt < L.lt) {
    L.lt = tt; hn = n; hb = bf; hit = true;
    L.lmesh = in_inst ? L.inst_mesh : (is_static ? aux : entry_mesh);
  }
}

// A child slot of a node row (its words w0, w1, w2 and its meta): the
// box test for the slots the resumed node still visits.
template <bool kBf16, class Ln>
__device__ __forceinline__ void node_slot(Ln& L, TwoBest& b, int slot, int arity, bool fwd,
                                          V go, V gs, float limit, float f0, float f1,
                                          float f2, float fmeta) {
  const int meta = __float_as_int(fmeta);
  const int prio = fwd ? slot : arity - 1 - slot;
  if (meta == 0 || prio < L.cur_slot) return;
  ++L.n_box;
  uint32_t w0 = __float_as_uint(f0), w1 = __float_as_uint(f1);
  V bmin, bmax;
  if constexpr (kBf16) {
    uint32_t w2 = __float_as_uint(f2);
    bmin = v3(__uint_as_float(w0 << 16), __uint_as_float(w0 & 0xFFFF0000u),
              __uint_as_float(w1 << 16));
    bmax = v3(__uint_as_float(w1 & 0xFFFF0000u), __uint_as_float(w2 << 16),
              __uint_as_float(w2 & 0xFFFF0000u));
  } else {
    V q_lo = v3((float)(int)(w0 & 255u), (float)(int)((w0 >> 8) & 255u),
                (float)(int)((w0 >> 16) & 255u));
    V q_hi = v3((float)(int)((w0 >> 24) & 255u), (float)(int)(w1 & 255u),
                (float)(int)((w1 >> 8) & 255u));
    bmin = go + q_lo * gs;
    bmax = go + q_hi * gs;
  }
  if (aabb(L.lo, L.lid, bmin, bmax, limit)) b.add(prio, meta);
}

// The BVH trip's traversal step — one bank row — then the fold.
template <bool kTlas, bool kBf16, class Ln, class X>
__device__ __forceinline__ bool traverse_rows(const X& x, Ln& L) {
  const int E = x.c.e_count;
  const int ec = min(L.entry, E - 1);
  const float* cp = x.tb.chain + ec * kCpWidth;
  // The frame at the start of the trip (an instance step may change it).
  bool in_inst = false;
  float inst_scale = 1.0f;
  if constexpr (kTlas) {
    in_inst = L.in_inst;
    inst_scale = L.inst_scale;
  }
  if (L.entry < E && L.cur >= 0) {
    const float* row = x.tb.rows + (size_t)L.cur * x.c.row_width;
    const float4* r4 = reinterpret_cast<const float4*>(row);
    bool pop_top;
    bool inst_row = false;
    if constexpr (kTlas) inst_row = L.cur_inst;
    if (inst_row) {
      pop_top = instance_step(x, L, row);
    } else if (L.cur_leaf) {
      ++L.n_leaf;
      const int entry_mesh = x.chain_mesh()[ec];
      const bool is_static = entry_mesh < 0;
      const bool cull_mesh_e = cp[14] != 0.0f;
      const int n_tris = x.c.leaf_tris;
      bool hit = false, hb = false;
      V hn = v3(0.0f, 0.0f, 0.0f);
      for (int g = 0; g < n_tris; g += 4) {
        const float4* g4 = r4 + 19 * (g >> 2);
        float4 carry = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        leaf_tri<0, kTlas>(x, L, g4, carry, is_static, cull_mesh_e, entry_mesh, in_inst, hit,
                           hn, hb);
        if (g + 1 < n_tris)
          leaf_tri<1, kTlas>(x, L, g4, carry, is_static, cull_mesh_e, entry_mesh, in_inst, hit,
                             hn, hb);
        if (g + 2 < n_tris)
          leaf_tri<2, kTlas>(x, L, g4, carry, is_static, cull_mesh_e, entry_mesh, in_inst, hit,
                             hn, hb);
        if (g + 3 < n_tris)
          leaf_tri<3, kTlas>(x, L, g4, carry, is_static, cull_mesh_e, entry_mesh, in_inst, hit,
                             hn, hb);
      }
      if (hit) {
        x.cold.put(LNRM_X, hn);
        x.cold.w(LBACK) = hb;
      }
      pop_top = true;
    } else {
      // Node row: arity children, visited in direction-signed priority
      // order; cur_slot floors the priority of a resumed node. Words 0-6
      // (grid origin, grid step, split axis) and word 7, slot 0's first,
      // come in two float4s; then u8: 3 words a slot, four slots in
      // three float4s, a slot's first word carried from the float4
      // before; bf16: absolute bounds, 4 words a slot, one float4 each.
      const int arity = x.c.arity;
      const float limit =
          minp(L.lt, L.w_dst / safe_scale(in_inst ? inst_scale : cp[12]) * kGrow);
      const float4 h0 = ld_row4(r4), h1 = ld_row4(r4 + 1);
      const V go = v3(h0.x, h0.y, h0.z), gs = v3(h0.w, h1.x, h1.y);
      const int axis = __float_as_int(h1.z);
      float carry = h1.w;
      float dcomp = axis == 0 ? L.ld.x : (axis == 1 ? L.ld.y : L.ld.z);
      bool fwd = dcomp >= 0.0f;
      TwoBest b;
      b.init(arity);
      if constexpr (kBf16) {
        for (int slot = 0; slot < arity; ++slot) {
          const float4 q = ld_row4(r4 + 2 + slot);
          node_slot<true>(L, b, slot, arity, fwd, go, gs, limit, carry, q.x, q.y, q.z);
          carry = q.w;
        }
      } else {
        const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int g = 0; g < arity; g += 4) {
          const float4* g4 = r4 + 2 + 3 * (g >> 2);
          // Only the float4s the row's slots reach are loaded.
          const float4 qa = ld_row4(g4);
          const float4 qb = g + 1 < arity ? ld_row4(g4 + 1) : none;
          const float4 qc = g + 3 < arity ? ld_row4(g4 + 2) : none;
          node_slot<false>(L, b, g, arity, fwd, go, gs, limit, carry, qa.x, 0.0f, qa.y);
          if (g + 1 < arity)
            node_slot<false>(L, b, g + 1, arity, fwd, go, gs, limit, qa.z, qa.w, 0.0f, qb.x);
          if (g + 2 < arity)
            node_slot<false>(L, b, g + 2, arity, fwd, go, gs, limit, qb.y, qb.z, 0.0f, qb.w);
          if (g + 3 < arity)
            node_slot<false>(L, b, g + 3, arity, fwd, go, gs, limit, qc.x, qc.y, 0.0f, qc.z);
          carry = qc.w;
        }
      }
      pop_top = b.best_prio >= arity;
      if (!pop_top) {
        // The 2nd-nearest hit child goes on top RESOLVED (tag set); a
        // (row, slot) resume entry below it only when a third exists.
        if (b.hits >= 3)
          push(L, ((uint32_t)L.cur << kSlotBits) | (uint32_t)(b.second_prio + 1), x.c.s_depth);
        if (b.hits >= 2) push(L, kTag | (uint32_t)b.second_meta, x.c.s_depth);
        if constexpr (kTlas) {
          L.cur = (int)((uint32_t)b.first_meta & kMetaT) >> 1;
          L.cur_inst = ((uint32_t)b.first_meta & kITag) != 0;
        } else {
          L.cur = b.first_meta >> 1;
        }
        L.cur_leaf = (b.first_meta & 1) == 1;
        L.cur_slot = 0;
      }
    }
    if (pop_top) {
      if (L.sp == 0) {
        L.cur = -1;
        if constexpr (kTlas) L.cur_inst = false;
      } else {
        uint32_t top = pop(L, x.c.s_depth);
        bool resolved = (top & kTag) != 0;
        uint32_t meta = top & 0x7FFFFFFFu;
        if constexpr (kTlas) {
          L.cur = resolved ? (int)((meta & kMetaT) >> 1) : (int)(top >> kSlotBits);
          L.cur_inst = resolved && (meta & kITag) != 0;
        } else {
          L.cur = resolved ? (int)(meta >> 1) : (int)(top >> kSlotBits);
        }
        L.cur_slot = resolved ? 0 : (int)(top & kSlotMask);
        L.cur_leaf = resolved && (meta & 1u) == 1u;
      }
    }
  }
  return fold<kTlas>(x, L, in_inst, inst_scale);
}

// The dense trip's traversal step for a lane whose entry the block
// sweep resolved (winner ``col``, -1 on a miss, at ``t_sw``): acceptance
// and t from the sweep; normal, backface and the cull verdict from the
// exact test on the winner (megakernel._dense_hit). Then the fold.
template <class Ln, class X>
__device__ __forceinline__ bool traverse_swept(const X& x, Ln& L, int col, float t_sw) {
  ++L.n_leaf;
  L.lt = t_sw;
  L.lmesh = -1;
  if (col >= 0) {
    const float* r = x.tb.dt.rows + 18 * (size_t)col;
    const V pa = ld3(r);
    float te;
    V n;
    bool bf;
    if (mt(L.lo, L.ld, pa, ld3(r + 3) - pa, ld3(r + 6) - pa, ld3(r + 9), ld3(r + 12),
           ld3(r + 15), x.tb.dt.cull[col] != 0.0f, te, n, bf)) {
      x.cold.put(LNRM_X, n);
      x.cold.w(LBACK) = bf;
      L.lmesh = x.tb.dt.owner[col];
    }
  }
  L.cur = -1;
  return fold<false>(x, L, false, 1.0f);
}

// The jittered primary ray of a lane's pixel and sample
// (megakernel.primary_ray): pixel uv, the jitter stream MakeSeed(pix ^
// salt, frame, sample), make_ray on the camera's scalars.
#if TPURT_MK_JITTER
constexpr uint32_t kJitterSalt = 0xA511E9B3u;  // core/camera.JITTER_SALT

__device__ __forceinline__ void primary_ray(const MkCfg& c, uint32_t pix, int sample, V& o,
                                            V& d) {
  const float w = (float)c.width, h = (float)c.height;
  float u = (float)((int)pix % c.width) / w;
  float v = 1.0f - (float)((int)pix / c.width) / h;
  float jx, jy;
  const uint32_t s = random_value(make_seed(pix ^ kJitterSalt, c.frame_index, (uint32_t)sample), jx);
  random_value(s, jy);
  u = u + (jx - 0.5f) / w;
  v = v + (jy - 0.5f) / h;
  const float nx = (u * 2.0f - 1.0f) * c.cam_aspect, ny = v * 2.0f - 1.0f;
  d = normalize(rot_t(c.cam_rot, normalize(v3(nx * c.cam_tan, ny * c.cam_tan, 1.0f))));
  o = ld3(c.cam_pos);
}
#endif

// The frame of quota slot ``pixno``: a cross-frame pack adds the slot's
// frame offset pixno / ppf.
__device__ __forceinline__ int slot_frame(const MkCfg& c, int pixno) {
  return c.frames > 1 ? c.frame_index + pixno / c.ppf : c.frame_index;
}

// The zero contribution a tail pass that ends no path adds to acc, once
// (Lane::acc_raw).
template <class Ln, class X>
__device__ __forceinline__ void add_zero_once(const X& x, Ln& L) {
  if (L.acc_raw) {
    x.cold.put(ACC_X, x.cold.v(ACC_X) + v3(0.0f, 0.0f, 0.0f));
    L.acc_raw = false;
  }
}

// Segment completion: shade -> accumulate/advance -> restart -> static
// stage -> chain enter (pretest, chain skip, root expansion). A pass on a
// lane that completes no segment touches no cold word but, once after
// a path's end, acc (add_zero_once), unless it enters the next chain
// entry.
template <bool kTlas, class Ln, class X>
__device__ __forceinline__ void tail(const X& x, Ln& L, bool entering_in, bool do_expand) {
  const MkCfg& c = x.c;
  const auto& C = x.cold;
  const int E = c.e_count;
  const V zero = v3(0.0f, 0.0f, 0.0f);
  V origin, direction;
  if (L.done || L.entry < E) {
    add_zero_once(x, L);
    if (E == 0 || !entering_in) return;
    origin = C.v(ORIGIN_X);
    direction = C.v(DIRECTION_X);
  } else {
    int sample = (int)C.w(SAMPLE);
    if (c.use_cache && C.w(C_SET) == 0 && C.w(BOUNCES) == 0 && sample == 0) {
      C.w(C_SET) = 1u; C.w(C_VALID) = C.w(W_VALID); C.put(C_POINT_X, C.v(W_POINT_X));
      C.put(C_NORMAL_X, C.v(W_NORMAL_X)); C.w(C_BACK) = C.w(W_BACK);
      C.w(C_MESH) = C.w(W_MESH); C.put(C_DST, L.w_dst);
    }
    C.w(SEGMENTS) += 1u;
    ++L.n_seg;
    // One completion group: the threads of the warp that run this
    // completion together; its lowest thread counts it.
    L.n_group += (threadIdx.x & 31u) == (unsigned)(__ffs(__activemask()) - 1);
    const int shaded = shade_hit(x);
    bool continuing = (shaded & kContinuing) != 0;
    if (shaded & kInvisible) {
      const int invis = (int)C.w(INVIS) + 1;
      C.w(INVIS) = (uint32_t)invis;
      continuing = continuing && !(invis > c.invisible_budget);
    }
    const bool path_end = !continuing;
    V acc = C.v(ACC_X);
    if (path_end) {
      acc = acc + C.v(LIGHT_X);
      sample += 1;
    } else if (L.acc_raw) {
      acc = acc + zero;
    }
    L.acc_raw = path_end;
    const bool pix_done = path_end && sample >= c.rays_per_pixel;
    bool retire = pix_done, advance = false;
    int pixno = (int)C.w(PIXNO);
    uint32_t pix = C.w(PIX);
    if (c.p_count > 1 && pix_done) {
      bool last_pix = pixno >= c.p_count - 1;
      retire = last_pix;
      advance = !last_pix;
      x.s.put(kAccBase<kTlas> + 3 * pixno, acc);  // bank into the quota slot
      acc = zero;
      L.acc_raw = false;
      sample = 0;
      if (advance) {
        pixno += 1;
        int row = pixno - 1;
        if (c.frames > 1) {
          // The table advance: slot pixno % ppf's pixel, and the direction
          // table's row (pixno - 1) % rd_rows.
          pix = x.tb.slot_pix[(size_t)(pixno % c.ppf) * x.s.n + x.s.i];
          row %= c.rd_rows;
        } else {
          pix = (uint32_t)min((int)pix + c.pixel_stride, c.width * c.height - 1);
        }
        const float* sr = x.tb.slot_rd + (size_t)row * x.s.n + x.s.i;
        size_t comp = (size_t)c.rd_rows * x.s.n;
        C.put(RD0_X, v3(sr[0], sr[comp], sr[2 * comp]));
        C.w(PIX) = pix;
        C.w(PIXNO) = (uint32_t)pixno;
      }
    }
    C.put(ACC_X, acc);
    C.w(SAMPLE) = (uint32_t)sample;
    L.done = retire;
    const bool new_sample = path_end && !retire;
    if (!c.seed_reference) {
      if (new_sample)
        C.w(RNG) = make_seed(pix, slot_frame(c, pixno),
                             (uint32_t)sample + (uint32_t)c.sample_offset);
    } else if (advance) {
      // Reference mode: one seed per PIXEL (Trace.cl:632-641).
      C.w(RNG) = make_seed(pix, slot_frame(c, pixno), 0u);
    }
    if (new_sample) {
#if TPURT_MK_JITTER
      primary_ray(c, pix, sample, origin, direction);
#else
      origin = C.v(RO0_X);
      direction = C.v(RD0_X);
#endif
      C.put(ORIGIN_X, origin); C.put(DIRECTION_X, direction);
      C.put(THROUGHPUT_X, v3(1.0f, 1.0f, 1.0f)); C.put(LIGHT_X, zero);
      C.w(BOUNCES) = 0u; C.w(INVIS) = 0u;
    } else {
      origin = C.v(ORIGIN_X);
      direction = C.v(DIRECTION_X);
    }
    bool replay = false;
    if (c.use_cache) {
      if (advance) C.w(C_SET) = 0u;
      replay = new_sample && C.w(C_SET) != 0;
    }
    const bool restart = continuing || (new_sample && !replay);
    if (restart) { L.entry = 0; L.sp = 0; }
    C.w(W_VALID) = 0u; L.w_dst = INFINITY; C.w(W_MESH) = (uint32_t)-1;
    if (restart) L.w_dst = static_stage(x, origin, direction);
    if (replay) {
      L.entry = E;
      C.w(W_VALID) = C.w(C_VALID); L.w_dst = C.f(C_DST); C.put(W_POINT_X, C.v(C_POINT_X));
      C.put(W_NORMAL_X, C.v(C_NORMAL_X)); C.w(W_BACK) = C.w(C_BACK);
      C.w(W_MESH) = C.w(C_MESH);
    }
    if (E == 0 || !(entering_in || restart)) return;
  }
  if constexpr (kTlas) {
    // An entering lane starts at the entry's root (a node row) in the
    // world frame.
    L.cur_inst = false;
    L.in_inst = false;
  }

  // Enter the chain at L.entry; a failed pretest advances the entry in
  // place (chain skip), up to n_skip further entries.
  int cur_e = L.entry, root;
  bool leaf;
  V lo, ld, lid;
  enter(x, cur_e, origin, direction, lo, ld, lid, root, leaf);
  bool ok = pretest(x, cur_e, lo, lid, L.w_dst);
  bool pend = !ok;
  for (int k = 0; k < c.n_skip && pend; ++k) {
    cur_e += 1;
    pend = false;
    if (cur_e < E) {
      V lo3, ld3_, lid3;
      int root3;
      bool leaf3;
      enter(x, cur_e, origin, direction, lo3, ld3_, lid3, root3, leaf3);
      bool ok3 = pretest(x, cur_e, lo3, lid3, L.w_dst);
      lo = lo3; ld = ld3_; lid = lid3; root = root3; leaf = leaf3; ok = ok3;
      pend = !ok3;
    }
  }
  if (pend && cur_e == E - 1) cur_e += 1;  // nothing left: shade now
  L.entry = cur_e;
  L.lo = lo; L.ld = ld; L.lid = lid;
  L.cur = ok ? root : -1;
  L.cur_leaf = leaf && ok;
  L.cur_slot = 0;
  if (do_expand && ok && cur_e < E && x.expand()[cur_e]) expand_root(x, L, cur_e);
}

// One loop trip after the traversal step: tail_passes segment
// completions (megakernel._body_math), at least one; the first enters
// the next chain entry where the fold advanced to one. One loop, so the
// inlined tail appears once.
template <bool kTlas, class Ln, class X>
__device__ __forceinline__ void trip_tail(const X& x, Ln& L, bool in_chain) {
  for (int p = 0; p == 0 || p < x.c.tail_passes; ++p)
    tail<kTlas>(x, L, p == 0 && in_chain, p < x.c.expand_passes);
}

// The next unstarted lane index from the queue; the threads of a warp
// that ask together share one atomicAdd.
__device__ __forceinline__ int take_lane(int* queue) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(queue, (int)g.size());
  return g.shfl(base, 0) + (int)g.thread_rank();
}

struct Out {
  uint32_t* state;
  int* trips;  // (R,) trips each lane ran in this launch
  int* work;   // (4, R) Lane::n_box, n_leaf, n_seg, n_group; TLAS: (6, R),
               // n_enter and n_exit before n_group
  int* queue;  // next unstarted lane index
};

// Stores a retired lane (its state is final for this launch).
template <bool kTlas, class Ln, class X>
__device__ __forceinline__ void retire(const X& x, Ln& L, int trips, const Out& o, int stack_base) {
  const int i = x.s.i, n = x.c.n_lanes;
  store_lane<kTlas>(L, x, stack_base);
  o.trips[i] = trips;
  o.work[i] = L.n_box;
  o.work[n + i] = L.n_leaf;
  o.work[2 * n + i] = L.n_seg;
  if constexpr (kTlas) {
    o.work[3 * n + i] = L.n_enter;
    o.work[4 * n + i] = L.n_exit;
  }
  o.work[(kTlas ? 5 : 3) * n + i] = L.n_group;
}

// Takes lanes from the queue until one needs a trip (retiring any that
// need none); false when the queue is empty.
template <bool kTlas, class Ln, class X>
__device__ __forceinline__ bool take_live(X& x, Ln& L, const Out& o, int stack_base,
                                          uint32_t* ring) {
  for (;;) {
    const int i = take_lane(o.queue);
    if (i >= x.c.n_lanes) return false;
    x.take(i);
    load_lane<kTlas>(L, x, stack_base, ring);
    if (!L.done && x.c.max_trips > 0) return true;
    retire<kTlas>(x, L, 0, o, stack_base);
  }
}

// Ends a trip of the dense megakernel's lane: a lane that is done or
// at max_trips retires and the thread takes the next. Returns whether
// the thread holds a live lane.
template <class Ln, class X>
__device__ __forceinline__ bool end_trip(X& x, Ln& L, int& trips, const Out& o, int stack_base,
                                         uint32_t* ring) {
  ++trips;
  if (!L.done && trips < x.c.max_trips) return true;
  retire<false>(x, L, trips, o, stack_base);
  trips = 0;
  return take_live<false>(x, L, o, stack_base, ring);
}

// The words of dynamic shared memory a thread takes: its stack ring
// (none in kDeep) and, where they are in shared memory, its cold rows.
__host__ __device__ constexpr int shared_words(bool dense, bool deep, int s_depth) {
  return (deep ? 0 : s_depth) +
         ((dense ? kDenseColdAt : kColdAt) == kColdInShared ? kColdWords : 0);
}

// The BVH megakernel (kDense = false): each thread runs its lane's
// trips to the end, then takes the next; no barriers. The dense one
// (kDense = true, unrolled chain and u8 only: it reads no node row): the
// loop is block-uniform around the block sweep, which every thread
// joins. Before it, each thread runs its lane's trips that need no sweep
// (the entry is finished or was skipped: fold and tail only), taking new
// lanes as they retire, so that at the sweep every live lane sweeps. A
// lane's trips are the same trips in the same order whichever loop runs
// them. Dynamic shared memory: the threads' stack rings, [entry][thread]
// (s_depth x blockDim words; none in kDeep), then, where they are in
// shared memory, the cold rows [row][thread].
template <bool kDense, bool kTlas, bool kBf16, bool kDeep>
__global__ void __launch_bounds__(kDense ? kDenseThreads : kThreads,
                                  kDense ? kDenseMinBlocks : kMinBlocks)
    megakernel(MkCfg c, Tables tb, Out o) {
  static_assert(!(kDense && (kTlas || kBf16 || kDeep)), "the dense kernel walks no rows");
  extern __shared__ uint32_t dyn[];
  constexpr int T = kDense ? kDenseThreads : kThreads;
  const int tid = (int)threadIdx.x;
  uint32_t* ring = dyn + tid;
  constexpr int kAt = kDense ? kDenseColdAt : kColdAt;
  uint32_t* cold_rows = dyn + (kDeep ? 0 : c.s_depth) * T + tid;
  Ctx<kAt> x{c, tb, Words{o.state, c.n_lanes, 0, {}},
             Cols<kAt>{kAt == kColdInShared ? cold_rows : o.state, c.n_lanes, 0, {}}};
  const int stack_base = kAccBase<kTlas> + (c.p_count > 1 ? 3 * c.p_count : 0);
  const int E = c.e_count;
  Lane<kDeep, T> L;
  if constexpr (!kDense) {
    while (take_live<kTlas>(x, L, o, stack_base, ring)) {
      int trips = 0;
      do {
        // A step that leaves its lane mid-walk (no fold into the next
        // entry, the chain not finished) makes a trip whose tail passes
        // only add acc's zero: the lane runs that and steps again, for
        // as long as kMinWalkers of the warp's lanes do so; a lane whose
        // walk ended waits for the warp to leave the loop, so that the
        // lanes at trip_tail complete their segments together. A lane's
        // trips are the same trips in the same order.
        bool in_chain = false, step = true;
        for (;;) {
          if (step) in_chain = E > 0 && traverse_rows<kTlas, kBf16>(x, L);
          step = step && !in_chain && L.entry < E && L.cur >= 0 && trips + 1 < c.max_trips;
          if (kMinWalkers > 32 || __popc(__ballot_sync(__activemask(), step)) < kMinWalkers)
            break;
          if (step) {
            add_zero_once(x, L);
            ++trips;
          }
        }
        trip_tail<kTlas>(x, L, in_chain);
        ++trips;
      } while (!L.done && trips < c.max_trips);
      retire<kTlas>(x, L, trips, o, stack_base);
    }
  } else {
    __shared__ SweepSmem<kDenseThreads> sm;
    int trips = 0;
    bool have = take_live<false>(x, L, o, stack_base, ring);
    while (__syncthreads_or(have)) {
      while (have && !(L.entry < E && L.cur >= 0)) {
        const bool in_chain = E > 0 && fold<false>(x, L, false, 1.0f);
        trip_tail<false>(x, L, in_chain);
        have = end_trip(x, L, trips, o, stack_base, ring);
      }
      // A thread that still holds a lane now needs a sweep.
      if (E > 0) {
        float t_sw;
        const int col = block_sweep<kDenseSweepUnroll>(
            tb.dt, have ? min(L.entry, E - 1) : -1, have ? L.lo.x : 0.0f, have ? L.lo.y : 0.0f,
            have ? L.lo.z : 0.0f, have ? L.ld.x : 0.0f, have ? L.ld.y : 0.0f,
            have ? L.ld.z : 0.0f, t_sw, sm);
        if (have) {
          trip_tail<false>(x, L, traverse_swept(x, L, col, t_sw));
          have = end_trip(x, L, trips, o, stack_base, ring);
        }
      }
    }
  }
}

// Threads a block of fresh_lanes.
constexpr int kFreshThreads = 256;

__device__ __forceinline__ float ray_at(const FreshIn& in, int k, int i) {
  return in.ray[k][(long long)i * in.stride[k]];
}

// Fresh lanes (megakernel._initial_lane), one thread a lane, written
// straight into the state buffer that the megakernel launch after it
// runs. Replaces no TPU kernel: the plain version built them with a
// thousand small torch operations, the host's time between launches.
// Bound by the buffer's bytes; its words come from the restart code of
// tail() above -- static_stage seeds the world best, enter and pretest
// chain entry 0, expand_root where entry 0 expands, at lt = +inf -- and
// store_lane writes the hot words and the stack, so a fresh lane holds
// the bits a restart computes. As _initial_lane, and unlike tail(), it
// skips no chain entry: a failed pretest leaves entry 0 and cur -1.
template <bool kTlas>
__global__ void __launch_bounds__(kFreshThreads)
    fresh_lanes(MkCfg c, Tables tb, FreshIn in, uint32_t* state) {
  const int i = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= c.n_lanes) return;
  const Ctx<kColdInBuffer> x{c, tb, Words{state, c.n_lanes, i, {}},
                             Words{state, c.n_lanes, i, {}}};
  const Words& s = x.s;
  const V ro = v3(ray_at(in, 0, i), ray_at(in, 1, i), ray_at(in, 2, i));
  const V rd = v3(ray_at(in, 3, i), ray_at(in, 4, i), ray_at(in, 5, i));
  const long long at = (long long)i * in.pix_stride;
  const uint32_t pix = in.pix_bytes == 8
                           ? (uint32_t)static_cast<const unsigned long long*>(in.pix)[at]
                           : static_cast<const uint32_t*>(in.pix)[at];
  const V zero = v3(0.0f, 0.0f, 0.0f);
  s.put(RO0_X, ro); s.put(RD0_X, rd);
  s.w(PIX) = pix; s.w(PIXNO) = 0u; s.w(SAMPLE) = 0u; s.put(ACC_X, zero);
  // megakernel._seed at sample 0: one seed a pixel in reference mode.
  s.w(RNG) = make_seed(pix, c.frame_index, c.seed_reference ? 0u : (uint32_t)c.sample_offset);
  s.w(SEGMENTS) = 0u;
  s.put(ORIGIN_X, ro); s.put(DIRECTION_X, rd);
  s.put(THROUGHPUT_X, v3(1.0f, 1.0f, 1.0f)); s.put(LIGHT_X, zero);
  s.w(BOUNCES) = 0u; s.w(INVIS) = 0u;
  s.put(LNRM_X, zero); s.w(LBACK) = 0u;
  // The cache words as mega_cuda.pack writes them: an empty cache
  // (mesh -1, distance +inf), or zeros where the cache is off.
  s.w(C_SET) = 0u; s.w(C_VALID) = 0u; s.put(C_POINT_X, zero); s.put(C_NORMAL_X, zero);
  s.w(C_BACK) = 0u;
  s.w(C_MESH) = c.use_cache ? (uint32_t)-1 : 0u;
  s.put(C_DST, c.use_cache ? INFINITY : 0.0f);
  const int stack_base = kAccBase<kTlas> + (c.p_count > 1 ? 3 * c.p_count : 0);
  for (int k = kAccBase<kTlas>; k < stack_base; ++k) s.w(k) = 0u;  // quota accumulators

  uint32_t ring[2];  // expand_root pushes at most two entries
  Lane<false, 1> L;
  L.stk = ring;
  L.head = L.sp = 0;
  L.done = false;
  L.entry = L.cur_slot = 0;
  L.lt = INFINITY;
  L.lmesh = -1;
  if constexpr (kTlas) {  // outside any instance, at a node row
    L.in_inst = L.cur_inst = L.inst_cull = L.inst_os = false;
    L.inst_mesh = -1;
    L.inst_scale = 1.0f;
  }
  L.w_dst = static_stage(x, ro, rd);
  if (c.e_count > 0) {
    int root;
    bool leaf;
    enter(x, 0, ro, rd, L.lo, L.ld, L.lid, root, leaf);
    const bool ok = pretest(x, 0, L.lo, L.lid, L.w_dst);
    L.cur = ok ? root : -1;
    L.cur_leaf = leaf && L.cur >= 0;
    if (ok && x.expand()[0]) expand_root(x, L, 0);
  } else {
    L.lo = ro; L.ld = rd; L.lid = v3(1.0f / rd.x, 1.0f / rd.y, 1.0f / rd.z);
    L.cur = -1;
    L.cur_leaf = false;
  }
  store_lane<kTlas>(L, x, stack_base);
  if (in.lane0) s.w(stack_base + c.s_depth) = (uint32_t)i;
}

}  // namespace

// The lane words before the quota accumulators: enum Field and the TLAS
// instantiation's enum TlasField.
extern "C" int tpurt_mk_fixed_words() { return N_TLAS_END; }

// Whether this library computes jittered primary rays (TPURT_MK_JITTER),
// and so takes the launch configuration with the camera's fields.
extern "C" int tpurt_mk_jitter() { return TPURT_MK_JITTER; }

extern "C" const char* tpurt_mk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace {

using KernelFn = void (*)(MkCfg, Tables, Out);

// The instantiation for ``variant`` = dense | tlas << 1 | bf16 << 2 |
// deep << 3 (mega_cuda._variant), its threads a block, or null if there
// is none.
KernelFn kernel_for(int variant, int* threads) {
  *threads = kThreads;
  switch (variant) {
    case 0: return megakernel<false, false, false, false>;
    case 2: return megakernel<false, true, false, false>;
    case 4: return megakernel<false, false, true, false>;
    case 6: return megakernel<false, true, true, false>;
    case 8: return megakernel<false, false, false, true>;
    case 10: return megakernel<false, true, false, true>;
    case 12: return megakernel<false, false, true, true>;
    case 14: return megakernel<false, true, true, true>;
    case 1:
    case 5:  // the dense kernel reads no node row: bounds format moot
      *threads = kDenseThreads;
      return megakernel<true, false, false, false>;
    default: return nullptr;
  }
}

}  // namespace

// The launch configuration of one instantiation on the current device
// for a stack budget of ``s_depth`` words: threads a block, resident
// blocks per SM, SMs, and the dynamic shared memory of a block
// (``shared_words`` a thread), which the occupancy counts; a block that
// needs more than 48 KB of shared memory in all is allowed its dynamic
// part first. Returns a cudaError_t.
extern "C" int tpurt_mk_occupancy(int variant, int s_depth, int* threads, int* blocks_per_sm,
                                  int* sms, int* smem_bytes) {
  KernelFn fn = kernel_for(variant, threads);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  *smem_bytes = 4 * *threads * shared_words((variant & 1) != 0, (variant & 8) != 0, s_depth);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && attr.sharedSizeBytes + (size_t)*smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, *threads,
                                                        (size_t)*smem_bytes);
  return (int)err;
}

// Launches the megakernel on ``stream`` — the dense instantiation when
// ``dense`` is not null, else the one cfg->tlas, cfg->bf16 and cfg->deep
// name (kDeep: the stacks on ``stack``, which the host sized) — as a
// persistent grid of resident blocks that take lanes from ``queue`` (an
// int the caller zeroed); returns a cudaError_t. A stack budget above
// kMaxSharedStack without kDeep, or kDeep with the dense sweep, is
// refused.
extern "C" int tpurt_mk_launch(const MkCfg* cfg, const float* rows, const float* chain,
                               const float* mats, const float* srows, const float* roots_f,
                               const int* roots_i, const int* meta, const float* slot_rd,
                               const uint32_t* slot_pix, uint32_t* stack, uint32_t* state,
                               int* trips, int* work, int* queue, const DenseTable* dense,
                               void* stream) {
  Tables tb{rows,    chain,    mats,  srows, roots_f, roots_i,
            meta,    slot_rd,  slot_pix, stack, DenseTable{}};
  if (cfg->n_lanes <= 0) return (int)cudaGetLastError();
  const bool deep = cfg->deep != 0;
  if (deep ? dense != nullptr : cfg->s_depth > kMaxSharedStack)
    return (int)cudaErrorInvalidValue;
  const int variant = (dense != nullptr) | (cfg->tlas != 0) << 1 | (cfg->bf16 != 0) << 2 |
                      (int)deep << 3;
  int threads = 0, per_sm = 0, sms = 0, smem = 0;
  int err = tpurt_mk_occupancy(variant, cfg->s_depth, &threads, &per_sm, &sms, &smem);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int needed = (cfg->n_lanes + threads - 1) / threads;
  const int blocks = per_sm * sms < needed ? per_sm * sms : needed;
  Out o{state, trips, work, queue};
  if (dense) tb.dt = *dense;
  MkCfg c = *cfg;
  void* args[] = {&c, &tb, &o};
  const cudaError_t launched =
      cudaLaunchKernel((const void*)kernel_for(variant, &threads), dim3(blocks),
                       dim3(threads), args, (size_t)smem, (cudaStream_t)stream);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

// Writes fresh lanes (fresh_lanes) into ``state``, an (n_words, R)
// buffer in the layout the launch after it takes, on ``stream``: the
// instantiation cfg->tlas names, with the launch's own configuration
// and tables (no bank row is read). Returns a cudaError_t.
extern "C" int tpurt_mk_fresh(const MkCfg* cfg, const float* chain, const float* srows,
                              const float* roots_f, const int* roots_i, const int* meta,
                              const FreshIn* in, uint32_t* state, void* stream) {
  if (cfg->n_lanes <= 0) return (int)cudaGetLastError();
  Tables tb{nullptr, chain,   nullptr, srows,   roots_f,
            roots_i, meta,    nullptr, nullptr, nullptr, DenseTable{}};
  const int blocks = (cfg->n_lanes + kFreshThreads - 1) / kFreshThreads;
  MkCfg c = *cfg;
  FreshIn f = *in;
  void* args[] = {&c, &tb, &f, &state};
  const void* fn = cfg->tlas != 0 ? (const void*)fresh_lanes<true> : (const void*)fresh_lanes<false>;
  const cudaError_t launched = cudaLaunchKernel(fn, dim3(blocks), dim3(kFreshThreads), args, 0,
                                                (cudaStream_t)stream);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}
