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
// What bounds it on the card: divergent per-lane row loads (each trip
// reads one 256-byte row at a data-dependent address; the bank, ~7 MB
// for the 69k-triangle mesh, stays resident in the 50 MB L2) and
// register pressure (the lane state is ~70 words plus a local-memory
// traversal stack). Warps diverge where lanes take different branches;
// reordering rays into coherent wavefronts is later work.
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
// Beside it the kernel writes each lane's trips and a (3, R) count of
// its work in this launch: child-box tests in node rows, leaf rows (in
// dense mode: entry sweeps), segment completions — from which the
// caller computes the launch's operation count.
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
//          (enum TlasField) carry the instance frame.
//   kDeep  the traversal stack lives in a scratch buffer in global
//          memory, (s_depth, R) words, instead of a kMaxStack-entry
//          array: for scenes whose stack budget (2 * mega_stack_depth)
//          exceeds kMaxStack. The other instantiations keep their array.
//
// Cross-frame packing (frames > 1, render_batch_flat_frames) is read at
// run time from the launch configuration, only where a lane advances to
// its next quota slot: the slot's pixel comes from a (ppf, R) table, its
// direction from the periodic slot table, and its frame offset pixno /
// ppf enters the seed. An unpacked launch takes the affine advance.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "dense_sweep.cuh"

namespace {

constexpr int kMaxStack = 64;
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
// and teapot batches (kernel_variants.py; PERF.md). Without a minimum
// nvcc gives both instantiations over 150 registers and 3 blocks per SM.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 9;
constexpr int kDenseThreads = 256;
constexpr int kDenseMinBlocks = 4;
constexpr int kDenseSweepUnroll = 1;

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
  // Cross-frame packing: frames in the launch (1 = unpacked), quota
  // slots a frame, and the rows of the slot direction table.
  int frames, ppf, rd_rows;
};

namespace {

struct Tables {
  const float* rows;     // (N, row_width) bank
  const float* chain;    // (E, 21) chain params
  const float* mats;     // (K, 11) materials
  const float* srows;    // (n_static, 19) static triangles
  const float* roots_f;  // (E, 1 + 6*arity) decoded root child bounds
  const int* roots_i;    // (E, arity) root child metas
  const int* meta;       // root[E] leaf[E] mesh[E] expand[E]
                         // s_cull[S] s_onesided[S] s_owner[S] mesh_cull[K]
  const float* slot_rd;  // (3, rd_rows, R) quota slot directions
  const uint32_t* slot_pix;  // (ppf, R) within-frame slot pixels (packed only)
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

// A lane's traversal stack, entry 0 at the bottom: a kMaxStack-entry
// array (local memory), or (kDeep) the lane's column of the launch's
// global scratch, entry k at stack[k * R + lane].
template <bool kDeep>
struct Stack {
  uint32_t e[kMaxStack];
  __device__ void bind(uint32_t*, int, int) {}
  __device__ uint32_t& operator[](int k) { return e[k]; }
  __device__ uint32_t operator[](int k) const { return e[k]; }
};
template <>
struct Stack<true> {
  uint32_t* p;
  int n;
  __device__ void bind(uint32_t* base, int n_lanes, int i) { p = base + i; n = n_lanes; }
  __device__ uint32_t& operator[](int k) { return p[(size_t)k * n]; }
  __device__ uint32_t operator[](int k) const { return p[(size_t)k * n]; }
};

template <bool kDeep>
struct Lane {
  V ro0, rd0;
  uint32_t pix;
  int pixno, sample;
  V acc;
  uint32_t rng;
  bool done;
  int segments;
  V origin, direction, throughput, light;
  int bounces, invis, entry, cur;
  bool cur_leaf;
  int cur_slot;
  V lo, ld, lid;
  float lt;
  V lnrm;
  bool lback;
  int lmesh;
  bool w_valid;
  float w_dst;
  V w_point, w_normal;
  bool w_back;
  int w_mesh;
  bool c_set, c_valid;
  V c_point, c_normal;
  bool c_back;
  int c_mesh;
  float c_dst;
  // TLAS regime (kTlas only): inside an instance; cur is an instance
  // row; the instance's owner mesh, scale, cull policy and OneSided flag.
  bool in_inst, cur_inst, inst_cull, inst_os;
  int inst_mesh;
  float inst_scale;
  int sp;  // stack entries; stk[sp - 1] is the top
  // This launch's work on the lane (not lane state): child-box tests,
  // leaf rows (dense: entry sweeps), segment completions, instance
  // enters and exits.
  int n_box, n_leaf, n_seg, n_enter, n_exit;
  Stack<kDeep> stk;
};

struct Words {
  uint32_t* p;
  int n;  // lanes (the row stride)
  int i;  // this lane
  __device__ uint32_t& w(int f) const { return p[(size_t)f * n + i]; }
  __device__ float f(int f) const { return __uint_as_float(w(f)); }
  __device__ V v(int f) const { return v3(this->f(f), this->f(f + 1), this->f(f + 2)); }
  __device__ void put(int f, float x) const { w(f) = __float_as_uint(x); }
  __device__ void put(int f, V a) const { put(f, a.x); put(f + 1, a.y); put(f + 2, a.z); }
};

template <bool kTlas, class Ln>
__device__ void load_lane(Ln& L, const Words& s, int stack_base, int s_depth, uint32_t* scratch) {
  L.ro0 = s.v(RO0_X); L.rd0 = s.v(RD0_X);
  L.pix = s.w(PIX); L.pixno = (int)s.w(PIXNO); L.sample = (int)s.w(SAMPLE);
  L.acc = s.v(ACC_X);
  L.rng = s.w(RNG); L.done = s.w(DONE) != 0; L.segments = (int)s.w(SEGMENTS);
  L.origin = s.v(ORIGIN_X); L.direction = s.v(DIRECTION_X);
  L.throughput = s.v(THROUGHPUT_X); L.light = s.v(LIGHT_X);
  L.bounces = (int)s.w(BOUNCES); L.invis = (int)s.w(INVIS);
  L.entry = (int)s.w(ENTRY); L.cur = (int)s.w(CUR);
  L.cur_leaf = s.w(CUR_LEAF) != 0; L.cur_slot = (int)s.w(CUR_SLOT);
  L.lo = s.v(LO_X); L.ld = s.v(LD_X); L.lid = s.v(LID_X);
  L.lt = s.f(LT); L.lnrm = s.v(LNRM_X); L.lback = s.w(LBACK) != 0; L.lmesh = (int)s.w(LMESH);
  L.w_valid = s.w(W_VALID) != 0; L.w_dst = s.f(W_DST);
  L.w_point = s.v(W_POINT_X); L.w_normal = s.v(W_NORMAL_X);
  L.w_back = s.w(W_BACK) != 0; L.w_mesh = (int)s.w(W_MESH);
  L.c_set = s.w(C_SET) != 0; L.c_valid = s.w(C_VALID) != 0;
  L.c_point = s.v(C_POINT_X); L.c_normal = s.v(C_NORMAL_X);
  L.c_back = s.w(C_BACK) != 0; L.c_mesh = (int)s.w(C_MESH); L.c_dst = s.f(C_DST);
  if constexpr (kTlas) {
    L.in_inst = s.w(IN_INST) != 0; L.cur_inst = s.w(CUR_INST) != 0;
    L.inst_mesh = (int)s.w(INST_MESH); L.inst_scale = s.f(INST_SCALE);
    L.inst_cull = s.w(INST_CULL) != 0; L.inst_os = s.w(INST_OS) != 0;
  }
  // Slot k of the buffer is the k-th entry from the top; the entries
  // are contiguous from slot 0 (pushes and pops shift the whole stack).
  L.stk.bind(scratch, s.n, s.i);
  int sp = 0;
  while (sp < s_depth && s.w(stack_base + sp) != kEmpty) ++sp;
  for (int k = 0; k < sp; ++k) L.stk[sp - 1 - k] = s.w(stack_base + k);
  L.sp = sp;
  L.n_box = L.n_leaf = L.n_seg = L.n_enter = L.n_exit = 0;
}

template <bool kTlas, class Ln>
__device__ void store_lane(const Ln& L, const Words& s, int stack_base, int s_depth) {
  s.put(RO0_X, L.ro0); s.put(RD0_X, L.rd0);
  s.w(PIX) = L.pix; s.w(PIXNO) = (uint32_t)L.pixno; s.w(SAMPLE) = (uint32_t)L.sample;
  s.put(ACC_X, L.acc);
  s.w(RNG) = L.rng; s.w(DONE) = L.done; s.w(SEGMENTS) = (uint32_t)L.segments;
  s.put(ORIGIN_X, L.origin); s.put(DIRECTION_X, L.direction);
  s.put(THROUGHPUT_X, L.throughput); s.put(LIGHT_X, L.light);
  s.w(BOUNCES) = (uint32_t)L.bounces; s.w(INVIS) = (uint32_t)L.invis;
  s.w(ENTRY) = (uint32_t)L.entry; s.w(CUR) = (uint32_t)L.cur;
  s.w(CUR_LEAF) = L.cur_leaf; s.w(CUR_SLOT) = (uint32_t)L.cur_slot;
  s.put(LO_X, L.lo); s.put(LD_X, L.ld); s.put(LID_X, L.lid);
  s.put(LT, L.lt); s.put(LNRM_X, L.lnrm); s.w(LBACK) = L.lback; s.w(LMESH) = (uint32_t)L.lmesh;
  s.w(W_VALID) = L.w_valid; s.put(W_DST, L.w_dst);
  s.put(W_POINT_X, L.w_point); s.put(W_NORMAL_X, L.w_normal);
  s.w(W_BACK) = L.w_back; s.w(W_MESH) = (uint32_t)L.w_mesh;
  s.w(C_SET) = L.c_set; s.w(C_VALID) = L.c_valid;
  s.put(C_POINT_X, L.c_point); s.put(C_NORMAL_X, L.c_normal);
  s.w(C_BACK) = L.c_back; s.w(C_MESH) = (uint32_t)L.c_mesh; s.put(C_DST, L.c_dst);
  if constexpr (kTlas) {
    s.w(IN_INST) = L.in_inst; s.w(CUR_INST) = L.cur_inst;
    s.w(INST_MESH) = (uint32_t)L.inst_mesh; s.put(INST_SCALE, L.inst_scale);
    s.w(INST_CULL) = L.inst_cull; s.w(INST_OS) = L.inst_os;
  }
  for (int k = 0; k < s_depth; ++k)
    s.w(stack_base + k) = k < L.sp ? L.stk[L.sp - 1 - k] : kEmpty;
}

// Push on top; a full stack drops its bottom entry, as tpurt's
// fixed-depth shift register does.
template <class Ln>
__device__ __forceinline__ void push(Ln& L, uint32_t e, int s_depth) {
  if (L.sp == s_depth) {
    for (int k = 1; k < s_depth; ++k) L.stk[k - 1] = L.stk[k];
    L.sp = s_depth - 1;
  }
  L.stk[L.sp++] = e;
}

struct Ctx {
  const MkCfg& c;
  const Tables& tb;
  Words s;
  __device__ const int* chain_root() const { return tb.meta; }
  __device__ const int* chain_leaf() const { return tb.meta + c.e_count; }
  __device__ const int* chain_mesh() const { return tb.meta + 2 * c.e_count; }
  __device__ const int* expand() const { return tb.meta + 3 * c.e_count; }
  __device__ const int* s_cull() const { return tb.meta + 4 * c.e_count; }
  __device__ const int* s_onesided() const { return s_cull() + c.n_static; }
  __device__ const int* s_owner() const { return s_onesided() + c.n_static; }
  __device__ const int* mesh_cull() const { return s_owner() + c.n_static; }
};

// WorldToLocalRay (Trace.cl:118-137) for chain entry ``entry``.
__device__ __forceinline__ void enter(const Ctx& x, int entry, V origin, V direction,
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

__device__ __forceinline__ bool pretest(const Ctx& x, int entry, V lo, V lid, float w_dst) {
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
template <class Ln>
__device__ void expand_root(const Ctx& x, Ln& L, int e) {
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
    if (b.hits >= 3)
      L.stk[L.sp++] = ((uint32_t)x.chain_root()[e] << kSlotBits) | (uint32_t)(b.second_prio + 1);
    if (b.hits >= 2) L.stk[L.sp++] = kTag | (uint32_t)b.second_meta;
  } else {
    L.cur = -1;
    L.cur_leaf = false;
  }
}

// Dense MT of the inline static triangles for a fresh ray.
__device__ void static_stage(const Ctx& x, V origin, V direction, bool& valid, float& dst,
                             V& point, V& normal, bool& back, int& mesh) {
  valid = false; dst = INFINITY; point = normal = v3(0.0f, 0.0f, 0.0f);
  back = false; mesh = -1;
  if (x.c.n_static == 0) return;
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
  if (lmesh < 0) return;
  valid = true;
  point = origin + ld * lt;
  normal = normalize(lnrm);
  dst = length(point - origin);
  back = lback;
  mesh = lmesh;
}

// One material interaction of a lane at the shading stage
// (shading.shade_hit_soa with enabled = true).
template <class Ln>
__device__ void shade_hit(const Ctx& x, Ln& L, bool& continuing, bool& invisible) {
  const float* m = x.tb.mats + kMatWidth * max(L.w_mesh, 0);
  float mtype = m[0], ior = m[1];
  V color = ld3(m + 2), em_color = ld3(m + 5);
  float em_strength = m[8], refl = m[9], spec_prob = m[10];
  V hp = L.w_point, hn = L.w_normal, dir = L.direction;

  bool a_hit = L.w_valid;
  invisible = a_hit && mtype == 2.0f;
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
  uint32_t rng = L.rng;
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
    float ior_cur = L.w_back ? ior : 1.0f;
    float ior_next = L.w_back ? 1.0f : ior;
    float rw = fresnel(dir, hn, ior_cur, ior_next);
    float r01;
    rng = rand01(rng, r01);
    bool will_reflect = r01 < rw;
    new_dir = will_reflect ? reflect(dir, hn) : refract(dir, hn, ior_cur, ior_next);
    glassy_w = will_reflect ? rw : 1.0f - rw;
  }
  V tn = L.throughput * glassy_w;

  // Common tail (Trace.cl:574-591), add-zero / mul-one forms kept.
  V contrib = tn * (em_color * em_strength);
  V zero = v3(0.0f, 0.0f, 0.0f);
  V light_new = L.light + sel(scatter, contrib, zero);
  V origin_new = scatter ? hp + new_dir * kEps : L.origin;
  if (invisible) origin_new = hp + dir * kEps;
  tn = tn * sel(scatter, color, v3(1.0f, 1.0f, 1.0f));
  float p = maxp(maxp(tn.x, tn.y), tn.z);
  bool rr = scatter && L.bounces > 3;
  float q = maxp(1.0f - p, 0.05f);
  bool killed = false;
  if (rr) {
    float r01;
    rng = rand01(rng, r01);
    killed = r01 < q;
    if (!killed) tn = tn / (1.0f - q);
  }
  int bounces_new = L.bounces + (scatter ? 1 : 0);
  continuing = a_hit && !killed && bounces_new < x.c.max_bounces;
  L.origin = origin_new;
  if (scatter) L.direction = new_dir;
  L.throughput = tn;
  L.light = light_new;
  L.rng = rng;
  L.bounces = bounces_new;
}

// Next mesh: fold a finished entry (cur < 0) to world space and advance
// the lane to the next entry. The scale is that of the lane's frame at
// the start of the trip: the entry's, or in the TLAS regime the
// instance's where the lane was inside one (``in_inst``, ``inst_scale``
// as they were then). Returns in_chain.
template <bool kTlas, class Ln>
__device__ bool fold(const Ctx& x, Ln& L, bool in_inst, float inst_scale) {
  const int E = x.c.e_count;
  if (!(L.entry < E && L.cur < 0)) return false;
  const float* cp = x.tb.chain + min(L.entry, E - 1) * kCpWidth;
  float scale_e = cp[12];
  if constexpr (kTlas) {
    if (in_inst) scale_e = inst_scale;
  }
  bool lvalid = L.lmesh >= 0 && !(cp[13] != 0.0f && L.lback) && scale_e > kEps;
  if (lvalid) {
    V point_w = rot_fwd(cp + 3, (L.lo + L.ld * L.lt) * scale_e) + ld3(cp);
    V n_w = normalize(rot_fwd(cp + 3, L.lnrm));
    float dst = length(point_w - L.origin);
    if (dst < L.w_dst) {
      L.w_valid = true; L.w_dst = dst; L.w_point = point_w; L.w_normal = n_w;
      L.w_back = L.lback; L.w_mesh = L.lmesh;
    }
  }
  L.entry += 1;
  L.lt = INFINITY;
  L.lnrm = v3(0.0f, 0.0f, 0.0f);
  L.lback = false;
  L.lmesh = -1;
  return L.entry < E;
}

// A trip on an instance row (kTlas; megakernel._instance_step): enter
// it or, when its exit marker brought the lane back, exit it. Returns
// whether the lane pops its stack.
template <class Ln>
__device__ bool instance_step(const Ctx& x, Ln& L, const float* row) {
  const float scale = row[12];
  const float safe = safe_scale(scale);
  if (!L.in_inst) {
    ++L.n_enter;
    // WorldToLocalRay with the baked transform, in enter()'s op order,
    // then the root pretest; a degenerate scale skips the instance.
    V lo = rot_t(row + 3, L.origin - ld3(row)) / safe;
    V ld = normalize(rot_t(row + 3, L.direction) / safe);
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
  if (L.lmesh >= 0 && !(L.inst_os && L.lback)) {
    V point_w = rot_fwd(row + 3, (L.lo + L.ld * L.lt) * scale) + ld3(row);
    V n_w = normalize(rot_fwd(row + 3, L.lnrm));
    float dst = length(point_w - L.origin);
    if (dst < L.w_dst) {
      L.w_valid = true; L.w_dst = dst; L.w_point = point_w; L.w_normal = n_w;
      L.w_back = L.lback; L.w_mesh = L.lmesh;
    }
  }
  L.in_inst = false;
  int root;
  bool leaf;
  enter(x, L.entry, L.origin, L.direction, L.lo, L.ld, L.lid, root, leaf);
  L.lt = INFINITY;
  L.lnrm = v3(0.0f, 0.0f, 0.0f);
  L.lback = false;
  L.lmesh = -1;
  return true;
}

// The BVH trip's traversal step — one bank row — then the fold.
template <bool kTlas, bool kBf16, class Ln>
__device__ bool traverse_rows(const Ctx& x, Ln& L) {
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
    float limit = minp(L.lt, L.w_dst / safe_scale(in_inst ? inst_scale : cp[12]) * kGrow);
    bool pop;
    bool inst_row = false;
    if constexpr (kTlas) inst_row = L.cur_inst;
    if (inst_row) {
      pop = instance_step(x, L, row);
    } else if (L.cur_leaf) {
      ++L.n_leaf;
      int entry_mesh = x.chain_mesh()[ec];
      bool is_static = entry_mesh < 0;
      bool cull_mesh_e = cp[14] != 0.0f;
      for (int k = 0; k < x.c.leaf_tris; ++k) {
        const float* t = row + 19 * k;
        int aux = __float_as_int(t[18]);
        bool cull = cull_mesh_e;
        if (is_static)
          cull = (aux >= 0 && aux < x.c.num_meshes) ? x.mesh_cull()[aux] != 0 : true;
        if constexpr (kTlas) {
          if (in_inst) cull = L.inst_cull;
        }
        V pa = ld3(t);
        float tt;
        V n;
        bool bf;
        if (mt(L.lo, L.ld, pa, ld3(t + 3) - pa, ld3(t + 6) - pa, ld3(t + 9), ld3(t + 12),
               ld3(t + 15), cull, tt, n, bf) &&
            tt < L.lt) {
          L.lt = tt; L.lnrm = n; L.lback = bf;
          L.lmesh = in_inst ? L.inst_mesh : (is_static ? aux : entry_mesh);
        }
      }
      pop = true;
    } else {
      // Node row: arity children, visited in direction-signed priority
      // order; cur_slot floors the priority of a resumed node. u8: child
      // boxes quantised on the node's grid, 3 words a slot; bf16:
      // absolute bounds, 4 words a slot.
      const int arity = x.c.arity;
      V go = ld3(row), gs = ld3(row + 3);
      int axis = __float_as_int(row[6]);
      float dcomp = axis == 0 ? L.ld.x : (axis == 1 ? L.ld.y : L.ld.z);
      bool fwd = dcomp >= 0.0f;
      TwoBest b;
      b.init(arity);
      for (int slot = 0; slot < arity; ++slot) {
        const float* w = row + 7 + (kBf16 ? 4 : 3) * slot;
        int meta = __float_as_int(w[kBf16 ? 3 : 2]);
        int prio = fwd ? slot : arity - 1 - slot;
        if (meta == 0 || prio < L.cur_slot) continue;
        ++L.n_box;
        uint32_t w0 = __float_as_uint(w[0]), w1 = __float_as_uint(w[1]);
        V bmin, bmax;
        if constexpr (kBf16) {
          uint32_t w2 = __float_as_uint(w[2]);
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
      pop = b.best_prio >= arity;
      if (!pop) {
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
    if (pop) {
      if (L.sp == 0) {
        L.cur = -1;
        if constexpr (kTlas) L.cur_inst = false;
      } else {
        uint32_t top = L.stk[--L.sp];
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
template <class Ln>
__device__ bool traverse_swept(const Ctx& x, Ln& L, int col, float t_sw) {
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
      L.lnrm = n;
      L.lback = bf;
      L.lmesh = x.tb.dt.owner[col];
    }
  }
  L.cur = -1;
  return fold<false>(x, L, false, 1.0f);
}

// The frame of quota slot ``pixno``: a cross-frame pack adds the slot's
// frame offset pixno / ppf.
__device__ __forceinline__ int slot_frame(const MkCfg& c, int pixno) {
  return c.frames > 1 ? c.frame_index + pixno / c.ppf : c.frame_index;
}

// Segment completion: shade -> accumulate/advance -> restart -> static
// stage -> chain enter (pretest, chain skip, root expansion).
template <bool kTlas, class Ln>
__device__ void tail(const Ctx& x, Ln& L, bool entering_in, bool do_expand) {
  const MkCfg& c = x.c;
  const int E = c.e_count;
  const bool shade = !L.done && L.entry >= E;
  if (shade && c.use_cache && !L.c_set && L.bounces == 0 && L.sample == 0) {
    L.c_set = true; L.c_valid = L.w_valid; L.c_point = L.w_point;
    L.c_normal = L.w_normal; L.c_back = L.w_back; L.c_mesh = L.w_mesh; L.c_dst = L.w_dst;
  }
  bool continuing = false, invisible = false;
  if (shade) {
    L.segments += 1;
    ++L.n_seg;
    shade_hit(x, L, continuing, invisible);
    if (invisible) L.invis += 1;
    continuing = continuing && !(invisible && L.invis > c.invisible_budget);
  }
  const bool cont = shade && continuing;
  const bool path_end = shade && !continuing;
  V zero = v3(0.0f, 0.0f, 0.0f);
  L.acc = L.acc + sel(path_end, L.light, zero);
  if (path_end) L.sample += 1;
  const bool pix_done = path_end && L.sample >= c.rays_per_pixel;
  bool retire = pix_done, advance = false;
  if (c.p_count > 1 && pix_done) {
    bool last_pix = L.pixno >= c.p_count - 1;
    retire = last_pix;
    advance = !last_pix;
    x.s.put(kAccBase<kTlas> + 3 * L.pixno, L.acc);  // bank into the quota slot
    L.acc = zero;
    L.sample = 0;
    if (advance) {
      L.pixno += 1;
      int row = L.pixno - 1;
      if (c.frames > 1) {
        // Cross-frame pack: within-frame slot pixno % ppf's pixel, and
        // the periodic direction table's row (pixno - 1) % rd_rows.
        L.pix = x.tb.slot_pix[(size_t)(L.pixno % c.ppf) * x.s.n + x.s.i];
        row %= c.rd_rows;
      } else {
        L.pix = (uint32_t)min((int)L.pix + c.pixel_stride, c.width * c.height - 1);
      }
      const float* sr = x.tb.slot_rd + (size_t)row * x.s.n + x.s.i;
      size_t comp = (size_t)c.rd_rows * x.s.n;
      L.rd0 = v3(sr[0], sr[comp], sr[2 * comp]);
    }
  }
  L.done = L.done || retire;
  const bool new_sample = path_end && !retire;
  if (!c.seed_reference) {
    if (new_sample)
      L.rng = make_seed(L.pix, slot_frame(c, L.pixno),
                        (uint32_t)L.sample + (uint32_t)c.sample_offset);
  } else if (advance) {
    // Reference mode: one seed per PIXEL (Trace.cl:632-641).
    L.rng = make_seed(L.pix, slot_frame(c, L.pixno), 0u);
  }
  if (new_sample) {
    L.origin = L.ro0; L.direction = L.rd0;
    L.throughput = v3(1.0f, 1.0f, 1.0f); L.light = zero;
    L.bounces = 0; L.invis = 0;
  }
  bool replay = false;
  if (c.use_cache) {
    if (advance) L.c_set = false;
    replay = new_sample && L.c_set;
  }
  const bool restart = cont || (new_sample && !replay);
  if (restart) { L.entry = 0; L.sp = 0; }
  if (shade) { L.w_valid = false; L.w_dst = INFINITY; L.w_mesh = -1; }
  if (restart)
    static_stage(x, L.origin, L.direction, L.w_valid, L.w_dst, L.w_point, L.w_normal,
                 L.w_back, L.w_mesh);
  if (replay) {
    L.entry = E;
    L.w_valid = L.c_valid; L.w_dst = L.c_dst; L.w_point = L.c_point;
    L.w_normal = L.c_normal; L.w_back = L.c_back; L.w_mesh = L.c_mesh;
  }
  if (E == 0 || !(entering_in || restart)) return;
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
  enter(x, cur_e, L.origin, L.direction, lo, ld, lid, root, leaf);
  bool ok = pretest(x, cur_e, lo, lid, L.w_dst);
  bool pend = !ok;
  for (int k = 0; k < c.n_skip && pend; ++k) {
    cur_e += 1;
    pend = false;
    if (cur_e < E) {
      V lo3, ld3_, lid3;
      int root3;
      bool leaf3;
      enter(x, cur_e, L.origin, L.direction, lo3, ld3_, lid3, root3, leaf3);
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
// completions (megakernel._body_math).
template <bool kTlas, class Ln>
__device__ __forceinline__ void trip_tail(const Ctx& x, Ln& L, bool in_chain) {
  tail<kTlas>(x, L, in_chain, x.c.expand_passes >= 1);
  for (int p = 1; p < x.c.tail_passes; ++p) tail<kTlas>(x, L, false, p < x.c.expand_passes);
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
  int* work;   // (3, R) Lane::n_box, n_leaf, n_seg; TLAS: (5, R), + n_enter, n_exit
  int* queue;  // next unstarted lane index
};

// Stores a retired lane (its state is final for this launch).
template <bool kTlas, class Ln>
__device__ void retire(const Ctx& x, const Ln& L, int trips, const Out& o, int stack_base) {
  const int i = x.s.i, n = x.c.n_lanes;
  store_lane<kTlas>(L, x.s, stack_base, x.c.s_depth);
  o.trips[i] = trips;
  o.work[i] = L.n_box;
  o.work[n + i] = L.n_leaf;
  o.work[2 * n + i] = L.n_seg;
  if constexpr (kTlas) {
    o.work[3 * n + i] = L.n_enter;
    o.work[4 * n + i] = L.n_exit;
  }
}

// Takes lanes from the queue until one needs a trip (retiring any that
// need none); false when the queue is empty.
template <bool kTlas, class Ln>
__device__ bool take_live(Ctx& x, Ln& L, const Out& o, int stack_base) {
  for (;;) {
    const int i = take_lane(o.queue);
    if (i >= x.c.n_lanes) return false;
    x.s.i = i;
    load_lane<kTlas>(L, x.s, stack_base, x.c.s_depth, x.tb.stack);
    if (!L.done && x.c.max_trips > 0) return true;
    retire<kTlas>(x, L, 0, o, stack_base);
  }
}

// Ends a trip of the dense megakernel's lane: a lane that is done or
// at max_trips retires and the thread takes the next. Returns whether
// the thread holds a live lane.
template <class Ln>
__device__ __forceinline__ bool end_trip(Ctx& x, Ln& L, int& trips, const Out& o,
                                         int stack_base) {
  ++trips;
  if (!L.done && trips < x.c.max_trips) return true;
  retire<false>(x, L, trips, o, stack_base);
  trips = 0;
  return take_live<false>(x, L, o, stack_base);
}

// The BVH megakernel (kDense = false): each thread runs its lane's
// trips to the end, then takes the next; no barriers. The dense one
// (kDense = true, unrolled chain and u8 only: it reads no node row): the
// loop is block-uniform around the block sweep, which every thread
// joins. Before it, each thread runs its lane's trips that need no sweep
// (the entry is finished or was skipped: fold and tail only), taking new
// lanes as they retire, so that at the sweep every live lane sweeps. A
// lane's trips are the same trips in the same order whichever loop runs
// them.
template <bool kDense, bool kTlas, bool kBf16, bool kDeep>
__global__ void __launch_bounds__(kDense ? kDenseThreads : kThreads,
                                  kDense ? kDenseMinBlocks : kMinBlocks)
    megakernel(MkCfg c, Tables tb, Out o) {
  static_assert(!(kDense && (kTlas || kBf16 || kDeep)), "the dense kernel walks no rows");
  Ctx x{c, tb, Words{o.state, c.n_lanes, 0}};
  const int stack_base = kAccBase<kTlas> + (c.p_count > 1 ? 3 * c.p_count : 0);
  const int E = c.e_count;
  Lane<kDeep> L;
  if constexpr (!kDense) {
    while (take_live<kTlas>(x, L, o, stack_base)) {
      int trips = 0;
      do {
        const bool in_chain = E > 0 && traverse_rows<kTlas, kBf16>(x, L);
        trip_tail<kTlas>(x, L, in_chain);
        ++trips;
      } while (!L.done && trips < c.max_trips);
      retire<kTlas>(x, L, trips, o, stack_base);
    }
  } else {
    __shared__ SweepSmem<kDenseThreads> sm;
    int trips = 0;
    bool have = take_live<false>(x, L, o, stack_base);
    while (__syncthreads_or(have)) {
      while (have && !(L.entry < E && L.cur >= 0)) {
        const bool in_chain = E > 0 && fold<false>(x, L, false, 1.0f);
        trip_tail<false>(x, L, in_chain);
        have = end_trip(x, L, trips, o, stack_base);
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
          have = end_trip(x, L, trips, o, stack_base);
        }
      }
    }
  }
}

}  // namespace

// The lane words before the quota accumulators: enum Field and the TLAS
// instantiation's enum TlasField.
extern "C" int tpurt_mk_fixed_words() { return N_TLAS_END; }

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

// The launch configuration of one instantiation on the current device:
// threads a block, resident blocks per SM, SMs. Returns a cudaError_t.
extern "C" int tpurt_mk_occupancy(int variant, int* threads, int* blocks_per_sm, int* sms) {
  KernelFn fn = kernel_for(variant, threads);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, *threads, 0);
  return (int)err;
}

// Launches the megakernel on ``stream`` — the dense instantiation when
// ``dense`` is not null, else the one cfg->tlas, cfg->bf16 and cfg->deep
// name (kDeep: the stacks on ``stack``, which the host sized) — as a
// persistent grid of resident blocks that take lanes from ``queue`` (an
// int the caller zeroed); returns a cudaError_t. A stack budget above
// kMaxStack without kDeep, or kDeep with the dense sweep, is refused.
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
  if (deep ? dense != nullptr : cfg->s_depth > kMaxStack) return (int)cudaErrorInvalidValue;
  const int variant = (dense != nullptr) | (cfg->tlas != 0) << 1 | (cfg->bf16 != 0) << 2 |
                      (int)deep << 3;
  int threads = 0, per_sm = 0, sms = 0;
  int err = tpurt_mk_occupancy(variant, &threads, &per_sm, &sms);
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
                       dim3(threads), args, 0, (cudaStream_t)stream);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}
