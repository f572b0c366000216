// Per-ray bodies shared by the trace kernels, one copy of each primitive
// test:
//   * `trace_ray`, the opaque Whitted chain (chain_trace.cu, spp_trace.cu):
//     the per-ray form of raytracingengine_tpu/kernels/chain_trace.py::
//     _trace_tile, which kernels/chain_trace.py::trace_chain_plain follows
//     line by line;
//   * `trace_wavefront_ray`, the full Whitted DFS with refraction, Fresnel,
//     TIR and march or binary shadows (wavefront_trace.cu,
//     wavefront_spp_trace.cu): the per-ray form of raytracingengine_tpu/
//     kernels/wavefront_trace.py::_dfs_trace_tile, which kernels/
//     wavefront_trace.py::trace_wavefront_plain follows line by line. Its
//     node's children (`node_children`) and march step (`march_step`) are
//     functions of their own, which the glass adjoint (wavefront_grad.cu)
//     calls too, so that its replays take the forward's branches;
//   * the Philox4x32-10 jitter of the in-kernel AA loops.
// Where the TPU kernels mask lanes of a tile, a thread here branches: the
// whole-tile early exits of the depth, DFS and march loops become per-ray
// exits, and the "any lane needs this light" skip of a shadow scan becomes
// a per-ray `if`; on culled tables the glass DFS keeps the tile's exits,
// with the warp as the tile (`trace_wavefront_warp`).
//
// Tables: float32, row-major [rows, cols], one column per primitive, as
// kernels/chain_trace.py::pack_scene_tables lays them out:
//   sph [4, S]: center xyz, r^2      pl [4, P]: unit normal xyz, p.n
//   tri [12, T]: v0, e1, e2, unit normal
//   mat [7, N]: albedo rgb, specular, shininess, transparency, ior
//   light [7, L]: position xyz, emission rgb, active
// Padded slots can never hit (r^2 = -1, n = 0, e1 = e2 = 0), and padded
// lights emit 0 with active 0. The staged scan (`StagedScan`) stops each
// family's loop at its last live slot; the other scans test every slot.
//
// Culled tables (kernels/chain_trace.py::pack_forward_tables_perm; the chain
// kernels take them above 128 triangles) hold the triangles in scan order,
// tri [13, n_blocks * 128] with row 12 the original global index, and one box
// per block of 128 triangles and per group of 8 blocks, taabb [6, n_blocks +
// n_blocks / 8]. Their scan is `CtaCulledTris`: the 128 threads of a CTA
// walk the hierarchy together, vote on the group and block boxes their rays'
// segments meet, stage each voted block's 13 rows into shared memory once
// with asynchronous copies (double-buffered: the next voted block is copied
// while the current one is tested), and only the rays whose own boxes pass
// are tested against a block, each by its whole warp (4 triangles a lane).
// A skipped block holds no hit the ray could take, so the results are the
// linear scan's. Linear tables take `LinearTris`,
// one thread per ray with no barriers; the scan is a template parameter of
// closest_hit, any_hit and trace_ray, so a kernel that never sees culled
// tables (chain_grad.cu) compiles without it. The glass kernels' DFS ends
// per ray, so no CTA barrier fits it: on linear tables `trace_wavefront_ray`
// (and march_T, march_step, nearest_t_tau under it) scans one ray a thread,
// and on culled tables `trace_wavefront_warp` (and the *_warp functions
// under it) runs the same DFS with every loop that reaches a scan voted
// over the warp, so that its scan, `WarpCulledTris`, walks the hierarchy
// with the warp's 32 lanes together: they vote on the boxes their own
// segments meet, and each met block's 128 tests for each ray that needs it
// are shared among the lanes (4 a lane, coalesced loads, warp reductions).
//
// chain_trace.cu and spp_trace.cu take linear tables whose 16-byte stage
// fits kStageMaxBytes through `StagedScan<K>` and `trace_packet<K>`
// instead: the CTA copies every table once into shared memory, one to
// three 16-byte entries per primitive, notes each family's live extent on
// the way, and each thread traces a packet of K rays over the live slots,
// so that one broadcast load of an entry serves K tests. The head-box
// adjoint (chain_grad.cu) scans its shadow rays over the same stage, one ray
// a thread (`StagedTris`, chosen by `grad_route`).
//
// `ChainTape` is the chain tape: chain_trace.cu's taping instantiations
// (trace_ray and trace_packet with kTape) write each ray's state and closest
// hit at every bounce it takes, and chain_grad.cu reads them back.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rte {

constexpr float kEps = 1e-6f;   // Shape.h:89, :151, :203
constexpr float kInf = 3.0e38f;  // closest-hit miss sentinel

constexpr int kTriBlock = 128;  // triangles per culling block (chain_trace.py::TRI_BLOCK)
constexpr int kTriGroup = 8;    // blocks per group (TRI_GROUP)
constexpr int kTriRows = 13;    // rows of a culled tri table column
constexpr int kCtaThreads = 128;  // threads of every chain kernel's CTA (chain_trace.py::CTA_THREADS)
constexpr unsigned kFullMask = 0xffffffffu;  // every lane of a warp

struct Tables {
  const float* sph; int sph_cols; int ns;
  const float* pl; int pl_cols; int np;
  const float* tri; int tri_cols; int nt;
  const float* mat; int mat_cols;
  const float* light; int light_cols; int nl;
  const float* taabb = nullptr;  // culled tables only; null for a linear scan
  int n_blocks = 0;
};

// Every thread of a warp reads the same table entry: one broadcast load
// through the read-only data cache.
static __device__ __forceinline__ float tab(const float* t, int cols, int row, int i) {
  return __ldg(t + row * cols + i);
}

struct Hit {
  float t, nx, ny, nz;
  int gi;  // global primitive index: spheres, then planes, then triangles
  int tc = 0;  // a winning triangle's column in the tri table
};

// The chain tape, [max_depth][kStateRows][R] then [kTailRows][R] floats:
// for each bounce k a ray takes, its state before the bounce (o xyz, d xyz,
// weight) and the bounce's closest hit (t, and the winner's global index
// and tri column as int bits); then per ray the bounces it took, whether it
// reached max_depth alive (the depth-exhaustion sky follows), and that
// sky's d.y and weight. Neighbouring rays' entries are neighbours, so a
// warp's stores and loads are coalesced. The taping forward writes it
// (chain_trace.cu) and the head-box adjoint reads it (chain_grad.cu):
// the adjoint differentiates the path the frame was rendered on.
constexpr int kStateRows = 10;
constexpr int kTailRows = 4;

inline long long chain_tape_floats(int max_depth, long long n) {
  return static_cast<long long>(max_depth * kStateRows + kTailRows) * n;
}

struct ChainTape {
  float* s;
  long long n;
  int max_depth;

  // Bounce k of ray i: its state and the closest hit h.
  __device__ __forceinline__ void bounce(int k, long long i, float ox, float oy, float oz,
                                         float dx, float dy, float dz, float w,
                                         const Hit& h) const {
    float* p = s + static_cast<long long>(k) * kStateRows * n + i;
    p[0] = ox; p[n] = oy; p[2 * n] = oz;
    p[3 * n] = dx; p[4 * n] = dy; p[5 * n] = dz; p[6 * n] = w;
    p[7 * n] = h.t; p[8 * n] = __int_as_float(h.gi); p[9 * n] = __int_as_float(h.tc);
  }

  // Ray i's end: nd bounces; `alive`: it reached max_depth live, where its
  // direction's y is dy and its weight w.
  __device__ __forceinline__ void end(long long i, int nd, bool alive, float dy, float w) const {
    float* p = s + static_cast<long long>(max_depth) * kStateRows * n + i;
    p[0] = __int_as_float(nd); p[n] = __int_as_float(alive ? 1 : 0);
    p[2 * n] = dy; p[3 * n] = w;
  }
};

// Products and sums that nvcc must not contract into FMAs (see tri_t).
static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
static __device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                             float by, float bz) {
  return __fadd_rn(__fadd_rn(mul(ax, bx), mul(ay, by)), mul(az, bz));
}
static __device__ __forceinline__ float diff2(float a, float b, float c, float d) {
  return __fsub_rn(mul(a, b), mul(c, d));  // a*b - c*d
}

// The discriminant of the sphere quadratic, with a = d.d. Its products are
// rounded as the plain version rounds them: at a silhouette disc is the
// difference of two nearly equal products, so its rounding decides whether
// a grazing ray hits, and the adjoint's d sqrt(disc) = 1 / (2 sqrt(disc))
// there. b and c are returned for the roots.
static __device__ __forceinline__ float sphere_disc(float a, float ocx, float ocy, float ocz,
                                                    float dx, float dy, float dz, float r2,
                                                    float& b, float& c) {
  b = 2.0f * dot3(ocx, ocy, ocz, dx, dy, dz);
  c = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), r2);
  return __fsub_rn(mul(b, b), mul(4.0f * a, c));
}

// Sphere quadratic with a = dot3(d, d), near root if >= eps (Shape.h:72-98),
// on the sphere's center and r^2.
static __device__ __forceinline__ bool sphere_test(float cx, float cy, float cz, float r2,
                                                   float a, float inv2a, float ox, float oy,
                                                   float oz, float dx, float dy, float dz,
                                                   float& t) {
  float b, c;
  const float disc = sphere_disc(a, ox - cx, oy - cy, oz - cz, dx, dy, dz, r2, b, c);
  if (!(disc >= 0.0f)) return false;
  const float sq = sqrtf(disc);
  const float tt0 = (-b - sq) * inv2a;
  const float tt1 = (-b + sq) * inv2a;
  t = (tt0 >= kEps) ? tt0 : tt1;
  return t >= kEps;
}

// Sphere i of the sph table.
static __device__ __forceinline__ bool sphere_t(
    const Tables& T, int i, float a, float inv2a, float ox, float oy, float oz,
    float dx, float dy, float dz, float& t) {
  const float cx = tab(T.sph, T.sph_cols, 0, i), cy = tab(T.sph, T.sph_cols, 1, i);
  const float cz = tab(T.sph, T.sph_cols, 2, i), r2 = tab(T.sph, T.sph_cols, 3, i);
  return sphere_test(cx, cy, cz, r2, a, inv2a, ox, oy, oz, dx, dy, dz, t);
}

// |denom| > eps and t >= 0 (Shape.h:149-159), on the plane's unit normal
// and p.n.
static __device__ __forceinline__ bool plane_test(float nx, float ny, float nz, float pn,
                                                  float ox, float oy, float oz, float dx,
                                                  float dy, float dz, float& t) {
  const float denom = dx * nx + dy * ny + dz * nz;
  if (!(fabsf(denom) > kEps)) return false;
  const float on = ox * nx + oy * ny + oz * nz;
  t = (pn - on) / denom;
  return t >= 0.0f;
}

// Plane i of the pl table.
static __device__ __forceinline__ bool plane_t(
    const Tables& T, int i, float ox, float oy, float oz, float dx, float dy,
    float dz, float& t) {
  const float nx = tab(T.pl, T.pl_cols, 0, i), ny = tab(T.pl, T.pl_cols, 1, i);
  const float nz = tab(T.pl, T.pl_cols, 2, i), pn = tab(T.pl, T.pl_cols, 3, i);
  return plane_test(nx, ny, nz, pn, ox, oy, oz, dx, dy, dz, t);
}

// A load of a table entry from device memory (through the read-only cache)
// or from a block staged in shared memory.
template <bool kShared>
static __device__ __forceinline__ float ld(const float* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// Moller-Trumbore, EPSILON = 1e-6 (Shape.h:202-220).
//
// Every product here is rounded on its own, as in the plain version and the
// reference, never contracted into an FMA. A ray through the edge that two
// triangles share (a quad's diagonal, a mesh seam) must hit at least one of
// them. When the ray is symmetric about that edge, as camera and shadow rays
// in the x=y plane of the head box are, the products cancel exactly and
// u or v is exactly 0. An FMA keeps the rounding error of one product, so
// both triangles can come out with a barycentric just below 0, and the ray
// passes through the closed mesh (seen as lit pixels inside the box's shadow
// on the head box golden at 128^2).
// The test on one triangle's v0, e1 and e2.
static __device__ __forceinline__ bool tri_test(float v0x, float v0y, float v0z, float e1x,
                                                float e1y, float e1z, float e2x, float e2y,
                                                float e2z, float ox, float oy, float oz,
                                                float dx, float dy, float dz, float& t) {
  const float hx = diff2(dy, e2z, dz, e2y);  // h = d x e2
  const float hy = diff2(dz, e2x, dx, e2z);
  const float hz = diff2(dx, e2y, dy, e2x);
  const float a = dot3(e1x, e1y, e1z, hx, hy, hz);
  if (!(fabsf(a) > kEps)) return false;
  const float f = 1.0f / a;
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = mul(f, dot3(sx, sy, sz, hx, hy, hz));
  const float qx = diff2(sy, e1z, sz, e1y);
  const float qy = diff2(sz, e1x, sx, e1z);
  const float qz = diff2(sx, e1y, sy, e1x);
  const float v = mul(f, dot3(dx, dy, dz, qx, qy, qz));
  t = mul(f, dot3(e2x, e2y, e2z, qx, qy, qz));
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > kEps;
}

// The test on one triangle column c whose rows lie `stride` floats apart:
// the tri table in device memory (stride tri_cols) or a block staged in
// shared memory (stride kTriBlock).
template <bool kShared>
static __device__ __forceinline__ bool tri_hit(const float* c, int stride, float ox, float oy,
                                               float oz, float dx, float dy, float dz, float& t) {
  const float v0x = ld<kShared>(c), v0y = ld<kShared>(c + stride);
  const float v0z = ld<kShared>(c + 2 * stride);
  const float e1x = ld<kShared>(c + 3 * stride), e1y = ld<kShared>(c + 4 * stride);
  const float e1z = ld<kShared>(c + 5 * stride);
  const float e2x = ld<kShared>(c + 6 * stride), e2y = ld<kShared>(c + 7 * stride);
  const float e2z = ld<kShared>(c + 8 * stride);
  return tri_test(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy, dz, t);
}

static __device__ __forceinline__ bool tri_t(
    const Tables& T, int i, float ox, float oy, float oz, float dx, float dy,
    float dz, float& t) {
  return tri_hit<false>(T.tri + i, T.tri_cols, ox, oy, oz, dx, dy, dz, t);
}

// The ray's side of the slab test: its origin and reciprocal direction, each
// near-zero component clamped to +-1e-12 with its sign kept, so that no box
// test is NaN (a NaN test would skip the box) and a grazing one errs toward a
// hit.
struct Slab {
  float ox, oy, oz, ix, iy, iz;
};

static __device__ __forceinline__ float slab_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d);
}

static __device__ __forceinline__ Slab make_slab(float ox, float oy, float oz, float dx, float dy,
                                                 float dz) {
  return Slab{ox, oy, oz, slab_inv(dx), slab_inv(dy), slab_inv(dz)};
}

// Does the segment [0, t_hi] of the ray meet box j of taabb? The packing
// inflates the boxes, so fp32 rounding here cannot lose a hit; an empty
// block's far-point box (2e38) is never met.
static __device__ __forceinline__ bool box_hit(const Tables& T, const Slab& s, int j, float t_hi) {
  const int c = T.n_blocks + T.n_blocks / kTriGroup;
  const float* a = T.taabb;
  const float t1x = (tab(a, c, 0, j) - s.ox) * s.ix, t2x = (tab(a, c, 3, j) - s.ox) * s.ix;
  const float t1y = (tab(a, c, 1, j) - s.oy) * s.iy, t2y = (tab(a, c, 4, j) - s.oy) * s.iy;
  const float t1z = (tab(a, c, 2, j) - s.oz) * s.iz, t2z = (tab(a, c, 5, j) - s.oz) * s.iz;
  const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  return tmax >= tmin && tmax >= 0.0f && tmin <= t_hi;
}

// ---------------------------------------------------------------------------
// The triangle scans: a template parameter of closest_hit, any_hit and
// trace_ray. Both take `active`: whether this thread's ray scans. A scan
// object is called by every thread of the CTA in the same order (the culled
// one holds barriers); `any(p)` is the loop vote that goes with it.
// ---------------------------------------------------------------------------

// Linear tables: one thread per ray, authoring order, strict < first-wins
// (Scene.h:218-257); no barriers, so loops exit per ray.
struct LinearTris {
  // CTAs per SM the trace kernels ask of the register allocator: 64
  // registers a thread (on the head box, caps of 72 and 96 registers ran
  // the AA kernel slower, PERF.md).
  static constexpr int kMinCtas = 8;
  static constexpr int kMinCtasAdjoint = 1;
  static __device__ __forceinline__ LinearTris make() { return LinearTris{}; }
  __device__ __forceinline__ bool any(bool p) const { return p; }
  // The loop bound of a warp whose lanes step together (the adjoint's
  // reverse loop): the warp's largest count.
  __device__ __forceinline__ int top(int n) const { return __reduce_max_sync(kFullMask, n); }

  __device__ __forceinline__ void closest(const Tables& T, bool active, float ox, float oy,
                                          float oz, float dx, float dy, float dz, Hit& h) {
    if (!active) return;
    float t;
    for (int i = 0; i < T.nt; ++i) {
      if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < h.t) {
        h = Hit{t, tab(T.tri, T.tri_cols, 9, i), tab(T.tri, T.tri_cols, 10, i),
                tab(T.tri, T.tri_cols, 11, i), T.ns + T.np + i, i};
      }
    }
  }

  __device__ __forceinline__ bool occluded(const Tables& T, bool active, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float lo,
                                           float hi) {
    if (!active) return false;
    float t;
    for (int i = 0; i < T.nt; ++i)
      if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t > lo && t < hi) return true;
    return false;
  }
};

// The blocks of culled tables that one vote covers: 8 groups.
constexpr int kWindow = 64;

// Blocks copied or being tested at a time, per CTA: double buffering, one
// block's copy in flight while the previous block is tested.
constexpr int kStages = 2;

// Shared memory of the CTA-cooperative scan: kStages buffers of one block's
// 13 rows (6,656 bytes each; each row is one coalesced 512-byte copy), and
// the warps' votes of the last two windows.
struct __align__(16) Stage {
  float tri[kStages][kTriRows * kTriBlock];
  unsigned long long vote[2][kCtaThreads / 32];
};

// 16-byte asynchronous copy global -> shared (cp.async, bypassing L1), and
// its group bookkeeping.
static __device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Culled tables: the CTA's 128 threads traverse the two-level hierarchy
// together, kWindow blocks per vote. For each window every thread tests the
// group boxes, and the block boxes of each group it meets, against its
// segment; a warp ORs its lanes' 64-bit masks and the CTA ORs its warps'.
// Each block of the CTA's mask is copied into shared memory once, the next
// one's copy in flight while the current one is tested; a thread re-tests
// the block's box against its best hit so far, and its warp tests the block
// for its ray only if the ray still meets it (a warp none of whose lanes do
// skips it). The box tests are the per-ray scan's (bound: the best t so far,
// inclusive), so each ray is tested against no fewer triangles than it needs
// and no winner changes.
struct CtaCulledTris {
  // CTAs per SM asked of the register allocator: 128 registers a thread for
  // the trace kernels (the compiler's choice, ~200, measured slower), 168
  // for the adjoint.
  static constexpr int kMinCtas = 4;
  static constexpr int kMinCtasAdjoint = 3;
  Stage* S;
  int par;  // which vote slots this window uses; the same on every thread

  static __device__ __forceinline__ CtaCulledTris make() {
    __shared__ Stage stage;
    return CtaCulledTris{&stage, 0};
  }

  __device__ __forceinline__ bool any(bool p) const { return __syncthreads_or(p) != 0; }

  // The CTA's largest count (every thread calls it).
  __device__ __forceinline__ int top(int n) {
    const int warp = threadIdx.x >> 5;
    const int w = __reduce_max_sync(kFullMask, n);
    unsigned long long* v = S->vote[par];
    if ((threadIdx.x & 31) == 0) v[warp] = static_cast<unsigned long long>(w);
    __syncthreads();
    int m = 0;
    for (int k = 0; k < kCtaThreads / 32; ++k) m = max(m, static_cast<int>(v[k]));
    par ^= 1;
    return m;
  }

  // This thread's blocks of window [w0, w0 + kWindow) whose boxes its
  // segment [0, t_hi] meets, as a bit mask.
  static __device__ __forceinline__ unsigned long long meets(const Tables& T, const Slab& s,
                                                             int w0, float t_hi) {
    const int nb = T.n_blocks;
    unsigned long long m = 0ull;
    const int g1 = min(w0 + kWindow, nb) / kTriGroup;
    for (int g = w0 / kTriGroup; g < g1; ++g) {
      if (!box_hit(T, s, nb + g, t_hi)) continue;
      for (int k = 0; k < kTriGroup; ++k) {
        const int b = g * kTriGroup + k;
        if (box_hit(T, s, b, t_hi)) m |= 1ull << (b - w0);
      }
    }
    return m;
  }

  // The OR of every thread's mask: a warp reduction, one slot per warp, one
  // barrier. The two slot sets alternate by window, so a slot is written
  // again only after every thread has passed the next window's barrier.
  __device__ __forceinline__ unsigned long long vote(unsigned long long m) {
    const unsigned lo = __reduce_or_sync(kFullMask, static_cast<unsigned>(m));
    const unsigned hi = __reduce_or_sync(kFullMask, static_cast<unsigned>(m >> 32));
    unsigned long long* v = S->vote[par];
    if ((threadIdx.x & 31) == 0) v[threadIdx.x >> 5] = (static_cast<unsigned long long>(hi) << 32) | lo;
    __syncthreads();
    unsigned long long all = 0ull;
    for (int k = 0; k < kCtaThreads / 32; ++k) all |= v[k];
    par ^= 1;
    return all;
  }

  // Copy block b's 13 rows into buffer `buf`: 416 16-byte pieces over the
  // CTA's threads.
  __device__ __forceinline__ void stage(const Tables& T, int buf, int b) {
    constexpr int kPieces = kTriRows * kTriBlock / 4;
    float* dst = S->tri[buf];
    const float* src = T.tri + static_cast<long long>(b) * kTriBlock;
    for (int k = threadIdx.x; k < kPieces; k += kCtaThreads) {
      const int row = k / (kTriBlock / 4), col = 4 * (k % (kTriBlock / 4));
      cp_async16(dst + row * kTriBlock + col, src + static_cast<long long>(row) * T.tri_cols + col);
    }
    cp_async_commit();
  }

  // Walk the set bits of the CTA's mask `cm` over window w0, staging each
  // block and calling test(b, rows) on every thread after it has landed.
  // test returns whether this thread still scans; with `early_exit`
  // (any-hit) the walk ends, returning false, once no thread does.
  template <class Test>
  __device__ __forceinline__ bool walk(const Tables& T, int w0, unsigned long long cm,
                                       bool early_exit, Test&& test) {
    static_assert(kStages == 2, "the waits below count one copy in flight at most");
    unsigned long long pend = 0ull;  // staged, not yet tested (lowest bit first)
    int issued = 0, used = 0;
    auto issue = [&]() {
      const unsigned long long low = cm & (~cm + 1ull);
      stage(T, issued % kStages, w0 + __ffsll(static_cast<long long>(cm)) - 1);
      pend |= low;
      cm &= cm - 1;
      ++issued;
    };
    while (cm && issued < kStages) issue();
    while (pend) {
      const int b = w0 + __ffsll(static_cast<long long>(pend)) - 1;
      if (issued - used > 1) {  // block b's copy, and the next one's behind it
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // block b has landed for every thread
      const bool scanning = test(b, static_cast<const float*>(S->tri[used % kStages]));
      if (early_exit) {
        if (!__syncthreads_or(scanning)) {  // buffer free, and nobody left
          cp_async_wait<0>();
          return false;
        }
      } else {
        __syncthreads();  // the buffer of block b is free
      }
      pend &= pend - 1;
      ++used;
      if (cm) issue();  // into the buffer block b just left
    }
    return true;
  }

  // The culled triangles of closest_hit. The winner is the lexicographic
  // minimum of (t, original index), the scan in authoring order with strict
  // < whatever the visit order; a sphere or plane (lower indices) keeps a
  // tie. The bound of every box test is the best hit so far, inclusive, so a
  // block holding a tie at h.t is scanned.
  //
  // A warp tests a staged block for the rays of its lanes that need it one
  // ray at a time: each lane tests 4 of the 128 triangles (neighbouring
  // lanes on neighbouring shared-memory words) and shuffles reduce the
  // lexicographic minimum of (t, index) over the lanes. A warp's cost is then
  // its rays' work, with no lane idle while another tests 128 triangles.
  __device__ __forceinline__ void closest(const Tables& T, bool active, float ox, float oy,
                                          float oz, float dx, float dy, float dz, Hit& h) {
    const Slab s = make_slab(ox, oy, oz, dx, dy, dz);
    float hg = h.t < kInf ? static_cast<float>(h.gi) : kInf;  // the best's original index
    const int lane = threadIdx.x & 31;
    for (int w0 = 0; w0 < T.n_blocks; w0 += kWindow) {
      const unsigned long long mine = active ? meets(T, s, w0, h.t) : 0ull;
      const unsigned long long cm = vote(mine);
      if (!cm) continue;
      walk(T, w0, cm, false, [&](int b, const float* rows) {
        const bool need = ((mine >> (b - w0)) & 1ull) && box_hit(T, s, b, h.t);
        for (unsigned w = __ballot_sync(kFullMask, need); w; w &= w - 1) {
          const int src = __ffs(w) - 1;
          const float rox = __shfl_sync(kFullMask, ox, src), roy = __shfl_sync(kFullMask, oy, src);
          const float roz = __shfl_sync(kFullMask, oz, src), rdx = __shfl_sync(kFullMask, dx, src);
          const float rdy = __shfl_sync(kFullMask, dy, src), rdz = __shfl_sync(kFullMask, dz, src);
          const float rt = __shfl_sync(kFullMask, h.t, src);
          float bt = kInf, bg = kInf;  // this lane's lexicographic minimum
          int bj = -1;
          for (int q = 0; q < kTriBlock / 32; ++q) {
            const int j = lane + 32 * q;
            float t;
            if (!tri_hit<true>(rows + j, kTriBlock, rox, roy, roz, rdx, rdy, rdz, t) || t > rt) continue;
            const float gi = rows[12 * kTriBlock + j];
            if (t < bt || (t == bt && gi < bg)) {
              bt = t;
              bg = gi;
              bj = j;
            }
          }
          for (int k = 16; k > 0; k >>= 1) {
            const float ot = __shfl_xor_sync(kFullMask, bt, k);
            const float og = __shfl_xor_sync(kFullMask, bg, k);
            const int oj = __shfl_xor_sync(kFullMask, bj, k);
            if (ot < bt || (ot == bt && og < bg)) {
              bt = ot;
              bg = og;
              bj = oj;
            }
          }
          if (lane == src && bj >= 0 && (bt < h.t || bg < hg)) {
            h = Hit{bt, rows[9 * kTriBlock + bj], rows[10 * kTriBlock + bj],
                    rows[11 * kTriBlock + bj], static_cast<int>(bg), b * kTriBlock + bj};
            hg = bg;
          }
        }
        return need;
      });
    }
  }

  // The culled triangles of any_hit: boxes against [0, hi]; a ray stops at
  // its first blocker, the CTA when no ray still scans. A warp tests a
  // staged block for its rays one at a time, as closest does.
  __device__ __forceinline__ bool occluded(const Tables& T, bool active, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float lo,
                                           float hi) {
    const Slab s = make_slab(ox, oy, oz, dx, dy, dz);
    bool scanning = active;
    const int lane = threadIdx.x & 31;
    for (int w0 = 0; w0 < T.n_blocks; w0 += kWindow) {
      const unsigned long long mine = scanning ? meets(T, s, w0, hi) : 0ull;
      const unsigned long long cm = vote(mine);
      if (!cm) continue;
      const bool more = walk(T, w0, cm, true, [&](int b, const float* rows) {
        const bool need = scanning && ((mine >> (b - w0)) & 1ull);
        for (unsigned w = __ballot_sync(kFullMask, need); w; w &= w - 1) {
          const int src = __ffs(w) - 1;
          const float rox = __shfl_sync(kFullMask, ox, src), roy = __shfl_sync(kFullMask, oy, src);
          const float roz = __shfl_sync(kFullMask, oz, src), rdx = __shfl_sync(kFullMask, dx, src);
          const float rdy = __shfl_sync(kFullMask, dy, src), rdz = __shfl_sync(kFullMask, dz, src);
          const float rlo = __shfl_sync(kFullMask, lo, src), rhi = __shfl_sync(kFullMask, hi, src);
          bool blocked = false;
          for (int q = 0; q < kTriBlock / 32 && !blocked; ++q) {
            float t;
            blocked = tri_hit<true>(rows + lane + 32 * q, kTriBlock, rox, roy, roz, rdx, rdy, rdz, t) &&
                      t > rlo && t < rhi;
          }
          if (__any_sync(kFullMask, blocked) && lane == src) scanning = false;
        }
        return scanning;
      });
      if (!more) break;
    }
    return active && !scanning;
  }
};

// Culled tables, the glass kernels (wavefront_trace.cu,
// wavefront_spp_trace.cu): the 32 lanes of a warp scan together, with no
// barrier beyond the warp, since each warp's DFS and shadow marches end on
// their own. Every lane of the warp calls each scan in step
// (trace_wavefront_warp's loops vote through `any`), each with its own
// `active`. Per window of kWindow blocks each lane forms the mask of the
// blocks whose box and group box its own segment [0, bound] meets
// (CtaCulledTris::meets), and the warp walks the OR of the masks in table
// order. For each block it ballots the lanes that still need it (the bit
// of their mask, and the block box against their bound now) and tests the
// block for each of their rays in lane order: the ray is broadcast by
// shuffles, each lane tests columns lane + 32k (k = 0..3), and the lanes
// reduce their results. The block's rows are first copied once into the
// warp's slice of shared memory, each row by 32 consecutive addresses.
// A warp so issues a block's 128 tests once per ray that needs it, where a
// loop per lane issues them 32 x its busiest lane's blocks. Each lane's
// bound shrinks block by block in table order, as in a walk of its own, so
// it visits the same blocks and takes the same winner: the lexicographic
// minimum of (t, row-12 original index), the linear scan's winner in
// authoring order with strict <, and a sphere or plane (lower indices)
// keeps a tie. The winner's global index comes from row 12, so material
// lookups read its authoring column, never a padded one (index 2^30, which
// never hits). tri_test rounds every product on its own, so a triangle's t
// is the same bits whichever lane tests it, in either table order. The
// any-hit scan bounds the segment by hi and stops a lane at the first
// block that blocks it.
struct WarpCulledTris {
  // CTAs per SM the glass kernels ask of the register allocator for this
  // scan: 80 registers a thread. On the glass mesh at 1080p (PERF.md §6),
  // 4 and 5 CTAs (128 and 96 registers) ran 5-12% slower, 8 (64, with
  // three times the spill loads) between 2% slower and 5% faster.
  static constexpr int kMinCtas = 6;
  // Rows of a block a test reads, staged: v0, e1, e2 (rows 0-8) and the
  // original index (row 12, staged as row 9).
  static constexpr int kStageRows = 10;
  float* S;  // this warp's stage, kStageRows rows of kTriBlock floats

  // Every thread of the CTA calls it: 5,120 bytes of shared memory a warp.
  static __device__ __forceinline__ WarpCulledTris make() {
    __shared__ float stage[kCtaThreads / 32][kStageRows * kTriBlock];
    return WarpCulledTris{stage[threadIdx.x >> 5]};
  }

  __device__ __forceinline__ bool any(bool p) const { return __any_sync(kFullMask, p) != 0; }

  // Copy block b's staged rows into this warp's stage -> this lane's first
  // column there (S + lane). Every lane of the warp calls it; the first
  // __syncwarp waits for the lanes still testing the previous block.
  // Staged once for the block's rays, where the tests read a block from
  // the L1 cache again for each ray that needs it, it ran 2-10% faster
  // (PERF.md §6).
  __device__ __forceinline__ const float* stage(const Tables& T, int b) const {
    const int lane = threadIdx.x & 31;
    const float* src = T.tri + b * kTriBlock + lane;
    __syncwarp();
    for (int r = 0; r < kStageRows; ++r) {
      const int row = r < 9 ? r : 12;
      for (int q = 0; q < kTriBlock / 32; ++q) {
        S[r * kTriBlock + lane + 32 * q] = __ldg(src + row * T.tri_cols + 32 * q);
      }
    }
    __syncwarp();
    return S + lane;
  }

  // block(b, need) for each block b of the OR of the lanes' masks, in table
  // order, where need, the same on every lane, is the ballot of the lanes
  // that scan and whose segment [0, bound()] meets b and its group. The walk
  // reads `scanning` (block may clear it) and ends once no lane scans.
  template <class Bound, class Block>
  static __device__ __forceinline__ void walk(const Tables& T, const Slab& s, const bool& scanning,
                                              Bound&& bound, Block&& block) {
    for (int w0 = 0; w0 < T.n_blocks; w0 += kWindow) {
      if (!__any_sync(kFullMask, scanning)) return;
      const unsigned long long mine = scanning ? CtaCulledTris::meets(T, s, w0, bound()) : 0ull;
      const unsigned lo = __reduce_or_sync(kFullMask, static_cast<unsigned>(mine));
      const unsigned hi = __reduce_or_sync(kFullMask, static_cast<unsigned>(mine >> 32));
      for (unsigned long long m = (static_cast<unsigned long long>(hi) << 32) | lo; m; m &= m - 1) {
        const int b = w0 + __ffsll(static_cast<long long>(m)) - 1;
        const bool need = scanning && ((mine >> (b - w0)) & 1ull) && box_hit(T, s, b, bound());
        const unsigned v = __ballot_sync(kFullMask, need);
        if (v) block(b, v);
      }
    }
  }

  // Lower this lane's (best, bg) to the lexicographic minimum of (t,
  // original index) over the triangles of the blocks its segment [0, best]
  // meets, calling win(t, column, original index) for each new best. Per
  // ray and block each lane keeps the least (t, index) of its 4 columns;
  // t > kEps > 0, so t's bits order as t, and the warp takes the least t
  // by one reduction and the least index among the lanes that hold it by
  // another.
  template <class Win>
  __device__ __forceinline__ void lowest(const Tables& T, bool active, float ox, float oy,
                                         float oz, float dx, float dy, float dz, float& best,
                                         float& bg, Win&& win) const {
    const Slab s = make_slab(ox, oy, oz, dx, dy, dz);
    const int lane = threadIdx.x & 31;
    walk(T, s, active, [&] { return best; }, [&](int b, unsigned need) {
      const float* c = stage(T, b);
      for (unsigned w = need; w; w &= w - 1) {
        const int src = __ffs(w) - 1;
        const float rox = __shfl_sync(kFullMask, ox, src), roy = __shfl_sync(kFullMask, oy, src);
        const float roz = __shfl_sync(kFullMask, oz, src), rdx = __shfl_sync(kFullMask, dx, src);
        const float rdy = __shfl_sync(kFullMask, dy, src), rdz = __shfl_sync(kFullMask, dz, src);
        float lt = kInf, lg = kInf;  // this lane's least (t, index) of its columns
        int lq = 0;
        for (int q = 0; q < kTriBlock / 32; ++q) {
          float t;
          if (!tri_hit<true>(c + 32 * q, kTriBlock, rox, roy, roz, rdx, rdy, rdz, t)) continue;
          const float g = c[32 * q + 9 * kTriBlock];
          if (t < lt || (t == lt && g < lg)) {
            lt = t;
            lg = g;
            lq = q;
          }
        }
        const unsigned tb = __reduce_min_sync(kFullMask, __float_as_uint(lt));
        if (tb == __float_as_uint(kInf)) continue;  // no lane hit
        const bool tie = __float_as_uint(lt) == tb;
        const unsigned gb = __reduce_min_sync(kFullMask, tie ? static_cast<unsigned>(lg) : ~0u);
        const int at = __ffs(__ballot_sync(kFullMask, tie && static_cast<unsigned>(lg) == gb)) - 1;
        const int q = __shfl_sync(kFullMask, lq, at);
        const float t = __uint_as_float(tb), g = static_cast<float>(gb);
        if (lane == src && (t < best || (t == best && g < bg))) {
          best = t;
          bg = g;
          win(t, b * kTriBlock + at + 32 * q, g);
        }
      }
    });
  }

  // The culled triangles of closest_hit.
  __device__ __forceinline__ void closest(const Tables& T, bool active, float ox, float oy,
                                          float oz, float dx, float dy, float dz, Hit& h) const {
    float best = h.t, bg = h.t < kInf ? static_cast<float>(h.gi) : kInf;
    lowest(T, active, ox, oy, oz, dx, dy, dz, best, bg, [&](float t, int col, float g) {
      h = Hit{t, tab(T.tri, T.tri_cols, 9, col), tab(T.tri, T.tri_cols, 10, col),
              tab(T.tri, T.tri_cols, 11, col), static_cast<int>(g), col};
    });
  }

  // The triangles of nearest_t_tau_warp: lower (best, gi) by the
  // lexicographic minimum of (t, original index).
  __device__ __forceinline__ void nearest(const Tables& T, bool active, float ox, float oy,
                                          float oz, float dx, float dy, float dz, float& best,
                                          int& gi) const {
    float bg = gi >= 0 ? static_cast<float>(gi) : kInf;
    lowest(T, active, ox, oy, oz, dx, dy, dz, best, bg,
           [&](float, int, float g) { gi = static_cast<int>(g); });
  }

  // The culled triangles of any_hit: is there one with lo < t < hi?
  __device__ __forceinline__ bool occluded(const Tables& T, bool active, float ox, float oy,
                                           float oz, float dx, float dy, float dz, float lo,
                                           float hi) const {
    const Slab s = make_slab(ox, oy, oz, dx, dy, dz);
    const int lane = threadIdx.x & 31;
    bool scanning = active;
    walk(T, s, scanning, [&] { return hi; }, [&](int b, unsigned need) {
      const float* c = stage(T, b);
      for (unsigned w = need; w; w &= w - 1) {
        const int src = __ffs(w) - 1;
        const float rox = __shfl_sync(kFullMask, ox, src), roy = __shfl_sync(kFullMask, oy, src);
        const float roz = __shfl_sync(kFullMask, oz, src), rdx = __shfl_sync(kFullMask, dx, src);
        const float rdy = __shfl_sync(kFullMask, dy, src), rdz = __shfl_sync(kFullMask, dz, src);
        const float rlo = __shfl_sync(kFullMask, lo, src), rhi = __shfl_sync(kFullMask, hi, src);
        bool blocked = false;
        for (int q = 0; q < kTriBlock / 32 && !blocked; ++q) {
          float t;
          blocked = tri_hit<true>(c + 32 * q, kTriBlock, rox, roy, roz, rdx, rdy, rdz, t) &&
                    t > rlo && t < rhi;
        }
        if (__any_sync(kFullMask, blocked) && lane == src) scanning = false;
      }
    });
    return active && !scanning;
  }
};

// Closest hit: spheres, planes, then the triangles by the scan `tris`. All
// hit fields update together under one `closer` test. Every thread of the
// CTA calls it (for a culled scan); `active` says whether its ray scans (a
// thread that does not returns a miss).
template <class Tris>
static __device__ __forceinline__ Hit closest_hit(const Tables& T, Tris& tris, bool active,
                                                  float ox, float oy, float oz, float dx,
                                                  float dy, float dz) {
  Hit h{kInf, 0.0f, 0.0f, 0.0f, 0};
  if (active) {
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv2a = 0.5f / a;
    float t;
    for (int i = 0; i < T.ns; ++i) {
      if (sphere_t(T, i, a, inv2a, ox, oy, oz, dx, dy, dz, t) && t < h.t) {
        const float gx = (ox + dx * t) - tab(T.sph, T.sph_cols, 0, i);
        const float gy = (oy + dy * t) - tab(T.sph, T.sph_cols, 1, i);
        const float gz = (oz + dz * t) - tab(T.sph, T.sph_cols, 2, i);
        const float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-24f));
        h = Hit{t, gx * inv, gy * inv, gz * inv, i};
      }
    }
    for (int i = 0; i < T.np; ++i) {
      if (plane_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < h.t) {
        h = Hit{t, tab(T.pl, T.pl_cols, 0, i), tab(T.pl, T.pl_cols, 1, i),
                tab(T.pl, T.pl_cols, 2, i), T.ns + i};
      }
    }
  }
  tris.closest(T, active, ox, oy, oz, dx, dy, dz, h);
  return h;
}

// The linear scan of one ray (the glass kernels).
static __device__ __forceinline__ Hit closest_hit(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz) {
  LinearTris lin;
  return closest_hit(T, lin, true, ox, oy, oz, dx, dy, dz);
}

// Does a sphere or plane block (lo < t < hi)? Returns at the first blocker.
static __device__ __forceinline__ bool prims_block(const Tables& T, float ox, float oy, float oz,
                                                   float dx, float dy, float dz, float lo,
                                                   float hi) {
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float inv2a = 0.5f / a;
  float t;
  for (int i = 0; i < T.ns; ++i)
    if (sphere_t(T, i, a, inv2a, ox, oy, oz, dx, dy, dz, t) && t > lo && t < hi) return true;
  for (int i = 0; i < T.np; ++i)
    if (plane_t(T, i, ox, oy, oz, dx, dy, dz, t) && t > lo && t < hi) return true;
  return false;
}

// Binary occlusion: is there any primitive with lo < t < hi? Stops at the
// first blocker. Called as closest_hit is.
template <class Tris>
static __device__ __forceinline__ bool any_hit(const Tables& T, Tris& tris, bool active,
                                               float ox, float oy, float oz, float dx, float dy,
                                               float dz, float lo, float hi) {
  const bool occ = active && prims_block(T, ox, oy, oz, dx, dy, dz, lo, hi);
  return tris.occluded(T, active && !occ, ox, oy, oz, dx, dy, dz, lo, hi) || occ;
}

static __device__ __forceinline__ bool any_hit(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz,
    float lo, float hi) {
  LinearTris lin;
  return any_hit(T, lin, true, ox, oy, oz, dx, dy, dz, lo, hi);
}

// Sky gradient on unit directions (Scene.h:30-33).
static __device__ __forceinline__ float3 sky(float dy) {
  const float t = 0.5f * (dy + 1.0f);
  return make_float3(1.0f * (1.0f - t) + 0.5f * t, 1.0f * (1.0f - t) + 0.7f * t,
                     1.0f * (1.0f - t) + 1.0f * t);
}

// The pieces of one bounce of the opaque chain in trace_packet, each the
// arithmetic of trace_ray's lines for one ray, in their order.

// acc += weight * sky (a miss, or depth exhaustion: Scene.h:132-134).
static __device__ __forceinline__ void add_sky(float3& acc, float weight, float dy) {
  const float3 s = sky(dy);
  acc.x += weight * s.x;
  acc.y += weight * s.y;
  acc.z += weight * s.z;
}

// The hit point and the front-facing normal (Scene.h:145-146).
struct Frame {
  float nx, ny, nz, px, py, pz;
};

static __device__ __forceinline__ Frame hit_frame(const Hit& h, float ox, float oy, float oz,
                                                  float dx, float dy, float dz) {
  const float ndotd = h.nx * dx + h.ny * dy + h.nz * dz;
  const float flip = ndotd < 0.0f ? 1.0f : -1.0f;
  return Frame{h.nx * flip, h.ny * flip, h.nz * flip,
               ox + dx * h.t, oy + dy * h.t, oz + dz * h.t};
}

// The unit direction from the hit point to a light, its distance, 1 / the
// distance and n.l clamped at 0 (Scene.h:79-129).
struct ToLight {
  float dx, dy, dz, dist, inv_d, ndotl;
};

static __device__ __forceinline__ ToLight to_light(float lx, float ly, float lz, const Frame& f) {
  const float vx = lx - f.px, vy = ly - f.py, vz = lz - f.pz;
  const float dist = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-30f));
  const float inv_d = 1.0f / dist;
  const float ldx = vx * inv_d, ldy = vy * inv_d, ldz = vz * inv_d;
  const float ndotl = fmaxf(0.0f, f.nx * ldx + f.ny * ldy + f.nz * ldz);
  return ToLight{ldx, ldy, ldz, dist, inv_d, ndotl};
}

// The diffuse and specular sums over the lights of one hit.
struct Direct {
  float dr = 0.0f, dg = 0.0f, db = 0.0f, sr = 0.0f, sg = 0.0f, sb = 0.0f;
};

// Add a light that reaches the hit point: 1/d^2 diffuse, and Blinn-Phong
// (Scene.h:115-123) with exp(shin * log(x)) as the TPU kernel.
static __device__ __forceinline__ void add_light(Direct& a, const ToLight& l, float er, float eg,
                                                 float eb, float dx, float dy, float dz,
                                                 const Frame& f, float spec, float shin) {
  const float inv_d2 = l.inv_d * l.inv_d;
  const float contrib = inv_d2 * l.ndotl;
  a.dr += er * contrib;
  a.dg += eg * contrib;
  a.db += eb * contrib;
  const float hx = l.dx - dx, hy = l.dy - dy, hz = l.dz - dz;
  const float invh = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-24f));
  const float ndoth = fmaxf(0.0f, (f.nx * hx + f.ny * hy + f.nz * hz) * invh);
  if (spec > 0.0f && ndoth > 0.0f) {
    const float sf = expf(shin * logf(ndoth)) * inv_d2;
    a.sr += er * sf;
    a.sg += eg * sf;
    a.sb += eb * sf;
  }
}

// acc += weight * (albedo * diffuse + specular sum * specular).
static __device__ __forceinline__ void add_direct(float3& acc, float weight, float ar, float ag,
                                                  float ab, float spec, const Direct& a) {
  acc.x += weight * (ar * a.dr + a.sr * spec);
  acc.y += weight * (ag * a.dg + a.sg * spec);
  acc.z += weight * (ab * a.db + a.sb * spec);
}

// The reflection chain's next ray (Scene.h:189-195): d reflected about n,
// renormalised, from the hit point moved by bias along it.
static __device__ __forceinline__ void reflect_ray(const Frame& f, float bias, float& ox,
                                                   float& oy, float& oz, float& dx, float& dy,
                                                   float& dz) {
  const float ddn = dx * f.nx + dy * f.ny + dz * f.nz;
  float rx = dx - 2.0f * ddn * f.nx;
  float ry = dy - 2.0f * ddn * f.ny;
  float rz = dz - 2.0f * ddn * f.nz;
  const float invr = rsqrtf(fmaxf(rx * rx + ry * ry + rz * rz, 1e-24f));
  rx *= invr;
  ry *= invr;
  rz *= invr;
  ox = f.px + rx * bias;
  oy = f.py + ry * bias;
  oz = f.pz + rz * bias;
  dx = rx;
  dy = ry;
  dz = rz;
}

// The full chain for one ray -> HDR radiance. Every thread of the CTA calls
// it (the culled scan's barriers); `valid` is false for a thread with no
// ray, whose result is not used. The depth loop and the light loop run
// until no ray of the CTA (culled) or this ray (linear) is live, and a
// thread whose ray ended passes through them with its scans inactive.
// With kTape it also writes ray `ray`'s bounces and end to `tape`.
template <class Tris, bool kTape = false>
static __device__ __forceinline__ float3 trace_ray(
    const Tables& T, Tris& tris, bool valid, float ox, float oy, float oz, float dx, float dy,
    float dz, int max_depth, float bias, float min_weight, const ChainTape& tape = ChainTape{},
    long long ray = 0) {
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, weight = 1.0f;
  bool live = valid;
  int nd = 0;  // bounces taken (the tape's)
  for (int depth = 0; depth < max_depth; ++depth) {
    if (!tris.any(live)) break;
    const Hit h = closest_hit(T, tris, live, ox, oy, oz, dx, dy, dz);
    if constexpr (kTape) {
      if (live) tape.bounce(nd++, ray, ox, oy, oz, dx, dy, dz, weight, h);
    }
    const bool shade = live && h.t < kInf;
    if (live && !shade) {  // miss -> sky
      const float3 s = sky(dy);
      acc_r += weight * s.x;
      acc_g += weight * s.y;
      acc_b += weight * s.z;
      live = false;
    }
    if (!tris.any(shade)) break;
    // Front-face flip (Scene.h:145-146)
    const float ndotd = h.nx * dx + h.ny * dy + h.nz * dz;
    const float flip = ndotd < 0.0f ? 1.0f : -1.0f;
    const float nx = h.nx * flip, ny = h.ny * flip, nz = h.nz * flip;
    const float px = ox + dx * h.t, py = oy + dy * h.t, pz = oz + dz * h.t;
    const float ar = tab(T.mat, T.mat_cols, 0, h.gi), ag = tab(T.mat, T.mat_cols, 1, h.gi);
    const float ab = tab(T.mat, T.mat_cols, 2, h.gi), spec = tab(T.mat, T.mat_cols, 3, h.gi);
    const float shin = tab(T.mat, T.mat_cols, 4, h.gi);

    // Direct lighting, binary shadows (Scene.h:79-129)
    float diff_r = 0.0f, diff_g = 0.0f, diff_b = 0.0f;
    float spec_r = 0.0f, spec_g = 0.0f, spec_b = 0.0f;
    const float sox = px + nx * bias, soy = py + ny * bias, soz = pz + nz * bias;
    for (int li = 0; li < T.nl; ++li) {
      const int c = T.light_cols;
      const float lx = tab(T.light, c, 0, li), ly = tab(T.light, c, 1, li), lz = tab(T.light, c, 2, li);
      const float er = tab(T.light, c, 3, li), eg = tab(T.light, c, 4, li), eb = tab(T.light, c, 5, li);
      const float vx = lx - px, vy = ly - py, vz = lz - pz;
      const float dist = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-30f));
      const float inv_d = 1.0f / dist;
      const float ldx = vx * inv_d, ldy = vy * inv_d, ldz = vz * inv_d;
      const float ndotl = fmaxf(0.0f, nx * ldx + ny * ldy + nz * ldz);
      const bool ok = shade && dist > bias && ndotl > 0.0f;
      if (!tris.any(ok)) continue;
      if (any_hit(T, tris, ok, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias) || !ok) continue;
      const float inv_d2 = inv_d * inv_d;
      const float contrib = inv_d2 * ndotl;
      diff_r += er * contrib;
      diff_g += eg * contrib;
      diff_b += eb * contrib;
      // Blinn-Phong (Scene.h:115-123); exp(shin * log(x)) as the TPU kernel.
      const float hx = ldx - dx, hy = ldy - dy, hz = ldz - dz;
      const float invh = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-24f));
      const float ndoth = fmaxf(0.0f, (nx * hx + ny * hy + nz * hz) * invh);
      if (spec > 0.0f && ndoth > 0.0f) {
        const float sf = expf(shin * logf(ndoth)) * inv_d2;
        spec_r += er * sf;
        spec_g += eg * sf;
        spec_b += eb * sf;
      }
    }
    if (!shade) continue;
    acc_r += weight * (ar * diff_r + spec_r * spec);
    acc_g += weight * (ag * diff_g + spec_g * spec);
    acc_b += weight * (ab * diff_b + spec_b * spec);

    // Reflection chain (Scene.h:189-195), pruned by min_weight.
    if (!(spec > bias && weight * spec >= min_weight)) {
      live = false;
      continue;
    }
    const float ddn = dx * nx + dy * ny + dz * nz;
    float rx = dx - 2.0f * ddn * nx;
    float ry = dy - 2.0f * ddn * ny;
    float rz = dz - 2.0f * ddn * nz;
    const float invr = rsqrtf(fmaxf(rx * rx + ry * ry + rz * rz, 1e-24f));
    rx *= invr;
    ry *= invr;
    rz *= invr;
    ox = px + rx * bias;
    oy = py + ry * bias;
    oz = pz + rz * bias;
    dx = rx;
    dy = ry;
    dz = rz;
    weight *= spec;
  }
  if (live) {  // depth exhaustion -> sky (Scene.h:132-134)
    const float3 s = sky(dy);
    acc_r += weight * s.x;
    acc_g += weight * s.y;
    acc_b += weight * s.z;
  }
  if constexpr (kTape) {
    if (valid) tape.end(ray, nd, live, dy, weight);
  }
  return make_float3(acc_r, acc_g, acc_b);
}

// ---------------------------------------------------------------------------
// The staged linear scan (chain_trace.cu, spp_trace.cu): linear tables
// staged once per CTA in shared memory, and K rays per thread
// ---------------------------------------------------------------------------

// The largest stage, in bytes (`trace_route`): the 7 CTAs per SM of the
// staged kernels then hold at most 112 KB of an SM's 228 KB of shared
// memory, and a CTA copies at most 1,024 16-byte entries, 8 per thread.
// Larger linear tables take the in-place scan, LinearTris.
constexpr int kStageMaxBytes = 16384;

// Where each family starts in the stage, in 16-byte entries: a sphere is one
// (center, r^2), a plane one (unit normal, p.n), a triangle three (v0 e1.x |
// e1.yz e2.xy | e2.z n), a light two (position, emission r | emission gb,
// active, 0) and a material two (albedo, specular | shininess,
// transparency, ior, 0). `n`: the entries in all.
struct StageLayout {
  int pl, tri, light, mat, n;
};

inline __host__ __device__ StageLayout stage_layout(const Tables& T) {
  StageLayout L;
  L.pl = T.ns;
  L.tri = L.pl + T.np;
  L.light = L.tri + 3 * T.nt;
  L.mat = L.light + 2 * T.nl;
  L.n = L.mat + 2 * (T.ns + T.np + T.nt);
  return L;
}

// Rows 4q .. 4q+3 of column i of a table of `rows` rows (0 past the last).
static __device__ __forceinline__ float4 column4(const float* t, int cols, int rows, int q, int i) {
  const int r = 4 * q;
  return make_float4(tab(t, cols, r, i), tab(t, cols, r + 1, i),
                     r + 2 < rows ? tab(t, cols, r + 2, i) : 0.0f,
                     r + 3 < rows ? tab(t, cols, r + 3, i) : 0.0f);
}

// The rays of one thread's packet, each with its own exits.
template <int K>
struct Rays {
  float ox[K], oy[K], oz[K], dx[K], dy[K], dz[K];
};

template <int K>
static __device__ __forceinline__ bool any_of(const bool (&p)[K]) {
  bool r = false;
#pragma unroll
  for (int k = 0; k < K; ++k) r |= p[k];
  return r;
}

// The CTA's staged tables and the packet scans over them. Each entry loaded
// (one 16-byte broadcast load: every lane of a warp reads the same entry)
// serves the tests of the packet's K rays. Per ray the tests, their order
// and the strict < first-win are LinearTris' and closest_hit's: spheres,
// planes, then triangles in authoring order; an any-hit scan stops a ray at
// its first blocker and the packet when none of its rays still scans.
//
// The scans stop at each family's live extent: one past its last slot that
// can hit (a sphere with r^2 >= 0, a plane with n != 0, a triangle with e1
// or e2 != 0) or light (active > 0), found while the CTA stages the tables.
// Every slot past it is padding that no test can take and no light that
// emits, so the results are those of the scan over every slot. Hit indices
// stay global over the slots (a plane's is L.pl + i, a triangle's L.tri +
// i), and the stage's layout is stage_layout(T)'s.
template <int K>
struct StagedScan {
  const float4* S;
  StageLayout L;
  int ns, np, nt, nl;  // live extents: the loop bounds of the scans

  // Every thread of the CTA calls it once, before any scan: the copy into
  // shared memory (dynamic, stage_layout(T).n entries), each family's live
  // extent (a maximum per warp, then over the warps) and one barrier.
  static __device__ __forceinline__ StagedScan make(const Tables& T) {
    extern __shared__ float4 stage[];
    // 64 static bytes beside the stage: a stage within kStageMaxBytes keeps
    // the adjoint's accumulator (grad_route) far below a block's limit.
    __shared__ int4 warp_ext[kCtaThreads / 32];
    const StageLayout L = stage_layout(T);
    int xs = 0, xp = 0, xt = 0, xl = 0;  // one past the last live slot this thread staged
    for (int e = threadIdx.x; e < L.n; e += kCtaThreads) {
      float4 v;
      if (e < L.pl) {
        v = column4(T.sph, T.sph_cols, 4, 0, e);
        if (v.w >= 0.0f) xs = e + 1;
      } else if (e < L.tri) {
        v = column4(T.pl, T.pl_cols, 4, 0, e - L.pl);
        if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f) xp = e - L.pl + 1;
      } else if (e < L.light) {
        // entry q of a triangle: v0 e1.x | e1.yz e2.xy | e2.z n
        const int q = (e - L.tri) % 3, i = (e - L.tri) / 3;
        v = column4(T.tri, T.tri_cols, 12, q, i);
        const bool edge = q == 0   ? v.w != 0.0f
                          : q == 1 ? (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
                                   : v.x != 0.0f;
        if (edge) xt = i + 1;
      } else if (e < L.mat) {
        // entry q of a light: position, emission r | emission gb, active, 0
        const int q = (e - L.light) % 2, i = (e - L.light) / 2;
        v = column4(T.light, T.light_cols, 7, q, i);
        if (q == 1 && v.z > 0.0f) xl = i + 1;
      } else {
        v = column4(T.mat, T.mat_cols, 7, (e - L.mat) % 2, (e - L.mat) / 2);
      }
      stage[e] = v;
    }
    const int4 w = make_int4(__reduce_max_sync(kFullMask, xs), __reduce_max_sync(kFullMask, xp),
                             __reduce_max_sync(kFullMask, xt), __reduce_max_sync(kFullMask, xl));
    if ((threadIdx.x & 31) == 0) warp_ext[threadIdx.x >> 5] = w;
    __syncthreads();
    int4 x = warp_ext[0];
#pragma unroll
    for (int j = 1; j < kCtaThreads / 32; ++j) {
      const int4 y = warp_ext[j];
      x = make_int4(max(x.x, y.x), max(x.y, y.y), max(x.z, y.z), max(x.w, y.w));
    }
    return StagedScan{stage, L, x.x, x.y, x.z, x.w};
  }

  // Closest hit of each ray k with act[k] (a miss for the others).
  __device__ __forceinline__ void closest(const bool (&act)[K], const Rays<K>& r,
                                          Hit (&h)[K]) const {
    float a[K], inv2a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      h[k] = Hit{kInf, 0.0f, 0.0f, 0.0f, 0};
      a[k] = dot3(r.dx[k], r.dy[k], r.dz[k], r.dx[k], r.dy[k], r.dz[k]);
      inv2a[k] = 0.5f / a[k];
    }
    for (int i = 0; i < ns; ++i) {
      const float4 c = S[i];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float t;
        if (act[k] && sphere_test(c.x, c.y, c.z, c.w, a[k], inv2a[k], r.ox[k], r.oy[k], r.oz[k],
                                  r.dx[k], r.dy[k], r.dz[k], t) && t < h[k].t) {
          const float gx = (r.ox[k] + r.dx[k] * t) - c.x;
          const float gy = (r.oy[k] + r.dy[k] * t) - c.y;
          const float gz = (r.oz[k] + r.dz[k] * t) - c.z;
          const float inv = rsqrtf(fmaxf(gx * gx + gy * gy + gz * gz, 1e-24f));
          h[k] = Hit{t, gx * inv, gy * inv, gz * inv, i};
        }
      }
    }
    for (int i = 0; i < np; ++i) {
      const float4 p = S[L.pl + i];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float t;
        if (act[k] && plane_test(p.x, p.y, p.z, p.w, r.ox[k], r.oy[k], r.oz[k], r.dx[k], r.dy[k],
                                 r.dz[k], t) && t < h[k].t) {
          h[k] = Hit{t, p.x, p.y, p.z, L.pl + i};
        }
      }
    }
    for (int i = 0; i < nt; ++i) {
      const float4 q0 = S[L.tri + 3 * i], q1 = S[L.tri + 3 * i + 1], q2 = S[L.tri + 3 * i + 2];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float t;
        if (act[k] && tri_test(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, r.ox[k],
                               r.oy[k], r.oz[k], r.dx[k], r.dy[k], r.dz[k], t) && t < h[k].t) {
          h[k] = Hit{t, q2.y, q2.z, q2.w, L.tri + i, i};
        }
      }
    }
  }

  // Binary occlusion: clears scan[k] where a primitive blocks ray k
  // (lo < t < hi[k]); rays with scan[k] false on entry are not tested.
  __device__ __forceinline__ void occluded(bool (&scan)[K], const Rays<K>& r, float lo,
                                           const float (&hi)[K]) const {
    float a[K], inv2a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      a[k] = dot3(r.dx[k], r.dy[k], r.dz[k], r.dx[k], r.dy[k], r.dz[k]);
      inv2a[k] = 0.5f / a[k];
    }
    for (int i = 0; i < ns; ++i) {
      const float4 c = S[i];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float t;
        if (scan[k] && sphere_test(c.x, c.y, c.z, c.w, a[k], inv2a[k], r.ox[k], r.oy[k], r.oz[k],
                                   r.dx[k], r.dy[k], r.dz[k], t) && t > lo && t < hi[k]) {
          scan[k] = false;
        }
      }
      if (!any_of(scan)) return;
    }
    for (int i = 0; i < np; ++i) {
      const float4 p = S[L.pl + i];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float t;
        if (scan[k] && plane_test(p.x, p.y, p.z, p.w, r.ox[k], r.oy[k], r.oz[k], r.dx[k],
                                  r.dy[k], r.dz[k], t) && t > lo && t < hi[k]) {
          scan[k] = false;
        }
      }
      if (!any_of(scan)) return;
    }
    for (int i = 0; i < nt; ++i) {
      const float4 q0 = S[L.tri + 3 * i], q1 = S[L.tri + 3 * i + 1], q2 = S[L.tri + 3 * i + 2];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float t;
        if (scan[k] && tri_test(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, r.ox[k],
                                r.oy[k], r.oz[k], r.dx[k], r.dy[k], r.dz[k], t) && t > lo &&
            t < hi[k]) {
          scan[k] = false;
        }
      }
      if (!any_of(scan)) return;
    }
  }
};

// trace_ray for a packet of K rays over the staged tables: ray k's bounces,
// tests and shading are trace_ray's, in its order; the depth loop runs
// until no ray of the packet is live and a light's shadow scan runs for the
// rays that need it. `live` marks the rays that exist; out[k] is ray k's
// radiance. (trace_ray keeps its own text: written with the helpers above,
// the culled kernels' block-test loop compiled 7 instructions longer and
// ran 2-3% slower on the H100, PERF.md §6.) With kTape it also writes the
// bounces and ends of rays i0 + k to `tape`, as trace_ray does.
template <int K, bool kTape = false>
static __device__ __forceinline__ void trace_packet(const StagedScan<K>& sc, bool (&live)[K],
                                                    Rays<K>& r, int max_depth, float bias,
                                                    float min_weight, float3 (&out)[K],
                                                    const ChainTape& tape = ChainTape{},
                                                    long long i0 = 0) {
  float weight[K];
  bool valid[K];  // the rays that exist (the tape's)
  int nd[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out[k] = make_float3(0.0f, 0.0f, 0.0f);
    weight[k] = 1.0f;
    valid[k] = live[k];
    nd[k] = 0;
  }
  for (int depth = 0; depth < max_depth; ++depth) {
    if (!any_of(live)) break;
    Hit h[K];
    sc.closest(live, r, h);
    if constexpr (kTape) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (live[k]) tape.bounce(nd[k]++, i0 + k, r.ox[k], r.oy[k], r.oz[k], r.dx[k], r.dy[k],
                                 r.dz[k], weight[k], h[k]);
      }
    }
    bool shade[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      shade[k] = live[k] && h[k].t < kInf;
      if (live[k] && !shade[k]) {  // miss -> sky
        add_sky(out[k], weight[k], r.dy[k]);
        live[k] = false;
      }
    }
    if (!any_of(shade)) break;
    Frame f[K];
    float4 m0[K];  // albedo, specular
    float shin[K], so_x[K], so_y[K], so_z[K];
    Direct a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      f[k] = hit_frame(h[k], r.ox[k], r.oy[k], r.oz[k], r.dx[k], r.dy[k], r.dz[k]);
      m0[k] = sc.S[sc.L.mat + 2 * h[k].gi];
      shin[k] = sc.S[sc.L.mat + 2 * h[k].gi + 1].x;
      so_x[k] = f[k].px + f[k].nx * bias;
      so_y[k] = f[k].py + f[k].ny * bias;
      so_z[k] = f[k].pz + f[k].nz * bias;
    }

    // Direct lighting, binary shadows (Scene.h:79-129), over the live
    // lights (an inactive one emits 0: the same on every thread)
    for (int li = 0; li < sc.nl; ++li) {
      const float4 l0 = sc.S[sc.L.light + 2 * li], l1 = sc.S[sc.L.light + 2 * li + 1];
      if (!(l1.z > 0.0f)) continue;
      ToLight l[K];
      bool scan[K];
      float hi[K];
      Rays<K> sh;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        l[k] = to_light(l0.x, l0.y, l0.z, f[k]);
        scan[k] = shade[k] && l[k].dist > bias && l[k].ndotl > 0.0f;
        hi[k] = l[k].dist - bias;
        sh.ox[k] = so_x[k];
        sh.oy[k] = so_y[k];
        sh.oz[k] = so_z[k];
        sh.dx[k] = l[k].dx;
        sh.dy[k] = l[k].dy;
        sh.dz[k] = l[k].dz;
      }
      if (!any_of(scan)) continue;
      bool lit[K];
#pragma unroll
      for (int k = 0; k < K; ++k) lit[k] = scan[k];
      sc.occluded(lit, sh, bias, hi);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lit[k]) add_light(a[k], l[k], l0.w, l1.x, l1.y, r.dx[k], r.dy[k], r.dz[k], f[k],
                              m0[k].w, shin[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!shade[k]) continue;
      add_direct(out[k], weight[k], m0[k].x, m0[k].y, m0[k].z, m0[k].w, a[k]);
      // Reflection chain, pruned by min_weight.
      if (!(m0[k].w > bias && weight[k] * m0[k].w >= min_weight)) {
        live[k] = false;
        continue;
      }
      reflect_ray(f[k], bias, r.ox[k], r.oy[k], r.oz[k], r.dx[k], r.dy[k], r.dz[k]);
      weight[k] *= m0[k].w;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (live[k]) add_sky(out[k], weight[k], r.dy[k]);  // depth exhaustion
    if constexpr (kTape) {
      if (valid[k]) tape.end(i0 + k, nd[k], live[k], r.dy[k], weight[k]);
    }
  }
}

// The staged tables as a scan of one ray a thread: the head-box adjoint's
// shadow rays (chain_grad.cu, where `grad_route` takes the stage). The
// tests, their order and the first-blocker exit are any_hit's over
// LinearTris, so the two routes' booleans, and the adjoint's arithmetic
// around them, are the same per ray.
struct StagedTris {
  StagedScan<1> sc;
  // Every thread of the CTA calls it once (StagedScan::make's barrier).
  static __device__ __forceinline__ StagedTris make(const Tables& T) {
    return StagedTris{StagedScan<1>::make(T)};
  }
  __device__ __forceinline__ bool any(bool p) const { return p; }
  __device__ __forceinline__ int top(int n) const { return __reduce_max_sync(kFullMask, n); }
};

// Binary occlusion over the stage: is there a primitive with lo < t < hi?
// (It takes the scan as any_hit<Tris> does, so that overload resolution
// picks it over the template.)
static __device__ __forceinline__ bool any_hit(const Tables&, StagedTris& s, bool active,
                                               float ox, float oy, float oz, float dx, float dy,
                                               float dz, float lo, float hi) {
  if (!active) return false;
  bool scan[1] = {true};
  Rays<1> r;
  r.ox[0] = ox; r.oy[0] = oy; r.oz[0] = oz;
  r.dx[0] = dx; r.dy[0] = dy; r.dz[0] = dz;
  const float h[1] = {hi};
  s.sc.occluded(scan, r, lo, h);
  return !scan[0];
}

// ---------------------------------------------------------------------------
// The full Whitted DFS (wavefront kernels)
// ---------------------------------------------------------------------------

// Largest stack the wavefront kernels compile: max_depth + 2 <= kMaxCap
// (kernels/wavefront_trace.py::MAX_CAP).
constexpr int kMaxCap = 32;

struct WavefrontParams {
  int max_depth;
  float bias, min_weight;
  int march;  // 1: transmittance march, 0: binary any-hit shadows
  int shadow_max_steps;
  float shadow_min_t;
  int budget;  // nodes popped per ray before the DFS stops
};

// One node of the per-ray LIFO stack.
struct Node {
  float ox, oy, oz, dx, dy, dz, w;
  int depth;
};

static __device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// The march's reduced closest-hit scan (wavefront_trace.py::_nearest_t_tau):
// the same tests, order and winner as closest_hit, without the normal, the
// triangles by the scan `tris`; returns t (kInf on a miss), the winner's
// global index gi (-1 on a miss) and its transparency, mat row 5.
template <class Tris>
static __device__ __forceinline__ float nearest_t_tau(
    const Tables& T, const Tris& tris, float ox, float oy, float oz, float dx, float dy,
    float dz, float& tau, int& gi) {
  float best = kInf;
  gi = -1;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float inv2a = 0.5f / a;
  float t;
  for (int i = 0; i < T.ns; ++i)
    if (sphere_t(T, i, a, inv2a, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = i; }
  for (int i = 0; i < T.np; ++i)
    if (plane_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = T.ns + i; }
  // The linear loop stays here: through a member function of LinearTris it
  // compiled the linear glass kernels and wavefront_grad.cu to other code
  // (the adjoint 7% slower, PERF.md §6). A scan of one ray a thread with a
  // nearest member of its own takes the other branch.
  if constexpr (std::is_same_v<Tris, LinearTris>) {
    for (int i = 0; i < T.nt; ++i)
      if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = T.ns + T.np + i; }
  } else {
    tris.nearest(T, ox, oy, oz, dx, dy, dz, best, gi);
  }
  tau = gi >= 0 ? tab(T.mat, T.mat_cols, 5, gi) : 0.0f;
  return best;
}

// The state of one shadow march: its origin, the distance traveled, T.
struct March {
  float ox, oy, oz, traveled, tr;
};

// One step of computeTransmittance (Scene.h:35-77; wavefront_trace.py::
// _march_T) along (dx, dy, dz): no hit ends the march; t <= 0 steps by
// bias; 0 < t <= bias steps past the surface without attenuating; a hit at
// or beyond max_dist ends it; else T *= clip(tau, 0, 1) and the march steps
// past the hit. Returns false where the march ended at this step. `crossed`
// is the global index of the surface whose transparency multiplied T here,
// else -1. The state updates in the TPU kernel's order (origin, traveled,
// T); the caller then tests the exits T <= min_t and traveled >= max_dist.
template <class Tris>
static __device__ __forceinline__ bool march_step(const Tables& T, const Tris& tris, March& m,
                                                  float dx, float dy, float dz, float max_dist,
                                                  float bias, int& crossed) {
  crossed = -1;
  float tau;
  int gi;
  const float t = nearest_t_tau(T, tris, m.ox, m.oy, m.oz, dx, dy, dz, tau, gi);
  if (!(t < kInf)) return false;
  float step;
  if (t <= 0.0f) {
    step = bias;
  } else if (t <= bias) {
    step = t + bias;
  } else if (m.traveled + t >= max_dist) {
    return false;
  } else {
    step = t + bias;
    m.tr *= clip01(tau);
    crossed = gi;
  }
  m.ox += dx * step;
  m.oy += dy * step;
  m.oz += dz * step;
  m.traveled += step;
  return true;
}

// The linear scan's step (the glass adjoint's replay, wavefront_grad.cu).
static __device__ __forceinline__ bool march_step(const Tables& T, March& m, float dx, float dy,
                                                  float dz, float max_dist, float bias,
                                                  int& crossed) {
  return march_step(T, LinearTris{}, m, dx, dy, dz, max_dist, bias, crossed);
}

// The march for one shadow ray -> T in [0, 1], at most max_steps steps.
template <class Tris>
static __device__ __forceinline__ float march_T(
    const Tables& T, const Tris& tris, float ox, float oy, float oz, float dx, float dy,
    float dz, float max_dist, float bias, int max_steps, float min_t) {
  if (!(max_dist > 0.0f)) return 1.0f;
  March m{ox, oy, oz, 0.0f, 1.0f};
  for (int it = 0; it < max_steps; ++it) {
    int crossed;
    if (!march_step(T, tris, m, dx, dy, dz, max_dist, bias, crossed)) break;
    if (!(m.tr > min_t && m.traveled < max_dist)) break;
  }
  return clip01(m.tr);
}

// The linear scan's march (wavefront_grad.cu).
static __device__ __forceinline__ float march_T(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz,
    float max_dist, float bias, int max_steps, float min_t) {
  return march_T(T, LinearTris{}, ox, oy, oz, dx, dy, dz, max_dist, bias, max_steps, min_t);
}

// The front-facing normal (Scene.h:145-146) and the point of a node's hit.
struct Surface {
  float nx, ny, nz, px, py, pz;
  bool front;
};

static __device__ __forceinline__ Surface surface(const Node& n, const Hit& h) {
  const bool front = h.nx * n.dx + h.ny * n.dy + h.nz * n.dz < 0.0f;
  const float flip = front ? 1.0f : -1.0f;
  return Surface{h.nx * flip, h.ny * flip, h.nz * flip, n.ox + n.dx * h.t, n.oy + n.dy * h.t,
                 n.oz + n.dz * h.t, front};
}

// The children of a shaded node (Scene.h:161-195): the reflection child,
// weighted by F on transparent hits (TIR forcing F = 1) or by the specular
// on opaque ones, and the refraction child, weighted tau * (1 - F) with F
// before TIR and biased by bias * 100; each pruned by min_weight. The
// forward kernels push them in this order (refraction pops first, as the
// reference's recursion visits it), and the adjoint's replay calls this
// same function, so that it takes the forward's branches.
struct Children {
  Node refl, refr;
  bool push_refl, push_refr;
};

static __device__ __forceinline__ Children node_children(const Tables& T, const WavefrontParams& P,
                                                         const Node& n, const Hit& h,
                                                         const Surface& s) {
  const float bias = P.bias;
  const int c = T.mat_cols;
  const float spec = tab(T.mat, c, 3, h.gi), tau = clip01(tab(T.mat, c, 5, h.gi));
  const float eta_t = tab(T.mat, c, 6, h.gi);
  const float nx = s.nx, ny = s.ny, nz = s.nz;

  // Schlick Fresnel (Scene.h:161-168)
  const float ddn = n.dx * nx + n.dy * ny + n.dz * nz;
  const float cos_theta = fmaxf(0.0f, -ddn);
  const float f0r = (eta_t - 1.0f) / (eta_t + 1.0f);
  const float f0 = f0r * f0r;
  const float omc = 1.0f - cos_theta;
  const float omc2 = omc * omc;
  const float fresnel = f0 + (1.0f - f0) * omc2 * omc2 * omc;

  // Refraction (Scene.h:175-187): d and n are unit, cosi = d.n, TIR -> 0.
  const float eta = s.front ? 1.0f / eta_t : eta_t;
  const float cosi = fminf(fmaxf(ddn, -1.0f), 1.0f);
  const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  float rfx = 0.0f, rfy = 0.0f, rfz = 0.0f;
  if (!(k < 0.0f)) {
    const float coef = eta * cosi + sqrtf(k);
    rfx = n.dx * eta - nx * coef;
    rfy = n.dy * eta - ny * coef;
    rfz = n.dz * eta - nz * coef;
  }
  const float rf2 = rfx * rfx + rfy * rfy + rfz * rfz;
  const float rflen = sqrtf(rf2);
  const bool wants_refr = tau > 0.0f;
  const bool has_refr = wants_refr && rflen > bias;
  const bool tir = wants_refr && !(rflen > bias);
  const float inv_rf = rsqrtf(fmaxf(rf2, 1e-24f));
  rfx *= inv_rf;
  rfy *= inv_rf;
  rfz *= inv_rf;
  const float refr_w = n.w * tau * (1.0f - fresnel);  // F before TIR (Scene.h:182)

  // Reflection (Scene.h:189-195)
  const float reflectiveness = tau > 0.0f ? (tir ? 1.0f : fresnel) : spec;
  float rlx = n.dx - 2.0f * ddn * nx;
  float rly = n.dy - 2.0f * ddn * ny;
  float rlz = n.dz - 2.0f * ddn * nz;
  const float inv_rl = rsqrtf(fmaxf(rlx * rlx + rly * rly + rlz * rlz, 1e-24f));
  rlx *= inv_rl;
  rly *= inv_rl;
  rlz *= inv_rl;
  const float refl_w = n.w * reflectiveness;
  const float b100 = bias * 1e2f;  // Scene.h:180
  return Children{
      Node{s.px + rlx * bias, s.py + rly * bias, s.pz + rlz * bias, rlx, rly, rlz, refl_w,
           n.depth + 1},
      Node{s.px + rfx * b100, s.py + rfy * b100, s.pz + rfz * b100, rfx, rfy, rfz, refr_w,
           n.depth + 1},
      reflectiveness > bias && refl_w >= P.min_weight,
      has_refr && refr_w >= P.min_weight};
}

// Push a child on a per-thread stack of cap nodes; a push finding the stack
// full is dropped and counted. Returns whether it was pushed.
static __device__ __forceinline__ bool push_node(Node* stack, int& sp, int cap, const Node& n,
                                                 int& dropped) {
  if (sp < cap) {
    stack[sp++] = n;
    return true;
  }
  ++dropped;
  return false;
}

// The full Whitted recursion for one ray -> HDR radiance: the DFS of
// _dfs_trace_tile over a per-thread LIFO stack of (o, d, weight, depth) in
// local memory, indexed by sp. Each pop shades one node: sky at depth >=
// max_depth or on a miss; else direct light weighted by (1 - tau), then the
// children of node_children where it can push one (the glass adjoint's
// replay, wavefront_grad.cu, calls it on every hit: where it is skipped here
// it pushes none there). A push finding the stack full is dropped and
// counted in `dropped` (cap = max_depth + 2 bounds the DFS, so it stays 0).
// `pops` counts the nodes popped, at most P.budget. The triangles of every
// scan go by `tris`, LinearTris (on culled tables trace_wavefront_warp runs
// the DFS over the warp-cooperative scan instead).
template <class Tris>
static __device__ __forceinline__ float3 trace_wavefront_ray(
    const Tables& T, Tris& tris, const WavefrontParams& P, float ox, float oy, float oz,
    float dx, float dy, float dz, int& pops, int& dropped) {
  const int cap = P.max_depth + 2;
  const float bias = P.bias;
  Node stack[kMaxCap];
  stack[0] = Node{ox, oy, oz, dx, dy, dz, 1.0f, 0};
  int sp = 1;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  while (sp > 0 && pops < P.budget) {
    const Node n = stack[--sp];
    ++pops;
    if (n.depth >= P.max_depth) {  // depth exhaustion -> sky (Scene.h:132-134)
      const float3 s = sky(n.dy);
      acc_r += n.w * s.x;
      acc_g += n.w * s.y;
      acc_b += n.w * s.z;
      continue;
    }
    const Hit h = closest_hit(T, tris, true, n.ox, n.oy, n.oz, n.dx, n.dy, n.dz);
    if (!(h.t < kInf)) {  // miss -> sky
      const float3 s = sky(n.dy);
      acc_r += n.w * s.x;
      acc_g += n.w * s.y;
      acc_b += n.w * s.z;
      continue;
    }
    const Surface srf = surface(n, h);
    const float nx = srf.nx, ny = srf.ny, nz = srf.nz, px = srf.px, py = srf.py, pz = srf.pz;
    const int c = T.mat_cols;
    const float ar = tab(T.mat, c, 0, h.gi), ag = tab(T.mat, c, 1, h.gi);
    const float ab = tab(T.mat, c, 2, h.gi), spec = tab(T.mat, c, 3, h.gi);
    const float shin = tab(T.mat, c, 4, h.gi), tau_raw = tab(T.mat, c, 5, h.gi);
    const float tau = clip01(tau_raw);

    // Direct lighting (Scene.h:79-129)
    float diff_r = 0.0f, diff_g = 0.0f, diff_b = 0.0f;
    float spec_r = 0.0f, spec_g = 0.0f, spec_b = 0.0f;
    const float sox = px + nx * bias, soy = py + ny * bias, soz = pz + nz * bias;
    const bool spec_on = tau_raw <= 0.0f && spec > 0.0f;  // Scene.h:115
    for (int li = 0; li < T.nl; ++li) {
      const int lc = T.light_cols;
      if (!(tab(T.light, lc, 6, li) > 0.0f)) continue;
      const float lx = tab(T.light, lc, 0, li), ly = tab(T.light, lc, 1, li);
      const float lz = tab(T.light, lc, 2, li);
      const float er = tab(T.light, lc, 3, li), eg = tab(T.light, lc, 4, li);
      const float eb = tab(T.light, lc, 5, li);
      const float vx = lx - px, vy = ly - py, vz = lz - pz;
      const float dist = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-30f));
      const float inv_d = 1.0f / dist;
      const float ldx = vx * inv_d, ldy = vy * inv_d, ldz = vz * inv_d;
      const float ndotl = fmaxf(0.0f, nx * ldx + ny * ldy + nz * ldz);
      if (!(dist > bias && ndotl > 0.0f)) continue;
      float tr;
      if (P.march) {
        tr = march_T(T, tris, sox, soy, soz, ldx, ldy, ldz, dist - bias, bias,
                     P.shadow_max_steps, P.shadow_min_t);
      } else {
        tr = any_hit(T, tris, true, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias) ? 0.0f
                                                                                      : 1.0f;
      }
      if (!(tr > bias)) continue;
      const float inv_d2 = inv_d * inv_d;
      const float contrib = inv_d2 * ndotl * tr;
      diff_r += er * contrib;
      diff_g += eg * contrib;
      diff_b += eb * contrib;
      const float hx = ldx - n.dx, hy = ldy - n.dy, hz = ldz - n.dz;
      const float invh = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-24f));
      const float ndoth = fmaxf(0.0f, (nx * hx + ny * hy + nz * hz) * invh);
      if (spec_on && ndoth > 0.0f) {
        const float sf = expf(shin * logf(ndoth)) * inv_d2 * tr;
        spec_r += er * sf;
        spec_g += eg * sf;
        spec_b += eb * sf;
      }
    }
    const float wl = n.w * (1.0f - tau);  // Scene.h:171-173
    acc_r += wl * (ar * diff_r + spec_r * spec);
    acc_g += wl * (ag * diff_g + spec_g * spec);
    acc_b += wl * (ab * diff_b + spec_b * spec);

    // node_children pushes a child only off a transparent hit (refraction,
    // Fresnel reflection) or a specular one (spec > bias): an opaque diffuse
    // hit, the floor's and most of a frame's, skips it.
    if (tau > 0.0f || spec > bias) {
      const Children ch = node_children(T, P, n, h, srf);
      if (ch.push_refl) push_node(stack, sp, cap, ch.refl, dropped);
      if (ch.push_refr) push_node(stack, sp, cap, ch.refr, dropped);
    }
  }
  return make_float3(acc_r, acc_g, acc_b);
}

// ---------------------------------------------------------------------------
// The DFS over the warp-cooperative scan (the glass kernels on culled tables)
// ---------------------------------------------------------------------------
// trace_wavefront_ray, march_T, march_step and nearest_t_tau again, each
// ray's arithmetic the same and in the same order, so the frame and the
// pops are theirs bit for bit; the loops that reach a scan run on every
// lane of the warp until no lane needs them (WarpCulledTris::any), and a
// lane with nothing to scan passes its scans inactive. (The functions above
// keep their own text: the linear kernels and the glass adjoint compile to
// the code they had.)

// nearest_t_tau on culled tables, on every lane of the warp: a lane with
// `active` false scans nothing and returns a miss.
static __device__ __forceinline__ float nearest_t_tau_warp(
    const Tables& T, const WarpCulledTris& tris, bool active, float ox, float oy, float oz,
    float dx, float dy, float dz, float& tau, int& gi) {
  float best = kInf;
  gi = -1;
  if (active) {
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float inv2a = 0.5f / a;
    float t;
    for (int i = 0; i < T.ns; ++i)
      if (sphere_t(T, i, a, inv2a, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = i; }
    for (int i = 0; i < T.np; ++i)
      if (plane_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = T.ns + i; }
  }
  tris.nearest(T, active, ox, oy, oz, dx, dy, dz, best, gi);
  tau = gi >= 0 ? tab(T.mat, T.mat_cols, 5, gi) : 0.0f;
  return best;
}

// march_step on culled tables, on every lane of the warp; a lane with
// `active` false keeps its state and returns false.
static __device__ __forceinline__ bool march_step_warp(const Tables& T, const WarpCulledTris& tris,
                                                       bool active, March& m, float dx, float dy,
                                                       float dz, float max_dist, float bias) {
  float tau;
  int gi;
  const float t = nearest_t_tau_warp(T, tris, active, m.ox, m.oy, m.oz, dx, dy, dz, tau, gi);
  if (!active || !(t < kInf)) return false;
  float step;
  if (t <= 0.0f) {
    step = bias;
  } else if (t <= bias) {
    step = t + bias;
  } else if (m.traveled + t >= max_dist) {
    return false;
  } else {
    step = t + bias;
    m.tr *= clip01(tau);
  }
  m.ox += dx * step;
  m.oy += dy * step;
  m.oz += dz * step;
  m.traveled += step;
  return true;
}

// march_T on culled tables: the warp steps while any of its lanes marches
// (at most max_steps steps); a lane with `active` false marches nothing.
static __device__ __forceinline__ float march_T_warp(
    const Tables& T, const WarpCulledTris& tris, bool active, float ox, float oy, float oz,
    float dx, float dy, float dz, float max_dist, float bias, int max_steps, float min_t) {
  bool marching = active && max_dist > 0.0f;
  March m{ox, oy, oz, 0.0f, 1.0f};
  for (int it = 0; it < max_steps && tris.any(marching); ++it) {
    marching = march_step_warp(T, tris, marching, m, dx, dy, dz, max_dist, bias) &&
               m.tr > min_t && m.traveled < max_dist;
  }
  return clip01(m.tr);
}

// trace_wavefront_ray on culled tables, on every lane of the warp. The DFS
// runs while any lane has a node to pop within its budget, and the light
// loop over every light; a lane whose node is done (none to pop, sky at
// depth exhaustion, or a miss) passes the scans inactive. `valid` is false
// for a lane with no ray (past the last ray of a launch): it pops nothing.
static __device__ __forceinline__ float3 trace_wavefront_warp(
    const Tables& T, const WavefrontParams& P, bool valid, float ox, float oy, float oz,
    float dx, float dy, float dz, int& pops, int& dropped) {
  WarpCulledTris tris = WarpCulledTris::make();
  const int cap = P.max_depth + 2;
  const float bias = P.bias;
  Node stack[kMaxCap];
  stack[0] = Node{ox, oy, oz, dx, dy, dz, 1.0f, 0};
  int sp = valid ? 1 : 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (;;) {
    const bool popping = sp > 0 && pops < P.budget;
    if (!tris.any(popping)) break;
    const Node n = stack[max(sp - 1, 0)];
    bool to_sky = false;  // depth exhaustion (Scene.h:132-134), or a miss
    if (popping) {
      --sp;
      ++pops;
      to_sky = n.depth >= P.max_depth;
    }
    bool live = popping && !to_sky;
    const Hit h = closest_hit(T, tris, live, n.ox, n.oy, n.oz, n.dx, n.dy, n.dz);
    if (live && !(h.t < kInf)) {
      to_sky = true;
      live = false;
    }
    if (to_sky) {  // one sky term a node, as trace_wavefront_ray adds it
      const float3 s = sky(n.dy);
      acc_r += n.w * s.x;
      acc_g += n.w * s.y;
      acc_b += n.w * s.z;
    }
    const Surface srf = surface(n, h);
    const float nx = srf.nx, ny = srf.ny, nz = srf.nz, px = srf.px, py = srf.py, pz = srf.pz;
    const int c = T.mat_cols;
    const float ar = tab(T.mat, c, 0, h.gi), ag = tab(T.mat, c, 1, h.gi);
    const float ab = tab(T.mat, c, 2, h.gi), spec = tab(T.mat, c, 3, h.gi);
    const float shin = tab(T.mat, c, 4, h.gi), tau_raw = tab(T.mat, c, 5, h.gi);
    const float tau = clip01(tau_raw);

    // Direct lighting (Scene.h:79-129)
    float diff_r = 0.0f, diff_g = 0.0f, diff_b = 0.0f;
    float spec_r = 0.0f, spec_g = 0.0f, spec_b = 0.0f;
    const float sox = px + nx * bias, soy = py + ny * bias, soz = pz + nz * bias;
    const bool spec_on = tau_raw <= 0.0f && spec > 0.0f;  // Scene.h:115
    for (int li = 0; li < T.nl; ++li) {
      const int lc = T.light_cols;
      if (!(tab(T.light, lc, 6, li) > 0.0f)) continue;  // the same on every lane
      const float lx = tab(T.light, lc, 0, li), ly = tab(T.light, lc, 1, li);
      const float lz = tab(T.light, lc, 2, li);
      const float er = tab(T.light, lc, 3, li), eg = tab(T.light, lc, 4, li);
      const float eb = tab(T.light, lc, 5, li);
      const float vx = lx - px, vy = ly - py, vz = lz - pz;
      const float dist = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-30f));
      const float inv_d = 1.0f / dist;
      const float ldx = vx * inv_d, ldy = vy * inv_d, ldz = vz * inv_d;
      const float ndotl = fmaxf(0.0f, nx * ldx + ny * ldy + nz * ldz);
      const bool ok = live && dist > bias && ndotl > 0.0f;
      if (!tris.any(ok)) continue;
      float tr;
      if (P.march) {
        tr = march_T_warp(T, tris, ok, sox, soy, soz, ldx, ldy, ldz, dist - bias, bias,
                          P.shadow_max_steps, P.shadow_min_t);
      } else {
        tr = any_hit(T, tris, ok, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias) ? 0.0f : 1.0f;
      }
      if (!(ok && tr > bias)) continue;
      const float inv_d2 = inv_d * inv_d;
      const float contrib = inv_d2 * ndotl * tr;
      diff_r += er * contrib;
      diff_g += eg * contrib;
      diff_b += eb * contrib;
      const float hx = ldx - n.dx, hy = ldy - n.dy, hz = ldz - n.dz;
      const float invh = rsqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-24f));
      const float ndoth = fmaxf(0.0f, (nx * hx + ny * hy + nz * hz) * invh);
      if (spec_on && ndoth > 0.0f) {
        const float sf = expf(shin * logf(ndoth)) * inv_d2 * tr;
        spec_r += er * sf;
        spec_g += eg * sf;
        spec_b += eb * sf;
      }
    }
    if (!live) continue;
    const float wl = n.w * (1.0f - tau);  // Scene.h:171-173
    acc_r += wl * (ar * diff_r + spec_r * spec);
    acc_g += wl * (ag * diff_g + spec_g * spec);
    acc_b += wl * (ab * diff_b + spec_b * spec);

    // node_children pushes a child only off a transparent hit (refraction,
    // Fresnel reflection) or a specular one (spec > bias).
    if (tau > 0.0f || spec > bias) {
      const Children ch = node_children(T, P, n, h, srf);
      if (ch.push_refl) push_node(stack, sp, cap, ch.refl, dropped);
      if (ch.push_refr) push_node(stack, sp, cap, ch.refr, dropped);
    }
  }
  return make_float3(acc_r, acc_g, acc_b);
}

// ---------------------------------------------------------------------------
// Jitter of the in-kernel AA loops
// ---------------------------------------------------------------------------

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., SC'11) keyed by (seed, 0) on the counter
// (pixel id, sample, 0, 0); returns the first two output words.
static __device__ __forceinline__ uint2 philox_xy(uint32_t seed, uint32_t pid, uint32_t sample) {
  uint32_t c0 = pid, c1 = sample, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint2(c0, c1);
}

// uint32 -> [0, 1): the top 23 bits under exponent 0x3F8 give [1, 2), minus 1.
static __device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// The camera ray of sample s of pixel (x, y) (Math.h:100-120), as the TPU
// kernels build it: sx = x - w/2 + jx, sy = h/2 - y + jy, dir =
// normalize((sx - cx, sy - cy, focal)); sample 0 is unjittered
// (Scene.h:289-296), samples 1.. draw (jx, jy) from philox_xy.
static __device__ __forceinline__ float3 camera_dir(
    const float* cam, int x, int y, int width, int height, uint32_t seed, int s) {
  const float sx0 = static_cast<float>(x) - 0.5f * static_cast<float>(width);
  const float sy0 = 0.5f * static_cast<float>(height) - static_cast<float>(y);
  float jx = 0.0f, jy = 0.0f;
  if (s > 0) {
    const uint32_t pid = static_cast<uint32_t>(y) * static_cast<uint32_t>(width) +
                         static_cast<uint32_t>(x);
    const uint2 bits = philox_xy(seed, pid, static_cast<uint32_t>(s));
    jx = uniform01(bits.x);
    jy = uniform01(bits.y);
  }
  const float ddx = (sx0 + jx) - cam[0];
  const float ddy = (sy0 + jy) - cam[1];
  const float ddz = cam[3];
  const float inv = rsqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
  return make_float3(ddx * inv, ddy * inv, ddz * inv);
}

// The ray of this thread of a chain kernel's 128-thread CTAs: thread t of
// CTA c takes ray 128 c + t; -1 past the last ray.
static __device__ __forceinline__ long long ray_of_thread(long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kCtaThreads + threadIdx.x;
  return i < n ? i : -1;
}

// CTAs of a chain kernel's launch over n rays, `packet` rays a thread.
inline unsigned ray_ctas(long long n, int packet = 1) {
  const long long per_cta = static_cast<long long>(kCtaThreads) * packet;
  return static_cast<unsigned>((n + per_cta - 1) / per_cta);
}

inline Tables make_tables(const float* sph, int sph_cols, int ns, const float* pl,
                          int pl_cols, int np, const float* tri, int tri_cols, int nt,
                          const float* mat, int mat_cols, const float* light,
                          int light_cols, int nl) {
  return Tables{sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt,
                mat, mat_cols, light, light_cols, nl};
}

// Can the culled scan stage these tables' tri rows with 16-byte copies?
inline bool stageable(const Tables& T) {
  return (reinterpret_cast<uintptr_t>(T.tri) % 16 == 0) && (T.tri_cols % 4 == 0);
}

// The tables with their culling boxes (null and 0: a linear scan).
inline Tables with_culling(Tables T, const float* taabb, int n_blocks) {
  T.taabb = taabb;
  T.n_blocks = taabb ? n_blocks : 0;
  return T;
}

// The scan chain_trace.cu and spp_trace.cu take for these tables, the one
// place that decides it: culled tables the CTA-cooperative scan, linear
// tables the staged scan where their stage fits kStageMaxBytes, else the
// in-place one. The entry points report it to their wrappers, which name
// and count it (kernels/chain_trace.py::ROUTES holds the names in this
// order).
enum Route { kInPlace = 0, kCulled = 1, kStaged = 2 };

inline int stage_bytes(const Tables& T) { return 16 * stage_layout(T).n; }

inline Route trace_route(const Tables& T) {
  if (T.taabb) return kCulled;
  return stage_bytes(T) <= kStageMaxBytes ? kStaged : kInPlace;
}

// Shared memory one block may hold (the H100's 227 KB).
constexpr int kBlockSmemMaxBytes = 232448;

// The scan of the head-box adjoint's shadow rays (chain_grad.cu), the one
// place that decides it: the staged tables where trace_route stages them
// and the stage and the block's table-cotangent accumulator (acc_bytes) fit
// one block's shared memory together, else the tables in place. The entry
// point reports it to its wrapper, which names and counts it
// (kernels/chain_grad.py).
inline Route grad_route(const Tables& T, int acc_bytes) {
  return trace_route(T) == kStaged && stage_bytes(T) + acc_bytes <= kBlockSmemMaxBytes ? kStaged
                                                                                       : kInPlace;
}

}  // namespace rte
