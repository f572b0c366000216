// Pieces shared by the hand-derived adjoint kernels (chain_grad.cu,
// wavefront_grad.cu): 3-vector arithmetic, the NaN-free guards and tie
// subgradients of the JAX package's autodiff, the pullbacks of a closest
// hit's (t, n) onto the winning primitive, the warp-summed table-cotangent
// adds, and the fixed-order reduction of the per-block partial sums.
//
// Table cotangents: every table entry has one float of a block-wide
// accumulator in shared memory, laid out as `Offsets` says (the tables in
// order, row-major). Each block writes its accumulator as one partial,
// [entry][block]; `reduce_partials` sums each entry's partials in a fixed
// order, so a run differs from the next only by the order of the
// shared-memory atomics of a block's warps.
#pragma once

#include "trace_common.cuh"

namespace {

using rte::kEps;
using rte::kInf;
using rte::tab;
using rte::Tables;

struct Offsets {  // of each table in the flat accumulator (row-major tables)
  int sph, pl, tri, mat, light, total;
};

inline Offsets make_offsets(int sph_cols, int pl_cols, int tri_cols, int mat_cols, int light_cols) {
  Offsets off;
  off.sph = 0;
  off.pl = off.sph + 4 * sph_cols;
  off.tri = off.pl + 4 * pl_cols;
  off.mat = off.tri + 12 * tri_cols;
  off.light = off.mat + 7 * mat_cols;
  off.total = off.light + 7 * light_cols;
  return off;
}

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3& operator+=(V3& a, V3 b) { a = a + b; return a; }
__device__ __forceinline__ V3& operator-=(V3& a, V3 b) { a = a - b; return a; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct Ray {  // the saved state of one bounce (live is implied)
  V3 o, d;
  float w;
};
struct RayCot {
  V3 o, d;
  float w;
};

// where(x > floor, rsqrt(x), 0): the JAX bounce's NaN-free guard.
__device__ __forceinline__ float rsqrt_where(float x, float floor) {
  return x > floor ? rsqrtf(x) : 0.0f;
}

// d clip(x, 0, 1) / dx with jnp.clip's subgradient: 0.5 at either bound.
__device__ __forceinline__ float clip01_grad(float x) {
  if (x > 0.0f && x < 1.0f) return 1.0f;
  return (x == 0.0f || x == 1.0f) ? 0.5f : 0.0f;
}

__device__ __forceinline__ V3 tab3(const float* t, int cols, int row, int i) {
  return {tab(t, cols, row, i), tab(t, cols, row + 1, i), tab(t, cols, row + 2, i)};
}

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {  // all 32 lanes converged
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFullWarp, v, s);
  return v;
}

// Add `n` (<= 12) cotangent values v[r] to acc[base + r * cols]: the entries of
// one table column. `mine` says whether this lane has values. Called by all 32
// lanes of the warp at once. If every lane with values adds to the same column
// (neighbouring pixels mostly hit the same primitive and see the same light),
// the warp sums each value with shuffles and its first such lane adds the sum;
// otherwise each lane adds its own values with shared-memory atomics.
template <int kMax>
__device__ __forceinline__ void add_column(float* acc, bool mine, int base, int cols, int n,
                                           const float (&v)[kMax]) {
  const unsigned who = __ballot_sync(kFullWarp, mine);
  if (who == 0u) return;
  const int lead = __ffs(who) - 1;
  const int base0 = __shfl_sync(kFullWarp, base, lead);
  if (__all_sync(kFullWarp, !mine || base == base0)) {
    const int n0 = __shfl_sync(kFullWarp, n, lead);
    const int cols0 = __shfl_sync(kFullWarp, cols, lead);
#pragma unroll
    for (int r = 0; r < kMax; ++r) {
      if (r < n0) {  // warp-uniform
        const float sum = warp_sum(mine ? v[r] : 0.0f);
        if ((threadIdx.x & 31) == lead) atomicAdd(acc + base0 + r * cols0, sum);
      }
    }
  } else if (mine) {
#pragma unroll
    for (int r = 0; r < kMax; ++r)
      if (r < n) atomicAdd(acc + base + r * cols, v[r]);
  }
}

// The closest hit with the JAX bounce's sphere-normal guard; returns the
// unflipped geometric normal in n. t >= kInf is a miss.
__device__ __forceinline__ rte::Hit closest(const Tables& T, const Ray& r, V3& n) {
  rte::Hit h = rte::closest_hit(T, r.o.x, r.o.y, r.o.z, r.d.x, r.d.y, r.d.z);
  n = {h.nx, h.ny, h.nz};
  if (h.t < kInf && h.gi < T.ns) {
    const V3 g = r.o + r.d * h.t - tab3(T.sph, T.sph_cols, 0, h.gi);
    n = g * rsqrt_where(dot(g, g), 1e-16f);
  }
  return h;
}

// Adjoint of the sky term w * sky(d.y) (a miss, or depth exhaustion).
__device__ __forceinline__ void sky_adjoint(const Ray& r, RayCot& c, float gr, float gg, float gb) {
  const float ts = 0.5f * (r.d.y + 1.0f);
  c.w += gr * (1.0f - 0.5f * ts) + gg * (1.0f - 0.3f * ts) + gb;
  c.d.y += r.w * (-0.25f * gr - 0.15f * gg);
}

// Pullback of the winner's (t, n) cotangents onto the ray (into c) and onto
// its table column (into pc, by row).
__device__ __forceinline__ void sphere_pullback(const Tables& T, int i, const Ray& r, float t,
                                                float tb, V3 nb, RayCot& c, float (&pc)[12]) {
  const V3 ctr = tab3(T.sph, T.sph_cols, 0, i);
  const float r2 = tab(T.sph, T.sph_cols, 3, i);
  const V3 oc = r.o - ctr;
  const float a = rte::dot3(r.d.x, r.d.y, r.d.z, r.d.x, r.d.y, r.d.z);
  float b, cc;  // rounded as closest_hit rounds them (rte::sphere_disc)
  const float disc = rte::sphere_disc(a, oc.x, oc.y, oc.z, r.d.x, r.d.y, r.d.z, r2, b, cc);
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float inv2a = 0.5f / a;
  const float sgn = ((-b - sq) * inv2a >= kEps) ? -1.0f : 1.0f;  // near or far root
  // n = g / |g|, g = o + d t - c
  const V3 g = r.o + r.d * t - ctr;
  const float inv = rsqrt_where(dot(g, g), 1e-16f);
  const V3 n = g * inv;
  const V3 gbar = (nb - n * dot(n, nb)) * inv;
  c.o += gbar;
  c.d += gbar * t;
  tb += dot(gbar, r.d);
  // t = (-b + sgn sq) * inv2a
  float bb = -tb * inv2a;
  const float sqb = sgn * tb * inv2a;
  const float inv2ab = tb * (-b + sgn * sq);
  float ab = -inv2ab * inv2a / a;
  // sq = sqrt(max(disc, 0)), derivative clamped as vecmath.sqrt_grad_safe;
  // max's tie at disc = 0 halves it, as jnp.maximum does.
  const float discb =
      sqb * 0.5f * rsqrtf(fmaxf(disc, 1e-12f)) * (disc > 0.0f ? 1.0f : 0.5f);
  bb += 2.0f * b * discb;
  ab += -4.0f * cc * discb;
  const float ccb = -4.0f * a * discb;
  const V3 ocb = oc * (2.0f * ccb) + r.d * (2.0f * bb);
  c.d += oc * (2.0f * bb) + r.d * (2.0f * ab);
  c.o += ocb;
  const V3 cb = V3{0.0f, 0.0f, 0.0f} - gbar - ocb;
  pc[0] = cb.x; pc[1] = cb.y; pc[2] = cb.z; pc[3] = -ccb;
}

__device__ __forceinline__ void plane_pullback(const Tables& T, int i, const Ray& r, float t,
                                               float tb, V3 nb, RayCot& c, float (&pc)[12]) {
  const V3 N = tab3(T.pl, T.pl_cols, 0, i);
  const float denom = dot(r.d, N);  // |denom| > eps for a hit
  // t = (pn - o.N) / denom
  const float pnb = tb / denom;
  const float denomb = -tb * t / denom;
  c.o -= N * pnb;
  c.d += N * denomb;
  const V3 Nb = nb - r.o * pnb + r.d * denomb;
  pc[0] = Nb.x; pc[1] = Nb.y; pc[2] = Nb.z; pc[3] = pnb;
}

__device__ __forceinline__ void tri_pullback(const Tables& T, int i, const Ray& r, float tb,
                                             V3 nb, RayCot& c, float (&pc)[12]) {
  const int cols = T.tri_cols;
  const V3 v0 = tab3(T.tri, cols, 0, i), e1 = tab3(T.tri, cols, 3, i);
  const V3 e2 = tab3(T.tri, cols, 6, i);
  // t = f k, f = 1 / (e1 . (d x e2)), k = e2 . ((o - v0) x e1)
  const V3 h = cross(r.d, e2);
  const float f = 1.0f / dot(e1, h);
  const V3 s = r.o - v0;
  const V3 q = cross(s, e1);
  const float k = dot(e2, q);
  const float fb = tb * k, kb = tb * f;
  const V3 qb = e2 * kb;
  const V3 sb = cross(e1, qb);
  const float ab = -fb * f * f;
  const V3 e1b = cross(qb, s) + h * ab;
  const V3 hb = e1 * ab;
  const V3 e2b = q * kb + cross(hb, r.d);
  c.d += cross(e2, hb);
  c.o += sb;
  // rows: v0, e1, e2, and the unit normal, which is its own table row
  pc[0] = -sb.x; pc[1] = -sb.y; pc[2] = -sb.z;
  pc[3] = e1b.x; pc[4] = e1b.y; pc[5] = e1b.z;
  pc[6] = e2b.x; pc[7] = e2b.y; pc[8] = e2b.z;
  pc[9] = nb.x; pc[10] = nb.y; pc[11] = nb.z;
}

// out[j] = sum over blocks of partials[j][block], in a fixed order: one block
// per entry, a strided sum per thread, then a tree in shared memory.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads) partials_reduce_kernel(
    const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  __shared__ float buf[kReduceThreads];
  const float* row = partials + (long long)blockIdx.x * n_blocks;
  float s = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kReduceThreads) s += row[b];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

inline int reduce_partials(const float* partials, int total, int n_blocks, float* out,
                           cudaStream_t stream) {
  if (total <= 0) return 0;
  partials_reduce_kernel<<<total, kReduceThreads, 0, stream>>>(partials, n_blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
