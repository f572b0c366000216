// Pieces shared by the hand-derived adjoint kernels (chain_grad.cu,
// chain_grad_dense.cu, wavefront_grad.cu): 3-vector arithmetic, the NaN-free
// guards and tie subgradients of the JAX package's autodiff, the pullbacks of
// a closest hit's (t, n) onto the winning primitive, the warp-summed
// table-cotangent adds, the fixed-order reduction of the per-block partial
// sums, and the chain adjoint's per-ray body: `chain_adjoint_ray`
// (chain_grad_dense.cu: its own checkpoint, then the reverse pass) and its
// reverse pass `reverse_bounces` (shared with chain_grad.cu, which reads the
// forward's tape), each kernel with its own sink for the table cotangents.
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
using rte::kStateRows;
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

// The power of two at or above k (k <= 16): the values a transposing warp
// sum (add_column) carries.
__host__ __device__ constexpr int pow2_at_least(int k) {
  return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
}
__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

// Add `n` (<= 12) cotangent values v[r] to acc[base + r * cols]: the entries of
// one table column. `mine` says whether this lane has values. Called by all 32
// lanes of the warp at once. If every lane with values adds to the same column
// (neighbouring pixels mostly hit the same primitive and see the same light),
// the warp sums the values together with a transposing butterfly: at each of
// the first log2(P) steps (P = kMax rounded up to a power of two), a lane
// hands half of its values to its partner and keeps the sums of the other
// half, so P - 1 shuffles leave each lane one value, and the remaining
// 5 - log2(P) steps sum that one (P - 1 + 5 - log2(P) shuffles in all,
// where one warp sum per value took 5 P). Lane l then holds the sum of value
// (l >> (5 - log2 P)) mod P, and the first lane of each group of 2^(5 -
// log2 P) adds it: up to P atomics from different lanes at once. Otherwise
// each lane adds its own values with atomics.
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
    constexpr int P = pow2_at_least(kMax), kSteps = log2_of(P);
    float a[P];
#pragma unroll
    for (int r = 0; r < P; ++r) a[r] = (mine && r < kMax) ? v[r] : 0.0f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int m = 16 >> s, half = P >> (s + 1);
      const bool up = (threadIdx.x & m) != 0;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float give = up ? a[j] : a[j + half];
        const float keep = up ? a[j + half] : a[j];
        a[j] = keep + __shfl_xor_sync(kFullWarp, give, m);
      }
    }
#pragma unroll
    for (int m = 16 >> kSteps; m > 0; m >>= 1) a[0] += __shfl_xor_sync(kFullWarp, a[0], m);
    const int lane = threadIdx.x & 31;
    const int r = (lane >> (5 - kSteps)) & (P - 1);
    if ((lane & ((1 << (5 - kSteps)) - 1)) == 0 && r < n0) atomicAdd(acc + base0 + r * cols0, a[0]);
  } else if (mine) {
#pragma unroll
    for (int r = 0; r < kMax; ++r)
      if (r < n) atomicAdd(acc + base + r * cols, v[r]);
  }
}

// A bounce's closest hit as the checkpoint saves it: t (kInf on a miss), the
// winner's global index and its tri table column.
struct Winner {
  float t;
  int gi, tc;
};

// The unflipped geometric normal of a saved winner, as the closest-hit scan
// gave it, with the JAX bounce's sphere-normal guard; 0 on a miss.
__device__ __forceinline__ V3 winner_normal(const Tables& T, const Ray& r, const Winner& w) {
  if (!(w.t < kInf)) return V3{0.0f, 0.0f, 0.0f};
  if (w.gi < T.ns) {
    const V3 g = r.o + r.d * w.t - tab3(T.sph, T.sph_cols, 0, w.gi);
    return g * rsqrt_where(dot(g, g), 1e-16f);
  }
  if (w.gi < T.ns + T.np) return tab3(T.pl, T.pl_cols, 0, w.gi - T.ns);
  return tab3(T.tri, T.tri_cols, 9, w.tc);
}

// The closest hit by the linear scan, with the unflipped normal of
// winner_normal in n (the glass adjoint's replays).
__device__ __forceinline__ rte::Hit closest(const Tables& T, const Ray& r, V3& n) {
  const rte::Hit h = rte::closest_hit(T, r.o.x, r.o.y, r.o.z, r.d.x, r.d.y, r.d.z);
  n = winner_normal(T, r, Winner{h.t, h.gi, h.tc});
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

// A triangle hit at the forward's t, pulled back as the plane through v0 with
// normal N = e1 x e2 met at p = o + d t: with s = o - v0 and the
// Moller-Trumbore factor f = 1 / (e1 . (d x e2)),
//   dt = f [N . (ds + t dd) + dN . (p - v0)].
// The expanded adjoint of t = f (e2 . (s x e1)) is the same in exact
// arithmetic but finds p - v0 as a difference of two terms ~|s| / |p - v0|
// times larger, through its own f and that product; on a grazing ray both
// are cancellations, so FMA contraction here (none in PyTorch) moved the e1
// and e2 rows by 2% at 50,800 triangles. Here p - v0 takes the forward's t,
// which the plain version (kernels/chain_grad.py::_tri_t_plane) shares.
__device__ __forceinline__ void tri_pullback(const Tables& T, int i, const Ray& r, float t,
                                             float tb, V3 nb, RayCot& c, float (&pc)[12]) {
  const int cols = T.tri_cols;
  const V3 v0 = tab3(T.tri, cols, 0, i), e1 = tab3(T.tri, cols, 3, i);
  const V3 e2 = tab3(T.tri, cols, 6, i);
  const float f = 1.0f / dot(e1, cross(r.d, e2));
  const float ft = tb * f;
  const V3 sb = cross(e1, e2) * ft;          // dt/ds = f N
  const V3 Nb = ((r.o - v0) + r.d * t) * ft;  // dt/dN = f (p - v0)
  const V3 e1b = cross(e2, Nb), e2b = cross(Nb, e1);
  c.o += sb;
  c.d += sb * t;
  // rows: v0, e1, e2, and the unit normal, which is its own table row
  pc[0] = -sb.x; pc[1] = -sb.y; pc[2] = -sb.z;
  pc[3] = e1b.x; pc[4] = e1b.y; pc[5] = e1b.z;
  pc[6] = e2b.x; pc[7] = e2b.y; pc[8] = e2b.z;
  pc[9] = nb.x; pc[10] = nb.y; pc[11] = nb.z;
}

// ---------------------------------------------------------------------------
// The chain adjoint, per ray (chain_grad.cu, chain_grad_dense.cu)
// ---------------------------------------------------------------------------

constexpr int kChainThreads = rte::kCtaThreads;  // block size of both chain adjoint kernels

// State-only bounce (the JAX package's `_make_state_bounce`): the closest hit
// by the scan `tris`, saved into w, and the reflection update. Returns
// whether the ray continues. Every thread of the CTA calls it; `live` says
// whether its ray bounces here.
template <class Tris>
__device__ __forceinline__ bool state_bounce(const Tables& T, Tris& tris, bool live, Ray& r,
                                             float bias, float min_weight, Winner& w) {
  const rte::Hit h = rte::closest_hit(T, tris, live, r.o.x, r.o.y, r.o.z, r.d.x, r.d.y, r.d.z);
  w = Winner{h.t, h.gi, h.tc};
  if (!(live && h.t < kInf)) return false;
  const float spec = tab(T.mat, T.mat_cols, 3, h.gi);
  if (!(spec > bias && r.w * spec >= min_weight)) return false;
  const V3 n = winner_normal(T, r, w);
  const V3 nf = n * (dot(n, r.d) < 0.0f ? 1.0f : -1.0f);
  const V3 p = r.o + r.d * h.t;
  const V3 rf = r.d - nf * (2.0f * dot(r.d, nf));
  const V3 rn = rf * rsqrt_where(dot(rf, rf), 1e-16f);
  r.o = p + rn * bias;
  r.d = rn;
  r.w *= spec;
  return true;
}

// Adjoint of one full bounce from the saved state r and its saved winner h
// (no closest-hit scan: the checkpoint's is the forward's). On entry c is
// the cotangent of the bounce's new state; on exit that of r. g is the rgb
// cotangent (the same at every bounce: the radiance is a sum of bounces).
// Every thread of the CTA calls it together (the culled shadow scans hold
// barriers, and the table cotangents are summed across each warp); `act` is
// false for a lane whose ray has no bounce here.
// The table cotangents go to `sink`: sink.light(lit, li, cols, v[6]) for
// each light's position and emission, and sink.hit(T, hit, gi, tc, m[6],
// p[12]) for the winner's material rows (albedo rgb, specular, shininess,
// transparency) and its primitive rows (4 of a sphere or plane column, 12
// of a triangle's, at tri table column tc).
template <class Sink, class Tris>
__device__ __forceinline__ void bounce_adjoint(const Tables& T, Sink& sink, Tris& tris, bool act,
                                               const Ray& r, const Winner& h, RayCot& c,
                                               float gr, float gg, float gb, float bias,
                                               float min_weight) {
  const bool hit = act && h.t < kInf;
  const V3 n = hit ? winner_normal(T, r, h) : V3{0.0f, 0.0f, 0.0f};
  if (act && !hit) sky_adjoint(r, c, gr, gg, gb);  // miss: rgb = w sky(d)

  const int gi = h.gi, mc = T.mat_cols;
  const float ar = tab(T.mat, mc, 0, gi), ag = tab(T.mat, mc, 1, gi), ab = tab(T.mat, mc, 2, gi);
  const float spec = tab(T.mat, mc, 3, gi), shin = tab(T.mat, mc, 4, gi);
  const float tau_raw = tab(T.mat, mc, 5, gi);
  const float omt = 1.0f - fminf(fmaxf(tau_raw, 0.0f), 1.0f);
  const float flip = dot(n, r.d) < 0.0f ? 1.0f : -1.0f;
  const V3 nf = n * flip;
  const V3 p = r.o + r.d * h.t;

  V3 pb{0.0f, 0.0f, 0.0f}, nfb{0.0f, 0.0f, 0.0f};
  float specb = 0.0f, shinb = 0.0f;
  RayCot old = c;  // a chain that ends here passes its state through
  if (hit && spec > bias && r.w * spec >= min_weight) {
    // Reflection: new o = p + rn bias, new d = rn, new w = w spec.
    const float ddn = dot(r.d, nf);
    const V3 rf = r.d - nf * (2.0f * ddn);
    const float invr = rsqrt_where(dot(rf, rf), 1e-16f);
    const V3 rn = rf * invr;
    pb += c.o;
    const V3 rnb = c.o * bias + c.d;
    const V3 rfb = (rnb - rn * dot(rn, rnb)) * invr;
    const float ddnb = -2.0f * dot(nf, rfb);
    old = RayCot{{0.0f, 0.0f, 0.0f}, rfb + nf * ddnb, c.w * spec};
    specb += c.w * r.w;
    nfb += rfb * (-2.0f * ddn) + r.d * ddnb;
  }

  // Direct light, binary shadows, with its adjoint light by light. The rgb
  // cotangent of each light's diffuse and specular sums is known up front.
  const float wo = r.w * omt;
  const float Gr = gr * wo, Gg = gg * wo, Gb = gb * wo;
  const V3 difb{Gr * ar, Gg * ag, Gb * ab};
  const V3 Sb{Gr * spec, Gg * spec, Gb * spec};
  V3 dif{0.0f, 0.0f, 0.0f}, S{0.0f, 0.0f, 0.0f};
  const V3 so = p + nf * bias;
  const int lc = T.light_cols;
  for (int li = 0; li < T.nl; ++li) {  // the same trip count on every lane
    float lcot[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // position, emission
    bool lit = false;
    const V3 L = tab3(T.light, lc, 0, li), E = tab3(T.light, lc, 3, li);
    const V3 v = L - p;
    const float dist2 = dot(v, v);
    const bool d_ok = dist2 > 1e-20f;
    const float dist = sqrtf(d_ok ? dist2 : 1.0f);
    const float inv_d = d_ok ? 1.0f / dist : 0.0f;
    const V3 ld = v * inv_d;
    const float ndotl = fmaxf(0.0f, dot(nf, ld));
    const bool ok = hit && dist > bias && ndotl > 0.0f;
    if (tris.any(ok))
      lit = !rte::any_hit(T, tris, ok, so.x, so.y, so.z, ld.x, ld.y, ld.z, bias, dist - bias) && ok;
    if (lit) {
      const float inv_d2 = inv_d * inv_d;
      const float contrib = inv_d2 * ndotl;
      dif += E * contrib;
      V3 Eb = difb * contrib;
      const float contribb = dot(difb, E);
      float inv_d2b = contribb * ndotl;
      const float ndotlb = contribb * inv_d2;
      V3 ldb{0.0f, 0.0f, 0.0f};
      // Blinn-Phong: sf = exp(shin log(ndoth)) / d^2
      const V3 hv = ld - r.d;
      const float h2 = dot(hv, hv);
      const float invh = rsqrt_where(h2, 1e-16f);
      const float m = dot(nf, hv);
      const float ndoth = fmaxf(0.0f, m * invh);
      if (spec > 0.0f && ndoth > 0.0f) {
        const float lg = logf(ndoth);
        const float P = expf(shin * lg);
        const float sf = P * inv_d2;
        S += E * sf;
        Eb += Sb * sf;
        const float sfb = dot(Sb, E);
        inv_d2b += sfb * P;
        const float Xb = sfb * inv_d2 * P;  // cotangent of shin * log(ndoth)
        shinb += Xb * lg;
        const float ndothb = Xb * shin / ndoth;
        const float mb = ndothb * invh, invhb = ndothb * m;
        nfb += hv * mb;
        V3 hvb = nf * mb;
        if (h2 > 1e-16f) hvb += hv * (-invhb * invh * invh * invh);
        ldb += hvb;
        old.d -= hvb;
      }
      nfb += ld * ndotlb;
      ldb += nf * ndotlb;
      // ld = v inv_d, inv_d = 1 / sqrt(|v|^2)  (d_ok holds: ndotl > 0)
      const float inv_db = 2.0f * inv_d * inv_d2b + dot(ldb, v);
      const float dist2b = -0.5f * inv_db * inv_d * inv_d2;
      const V3 vb = ldb * inv_d + v * (2.0f * dist2b);
      pb -= vb;
      lcot[0] = vb.x; lcot[1] = vb.y; lcot[2] = vb.z;
      lcot[3] = Eb.x; lcot[4] = Eb.y; lcot[5] = Eb.z;
    }
    sink.light(lit, li, lc, lcot);
  }

  float mcot[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // albedo rgb, spec, shin, tau
  float pc[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (hit) {
    // rgb += w (1 - tau) (albedo * dif + S spec)
    const V3 Q{ar * dif.x + S.x * spec, ag * dif.y + S.y * spec, ab * dif.z + S.z * spec};
    const float gQ = gr * Q.x + gg * Q.y + gb * Q.z;
    old.w += omt * gQ;
    mcot[0] = Gr * dif.x; mcot[1] = Gg * dif.y; mcot[2] = Gb * dif.z;
    mcot[3] = specb + Gr * S.x + Gg * S.y + Gb * S.z;
    mcot[4] = shinb;
    mcot[5] = -r.w * gQ * clip01_grad(tau_raw);
    // p = o + d t; nf = n flip
    old.o += pb;
    old.d += pb * h.t;
    const float tb = dot(pb, r.d);
    const V3 nb = nfb * flip;
    if (gi < T.ns) {
      sphere_pullback(T, gi, r, h.t, tb, nb, old, pc);
    } else if (gi < T.ns + T.np) {
      plane_pullback(T, gi - T.ns, r, h.t, tb, nb, old, pc);
    } else {
      tri_pullback(T, h.tc, r, h.t, tb, nb, old, pc);
    }
    c = old;
  }
  sink.hit(T, hit, gi, h.tc, mcot, pc);
}

// Step 3 of chain_adjoint_ray, for ray i (-1: none) with nd saved bounces
// in `states` ([depth][kStateRows][n], rte::ChainTape's layout): on entry c
// is the cotangent of the state after the last bounce, on exit that of the
// ray (o, d). The threads step through the loop together from the deepest
// ray of the warp (linear tables) or of the CTA (culled) down; a lane whose
// ray has no bounce at a depth idles through it, at the state `idle`.
template <class Sink, class Tris>
__device__ __forceinline__ void reverse_bounces(
    const Tables& T, Sink& sink, Tris& tris, const float* __restrict__ states, long long n,
    long long i, int nd, const Ray& idle, RayCot& c, float gr, float gg, float gb, float bias,
    float min_weight) {
  const int top = tris.top(nd);
  for (int k = top - 1; k >= 0; --k) {
    const bool act = k < nd;
    Ray rk = idle;
    Winner wk{kInf, 0, 0};
    if (act) {
      const float* s = states + static_cast<long long>(k) * kStateRows * n + i;
      rk = Ray{{s[0], s[n], s[2 * n]}, {s[3 * n], s[4 * n], s[5 * n]}, s[6 * n]};
      wk = Winner{s[7 * n], __float_as_int(s[8 * n]), __float_as_int(s[9 * n])};
    }
    bounce_adjoint(T, sink, tris, act, rk, wk, c, gr, gg, gb, bias, min_weight);
  }
}

// Ray i of the dense chain adjoint, -1 for a thread with none (128-thread
// CTAs; every thread of the CTA runs to the end, since the warp sums need
// all 32 lanes and the culled scans every thread, and a thread with no ray
// has no bounces):
//   1. a state-only forward saves the ray state (o, d, w) before each bounce
//      and that bounce's closest hit (t, gi, tc) into `states`
//      [max_depth][kStateRows][R] in device memory, allocated by the
//      wrapper. The depth count `nd` is per thread. Device memory rather
//      than local memory: it has no compile-time depth bound, neighbouring
//      threads' accesses are coalesced, and at 1080p and depth 10 the 830 MB
//      are written once and read once. This is the adjoint's only
//      closest-hit scan;
//   2. the VJP of the depth-exhaustion sky term seeds the state cotangent;
//   3. for depth nd-1 down to 0 the bounce's adjoint (its shading, one
//      binary shadow scan per light, Blinn-Phong, reflection) is applied at
//      its saved state and winner (`reverse_bounces`).
template <class Sink, class Tris>
__device__ __forceinline__ void chain_adjoint_ray(
    const Tables& T, Sink& sink, Tris& tris, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ g, float* __restrict__ go,
    float* __restrict__ gd, long long n, long long i, float* __restrict__ states, int max_depth,
    float bias, float min_weight) {
  const bool valid = i >= 0;
  Ray r{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f}, 1.0f};
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;
  if (valid) {
    r = Ray{{o[3 * i], o[3 * i + 1], o[3 * i + 2]}, {d[3 * i], d[3 * i + 1], d[3 * i + 2]}, 1.0f};
    gr = g[3 * i]; gg = g[3 * i + 1]; gb = g[3 * i + 2];
  }
  // 1. checkpoint the state and the winner of each bounce
  int nd = 0;
  bool live = valid;
  for (int k = 0; k < max_depth; ++k) {
    if (!tris.any(live)) break;
    float* s = states + static_cast<long long>(k) * kStateRows * n + (valid ? i : 0);
    if (live) {
      s[0] = r.o.x; s[n] = r.o.y; s[2 * n] = r.o.z;
      s[3 * n] = r.d.x; s[4 * n] = r.d.y; s[5 * n] = r.d.z; s[6 * n] = r.w;
    }
    Winner w;
    const bool cont = state_bounce(T, tris, live, r, bias, min_weight, w);
    if (live) {
      s[7 * n] = w.t; s[8 * n] = __int_as_float(w.gi); s[9 * n] = __int_as_float(w.tc);
      ++nd;
      live = cont;
    }
  }
  // 2. the sky term of a chain that reached max_depth
  RayCot c{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f};
  if (live) sky_adjoint(r, c, gr, gg, gb);
  // 3. bounces in reverse, the threads in step
  reverse_bounces(T, sink, tris, states, n, i, nd, r, c, gr, gg, gb, bias, min_weight);
  if (valid) {
    go[3 * i] = c.o.x; go[3 * i + 1] = c.o.y; go[3 * i + 2] = c.o.z;
    gd[3 * i] = c.d.x; gd[3 * i + 1] = c.d.y; gd[3 * i + 2] = c.d.z;
  }
}

// Each block's shared accumulator, [entry][block], for the fixed-order sum.
__device__ __forceinline__ void write_partials(const float* acc, int total,
                                               float* __restrict__ partials) {
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += blockDim.x)
    partials[(long long)j * gridDim.x + blockIdx.x] = acc[j];
}

// Allow `smem` bytes of dynamic shared memory to `kernel` where that with
// the culled scan's static staging (13.4 KB) may pass the default 48 KB.
template <class K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
