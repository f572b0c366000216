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
// a per-ray `if`.
//
// Tables: float32, row-major [rows, cols], one column per primitive, as
// kernels/chain_trace.py::pack_scene_tables lays them out:
//   sph [4, S]: center xyz, r^2      pl [4, P]: unit normal xyz, p.n
//   tri [12, T]: v0, e1, e2, unit normal
//   mat [7, N]: albedo rgb, specular, shininess, transparency, ior
//   light [7, L]: position xyz, emission rgb, active
// Padded slots can never hit (r^2 = -1, n = 0, e1 = e2 = 0).
//
// Culled tables (kernels/chain_trace.py::pack_forward_tables_perm; the chain
// kernels take them above 128 triangles) hold the triangles in scan order,
// tri [13, n_blocks * 128] with row 12 the original global index, and one box
// per block of 128 triangles and per group of 8 blocks, taabb [6, n_blocks +
// n_blocks / 8]. closest_hit and any_hit then test a group's box, its blocks'
// boxes and the triangles of the blocks that pass, per ray (the per-lane form
// of the TPU kernels' whole-tile `_block_hits_tile` skips). A skipped block
// holds no hit the ray could take, so the results are the linear scan's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rte {

constexpr float kEps = 1e-6f;   // Shape.h:89, :151, :203
constexpr float kInf = 3.0e38f;  // closest-hit miss sentinel

constexpr int kTriBlock = 128;  // triangles per culling block (chain_trace.py::TRI_BLOCK)
constexpr int kTriGroup = 8;    // blocks per group (TRI_GROUP)

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

// Sphere quadratic with a = dot3(d, d), near root if >= eps (Shape.h:72-98).
static __device__ __forceinline__ bool sphere_t(
    const Tables& T, int i, float a, float inv2a, float ox, float oy, float oz,
    float dx, float dy, float dz, float& t) {
  const float cx = tab(T.sph, T.sph_cols, 0, i), cy = tab(T.sph, T.sph_cols, 1, i);
  const float cz = tab(T.sph, T.sph_cols, 2, i), r2 = tab(T.sph, T.sph_cols, 3, i);
  float b, c;
  const float disc = sphere_disc(a, ox - cx, oy - cy, oz - cz, dx, dy, dz, r2, b, c);
  if (!(disc >= 0.0f)) return false;
  const float sq = sqrtf(disc);
  const float tt0 = (-b - sq) * inv2a;
  const float tt1 = (-b + sq) * inv2a;
  t = (tt0 >= kEps) ? tt0 : tt1;
  return t >= kEps;
}

// |denom| > eps and t >= 0 (Shape.h:149-159).
static __device__ __forceinline__ bool plane_t(
    const Tables& T, int i, float ox, float oy, float oz, float dx, float dy,
    float dz, float& t) {
  const float nx = tab(T.pl, T.pl_cols, 0, i), ny = tab(T.pl, T.pl_cols, 1, i);
  const float nz = tab(T.pl, T.pl_cols, 2, i), pn = tab(T.pl, T.pl_cols, 3, i);
  const float denom = dx * nx + dy * ny + dz * nz;
  if (!(fabsf(denom) > kEps)) return false;
  const float on = ox * nx + oy * ny + oz * nz;
  t = (pn - on) / denom;
  return t >= 0.0f;
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
static __device__ __forceinline__ bool tri_t(
    const Tables& T, int i, float ox, float oy, float oz, float dx, float dy,
    float dz, float& t) {
  const int c = T.tri_cols;
  const float v0x = tab(T.tri, c, 0, i), v0y = tab(T.tri, c, 1, i), v0z = tab(T.tri, c, 2, i);
  const float e1x = tab(T.tri, c, 3, i), e1y = tab(T.tri, c, 4, i), e1z = tab(T.tri, c, 5, i);
  const float e2x = tab(T.tri, c, 6, i), e2y = tab(T.tri, c, 7, i), e2z = tab(T.tri, c, 8, i);
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

// The culled triangles of closest_hit: the groups in table order (front to
// back along the frame's mean direction), the blocks of a group whose box
// meets [0, h.t], the triangles of a block whose box does. The bound is the
// best hit so far, inclusive, so a block holding a tie at h.t is scanned. The
// winner is the lexicographic minimum of (t, original index), the scan in
// authoring order with strict < whatever the visit order; a sphere or plane
// (lower indices) keeps a tie.
static __device__ __forceinline__ void closest_culled(const Tables& T, float ox, float oy,
                                                      float oz, float dx, float dy, float dz,
                                                      Hit& h) {
  const Slab s = make_slab(ox, oy, oz, dx, dy, dz);
  const int nb = T.n_blocks, c = T.tri_cols;
  float hg = h.t < kInf ? static_cast<float>(h.gi) : kInf;  // the best's original index
  float t;
  for (int g = 0; g < nb / kTriGroup; ++g) {
    if (!box_hit(T, s, nb + g, h.t)) continue;
    for (int b = g * kTriGroup; b < (g + 1) * kTriGroup; ++b) {
      if (!box_hit(T, s, b, h.t)) continue;
      for (int i = b * kTriBlock; i < (b + 1) * kTriBlock; ++i) {
        if (!tri_t(T, i, ox, oy, oz, dx, dy, dz, t) || t > h.t) continue;
        const float gi = tab(T.tri, c, 12, i);
        if (t < h.t || gi < hg) {
          h = Hit{t, tab(T.tri, c, 9, i), tab(T.tri, c, 10, i), tab(T.tri, c, 11, i),
                  static_cast<int>(gi), i};
          hg = gi;
        }
      }
    }
  }
}

// The culled triangles of any_hit: boxes against [0, hi], the first blocker
// ends the scan.
static __device__ __forceinline__ bool any_hit_culled(const Tables& T, float ox, float oy,
                                                      float oz, float dx, float dy, float dz,
                                                      float lo, float hi) {
  const Slab s = make_slab(ox, oy, oz, dx, dy, dz);
  const int nb = T.n_blocks;
  float t;
  for (int g = 0; g < nb / kTriGroup; ++g) {
    if (!box_hit(T, s, nb + g, hi)) continue;
    for (int b = g * kTriGroup; b < (g + 1) * kTriGroup; ++b) {
      if (!box_hit(T, s, b, hi)) continue;
      for (int i = b * kTriBlock; i < (b + 1) * kTriBlock; ++i)
        if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t > lo && t < hi) return true;
    }
  }
  return false;
}

// Closest hit: spheres, planes, then the triangles; a linear scan in
// authoring order with strict < first-wins (Scene.h:218-257), or the culled
// scan. All hit fields update together under one `closer` test.
static __device__ __forceinline__ Hit closest_hit(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz) {
  Hit h{kInf, 0.0f, 0.0f, 0.0f, 0};
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
  if (T.taabb) {
    closest_culled(T, ox, oy, oz, dx, dy, dz, h);
    return h;
  }
  for (int i = 0; i < T.nt; ++i) {
    if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < h.t) {
      h = Hit{t, tab(T.tri, T.tri_cols, 9, i), tab(T.tri, T.tri_cols, 10, i),
              tab(T.tri, T.tri_cols, 11, i), T.ns + T.np + i, i};
    }
  }
  return h;
}

// Binary occlusion: is there any primitive with lo < t < hi? Stops at the
// first blocker.
static __device__ __forceinline__ bool any_hit(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz,
    float lo, float hi) {
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float inv2a = 0.5f / a;
  float t;
  for (int i = 0; i < T.ns; ++i)
    if (sphere_t(T, i, a, inv2a, ox, oy, oz, dx, dy, dz, t) && t > lo && t < hi) return true;
  for (int i = 0; i < T.np; ++i)
    if (plane_t(T, i, ox, oy, oz, dx, dy, dz, t) && t > lo && t < hi) return true;
  if (T.taabb) return any_hit_culled(T, ox, oy, oz, dx, dy, dz, lo, hi);
  for (int i = 0; i < T.nt; ++i)
    if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t > lo && t < hi) return true;
  return false;
}

// Sky gradient on unit directions (Scene.h:30-33).
static __device__ __forceinline__ float3 sky(float dy) {
  const float t = 0.5f * (dy + 1.0f);
  return make_float3(1.0f * (1.0f - t) + 0.5f * t, 1.0f * (1.0f - t) + 0.7f * t,
                     1.0f * (1.0f - t) + 1.0f * t);
}

// The full chain for one ray -> HDR radiance.
static __device__ __forceinline__ float3 trace_ray(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz,
    int max_depth, float bias, float min_weight) {
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, weight = 1.0f;
  bool live = true;
  for (int depth = 0; depth < max_depth; ++depth) {
    const Hit h = closest_hit(T, ox, oy, oz, dx, dy, dz);
    if (!(h.t < kInf)) {  // miss -> sky
      const float3 s = sky(dy);
      acc_r += weight * s.x;
      acc_g += weight * s.y;
      acc_b += weight * s.z;
      live = false;
      break;
    }
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
      if (!(dist > bias && ndotl > 0.0f)) continue;
      if (any_hit(T, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias)) continue;
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
    acc_r += weight * (ar * diff_r + spec_r * spec);
    acc_g += weight * (ag * diff_g + spec_g * spec);
    acc_b += weight * (ab * diff_b + spec_b * spec);

    // Reflection chain (Scene.h:189-195), pruned by min_weight.
    if (!(spec > bias && weight * spec >= min_weight)) {
      live = false;
      break;
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
  return make_float3(acc_r, acc_g, acc_b);
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
// the same tests, order and strict < as closest_hit, without the normal;
// returns t (kInf on a miss), the winner's global index gi (-1 on a miss)
// and its transparency, mat row 5.
static __device__ __forceinline__ float nearest_t_tau(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz, float& tau,
    int& gi) {
  float best = kInf;
  gi = -1;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float inv2a = 0.5f / a;
  float t;
  for (int i = 0; i < T.ns; ++i)
    if (sphere_t(T, i, a, inv2a, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = i; }
  for (int i = 0; i < T.np; ++i)
    if (plane_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = T.ns + i; }
  for (int i = 0; i < T.nt; ++i)
    if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < best) { best = t; gi = T.ns + T.np + i; }
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
static __device__ __forceinline__ bool march_step(const Tables& T, March& m, float dx, float dy,
                                                  float dz, float max_dist, float bias,
                                                  int& crossed) {
  crossed = -1;
  float tau;
  int gi;
  const float t = nearest_t_tau(T, m.ox, m.oy, m.oz, dx, dy, dz, tau, gi);
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

// The march for one shadow ray -> T in [0, 1], at most max_steps steps.
static __device__ __forceinline__ float march_T(
    const Tables& T, float ox, float oy, float oz, float dx, float dy, float dz,
    float max_dist, float bias, int max_steps, float min_t) {
  if (!(max_dist > 0.0f)) return 1.0f;
  March m{ox, oy, oz, 0.0f, 1.0f};
  for (int it = 0; it < max_steps; ++it) {
    int crossed;
    if (!march_step(T, m, dx, dy, dz, max_dist, bias, crossed)) break;
    if (!(m.tr > min_t && m.traveled < max_dist)) break;
  }
  return clip01(m.tr);
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
// children of node_children. A push finding the stack full is dropped and
// counted in `dropped` (cap = max_depth + 2 bounds the DFS, so it stays 0).
// `pops` counts the nodes popped, at most P.budget.
static __device__ __forceinline__ float3 trace_wavefront_ray(
    const Tables& T, const WavefrontParams& P, float ox, float oy, float oz, float dx,
    float dy, float dz, int& pops, int& dropped) {
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
    const Hit h = closest_hit(T, n.ox, n.oy, n.oz, n.dx, n.dy, n.dz);
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
        tr = march_T(T, sox, soy, soz, ldx, ldy, ldz, dist - bias, bias, P.shadow_max_steps,
                     P.shadow_min_t);
      } else {
        tr = any_hit(T, sox, soy, soz, ldx, ldy, ldz, bias, dist - bias) ? 0.0f : 1.0f;
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

    const Children ch = node_children(T, P, n, h, srf);
    if (ch.push_refl) push_node(stack, sp, cap, ch.refl, dropped);
    if (ch.push_refr) push_node(stack, sp, cap, ch.refr, dropped);
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

inline Tables make_tables(const float* sph, int sph_cols, int ns, const float* pl,
                          int pl_cols, int np, const float* tri, int tri_cols, int nt,
                          const float* mat, int mat_cols, const float* light,
                          int light_cols, int nl) {
  return Tables{sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt,
                mat, mat_cols, light, light_cols, nl};
}

// The tables with their culling boxes (null and 0: a linear scan).
inline Tables with_culling(Tables T, const float* taabb, int n_blocks) {
  T.taabb = taabb;
  T.n_blocks = taabb ? n_blocks : 0;
  return T;
}

}  // namespace rte
