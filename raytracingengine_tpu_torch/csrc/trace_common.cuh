// Per-ray body of the opaque Whitted chain, shared by chain_trace.cu and
// spp_trace.cu. It is the per-ray form of the TPU kernel body
// raytracingengine_tpu/kernels/chain_trace.py::_trace_tile, and the plain
// PyTorch version kernels/chain_trace.py::trace_chain_plain follows it line
// by line. Where the TPU kernel masks lanes of a tile, a thread here
// branches: the whole-tile early exit of the depth loop becomes a per-ray
// `break`, and the "any lane needs this light" skip of the shadow scan
// becomes a per-ray `if`.
//
// Tables: float32, row-major [rows, cols], one column per primitive, as
// kernels/chain_trace.py::pack_scene_tables lays them out:
//   sph [4, S]: center xyz, r^2      pl [4, P]: unit normal xyz, p.n
//   tri [12, T]: v0, e1, e2, unit normal
//   mat [7, N]: albedo rgb, specular, shininess, transparency, ior
//   light [7, L]: position xyz, emission rgb, active
// Padded slots can never hit (r^2 = -1, n = 0, e1 = e2 = 0).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rte {

constexpr float kEps = 1e-6f;   // Shape.h:89, :151, :203
constexpr float kInf = 3.0e38f;  // closest-hit miss sentinel

struct Tables {
  const float* sph; int sph_cols; int ns;
  const float* pl; int pl_cols; int np;
  const float* tri; int tri_cols; int nt;
  const float* mat; int mat_cols;
  const float* light; int light_cols; int nl;
};

// Every thread of a warp reads the same table entry: one broadcast load
// through the read-only data cache.
static __device__ __forceinline__ float tab(const float* t, int cols, int row, int i) {
  return __ldg(t + row * cols + i);
}

struct Hit {
  float t, nx, ny, nz;
  int gi;  // global primitive index: spheres, then planes, then triangles
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

// Linear scan in authoring order with strict < first-wins (Scene.h:218-257).
// All hit fields update together under one `closer` test.
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
  for (int i = 0; i < T.nt; ++i) {
    if (tri_t(T, i, ox, oy, oz, dx, dy, dz, t) && t < h.t) {
      h = Hit{t, tab(T.tri, T.tri_cols, 9, i), tab(T.tri, T.tri_cols, 10, i),
              tab(T.tri, T.tri_cols, 11, i), T.ns + T.np + i};
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

inline Tables make_tables(const float* sph, int sph_cols, int ns, const float* pl,
                          int pl_cols, int np, const float* tri, int tri_cols, int nt,
                          const float* mat, int mat_cols, const float* light,
                          int light_cols, int nl) {
  return Tables{sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt,
                mat, mat_cols, light, light_cols, nl};
}

}  // namespace rte
