// Adjoint of the chain trace: [R,3] rays and g = dL/d(rgb) -> cotangents of
// every scene table (summed over rays) and of each ray's origin and direction.
//
// Replaces raytracingengine_tpu/kernels/chain_grad.py::chain_grad_pallas
// (`_make_grad_kernel`, at most 512 primitives). The TPU kernel re-runs each
// bounce under jax.vjp inside the kernel; CUDA has no such thing, so the
// reverse mode of the bounce is derived by hand below, piece by piece as the
// JAX package's blocked adjoint splits it: the closest hit keeping the winner,
// the shading and chain update given the hit (`_make_shade_hit`), and the
// pullback of the hit's (t, n) onto the one winning primitive
// (`_sphere_tn_prim`, `_plane_tn_prim`, `_tri_tn_prim`). Shadow occlusion is
// boolean and carries no cotangent. The plain PyTorch version is
// kernels/chain_grad.py::chain_grad_plain (autograd of bounce_plain); the
// guards below are its guards, and the transparency clip keeps JAX's
// subgradient of 0.5 at tau = 0 and tau = 1.
//
// Per ray, one thread (128-thread blocks):
//   1. a state-only forward (closest hit + reflection update, no lighting)
//      saves the ray state (o, d, w) before each bounce into `states`
//      [max_depth][7][R] in device memory, allocated by the wrapper. The
//      depth count `nd` is per thread. Device memory rather than local
//      memory: it has no compile-time depth bound, each thread's accesses
//      are coalesced with its neighbours', and at 1080p and depth 10 the
//      580 MB are written once and read once;
//   2. the VJP of the depth-exhaustion sky term seeds the state cotangent;
//   3. for depth nd-1 down to 0 the full bounce (closest hit, one binary
//      shadow scan per light, Blinn-Phong, reflection) is re-run from its
//      saved state and its adjoint applied. The lanes of a warp step through
//      this loop together, from the warp's deepest ray down; a lane whose ray
//      has no bounce at a depth idles through it.
// Table cotangents: every table entry has one float of a block-wide
// accumulator in shared memory (at 512 triangles 19 * 512 floats, 38.9 KB,
// plus 7 floats per light). Every ray adds to the same light entries, and
// neighbouring rays mostly to the same primitive's, so per-lane atomics on
// those addresses serialise. A warp first sums each entry's values over its
// lanes with shuffles when all its contributing lanes share the column, and
// one lane adds the sum (`add_column`); otherwise each lane adds its own.
// Each block writes its accumulator as one partial, [entry][block]; a second
// kernel sums each entry's partials in a fixed order (a strided per-thread
// sum, then a tree in shared memory). So a run differs from the next only by
// the order of the atomics of a block's four warps.
//
// What bounds it on the H100: fp32 work and divergence, as the forward
// kernel. Per ray it reads o, d and g (36 bytes) and writes d_o and d_d (24
// bytes). The function needs at least the forward's intersection tests: one
// closest-hit scan per bounce and the shadow scans. On the head box at 1080p
// (five bounces per ray) they are ~9,000 fp32 operations per ray
// (roofline.py's count in chip_smoke.py, on an NVIDIA H100 80GB HBM3 at
// 700 W; the shading and the adjoint arithmetic are left out, so it is a
// lower bound): 0.28 ms at 67 TFLOP/s, against 0.04 ms for the 60 bytes per
// ray at 3.35 TB/s. The fp32 rate is the bound. This design adds to it a
// second closest-hit scan per bounce (checkpoint, then re-run) and 28 bytes
// of saved state per bounce each way.
//
// What the design does about it: one thread per ray with per-ray exits (the
// depth loop, the shadow scan's first blocker), the forward kernel's
// per-primitive tests (trace_common.cuh) for every hit decision, so the
// adjoint follows the same path the forward traced; the shadow scans run
// only in the reverse loop, once per bounce. Table cotangents stay in shared
// memory until the block ends: one device-memory write per entry and block.
#include "adjoint_common.cuh"

namespace {

constexpr int kThreads = 128;

// State-only bounce (the JAX package's `_make_state_bounce`): the closest hit
// and the reflection update. Returns whether the ray continues.
__device__ __forceinline__ bool state_bounce(const Tables& T, Ray& r, float bias,
                                             float min_weight) {
  V3 n;
  const rte::Hit h = closest(T, r, n);
  if (!(h.t < kInf)) return false;
  const float spec = tab(T.mat, T.mat_cols, 3, h.gi);
  if (!(spec > bias && r.w * spec >= min_weight)) return false;
  const V3 nf = n * (dot(n, r.d) < 0.0f ? 1.0f : -1.0f);
  const V3 p = r.o + r.d * h.t;
  const V3 rf = r.d - nf * (2.0f * dot(r.d, nf));
  const V3 rn = rf * rsqrt_where(dot(rf, rf), 1e-16f);
  r.o = p + rn * bias;
  r.d = rn;
  r.w *= spec;
  return true;
}

// Adjoint of one full bounce from the saved state r. On entry c is the
// cotangent of the bounce's new state; on exit that of r. g is the rgb
// cotangent (the same at every bounce: the radiance is a sum of bounces).
// All 32 lanes of a warp call it together (the table cotangents are summed
// across the warp); `act` is false for a lane whose ray has no bounce here.
__device__ __forceinline__ void bounce_adjoint(const Tables& T, const Offsets& off, float* acc,
                                               bool act, const Ray& r, RayCot& c, float gr,
                                               float gg, float gb, float bias, float min_weight) {
  V3 n{0.0f, 0.0f, 0.0f};
  rte::Hit h{kInf, 0.0f, 0.0f, 0.0f, 0};
  if (act) h = closest(T, r, n);
  const bool hit = act && h.t < kInf;
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
    if (hit && dist > bias && ndotl > 0.0f)
      lit = !rte::any_hit(T, so.x, so.y, so.z, ld.x, ld.y, ld.z, bias, dist - bias);
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
    add_column<6>(acc, lit, off.light + li, lc, 6, lcot);
  }

  float mcot[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // albedo rgb, spec, shin, tau
  float pc[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int pbase = 0, pcols = 0, prows = 0;
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
      pbase = off.sph + gi; pcols = T.sph_cols; prows = 4;
    } else if (gi < T.ns + T.np) {
      plane_pullback(T, gi - T.ns, r, h.t, tb, nb, old, pc);
      pbase = off.pl + gi - T.ns; pcols = T.pl_cols; prows = 4;
    } else {
      tri_pullback(T, gi - T.ns - T.np, r, tb, nb, old, pc);
      pbase = off.tri + gi - T.ns - T.np; pcols = T.tri_cols; prows = 12;
    }
    c = old;
  }
  add_column<6>(acc, hit, off.mat + gi, mc, 6, mcot);
  add_column<12>(acc, hit, pbase, pcols, prows, pc);
}

__global__ void __launch_bounds__(kThreads) chain_grad_kernel(
    Tables T, Offsets off, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ g, float* __restrict__ go, float* __restrict__ gd, int n_rays,
    float* __restrict__ states, float* __restrict__ partials, int max_depth, float bias,
    float min_weight) {
  extern __shared__ float acc[];
  for (int j = threadIdx.x; j < off.total; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  // Every thread of the block runs to the end (the warp sums need all 32
  // lanes); a thread past the last ray has no bounces.
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = n_rays;
  const bool valid = i < n;
  Ray r{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f}, 1.0f};
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;
  int nd = 0;
  bool live = valid;
  if (valid) {
    r = Ray{{o[3 * i], o[3 * i + 1], o[3 * i + 2]}, {d[3 * i], d[3 * i + 1], d[3 * i + 2]}, 1.0f};
    gr = g[3 * i]; gg = g[3 * i + 1]; gb = g[3 * i + 2];
    // 1. checkpoint the state before each bounce
    while (nd < max_depth && live) {
      float* s = states + (long long)nd * 7 * n + i;
      s[0] = r.o.x; s[n] = r.o.y; s[2 * n] = r.o.z;
      s[3 * n] = r.d.x; s[4 * n] = r.d.y; s[5 * n] = r.d.z; s[6 * n] = r.w;
      live = state_bounce(T, r, bias, min_weight);
      ++nd;
    }
  }
  // 2. the sky term of a chain that reached max_depth
  RayCot c{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f};
  if (live) sky_adjoint(r, c, gr, gg, gb);
  // 3. bounces in reverse, the warp's lanes in step
  const int nd_warp = __reduce_max_sync(kFullWarp, nd);
  for (int k = nd_warp - 1; k >= 0; --k) {
    const bool act = k < nd;
    Ray rk = r;
    if (act) {
      const float* s = states + (long long)k * 7 * n + i;
      rk = Ray{{s[0], s[n], s[2 * n]}, {s[3 * n], s[4 * n], s[5 * n]}, s[6 * n]};
    }
    bounce_adjoint(T, off, acc, act, rk, c, gr, gg, gb, bias, min_weight);
  }
  if (valid) {
    go[3 * i] = c.o.x; go[3 * i + 1] = c.o.y; go[3 * i + 2] = c.o.z;
    gd[3 * i] = c.d.x; gd[3 * i + 1] = c.d.y; gd[3 * i + 2] = c.d.z;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < off.total; j += blockDim.x)
    partials[(long long)j * gridDim.x + blockIdx.x] = acc[j];
}

}  // namespace

extern "C" int rte_chain_grad(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* o, const float* d,
    const float* g, float* go, float* gd, int n_rays, float* states, float* partials,
    int total, int max_depth, float bias, float min_weight, void* stream) {
  if (n_rays <= 0) return 0;
  const Tables T = rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt,
                                    mat, mat_cols, light, light_cols, nl);
  const Offsets off = make_offsets(sph_cols, pl_cols, tri_cols, mat_cols, light_cols);
  if (off.total != total) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(total);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  chain_grad_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      T, off, o, d, g, go, gd, n_rays, states, partials, max_depth, bias, min_weight);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rte_chain_grad_reduce(const float* partials, int total, int n_blocks, float* out,
                                     void* stream) {
  return reduce_partials(partials, total, n_blocks, out, static_cast<cudaStream_t>(stream));
}
