// Adjoint of the wavefront (glass) trace: [R,3] rays and g = dL/d(rgb) ->
// cotangents of every scene table (summed over rays) and of each ray's
// origin and direction.
//
// Replaces raytracingengine_tpu/kernels/wavefront_grad.py::
// wavefront_grad_pallas (`_make_wavefront_grad_kernel`, at most 512
// primitives). The TPU kernel replays the DFS of a tile of rays in
// lockstep, tapes every iteration's popped node to HBM ([budget, 9, SUB,
// LANE]), then sweeps the tape in reverse under jax.vjp of each node's
// shading and child construction, with a per-lane cotangent stack that
// mirrors the ray stack. Here one thread runs one ray's DFS:
//   1. the forward's counting instantiation (wavefront_trace.cu, kCount)
//      wrote, per warp of 32 rays, the most nodes one of its rays popped;
//      the wrapper gives each warp a stretch of 32 x that many node slots
//      in the tape (an exclusive prefix sum, one host sync: `tape_slots`);
//   2. `wavefront_grad_kernel` replays the DFS without lighting (the
//      closest hit and `rte::node_children`, the forward kernel's own
//      functions, so the same branches), writing each popped node (o, d,
//      weight, depth and which children it pushed: 32 bytes) to its
//      warp's stretch, then walks it from the last pop back. A
//      cotangent stack of kMaxCap (o, d, w) cotangents in local memory hands
//      each node the cotangents of the children it pushed (refraction on
//      top); the node's adjoint (`node_adjoint`, derived by hand below from
//      the plain version's node_children_rgb) runs with those and g, and
//      pushes the node's own. Nodes the budget left on the stack start as
//      zero cotangents; the primary ray's ends in slot 0;
//   3. per light with march shadows, wherever the cotangent of the shadow
//      transmittance T is non-zero, the march is replayed (`rte::march_step`,
//      the forward's step) and each crossed surface i gets cot_T * T / tau_i
//      in its transparency, times clip's subgradient at tau_raw_i and at T
//      (0.5 at a bound): jax.grad of the JAX package's XLA march, the tests'
//      reference. (The TPU kernel passes the full gradient on [0, 1].)
// The tape (`TapeSlots`) is node-major and lane-minor within a warp's
// stretch, and each node's two float4s lie in two planes, so the 32 lanes'
// stores and loads of their node k fall in four contiguous 128-byte lines.
// It holds every tree up to cfg.budget() nodes: at 1080p on the glass
// sphere ~2 nodes per ray (~130 MB) plus each warp's padding to its
// longest tree, where the TPU kernel's layout would take budget x 36
// bytes per ray (2,048 x 36 x 2M = 153 GB). A lane whose replay pops more
// nodes than the forward counted for its warp writes nothing past its
// stretch: it counts itself in the overrun counter, which the wrapper reads
// after the launch and raises on, and gives NaN cotangents (its rays' and
// one table entry).
// Pushes dropped on a full stack were counted by the forward.
//
// The node's reverse mode, by hand (CUDA has no jax.vjp): the sky of a miss
// or of depth exhaustion (dy of the stored direction, not normalised); the
// per-light diffuse and Blinn-Phong terms with exp(shin log(n.h)), 1/d^2
// and T; the local term's (1 - clip(tau)); Schlick's F with f0 from the
// ior; eta = 1/ior on front hits; the refraction d eta - n (eta cosi +
// sqrt(k)) with the sqrt's derivative 0 at k <= 0; both children's
// normalisations under rsqrt_where; the refraction weight w tau (1 - F)
// with F before TIR; reflectiveness F on transparent hits (1 under TIR) or
// the specular on opaque ones; the front-face flip and the min_weight
// pruning as constants; the hit's (t, n) pulled back onto the one winning
// primitive (adjoint_common.cuh). Clips and maxima take JAX's 0.5 at a tie.
//
// What bounds it on the H100: fp32 work and divergence, as the forward
// kernel. Per ray it reads o, d and g (36 bytes) and writes d_o and d_d (24
// bytes); the function needs at least the forward's intersection tests (one
// closest-hit scan per popped node and the shadow scans). On the glass
// sphere at 1080p that is ~200 fp32 operations per ray, so the 60 bytes per
// ray at 3.35 TB/s (0.04 ms) bound it, not the operations (roofline.py's
// count in chip_smoke.py). This design adds one replay of the closest-hit
// scans, a march replay per lit light, the adjoint arithmetic and 32 bytes
// of tape per node slot each way.
//
// What the design does about it: one thread per ray with per-ray exits, the
// replays without lighting; the lanes of a warp step through the reverse
// sweep together, from the warp's longest tape down (a lane with fewer
// nodes idles first), so that the table cotangents can be summed over the
// warp with shuffles before shared-memory atomics (`add_column`); the
// march replays step the warp together for the same reason. Table
// cotangents stay in shared memory until the block ends; the per-block
// partials are summed by the fixed-order reduction of adjoint_common.cuh.
#include "adjoint_common.cuh"

namespace {

using rte::Children;
using rte::Node;
using rte::WavefrontParams;

constexpr int kThreads = 128;

// A taped node's code: its depth, and which children the replay pushed.
constexpr int kDepthMask = 0xff, kReflPushed = 1 << 8, kRefrPushed = 1 << 9;

// The tape's layout, the one place that decides it: n_slots slots of 32
// nodes, slot s lane l at index 32 s + l of two float4 planes (o xyz, d.x |
// d.y, d.z, w, code). Warp w owns slots starts[w] .. starts[w] + its
// count - 1, node k of its lane l in slot starts[w] + k.
constexpr int kTapeFloatsPerSlot = 32 * 8;

struct TapeSlots {
  float4* a;  // o xyz, d.x
  float4* b;  // d.y, d.z, w, code
  __device__ __forceinline__ long long at(long long slot, int lane) const {
    return 32 * slot + lane;
  }
};

// The forward DFS (trace_wavefront_ray) without the lighting, which does not
// change which nodes are popped: visit(k, node, code) sees the k-th pop.
// Returns the pops; sp_fin is the size of the stack the budget left.
template <class Visit>
__device__ __forceinline__ int replay(const Tables& T, const WavefrontParams& P, float ox,
                                      float oy, float oz, float dx, float dy, float dz,
                                      int& sp_fin, int& dropped, Visit visit) {
  const int cap = P.max_depth + 2;
  Node stack[rte::kMaxCap];
  stack[0] = Node{ox, oy, oz, dx, dy, dz, 1.0f, 0};
  int sp = 1, pops = 0;
  while (sp > 0 && pops < P.budget) {
    const Node n = stack[--sp];
    int code = n.depth;
    if (n.depth < P.max_depth) {
      const rte::Hit h = rte::closest_hit(T, n.ox, n.oy, n.oz, n.dx, n.dy, n.dz);
      if (h.t < kInf) {
        const Children ch = rte::node_children(T, P, n, h, rte::surface(n, h));
        if (ch.push_refl && rte::push_node(stack, sp, cap, ch.refl, dropped)) code |= kReflPushed;
        if (ch.push_refr && rte::push_node(stack, sp, cap, ch.refr, dropped)) code |= kRefrPushed;
      }
    }
    visit(pops++, n, code);
  }
  sp_fin = sp;
  return pops;
}

// d min(max(x, lo), hi) / dx with jnp.clip's subgradient: 0.5 at a bound.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  if (x > lo && x < hi) return 1.0f;
  return (x == lo || x == hi) ? 0.5f : 0.0f;
}

// d max(0, x) / dx with jnp.maximum's subgradient: 0.5 at 0.
__device__ __forceinline__ float relu_grad(float x) {
  return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
}

// The march adjoint of one shadow ray: T = clip(prod_i clip(tau_raw_i)),
// so each crossing of surface i adds cot_T clip'(T) T / tau_i clip'(tau_raw_i)
// to its transparency (tau_i > 1e-12). All 32 lanes call it together and
// step the march together until every lane's march has ended.
__device__ __forceinline__ void march_adjoint(const Tables& T, const WavefrontParams& P,
                                              const Offsets& off, float* acc, bool want, V3 so,
                                              V3 ld, float max_dist, float tr, float cot_T) {
  rte::March m{so.x, so.y, so.z, 0.0f, 1.0f};
  const float scale = cot_T * tr * clip01_grad(tr);
  const int row = off.mat + 5 * T.mat_cols;
  bool live = want && max_dist > 0.0f;
  int it = 0;
  while (__any_sync(kFullWarp, live)) {
    float v[1] = {0.0f};
    int gi = 0;
    bool mine = false;
    if (live) {
      int crossed;
      live = rte::march_step(T, m, ld.x, ld.y, ld.z, max_dist, P.bias, crossed);
      if (crossed >= 0) {
        const float tau_raw = tab(T.mat, T.mat_cols, 5, crossed);
        const float tau = rte::clip01(tau_raw);
        if (tau > 1e-12f) {
          v[0] = scale * clip01_grad(tau_raw) / tau;
          gi = crossed;
          mine = true;
        }
      }
      live = live && m.tr > P.shadow_min_t && m.traveled < max_dist && ++it < P.shadow_max_steps;
    }
    add_column<1>(acc, mine, row + gi, T.mat_cols, 1, v);
  }
}

// Adjoint of one popped node. All 32 lanes of a warp call it together (the
// table cotangents are summed across the warp); `act` is false for a lane
// with no node at this step. c_refl and c_refr are the cotangents of the
// children the node pushed (`code` says which); returns the cotangent of
// its state (o, d, w).
__device__ __forceinline__ RayCot node_adjoint(const Tables& T, const WavefrontParams& P,
                                               const Offsets& off, float* acc, bool act,
                                               const Node& n, int code, const RayCot& c_refl,
                                               const RayCot& c_refr, float gr, float gg,
                                               float gb) {
  const float bias = P.bias;
  const Ray r{{n.ox, n.oy, n.oz}, {n.dx, n.dy, n.dz}, n.w};
  RayCot c{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f};
  V3 nrm{0.0f, 0.0f, 0.0f};
  rte::Hit h{kInf, 0.0f, 0.0f, 0.0f, 0};
  if (act && n.depth < P.max_depth) h = closest(T, r, nrm);
  const bool hit = h.t < kInf;
  if (act && !hit) sky_adjoint(r, c, gr, gg, gb);  // a miss, or depth exhaustion

  const int gi = h.gi, mc = T.mat_cols;
  const float ar = tab(T.mat, mc, 0, gi), ag = tab(T.mat, mc, 1, gi), ab = tab(T.mat, mc, 2, gi);
  const float spec = tab(T.mat, mc, 3, gi), shin = tab(T.mat, mc, 4, gi);
  const float tau_raw = tab(T.mat, mc, 5, gi), eta_t = tab(T.mat, mc, 6, gi);
  const float tau = rte::clip01(tau_raw);
  const bool front = dot(nrm, r.d) < 0.0f;
  const float flip = front ? 1.0f : -1.0f;
  const V3 nf = nrm * flip;
  const V3 p = r.o + r.d * (hit ? h.t : 0.0f);

  V3 pb{0.0f, 0.0f, 0.0f}, nfb{0.0f, 0.0f, 0.0f}, db{0.0f, 0.0f, 0.0f};
  float wb = 0.0f, taub = 0.0f, specb = 0.0f, shinb = 0.0f, eta_tb = 0.0f, ddnb = 0.0f;
  if (hit) {
    // The children (rte::node_children), forward values first.
    const float ddn = dot(r.d, nf);
    const float cos_theta = fmaxf(0.0f, -ddn);
    const float f0r = (eta_t - 1.0f) / (eta_t + 1.0f);
    const float f0 = f0r * f0r;
    const float omc = 1.0f - cos_theta;
    const float omc4 = (omc * omc) * (omc * omc);
    const float F = f0 + (1.0f - f0) * omc4 * omc;
    const float eta = front ? 1.0f / eta_t : eta_t;
    const float cosi = fminf(fmaxf(ddn, -1.0f), 1.0f);
    const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
    const float sqk = k > 0.0f ? sqrtf(k) : 0.0f;
    const float coef = eta * cosi + sqk;
    const V3 rf = k < 0.0f ? V3{0.0f, 0.0f, 0.0f} : r.d * eta - nf * coef;
    const float rf2 = dot(rf, rf);
    const float inv_rf = rsqrt_where(rf2, 1e-24f);
    const V3 rfn = rf * inv_rf;
    const bool tir = tau > 0.0f && !(sqrtf(rf2) > bias);
    const float R = tau > 0.0f ? (tir ? 1.0f : F) : spec;
    const V3 rl = r.d - nf * (2.0f * ddn);
    const float inv_rl = rsqrt_where(dot(rl, rl), 1e-24f);
    const V3 rln = rl * inv_rl;

    float Rb = 0.0f, Fb = 0.0f;
    if (code & kReflPushed) {  // o = p + rln bias, d = rln, w = w R
      pb += c_refl.o;
      const V3 rlnb = c_refl.o * bias + c_refl.d;
      wb += c_refl.w * R;
      Rb += c_refl.w * n.w;
      const V3 rlb = (rlnb - rln * dot(rln, rlnb)) * inv_rl;
      db += rlb;  // rl = d - 2 (d.nf) nf
      ddnb -= 2.0f * dot(nf, rlb);
      nfb += rlb * (-2.0f * ddn);
    }
    if (tau > 0.0f) {
      if (!tir) Fb += Rb;
    } else {
      specb += Rb;
    }
    if (code & kRefrPushed) {  // o = p + rfn bias 100, d = rfn, w = w tau (1 - F)
      pb += c_refr.o;
      const V3 rfnb = c_refr.o * (bias * 1e2f) + c_refr.d;
      wb += c_refr.w * tau * (1.0f - F);
      taub += c_refr.w * n.w * (1.0f - F);
      Fb -= c_refr.w * n.w * tau;
      const V3 rfb = (rfnb - rfn * dot(rfn, rfnb)) * inv_rf;
      // rf = d eta - nf coef (k >= 0: a pushed refraction has length > bias)
      db += rfb * eta;
      nfb -= rfb * coef;
      const float coefb = -dot(rfb, nf);
      float etab = dot(rfb, r.d) + coefb * cosi;
      float cosib = coefb * eta;
      if (k > 0.0f) {  // coef = eta cosi + sqrt(k), k = 1 - eta^2 (1 - cosi^2)
        const float kb = coefb * 0.5f / sqk;
        etab -= kb * 2.0f * eta * (1.0f - cosi * cosi);
        cosib += kb * 2.0f * eta * eta * cosi;
      }
      ddnb += cosib * clip_grad(ddn, -1.0f, 1.0f);
      eta_tb += front ? -etab * eta * eta : etab;  // eta = 1 / eta_t on front hits
    }
    // Schlick: F = f0 + (1 - f0) omc^5, omc = 1 - max(0, -ddn),
    // f0 = ((eta_t - 1) / (eta_t + 1))^2
    const float f0b = Fb * (1.0f - omc4 * omc);
    ddnb += Fb * (1.0f - f0) * 5.0f * omc4 * relu_grad(-ddn);
    eta_tb += 2.0f * f0r * f0b * 2.0f / ((eta_t + 1.0f) * (eta_t + 1.0f));
  }

  // Direct light with its adjoint, light by light. The rgb cotangent of each
  // light's diffuse and specular sums is known up front.
  const float omt = 1.0f - tau;
  const float wo = n.w * omt;
  const float Gr = gr * wo, Gg = gg * wo, Gb = gb * wo;
  const V3 difb{Gr * ar, Gg * ag, Gb * ab};
  const V3 Sb{Gr * spec, Gg * spec, Gb * spec};
  V3 dif{0.0f, 0.0f, 0.0f}, S{0.0f, 0.0f, 0.0f};
  const V3 so = p + nf * bias;
  const bool spec_on = tau_raw <= 0.0f && spec > 0.0f;  // Scene.h:115
  const int lc = T.light_cols;
  for (int li = 0; li < T.nl; ++li) {  // the same trip count on every lane
    float lcot[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // position, emission
    bool lit = false;
    float tr = 1.0f, trb = 0.0f, dist = 0.0f;
    V3 ld{0.0f, 0.0f, 0.0f};
    if (hit && tab(T.light, lc, 6, li) > 0.0f) {
      // The forward kernel's shadow ray and T (forward-only).
      const V3 L = tab3(T.light, lc, 0, li), E = tab3(T.light, lc, 3, li);
      const V3 v = L - p;
      dist = sqrtf(fmaxf(dot(v, v), 1e-30f));
      const float inv_d = 1.0f / dist;
      ld = v * inv_d;
      const float ndotl = fmaxf(0.0f, dot(nf, ld));
      if (dist > bias && ndotl > 0.0f) {
        tr = P.march ? rte::march_T(T, so.x, so.y, so.z, ld.x, ld.y, ld.z, dist - bias, bias,
                                    P.shadow_max_steps, P.shadow_min_t)
                     : (rte::any_hit(T, so.x, so.y, so.z, ld.x, ld.y, ld.z, bias, dist - bias)
                            ? 0.0f
                            : 1.0f);
        lit = tr > bias;
      }
      if (lit) {  // contrib = n.l T / d^2; sf = exp(shin log(n.h)) T / d^2
        const float inv_d2 = inv_d * inv_d;
        const float contrib = inv_d2 * ndotl * tr;
        dif += E * contrib;
        V3 Eb = difb * contrib;
        const float contribb = dot(difb, E);
        float inv_d2b = contribb * ndotl * tr;
        const float ndotlb = contribb * inv_d2 * tr;
        trb = contribb * inv_d2 * ndotl;
        V3 ldb{0.0f, 0.0f, 0.0f};
        const V3 hv = ld - r.d;
        const float h2 = dot(hv, hv);
        const float invh = rsqrt_where(h2, 1e-16f);
        const float m = dot(nf, hv);
        const float ndoth = fmaxf(0.0f, m * invh);
        if (spec_on && ndoth > 0.0f) {
          const float lg = logf(ndoth);
          const float Pw = expf(shin * lg);
          const float sf = Pw * inv_d2 * tr;
          S += E * sf;
          Eb += Sb * sf;
          const float sfb = dot(Sb, E);
          inv_d2b += sfb * Pw * tr;
          trb += sfb * Pw * inv_d2;
          const float Xb = sfb * inv_d2 * tr * Pw;  // cotangent of shin * log(n.h)
          shinb += Xb * lg;
          const float ndothb = Xb * shin / ndoth;
          const float mb = ndothb * invh, invhb = ndothb * m;
          nfb += hv * mb;
          V3 hvb = nf * mb;
          if (h2 > 1e-16f) hvb += hv * (-invhb * invh * invh * invh);
          ldb += hvb;
          db -= hvb;
        }
        nfb += ld * ndotlb;
        ldb += nf * ndotlb;
        // ld = v inv_d, inv_d = 1 / sqrt(|v|^2)
        const float inv_db = 2.0f * inv_d * inv_d2b + dot(ldb, v);
        const float dist2b = -0.5f * inv_db * inv_d * inv_d2;
        const V3 vb = ldb * inv_d + v * (2.0f * dist2b);
        pb -= vb;
        lcot[0] = vb.x; lcot[1] = vb.y; lcot[2] = vb.z;
        lcot[3] = Eb.x; lcot[4] = Eb.y; lcot[5] = Eb.z;
      }
    }
    add_column<6>(acc, lit, off.light + li, lc, 6, lcot);
    if (P.march) march_adjoint(T, P, off, acc, lit && trb != 0.0f, so, ld, dist - bias, tr, trb);
  }

  float mcot[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // albedo rgb, spec, shin, tau, ior
  float pc[12] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int pbase = 0, pcols = 0, prows = 0;
  if (hit) {
    // rgb += w (1 - tau) (albedo * dif + S spec)
    const V3 Q{ar * dif.x + S.x * spec, ag * dif.y + S.y * spec, ab * dif.z + S.z * spec};
    const float gQ = gr * Q.x + gg * Q.y + gb * Q.z;
    wb += omt * gQ;
    taub -= n.w * gQ;
    mcot[0] = Gr * dif.x; mcot[1] = Gg * dif.y; mcot[2] = Gb * dif.z;
    mcot[3] = specb + Gr * S.x + Gg * S.y + Gb * S.z;
    mcot[4] = shinb;
    mcot[5] = taub * clip01_grad(tau_raw);
    mcot[6] = eta_tb;
    // ddn = d.nf; p = o + d t; nf = n flip
    db += nf * ddnb;
    nfb += r.d * ddnb;
    c.o += pb;
    db += pb * h.t;
    c.d += db;
    c.w += wb;
    const float tb = dot(pb, r.d);
    const V3 nb = nfb * flip;
    if (gi < T.ns) {
      sphere_pullback(T, gi, r, h.t, tb, nb, c, pc);
      pbase = off.sph + gi; pcols = T.sph_cols; prows = 4;
    } else if (gi < T.ns + T.np) {
      plane_pullback(T, gi - T.ns, r, h.t, tb, nb, c, pc);
      pbase = off.pl + gi - T.ns; pcols = T.pl_cols; prows = 4;
    } else {
      tri_pullback(T, gi - T.ns - T.np, r, h.t, tb, nb, c, pc);
      pbase = off.tri + gi - T.ns - T.np; pcols = T.tri_cols; prows = 12;
    }
  }
  add_column<7>(acc, hit, off.mat + gi, mc, 7, mcot);
  add_column<12>(acc, hit, pbase, pcols, prows, pc);
  return c;
}

__global__ void __launch_bounds__(kThreads) wavefront_grad_kernel(
    Tables T, WavefrontParams P, Offsets off, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ g, float* __restrict__ go,
    float* __restrict__ gd, int n_rays, const int* __restrict__ warp_pops,
    const long long* __restrict__ starts, TapeSlots tape, int* __restrict__ overruns,
    float* __restrict__ partials) {
  extern __shared__ float acc[];
  for (int j = threadIdx.x; j < off.total; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  // Every thread of the block runs to the end (the warp sums need all 32
  // lanes); a thread past the last ray has no nodes.
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = i < n_rays;
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;
  int n_pops = 0, sp_fin = 0;
  long long slot0 = 0;  // this warp's first slot
  bool over = false;
  if (valid) {
    gr = g[3 * i]; gg = g[3 * i + 1]; gb = g[3 * i + 2];
    const long long w = i >> 5;
    slot0 = starts[w];
    const int room = warp_pops[w];
    int dropped = 0;  // the forward counted the drops
    n_pops = replay(T, P, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
                    d[3 * i + 2], sp_fin, dropped, [&](int k, const Node& n, int code) {
                      if (k >= room) {  // past the stretch the forward sized
                        over = true;
                        return;
                      }
                      const long long at = tape.at(slot0 + k, lane);
                      tape.a[at] = make_float4(n.ox, n.oy, n.oz, n.dx);
                      tape.b[at] = make_float4(n.dy, n.dz, n.w, __int_as_float(code));
                    });
    if (over) {  // no sweep over a tape cut short: NaN, and the wrapper raises
      atomicAdd(overruns, 1);
      atomicAdd(acc, __int_as_float(0x7fffffff));
      n_pops = 0;
      sp_fin = 0;
    }
  }
  // The reverse sweep, the warp's lanes in step.
  const RayCot zero{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f};
  RayCot cs[rte::kMaxCap];
  for (int s = 0; s < sp_fin; ++s) cs[s] = zero;  // never popped
  int rsp = sp_fin;
  const int n_warp = __reduce_max_sync(kFullWarp, n_pops);
  for (int k = n_warp - 1; k >= 0; --k) {
    const bool act = k < n_pops;
    Node n{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0};
    int code = 0;
    RayCot c_refl = zero, c_refr = zero;
    if (act) {
      const long long at = tape.at(slot0 + k, lane);
      const float4 a = tape.a[at], b = tape.b[at];
      code = __float_as_int(b.w);
      n = Node{a.x, a.y, a.z, a.w, b.x, b.y, b.z, code & kDepthMask};
      if (code & kRefrPushed) c_refr = cs[--rsp];  // pushed last, on top
      if (code & kReflPushed) c_refl = cs[--rsp];
    }
    const RayCot c = node_adjoint(T, P, off, acc, act, n, code, c_refl, c_refr, gr, gg, gb);
    if (act) cs[rsp++] = c;
  }
  if (over) {
    const float nan = __int_as_float(0x7fffffff);
    cs[0] = RayCot{{nan, nan, nan}, {nan, nan, nan}, nan};
  }
  if (valid) {
    go[3 * i] = cs[0].o.x; go[3 * i + 1] = cs[0].o.y; go[3 * i + 2] = cs[0].o.z;
    gd[3 * i] = cs[0].d.x; gd[3 * i + 1] = cs[0].d.y; gd[3 * i + 2] = cs[0].d.z;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < off.total; j += blockDim.x)
    partials[(long long)j * gridDim.x + blockIdx.x] = acc[j];
}

}  // namespace

// Floats of a tape of n_slots slots (TapeSlots).
extern "C" long long rte_wavefront_tape_floats(long long n_slots) {
  return kTapeFloatsPerSlot * n_slots;
}

// The adjoint of ray block [n_rays] given the forward's per-warp counts
// `warp_pops` [ceil(n_rays / 32)], each warp's first slot `starts` and a
// tape of n_slots slots (rte_wavefront_tape_floats floats). A lane that
// pops past its warp's count adds one to *overruns.
extern "C" int rte_wavefront_grad(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* o, const float* d, const float* g,
    float* go, float* gd, int n_rays, const int* warp_pops, const long long* starts,
    float* tape, long long n_slots, int* overruns, float* partials, float* out, int total,
    int max_depth, float bias, float min_weight, int march, int shadow_max_steps,
    float shadow_min_t, int budget, int* dropped, void* stream) {
  (void)dropped;  // the forward counted the drops
  if (max_depth < 0 || max_depth + 2 > rte::kMaxCap) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return 0;
  const Tables T = rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat,
                                    mat_cols, light, light_cols, nl);
  const WavefrontParams P{max_depth, bias, min_weight, march, shadow_max_steps, shadow_min_t,
                          budget};
  const Offsets off = make_offsets(sph_cols, pl_cols, tri_cols, mat_cols, light_cols);
  if (off.total != total) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(total);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wavefront_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  float4* planes = reinterpret_cast<float4*>(tape);
  const TapeSlots slots{planes, planes + 32 * n_slots};
  wavefront_grad_kernel<<<blocks, kThreads, smem, s>>>(T, P, off, o, d, g, go, gd, n_rays,
                                                       warp_pops, starts, slots, overruns,
                                                       partials);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return reduce_partials(partials, total, blocks, out, s);
}
