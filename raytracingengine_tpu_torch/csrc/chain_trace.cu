// Chain-trace kernel: [R,3] ray origins and directions -> [R,3] HDR.
//
// Replaces raytracingengine_tpu/kernels/chain_trace.py::chain_trace_pallas
// (the SMEM-resident forward, culled above 128 triangles) and
// chain_trace_streamed_pallas (the same culled scan with the triangles
// DMA'd from HBM past 8,192). Here every table stays in device memory at
// every size (at 50,800 triangles the tri table is 2.6 MB and mat 1.4 MB,
// far below the 50 MB L2), so one kernel covers both. The per-ray body is
// trace_common.cuh.
//
// What bounds it on the H100: fp32 ALU work and warp divergence. A ray
// reads 24 bytes and writes 12, while it runs up to max_depth closest-hit
// scans plus one shadow scan per light and bounce. Neighbouring rays follow
// different paths (miss, short chain, long reflection chain; shadowed or
// not; other blocks), so the cost of a warp is that of its slowest ray. On
// culled tables a thread that read each triangle of the blocks it meets
// from device memory (nine loads from nine rows a column apart) waited on
// L2 for most of its time, with few warps in flight: 2,048 CTAs at 512^2.
//
// What the design does about it: one thread per ray, so per-ray early exits
// (miss, pruned chain, first shadow blocker) end work that the TPU kernel
// could only skip when a whole tile agreed; thread t of CTA c takes ray
// 128 c + t, so a warp's rays are neighbouring pixels of a row. Up to 128
// triangles the scan is linear in authoring order
// (trace_common.cuh::LinearTris); above, on culled tables
// (kernels/chain_trace.py::pack_forward_tables_perm), it is
// CtaCulledTris: the CTA votes on the group and block boxes its rays'
// segments meet, copies each voted block into shared memory once with
// cp.async while the previous one is tested, and each warp tests a block
// only for the rays of its lanes that still meet it, one ray at a time
// with its 32 lanes on 4 triangles each, so no lane idles while another
// runs 128 tests. The depth and light loops are then CTA-uniform, so every
// thread reaches every barrier.
//
// Linear tables (the head box of the main path: 12 triangles, 5 planes, 2
// lights). What bounds them is the fp32 work of the tests, and the floor
// sits at twice roofline.py's bound: the bound counts each add and multiply
// as one operation against 67 TFLOP/s, a peak that counts an FMA as two,
// and the tests round every product on its own (trace_common.cuh::
// tri_test), so no FMA can pair them. An in-place scan (LinearTris, one
// thread per ray) also issues, beside that arithmetic, the tables' loads:
// nine 32-bit loads nine rows apart per triangle test, four per plane, six
// per light and five per material, each with its own address, every thread
// reloading the same entries for every ray. The staged route
// (trace_common.cuh::StagedScan) copies the tables once per CTA into shared
// memory as 16-byte entries, so a triangle test reads three 16-byte
// broadcast entries and a plane one, its scans stop at each family's last
// live slot (padded slots past it cost no test), and each thread traces
// kChainPacket neighbouring rays as one packet, so each entry loaded serves
// that many tests. Per ray the arithmetic, the test order and the exits are the
// in-place scan's. Tables whose stage passes kStageMaxBytes take the
// in-place scan: trace_common.cuh::trace_route chooses by size, and the
// wrapper (kernels/chain_trace.py) names and counts the route reported.
//
// The taping instantiations (kTape, linear tables on both routes) also
// write each ray's bounces to the chain tape (trace_common.cuh::ChainTape)
// for the head-box adjoint (chain_grad.cu): 40 bytes per bounce, stored
// coalesced across a warp's rays. Only a training step launches them
// (kernels/chain_grad.py::ChainTraceFused); render_hdr without gradients
// runs the kernels without kTape, whose code the tape does not touch.
#include "trace_common.cuh"

namespace {

// The staged route: kChainPacket neighbouring rays per thread (thread t of
// CTA c takes rays K (128 c + t) + k, k < K), and the CTAs per SM asked of
// the register allocator (7: 72 registers a thread). On the head box at
// 1080p on the H100 one ray a thread ran about as fast, but its frames
// differed from the in-place scan's in the last bits; 4 rays, and 4, 5, 6
// or 8 CTAs per SM, ran slower (PERF.md §6).
constexpr int kChainPacket = 2;
constexpr int kChainStagedMinCtas = 7;

template <class Tris, bool kTape = false>
__global__ void __launch_bounds__(rte::kCtaThreads, Tris::kMinCtas) chain_trace_kernel(
    rte::Tables T, const float* __restrict__ o, const float* __restrict__ d,
    float* __restrict__ out, long long n_rays, int max_depth, float bias, float min_weight,
    rte::ChainTape tape = rte::ChainTape{}) {
  Tris tris = Tris::make();
  const long long i = rte::ray_of_thread(n_rays);
  const bool valid = i >= 0;
  const long long k = valid ? i : 0;
  const float3 c = rte::trace_ray<Tris, kTape>(T, tris, valid, o[3 * k], o[3 * k + 1],
                                               o[3 * k + 2], d[3 * k], d[3 * k + 1],
                                               d[3 * k + 2], max_depth, bias, min_weight, tape, k);
  if (!valid) return;
  out[3 * i] = c.x;
  out[3 * i + 1] = c.y;
  out[3 * i + 2] = c.z;
}

template <int K, bool kTape = false>
__global__ void __launch_bounds__(rte::kCtaThreads, kChainStagedMinCtas) chain_trace_staged_kernel(
    rte::Tables T, const float* __restrict__ o, const float* __restrict__ d,
    float* __restrict__ out, long long n_rays, int max_depth, float bias, float min_weight,
    rte::ChainTape tape = rte::ChainTape{}) {
  const rte::StagedScan<K> sc = rte::StagedScan<K>::make(T);
  const long long i0 = K * (static_cast<long long>(blockIdx.x) * rte::kCtaThreads + threadIdx.x);
  if (i0 >= n_rays) return;  // no barrier follows the stage
  bool live[K];
  rte::Rays<K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    live[k] = i0 + k < n_rays;
    const long long j = 3 * (live[k] ? i0 + k : i0);
    r.ox[k] = o[j];
    r.oy[k] = o[j + 1];
    r.oz[k] = o[j + 2];
    r.dx[k] = d[j];
    r.dy[k] = d[j + 1];
    r.dz[k] = d[j + 2];
  }
  float3 c[K];
  rte::trace_packet<K, kTape>(sc, live, r, max_depth, bias, min_weight, c, tape, i0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (i0 + k >= n_rays) break;
    out[3 * (i0 + k)] = c[k].x;
    out[3 * (i0 + k) + 1] = c[k].y;
    out[3 * (i0 + k) + 2] = c[k].z;
  }
}

// One CTA stages the tables as the staged kernels do and writes each
// family's live extent (rte::StagedScan::make): spheres, planes, triangles,
// lights.
__global__ void __launch_bounds__(rte::kCtaThreads) stage_extents_kernel(rte::Tables T,
                                                                         int* __restrict__ out) {
  const rte::StagedScan<1> sc = rte::StagedScan<1>::make(T);
  if (threadIdx.x != 0) return;
  out[0] = sc.ns;
  out[1] = sc.np;
  out[2] = sc.nt;
  out[3] = sc.nl;
}

}  // namespace

// The scan is rte::trace_route's (culled, staged or in place), written to
// *route for the wrapper to name and count. A non-null `tape` (linear
// tables only: rte_chain_tape_floats(max_depth, n_rays) floats) takes the
// route's taping kernel.
extern "C" int rte_chain_trace(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* taabb, int n_blocks,
    const float* o, const float* d, float* out, int n_rays, int* route, float* tape,
    int max_depth, float bias, float min_weight, void* stream) {
  const rte::Tables T = rte::with_culling(
      rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat, mat_cols,
                       light, light_cols, nl),
      taabb, n_blocks);
  const rte::Route r = rte::trace_route(T);
  *route = r;
  if (n_rays <= 0) return 0;
  if (taabb && !rte::stageable(T)) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tape) {
    if (r == rte::kCulled) return static_cast<int>(cudaErrorInvalidValue);
    const rte::ChainTape tp{tape, n_rays, max_depth};
    if (r == rte::kStaged) {
      chain_trace_staged_kernel<kChainPacket, true>
          <<<rte::ray_ctas(n_rays, kChainPacket), rte::kCtaThreads, rte::stage_bytes(T), s>>>(
              T, o, d, out, n_rays, max_depth, bias, min_weight, tp);
    } else {
      chain_trace_kernel<rte::LinearTris, true><<<rte::ray_ctas(n_rays), rte::kCtaThreads, 0, s>>>(
          T, o, d, out, n_rays, max_depth, bias, min_weight, tp);
    }
  } else if (r == rte::kStaged) {
    chain_trace_staged_kernel<kChainPacket>
        <<<rte::ray_ctas(n_rays, kChainPacket), rte::kCtaThreads, rte::stage_bytes(T), s>>>(
            T, o, d, out, n_rays, max_depth, bias, min_weight);
  } else if (r == rte::kCulled) {
    chain_trace_kernel<rte::CtaCulledTris><<<rte::ray_ctas(n_rays), rte::kCtaThreads, 0, s>>>(
        T, o, d, out, n_rays, max_depth, bias, min_weight);
  } else {
    chain_trace_kernel<rte::LinearTris><<<rte::ray_ctas(n_rays), rte::kCtaThreads, 0, s>>>(
        T, o, d, out, n_rays, max_depth, bias, min_weight);
  }
  return static_cast<int>(cudaGetLastError());
}

// The live extents of linear tables on the staged route, into out[4] (device
// ints: spheres, planes, triangles, lights), for the wrapper's count of the
// slots the staged scans skip. *route is rte::trace_route's; on another
// route nothing is launched.
extern "C" int rte_stage_extents(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, int* out, int* route, void* stream) {
  const rte::Tables T = rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt,
                                         mat, mat_cols, light, light_cols, nl);
  const rte::Route r = rte::trace_route(T);
  *route = r;
  if (r != rte::kStaged) return 0;
  stage_extents_kernel<<<1, rte::kCtaThreads, rte::stage_bytes(T),
                         static_cast<cudaStream_t>(stream)>>>(T, out);
  return static_cast<int>(cudaGetLastError());
}

// CTAs per SM that the occupancy calculator gives each route (rte::Route;
// the staged one at the largest stage), taping (tape != 0: the linear
// routes) or not.
extern "C" int rte_chain_trace_occupancy(int route, int tape) {
  int n = 0;
  const auto occ = [&](auto kernel, int smem) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, rte::kCtaThreads, smem);
  };
  const int st = rte::kStageMaxBytes;
  const cudaError_t e =
      route == rte::kStaged
          ? (tape ? occ(chain_trace_staged_kernel<kChainPacket, true>, st)
                  : occ(chain_trace_staged_kernel<kChainPacket>, st))
      : route == rte::kCulled ? occ(chain_trace_kernel<rte::CtaCulledTris>, 0)
      : tape                  ? occ(chain_trace_kernel<rte::LinearTris, true>, 0)
                              : occ(chain_trace_kernel<rte::LinearTris>, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Floats of the chain tape of n_rays rays at max_depth (rte::ChainTape).
extern "C" long long rte_chain_tape_floats(int max_depth, int n_rays) {
  return rte::chain_tape_floats(max_depth, n_rays);
}

extern "C" const char* rte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
