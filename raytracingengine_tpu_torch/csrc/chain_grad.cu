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
// Per ray, one thread (128-thread blocks; given the ray block's image width,
// a CTA takes a 32x4 pixel tile, `ray_of_tile_thread`): the sky term's VJP,
// then the bounces' adjoints in reverse at the states and winners that the
// forward wrote to its tape (rte::ChainTape: kernels/chain_grad.py's
// ChainTraceFused runs chain_trace's taping instantiation when gradients
// are needed), with the warp's lanes in step (adjoint_common.cuh::
// reverse_bounces, which chain_grad_dense.cu shares). The adjoint runs no
// closest-hit scan: it differentiates the path the frame was rendered on.
// Its shadow scans take the route rte::grad_route decides: the tables
// staged in shared memory (rte::StagedTris, the forward's stage, one ray a
// thread) where the stage and the accumulator fit one block, else the
// tables in place (LinearTris); the entry point reports the route.
// Table cotangents: every table entry has one float of a block-wide
// accumulator in shared memory (at 512 triangles 19 * 512 floats, 38.9 KB,
// plus 7 floats per light), after the stage. Every ray adds to the same
// light entries, and neighbouring rays mostly to the same primitive's, so
// per-lane atomics on those addresses serialise. A warp first sums a
// column's values over its lanes with a transposing butterfly of shuffles
// when all its contributing lanes share the column, and a few lanes add the
// sums (`add_column`); otherwise each lane adds its own. Each block writes its accumulator as
// one partial, [entry][block]; a second kernel sums each entry's partials
// in a fixed order (a strided per-thread sum, then a tree in shared
// memory). So a run differs from the next only by the order of the atomics
// of a block's four warps.
//
// What bounds it on the H100: fp32 work and divergence, as the forward
// kernel. Per ray it reads g (12 bytes) and the tape (40 bytes per bounce
// taken and 16 more) and writes d_o and d_d (24 bytes): ~250 bytes per ray
// on the head box at 1080p (five bounces per ray). Its function needs the
// shadow scans (the closest hits are the tape's), and their intersection
// tests are thousands of fp32 operations per ray (roofline.py's count in
// chip_smoke.py, which leaves out the shading and the adjoint arithmetic,
// so it is a lower bound). chip_smoke.py prints which of the two bounds it.
//
// What the design does about it: one thread per ray with per-ray exits (the
// depth loop, the shadow scan's first blocker), the forward kernel's
// per-primitive tests (trace_common.cuh), the winners the forward took, and
// each table entry of a shadow test read from shared memory once per test
// where the stage fits. Table cotangents stay in shared memory until the
// block ends: one device-memory write per entry and block.
#include <type_traits>

#include "adjoint_common.cuh"

namespace {

// Thread-to-ray map (kernels/chain_trace.py::thread_rays mirrors it). With
// the image width of the ray block's rows, warp w of a CTA takes row w of a
// 32x4 pixel tile, so the lanes that step through the reverse loop together
// are neighbours in two dimensions, with similar chain depths (faster than
// the identity on the head box at 1080p on the H100, PERF.md); width 0 is
// the identity of the other chain kernels.
constexpr int kTileW = 32, kTileH = kChainThreads / kTileW;

// CTAs of a launch over n rays: one per 128 rays (width 0), else one per
// pixel tile of the rows of `width` rays that hold them.
inline long long map_ctas(long long n, int width) {
  if (width <= 0) return rte::ray_ctas(n);
  const long long rows = (n + width - 1) / width;
  return static_cast<long long>((width + kTileW - 1) / kTileW) * ((rows + kTileH - 1) / kTileH);
}

// This thread's ray, or -1: width 0 is rte::ray_of_thread; else the tiles
// lie in row-major order, thread t of a CTA takes the pixel (t % 32, t / 32)
// of its tile, and the ray is row * width + column. A pixel past the width
// or past the last ray has none.
__device__ __forceinline__ long long ray_of_tile_thread(long long n, int width) {
  if (width <= 0) return rte::ray_of_thread(n);
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int x = (blockIdx.x % tiles_x) * kTileW + threadIdx.x % kTileW;
  const long long y = static_cast<long long>(blockIdx.x / tiles_x) * kTileH + threadIdx.x / kTileW;
  const long long i = y * width + x;
  return (x < width && i < n) ? i : -1;
}

// Every table's cotangents in the block's shared accumulator.
struct SmemSink {
  float* acc;
  Offsets off;

  __device__ __forceinline__ void light(bool lit, int li, int cols, const float (&v)[6]) {
    add_column<6>(acc, lit, off.light + li, cols, 6, v);
  }

  __device__ __forceinline__ void hit(const Tables& T, bool hit, int gi, int tc,
                                      const float (&mcot)[6], const float (&pc)[12]) {
    int pbase = 0, pcols = 0, prows = 0;
    if (hit) {
      if (gi < T.ns) {
        pbase = off.sph + gi; pcols = T.sph_cols; prows = 4;
      } else if (gi < T.ns + T.np) {
        pbase = off.pl + gi - T.ns; pcols = T.pl_cols; prows = 4;
      } else {
        pbase = off.tri + tc; pcols = T.tri_cols; prows = 12;
      }
    }
    add_column<6>(acc, hit, off.mat + gi, T.mat_cols, 6, mcot);
    add_column<12>(acc, hit, pbase, pcols, prows, pc);
  }
};

// The ray's adjoint from the tape: the depth-exhaustion sky term's VJP
// seeds the state cotangent, then reverse_bounces; -1: no ray.
template <class Sink, class Tris>
__device__ __forceinline__ void taped_adjoint_ray(
    const Tables& T, Sink& sink, Tris& tris, const float* __restrict__ tape,
    const float* __restrict__ g, float* __restrict__ go, float* __restrict__ gd, long long n,
    long long i, int max_depth, float bias, float min_weight) {
  const bool valid = i >= 0;
  float gr = 0.0f, gg = 0.0f, gb = 0.0f;
  int nd = 0;
  RayCot c{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f};
  if (valid) {
    gr = g[3 * i]; gg = g[3 * i + 1]; gb = g[3 * i + 2];
    const float* end = tape + static_cast<long long>(max_depth) * kStateRows * n + i;
    nd = __float_as_int(end[0]);
    if (__float_as_int(end[n]))  // the chain reached max_depth: its sky term
      sky_adjoint(Ray{{0.0f, 0.0f, 0.0f}, {0.0f, end[2 * n], 0.0f}, end[3 * n]}, c, gr, gg, gb);
  }
  const Ray idle{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 1.0f}, 1.0f};
  reverse_bounces(T, sink, tris, tape, n, i, nd, idle, c, gr, gg, gb, bias, min_weight);
  if (valid) {
    go[3 * i] = c.o.x; go[3 * i + 1] = c.o.y; go[3 * i + 2] = c.o.z;
    gd[3 * i] = c.d.x; gd[3 * i + 1] = c.d.y; gd[3 * i + 2] = c.d.z;
  }
}

// Every thread of the CTA calls it once (the staged scan's copy and barrier).
template <class Scan>
__device__ __forceinline__ Scan make_scan(const Tables& T) {
  if constexpr (std::is_same_v<Scan, rte::StagedTris>) {
    return rte::StagedTris::make(T);
  } else {
    return rte::LinearTris::make();
  }
}

// Scan: rte::StagedTris or rte::LinearTris, as rte::grad_route decides.
// Dynamic shared memory: the stage (staged route), then the accumulator.
template <class Scan>
__global__ void __launch_bounds__(kChainThreads) chain_grad_kernel(
    Tables T, Offsets off, const float* __restrict__ tape, const float* __restrict__ g,
    float* __restrict__ go, float* __restrict__ gd, long long n_rays, int width,
    float* __restrict__ partials, int max_depth, float bias, float min_weight) {
  constexpr bool kStaged = std::is_same_v<Scan, rte::StagedTris>;
  extern __shared__ float4 smem[];  // the stage's alias too (StagedScan::make)
  float* acc = reinterpret_cast<float*>(smem + (kStaged ? rte::stage_layout(T).n : 0));
  for (int j = threadIdx.x; j < off.total; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  Scan tris = make_scan<Scan>(T);
  SmemSink sink{acc, off};
  taped_adjoint_ray(T, sink, tris, tape, g, go, gd, n_rays, ray_of_tile_thread(n_rays, width),
                    max_depth, bias, min_weight);
  write_partials(acc, off.total, partials);
}

// Launch the route's kernel with `smem` bytes of dynamic shared memory.
template <class Scan>
cudaError_t launch_grad(const Tables& T, const Offsets& off, size_t smem, int n_ctas,
                        cudaStream_t s, const float* tape, const float* g, float* go, float* gd,
                        long long n_rays, int width, float* partials, int max_depth, float bias,
                        float min_weight) {
  const cudaError_t e = allow_smem(chain_grad_kernel<Scan>, smem);
  if (e != cudaSuccess) return e;
  chain_grad_kernel<Scan><<<n_ctas, kChainThreads, smem, s>>>(
      T, off, tape, g, go, gd, n_rays, width, partials, max_depth, bias, min_weight);
  return cudaGetLastError();
}

}  // namespace

// The adjoint of ray block [n_rays] from the taping forward's `tape`
// (rte::ChainTape, written by rte_chain_trace at the same max_depth). The
// scan of its shadow rays is rte::grad_route's (staged or in place),
// written to *route for the wrapper to name and count.
extern "C" int rte_chain_grad(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* tape, const float* g, float* go,
    float* gd, int n_rays, int width, float* partials, int total, int n_ctas, int* route,
    int max_depth, float bias, float min_weight, void* stream) {
  const Tables T = rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt,
                                    mat, mat_cols, light, light_cols, nl);
  const Offsets off = make_offsets(sph_cols, pl_cols, tri_cols, mat_cols, light_cols);
  if (off.total != total) return static_cast<int>(cudaErrorInvalidValue);
  const size_t acc = sizeof(float) * static_cast<size_t>(total);
  const rte::Route r = rte::grad_route(T, static_cast<int>(acc));
  *route = r;
  if (n_rays <= 0) return 0;
  // `partials` holds one column per CTA: n_ctas, the wrapper's count of the map's CTAs
  if (map_ctas(n_rays, width) != n_ctas) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      r == rte::kStaged
          ? launch_grad<rte::StagedTris>(T, off, rte::stage_bytes(T) + acc, n_ctas, s, tape, g, go,
                                         gd, n_rays, width, partials, max_depth, bias, min_weight)
          : launch_grad<rte::LinearTris>(T, off, acc, n_ctas, s, tape, g, go, gd, n_rays, width,
                                         partials, max_depth, bias, min_weight);
  return static_cast<int>(e);
}

// CTAs per SM of the route's kernel (rte::Route: staged or in place) with an
// accumulator of acc_bytes (the staged one at the largest stage).
extern "C" int rte_chain_grad_occupancy(int route, int acc_bytes) {
  int n = 0;
  const int smem = acc_bytes + (route == rte::kStaged ? rte::kStageMaxBytes : 0);
  const auto occ = [&](auto kernel) {
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kChainThreads, smem);
  };
  const cudaError_t e = route == rte::kStaged ? occ(chain_grad_kernel<rte::StagedTris>)
                                              : occ(chain_grad_kernel<rte::LinearTris>);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int rte_chain_grad_reduce(const float* partials, int total, int n_blocks, float* out,
                                     void* stream) {
  return reduce_partials(partials, total, n_blocks, out, static_cast<cudaStream_t>(stream));
}
