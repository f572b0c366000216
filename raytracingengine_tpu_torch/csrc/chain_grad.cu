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
// a CTA takes a 32x4 pixel tile, `ray_of_tile_thread`): a state-only
// forward saving each bounce's state and closest hit in device memory, the
// sky term's VJP, then the bounces' adjoints in reverse
// at their saved winners, with the warp's lanes in step (adjoint_common.cuh::
// chain_adjoint_ray, which chain_grad_dense.cu shares). The tables here are
// never culled, so the scans are the linear ones (LinearTris).
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
// ray at 3.35 TB/s. The fp32 rate is the bound. This design runs the
// function's scans once each (the checkpoint's closest hits, the reverse
// pass's shadow scans) and adds 40 bytes of saved state and winner per
// bounce each way.
//
// What the design does about it: one thread per ray with per-ray exits (the
// depth loop, the shadow scan's first blocker), the forward kernel's
// per-primitive tests (trace_common.cuh) for every hit decision, so the
// adjoint follows the same path the forward traced; the shadow scans run
// only in the reverse loop, once per bounce. Table cotangents stay in shared
// memory until the block ends: one device-memory write per entry and block.
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

__global__ void __launch_bounds__(kChainThreads) chain_grad_kernel(
    Tables T, Offsets off, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ g, float* __restrict__ go, float* __restrict__ gd,
    long long n_rays, int width, float* __restrict__ states, float* __restrict__ partials,
    int max_depth, float bias, float min_weight) {
  extern __shared__ float acc[];
  for (int j = threadIdx.x; j < off.total; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  SmemSink sink{acc, off};
  rte::LinearTris tris;
  chain_adjoint_ray(T, sink, tris, o, d, g, go, gd, n_rays, ray_of_tile_thread(n_rays, width),
                    states, max_depth, bias, min_weight);
  write_partials(acc, off.total, partials);
}

}  // namespace

extern "C" int rte_chain_grad(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* o, const float* d,
    const float* g, float* go, float* gd, int n_rays, int width, float* states, float* partials,
    int total, int n_ctas, int max_depth, float bias, float min_weight, void* stream) {
  if (n_rays <= 0) return 0;
  const Tables T = rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt,
                                    mat, mat_cols, light, light_cols, nl);
  const Offsets off = make_offsets(sph_cols, pl_cols, tri_cols, mat_cols, light_cols);
  if (off.total != total) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(total);
  const cudaError_t e = allow_smem(chain_grad_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // `partials` holds one column per CTA: n_ctas, the wrapper's count of the map's CTAs
  if (map_ctas(n_rays, width) != n_ctas) return static_cast<int>(cudaErrorInvalidValue);
  chain_grad_kernel<<<n_ctas, kChainThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      T, off, o, d, g, go, gd, n_rays, width, states, partials, max_depth, bias, min_weight);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rte_chain_grad_occupancy(int smem) {
  int n = 0;
  if (allow_smem(chain_grad_kernel, smem) != cudaSuccess) return -1;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, chain_grad_kernel, kChainThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int rte_chain_grad_reduce(const float* partials, int total, int n_blocks, float* out,
                                     void* stream) {
  return reduce_partials(partials, total, n_blocks, out, static_cast<cudaStream_t>(stream));
}
