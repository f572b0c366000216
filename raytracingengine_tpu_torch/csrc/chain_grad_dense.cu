// The dense adjoint of the chain trace: [R,3] rays and g = dL/d(rgb) ->
// cotangents of every scene table (summed over rays) and of each ray's
// origin and direction, for culled tables (above 128 triangles) or more than
// 512 primitives.
//
// Replaces raytracingengine_tpu/kernels/chain_grad.py::
// chain_grad_pallas_blocked (513-8,192 primitives) and
// chain_grad_pallas_streamed (past 8,192 triangles: the same adjoint with the
// triangle windows and their cotangents read, modified and written in HBM,
// race-free there only because the TPU grid runs in order). One kernel
// covers both: the tables stay in device memory at every size.
//
// The per-ray work is chain_grad.cu's (adjoint_common.cuh::
// chain_adjoint_ray): a state-only forward saving each bounce's state and
// closest hit (t, winner, tri column) in device memory, the sky term's VJP,
// and the bounces' hand-derived adjoints in reverse at their saved winners,
// the hit pulled back onto its one winner. The checkpoint's closest-hit scan
// is the adjoint's only one: the reverse pass rebuilds (t, n) from the saved
// winner and scans only for shadows. Every scan is the forward kernel's
// (trace_common.cuh) over the same packed tables the forward used
// (kernels/chain_grad.py keeps them for the backward), so the adjoint's
// winners are the forward's. On culled tables the scans are the
// CTA-cooperative CtaCulledTris; the checkpoint loop and the reverse loop
// then run from the CTA's deepest ray down, every thread through every
// barrier.
//
// Table cotangents, two sinks (the kernel's template parameter; the
// wrapper picks one by bytes, kernels/chain_grad.py::dense_sink, and
// counts it):
//   * DenseSink, where they fit one block's shared memory (beside the culled
//     scan's staging): spheres, planes, lights and the material columns of
//     spheres and planes in the block's shared-memory accumulator, written
//     as per-block partials and summed by partials_reduce_kernel in a fixed
//     order, as chain_grad.cu does;
//   * GlobalSink, past that (about 5,281 spheres and planes with one
//     light): only the lights stay in shared memory and in the partials
//     (every lit ray adds to every light's column, so in device memory they
//     would contend the most), and the sphere, plane and material
//     cotangents go to zeroed device memory as the triangles' do below: no
//     [entries, blocks] partials, which at 6,000 spheres would take ~0.5 GB
//     at 512x512 and several GB at 1080p.
// In both:
//   * the triangle rows (12 of each tri table column, in scan order) and the
//     triangles' material columns (6 rows, at the original index) straight
//     into zeroed device memory: 3.7 MB at 50,800 triangles, far more than a
//     block's shared memory. A warp first sums each entry over its lanes with
//     shuffles where all its contributing lanes share the winner (neighbouring
//     rays mostly do); lanes then add the column's sums with global
//     atomicAdds (add_column), else each lane adds its own. This replaces the
//     TPU's in-order read-modify-write, which would be a race on a GPU.
// Tolerance: the global atomics land in an order that changes from run to
// run, so the triangle and triangle-material cotangents (and, on the
// global sink, the sphere, plane and material ones) do too, by the
// rounding of an fp32 sum of up to ~10^5 terms in another order: changes
// of order 1e-6 of an entry's magnitude. Two calls may differ by at most
// 1e-4 of each output's largest entry (chip_smoke.py phase 16 checks it),
// far inside parity.table_cot_rows (1e-3 of the row's largest entry + 2e-3
// of the entry), which holds each table row to its plain version.
//
// What bounds it on the H100: the fp32 work of the intersection tests (the
// forward's culled scans: one closest hit per bounce, the shadow scans) and
// divergence; per ray 36 bytes in, 24 out, and the tables read and their
// cotangents written once. This design runs each of those scans once, and
// adds 40 bytes of saved state and winner per bounce each way and one
// global atomic per warp and winner entry.
#include "adjoint_common.cuh"

namespace {

// Sphere, plane and light cotangents in the block's shared accumulator (its
// mat part has one column per sphere and plane), triangle and
// triangle-material cotangents in device memory.
struct DenseSink {
  float* acc;
  Offsets off;
  float* gtri;  // [tri rows, tri_cols], zeroed by the wrapper
  float* gmat;  // [7, mat_cols], zeroed; only triangle columns are added here

  __device__ __forceinline__ void light(bool lit, int li, int cols, const float (&v)[6]) {
    add_column<6>(acc, lit, off.light + li, cols, 6, v);
  }

  __device__ __forceinline__ void hit(const Tables& T, bool hit, int gi, int tc,
                                      const float (&mcot)[6], const float (&pc)[12]) {
    const int nsp = T.ns + T.np;
    const bool tri = gi >= nsp;
    int pbase = 0, pcols = 0;
    if (hit && !tri) {
      if (gi < T.ns) {
        pbase = off.sph + gi; pcols = T.sph_cols;
      } else {
        pbase = off.pl + gi - T.ns; pcols = T.pl_cols;
      }
    }
    add_column<6>(acc, hit && !tri, off.mat + gi, nsp, 6, mcot);
    add_column<12>(acc, hit && !tri, pbase, pcols, 4, pc);
    add_column<6>(gmat, hit && tri, gi, T.mat_cols, 6, mcot);
    add_column<12>(gtri, hit && tri, tc, T.tri_cols, 12, pc);
  }
};

template <class Tris>
__global__ void __launch_bounds__(kChainThreads, Tris::kMinCtasAdjoint) chain_grad_dense_kernel(
    Tables T, Offsets off, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ g, float* __restrict__ go, float* __restrict__ gd,
    long long n_rays, float* __restrict__ states, float* __restrict__ partials,
    float* gtri, float* gmat, int max_depth, float bias, float min_weight) {
  extern __shared__ float acc[];
  Tris tris = Tris::make();
  for (int j = threadIdx.x; j < off.total; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  DenseSink sink{acc, off, gtri, gmat};
  chain_adjoint_ray(T, sink, tris, o, d, g, go, gd, n_rays, rte::ray_of_thread(n_rays), states,
                    max_depth, bias, min_weight);
  write_partials(acc, off.total, partials);
}

// Past one block's shared memory: the light cotangents in the block's
// shared accumulator ([7, light_cols]: its partials), the sphere and plane
// rows (`gsp`, laid out as the shared accumulator's first two tables:
// [4, sph_cols] then [4, pl_cols]), every material column and the
// triangle rows in zeroed device memory, each by the warp-summed atomics of
// add_column.
struct GlobalSink {
  float* acc;
  float* gsp;
  float* gtri;
  float* gmat;

  __device__ __forceinline__ void light(bool lit, int li, int cols, const float (&v)[6]) {
    add_column<6>(acc, lit, li, cols, 6, v);
  }

  __device__ __forceinline__ void hit(const Tables& T, bool hit, int gi, int tc,
                                      const float (&mcot)[6], const float (&pc)[12]) {
    const bool tri = gi >= T.ns + T.np;
    int pbase = 0, pcols = 0;
    if (hit && !tri) {
      if (gi < T.ns) {
        pbase = gi; pcols = T.sph_cols;
      } else {
        pbase = 4 * T.sph_cols + gi - T.ns; pcols = T.pl_cols;
      }
    }
    add_column<6>(gmat, hit, gi, T.mat_cols, 6, mcot);
    add_column<12>(gsp, hit && !tri, pbase, pcols, 4, pc);
    add_column<12>(gtri, hit && tri, tc, T.tri_cols, 12, pc);
  }
};

template <class Tris>
__global__ void __launch_bounds__(kChainThreads, Tris::kMinCtasAdjoint) chain_grad_dense_global_kernel(
    Tables T, int light_total, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ g, float* __restrict__ go, float* __restrict__ gd,
    long long n_rays, float* __restrict__ states, float* __restrict__ partials, float* gsp,
    float* gtri, float* gmat, int max_depth, float bias, float min_weight) {
  extern __shared__ float acc[];
  Tris tris = Tris::make();
  for (int j = threadIdx.x; j < light_total; j += blockDim.x) acc[j] = 0.0f;
  __syncthreads();
  GlobalSink sink{acc, gsp, gtri, gmat};
  chain_adjoint_ray(T, sink, tris, o, d, g, go, gd, n_rays, rte::ray_of_thread(n_rays), states,
                    max_depth, bias, min_weight);
  write_partials(acc, light_total, partials);
}

template <class Tris>
cudaError_t launch_global(const Tables& T, int light_total, cudaStream_t stream, const float* o,
                          const float* d, const float* g, float* go, float* gd, long long n_rays,
                          float* states, float* partials, float* gsp, float* gtri, float* gmat,
                          int max_depth, float bias, float min_weight) {
  const size_t smem = sizeof(float) * static_cast<size_t>(light_total);
  const cudaError_t e = allow_smem(chain_grad_dense_global_kernel<Tris>, smem);
  if (e != cudaSuccess) return e;
  chain_grad_dense_global_kernel<Tris><<<rte::ray_ctas(n_rays), kChainThreads, smem, stream>>>(
      T, light_total, o, d, g, go, gd, n_rays, states, partials, gsp, gtri, gmat, max_depth, bias,
      min_weight);
  return cudaGetLastError();
}

template <class Tris>
cudaError_t launch_dense(const Tables& T, const Offsets& off, size_t smem, cudaStream_t stream,
                         const float* o, const float* d, const float* g, float* go, float* gd,
                         long long n_rays, float* states, float* partials, float* gtri,
                         float* gmat, int max_depth, float bias, float min_weight) {
  const cudaError_t e = allow_smem(chain_grad_dense_kernel<Tris>, smem);
  if (e != cudaSuccess) return e;
  chain_grad_dense_kernel<Tris><<<rte::ray_ctas(n_rays), kChainThreads, smem, stream>>>(
      T, off, o, d, g, go, gd, n_rays, states, partials, gtri, gmat, max_depth, bias,
      min_weight);
  return cudaGetLastError();
}

}  // namespace

// Sinks, in `sink` (the wrapper's choice): kSharedSink, whose `total` is
// the shared accumulator's size, 4 sph_cols + 4 pl_cols + 7 (ns + np) +
// 7 light_cols floats, and whose `partials` hold one column per 128-ray
// CTA of it; or kGlobalSink, whose `total` is 7 light_cols (the lights'
// accumulator and partials), with `gsp` [4 sph_cols + 4 pl_cols] zeroed
// beside the zeroed gtri and gmat.
// The shared sink refuses an accumulator that does not fit beside the
// culled scan's staging (kernels/chain_grad.py::dense_sink decides).
enum Sink { kSharedSink = 0, kGlobalSink = 1 };

extern "C" int rte_chain_grad_dense(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* taabb, int n_blocks,
    const float* o, const float* d, const float* g, float* go, float* gd, int n_rays,
    float* states, float* partials, int total, float* gtri, float* gmat, float* gsp, int sink,
    int max_depth, float bias, float min_weight, void* stream) {
  if (n_rays <= 0) return 0;
  const Tables T = rte::with_culling(
      rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat, mat_cols,
                       light, light_cols, nl),
      taabb, n_blocks);
  if (taabb && !rte::stageable(T)) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (sink == kGlobalSink) {
    if (total != 7 * light_cols || gsp == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    e = taabb ? launch_global<rte::CtaCulledTris>(T, total, s, o, d, g, go, gd, n_rays, states,
                                                  partials, gsp, gtri, gmat, max_depth, bias,
                                                  min_weight)
              : launch_global<rte::LinearTris>(T, total, s, o, d, g, go, gd, n_rays, states,
                                               partials, gsp, gtri, gmat, max_depth, bias,
                                               min_weight);
  } else {
    const Offsets off = make_offsets(sph_cols, pl_cols, 0, ns + np, light_cols);
    const size_t smem = sizeof(float) * static_cast<size_t>(total);
    const size_t stage = taabb ? sizeof(rte::Stage) : 0;
    if (sink != kSharedSink || off.total != total ||
        smem + stage > static_cast<size_t>(rte::kBlockSmemMaxBytes))
      return static_cast<int>(cudaErrorInvalidValue);
    e = taabb ? launch_dense<rte::CtaCulledTris>(T, off, smem, s, o, d, g, go, gd, n_rays, states,
                                                 partials, gtri, gmat, max_depth, bias, min_weight)
              : launch_dense<rte::LinearTris>(T, off, smem, s, o, d, g, go, gd, n_rays, states,
                                              partials, gtri, gmat, max_depth, bias, min_weight);
  }
  return static_cast<int>(e);
}

// CTAs per SM that the occupancy calculator gives each instantiation with
// `smem` bytes of accumulator, on the shared sink (global_sink 0) or the
// global one (1).
template <class K>
int occupancy(K kernel, int smem) {
  int n = 0;
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kChainThreads, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int rte_chain_grad_dense_occupancy(int culled, int smem, int global_sink) {
  if (global_sink)
    return culled ? occupancy(chain_grad_dense_global_kernel<rte::CtaCulledTris>, smem)
                  : occupancy(chain_grad_dense_global_kernel<rte::LinearTris>, smem);
  return culled ? occupancy(chain_grad_dense_kernel<rte::CtaCulledTris>, smem)
                : occupancy(chain_grad_dense_kernel<rte::LinearTris>, smem);
}
