// Wavefront (full Whitted) trace kernel: [R,3] ray origins and directions
// -> [R,3] HDR, with refraction, Schlick Fresnel, TIR and march or binary
// shadows.
//
// Replaces raytracingengine_tpu/kernels/wavefront_trace.py::
// wavefront_trace_pallas, its culled scan (_tri_scan_blocked) included. The
// TPU kernel keeps a [cap, 8, SUB, LANE] ray
// stack in VMEM and pushes and pops with one-hot selects over cap for a
// tile of lanes. Here one thread traces one ray: its stack is a local
// array of kMaxCap nodes indexed by sp (trace_common.cuh::
// trace_wavefront_ray), its DFS ends when its own stack is empty, and its
// shadow march when its own shadow ray is done.
//
// What bounds it on the H100: the issue of each popped node's instructions.
// A ray reads 24 bytes and writes 12; its work is a tree of closest-hit
// scans, each with a shadow march (or an any-hit scan) per light, and the
// node's shading and children. Measured at 1080p on the glass sphere
// (PERF.md §6): the trees of a warp's 32 rays keep 97% of its lanes
// busy (the same rays sorted by their tree size ran 1-3% faster), the
// stack in local memory costs nothing measurable (in shared memory, or cut
// to 12 nodes, no faster), and one node per ray takes half the time of the
// whole tree, so the time is the node's own instruction stream. What the
// design does about it: a hit whose material can push no child (opaque and
// not specular: the floor's and most of a frame's) skips node_children's
// Fresnel and child arithmetic (trace_common.cuh::trace_wavefront_ray);
// per-ray exits end work the TPU kernel could only skip when a whole tile
// agreed; consecutive rays are neighbouring pixels; and a dropped push
// (stack full, which cap = max_depth + 2 rules out) is counted into
// *dropped for the wrapper to read, never silent.
//
// Above 128 triangles render_hdr hands the kernel culled tables
// (kernels/chain_trace.py::pack_forward_tables_perm: blocks of 128
// triangles in a spatial order, a box per block and per group of 8
// blocks), and its culled instantiation runs the same DFS as
// trace_common.cuh::trace_wavefront_warp over WarpCulledTris. A ray's
// segments meet few blocks (23 of 47 a ray on the transparent
// 6,016-triangle glass mesh at 1080p, PERF.md §6), but the lanes of a warp
// meet different ones: a loop per lane over its own blocks runs as long as
// its busiest lane, 98 block turns of the warp a ray with the lanes busy
// in 23% of them. The TPU kernel's tile-synchronous DFS
// (_dfs_trace_tile, _tri_scan_blocked) tests a block for the whole tile
// once any lane meets it. Here the warp stays the tile but shares the
// work: its loops vote (the DFS while any lane has a node, the march while
// any lane marches), its lanes vote on the boxes, and each met block,
// copied once into the warp's shared memory, is tested for each ray that
// needs it by the 32 lanes together, 4 triangles a lane, with warp
// reductions for the winner. The tests issued follow the lanes' own need,
// 29 turns a ray with the votes: 4.1x faster than the loop per lane on
// that mesh (PERF.md §6). A lane
// whose ray is done, or past the last ray, joins the votes with nothing to
// test. Its frame and pop counts are the linear instantiation's bit for
// bit.
//
// The counting instantiation (kCount) also writes, for each warp of 32
// consecutive rays, the most nodes any of its rays popped: the glass
// adjoint (wavefront_grad.cu) sizes its warp-interleaved tape by these
// counts. Every lane of a warp traces, a lane past the last ray tracing
// the last ray again without writing it, so that the trace is not inside a
// branch: so built it takes the plain kernel's 80 registers (a branch
// around the trace took 96, one CTA per SM fewer, and ran 11-13% slower).
// Only a training step launches it (kernels/wavefront_grad.py::
// WavefrontTraceFused); render_hdr without gradients runs the kernel
// without kCount.
#include "trace_common.cuh"

namespace {

// One thread's ray over the scan Tris: the linear kernels' body.
template <class Tris, bool kCount>
__device__ __forceinline__ void trace_thread(
    const rte::Tables& T, const rte::WavefrontParams& P, const float* __restrict__ o,
    const float* __restrict__ d, float* __restrict__ out, int n_rays, int* __restrict__ dropped,
    int* __restrict__ warp_pops) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (!kCount) {
    if (i >= n_rays) return;
  }
  const long long j = kCount ? min(i, static_cast<long long>(n_rays) - 1) : i;  // the ray traced
  int pops = 0, n_dropped = 0;
  Tris tris = Tris::make();
  const float3 c = rte::trace_wavefront_ray(T, tris, P, o[3 * j], o[3 * j + 1], o[3 * j + 2],
                                            d[3 * j], d[3 * j + 1], d[3 * j + 2], pops,
                                            n_dropped);
  if (i < n_rays) {
    out[3 * i] = c.x;
    out[3 * i + 1] = c.y;
    out[3 * i + 2] = c.z;
    if (n_dropped) atomicAdd(dropped, n_dropped);
  }
  if constexpr (kCount) {  // every lane of the warp is here; one past the end repeats the last ray
    const int most = __reduce_max_sync(rte::kFullMask, pops);
    const long long w = i >> 5;
    if ((threadIdx.x & 31) == 0 && (w << 5) < n_rays) warp_pops[w] = most;
  }
}

// Linear tables: the compiler's register count (80).
template <bool kCount>
__global__ void __launch_bounds__(128) wavefront_trace_kernel(
    rte::Tables T, rte::WavefrontParams P, const float* __restrict__ o,
    const float* __restrict__ d, float* __restrict__ out, int n_rays, int* __restrict__ dropped,
    int* __restrict__ warp_pops) {
  trace_thread<rte::LinearTris, kCount>(T, P, o, d, out, n_rays, dropped, warp_pops);
}

// Culled tables (above 128 triangles): the warp scans together, so every
// lane stays in the trace; a lane past the last ray traces nothing but
// joins its warp's votes.
template <bool kCount>
__global__ void __launch_bounds__(128, rte::WarpCulledTris::kMinCtas) wavefront_trace_culled_kernel(
    rte::Tables T, rte::WavefrontParams P, const float* __restrict__ o,
    const float* __restrict__ d, float* __restrict__ out, int n_rays, int* __restrict__ dropped,
    int* __restrict__ warp_pops) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_rays;
  const long long j = valid ? i : 0;
  int pops = 0, n_dropped = 0;
  const float3 c = rte::trace_wavefront_warp(T, P, valid, o[3 * j], o[3 * j + 1], o[3 * j + 2],
                                             d[3 * j], d[3 * j + 1], d[3 * j + 2], pops,
                                             n_dropped);
  if (valid) {
    out[3 * i] = c.x;
    out[3 * i + 1] = c.y;
    out[3 * i + 2] = c.z;
    if (n_dropped) atomicAdd(dropped, n_dropped);
  }
  if constexpr (kCount) {
    const int most = __reduce_max_sync(rte::kFullMask, pops);
    const long long w = i >> 5;
    if ((threadIdx.x & 31) == 0 && (w << 5) < n_rays) warp_pops[w] = most;
  }
}

}  // namespace

extern "C" int rte_wavefront_trace(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* taabb, int n_blocks,
    const float* o, const float* d, float* out, int n_rays, int max_depth, float bias,
    float min_weight, int march, int shadow_max_steps, float shadow_min_t, int budget,
    int* dropped, int* warp_pops, void* stream) {
  if (max_depth < 0 || max_depth + 2 > rte::kMaxCap) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return 0;
  const rte::Tables T = rte::with_culling(
      rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat, mat_cols,
                       light, light_cols, nl),
      taabb, n_blocks);
  const rte::WavefrontParams P{max_depth, bias, min_weight, march, shadow_max_steps,
                               shadow_min_t, budget};
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (T.taabb) {
    if (warp_pops) {
      wavefront_trace_culled_kernel<true><<<blocks, threads, 0, s>>>(T, P, o, d, out, n_rays,
                                                                    dropped, warp_pops);
    } else {
      wavefront_trace_culled_kernel<false><<<blocks, threads, 0, s>>>(T, P, o, d, out, n_rays,
                                                                     dropped, nullptr);
    }
  } else if (warp_pops) {
    wavefront_trace_kernel<true><<<blocks, threads, 0, s>>>(T, P, o, d, out, n_rays, dropped,
                                                           warp_pops);
  } else {
    wavefront_trace_kernel<false><<<blocks, threads, 0, s>>>(T, P, o, d, out, n_rays, dropped,
                                                            nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs per SM of the kernel, counting (count != 0) or not, on culled tables
// (culled != 0) or linear ones.
extern "C" int rte_wavefront_trace_occupancy(int count, int culled) {
  int n = 0;
  const auto occ = [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 128, 0);
  };
  const cudaError_t e = culled ? (count ? occ(wavefront_trace_culled_kernel<true>)
                                        : occ(wavefront_trace_culled_kernel<false>))
                               : (count ? occ(wavefront_trace_kernel<true>)
                                        : occ(wavefront_trace_kernel<false>));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
