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
// scans plus one shadow scan per light and bounce; the scene tables are
// read by every thread of a warp at the same address where the warp's rays
// visit the same blocks (broadcast loads through the read-only cache).
// Neighbouring rays follow different paths (miss, short chain, long
// reflection chain; shadowed or not; other blocks), so the cost of a warp is
// that of its slowest ray.
//
// What the design does about it: one thread per ray, so per-ray early exits
// (miss, pruned chain, first shadow blocker) end work that the TPU kernel
// could only skip when a whole tile agreed. Consecutive rays are
// neighbouring pixels, which keeps a warp's paths similar. Up to 128
// triangles the scan is linear in authoring order; above, on culled tables
// (kernels/chain_trace.py::pack_forward_tables_perm), each ray tests the
// group and block boxes against its segment and scans only the blocks its
// segment meets, front to back so that the closest hit's bound shrinks
// early. The culling is per ray, the simple first version: warp-cooperative
// traversal, blocks staged in shared memory and a deeper BVH are later work.
#include "trace_common.cuh"

namespace {

__global__ void __launch_bounds__(128) chain_trace_kernel(
    rte::Tables T, const float* __restrict__ o, const float* __restrict__ d,
    float* __restrict__ out, int n_rays, int max_depth, float bias, float min_weight) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float3 c = rte::trace_ray(T, o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
                                  d[3 * i + 1], d[3 * i + 2], max_depth, bias, min_weight);
  out[3 * i] = c.x;
  out[3 * i + 1] = c.y;
  out[3 * i + 2] = c.z;
}

}  // namespace

extern "C" int rte_chain_trace(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* taabb, int n_blocks,
    const float* o, const float* d, float* out, int n_rays, int max_depth, float bias,
    float min_weight, void* stream) {
  if (n_rays <= 0) return 0;
  const rte::Tables T = rte::with_culling(
      rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat, mat_cols,
                       light, light_cols, nl),
      taabb, n_blocks);
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  chain_trace_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      T, o, d, out, n_rays, max_depth, bias, min_weight);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rte_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
