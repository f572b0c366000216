// In-kernel anti-aliasing on the wavefront trace: pixel coordinates -> mean
// HDR over spp samples, each a full Whitted DFS.
//
// Replaces raytracingengine_tpu/kernels/wavefront_trace.py::
// wavefront_spp_trace_pallas, its culled scan included. One thread per pixel builds its camera ray per
// sample as spp_trace.cu does (trace_common.cuh::camera_dir: sample 0
// unjittered, samples 1.. with Philox4x32-10 jitter on (seed; pixel id,
// sample), the bits of kernels/spp_trace.py::pixel_jitter), traces it with
// trace_wavefront_ray and writes the mean once. Forward-only.
//
// What bounds it on the H100: as wavefront_trace.cu, the issue of each
// popped node's instructions, over spp trees per pixel; a pixel reads 8
// bytes and writes 12. The sample loop inside the thread keeps the
// per-sample rays, their jitter and the running sum out of device memory
// entirely, and trace_wavefront_ray skips node_children on hits that can
// push no child. Measured (PERF.md §6): pixels sorted by their 8
// trees' size ran 3% faster, so the warp waiting for its largest pixel
// costs little; the sample loop flattened into the node loop, with each
// CTA's threads taking pixels from a shared pool as they finish (no lane
// waiting for another's trees), ran 29-47% slower: the lanes then pop
// nodes of different kinds side by side, and the loop spills.
//
// Above 128 triangles it takes culled tables, scanned by its culled
// instantiation as wavefront_trace.cu's is (trace_common.cuh::
// trace_wavefront_warp over WarpCulledTris: the warp's lanes vote on the
// boxes and share each met block's tests): every lane of the warp stays in
// the sample loop, a lane past the last pixel tracing nothing, and the
// frame is the linear instantiation's bit for bit.
#include "trace_common.cuh"

namespace {

// One thread's pixel over the scan Tris: the linear kernel's body.
template <class Tris>
__device__ __forceinline__ void trace_pixel(
    const rte::Tables& T, const rte::WavefrontParams& P, const float* __restrict__ cam,
    const int* __restrict__ px, const int* __restrict__ py, float* __restrict__ out,
    int n_pixels, int width, int height, int spp, uint32_t seed, int* __restrict__ dropped) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pixels) return;
  const int x = px[i], y = py[i];
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int n_dropped = 0;
  Tris tris = Tris::make();
  for (int s = 0; s < spp; ++s) {
    const float3 d = rte::camera_dir(cam, x, y, width, height, seed, s);
    int pops = 0;
    const float3 c = rte::trace_wavefront_ray(T, tris, P, cam[0], cam[1], cam[2], d.x, d.y,
                                              d.z, pops, n_dropped);
    ar += c.x;
    ag += c.y;
    ab += c.z;
  }
  const float inv_spp = 1.0f / static_cast<float>(spp);
  out[3 * i] = ar * inv_spp;
  out[3 * i + 1] = ag * inv_spp;
  out[3 * i + 2] = ab * inv_spp;
  if (n_dropped) atomicAdd(dropped, n_dropped);
}

// Linear tables: the compiler's register count.
__global__ void __launch_bounds__(128) wavefront_spp_trace_kernel(
    rte::Tables T, rte::WavefrontParams P, const float* __restrict__ cam,
    const int* __restrict__ px, const int* __restrict__ py, float* __restrict__ out,
    int n_pixels, int width, int height, int spp, uint32_t seed, int* __restrict__ dropped) {
  trace_pixel<rte::LinearTris>(T, P, cam, px, py, out, n_pixels, width, height, spp, seed,
                               dropped);
}

// Culled tables (above 128 triangles): the warp scans together, so every
// lane stays in the sample loop; a lane past the last pixel traces nothing
// but joins its warp's votes.
__global__ void __launch_bounds__(128, rte::WarpCulledTris::kMinCtas) wavefront_spp_trace_culled_kernel(
    rte::Tables T, rte::WavefrontParams P, const float* __restrict__ cam,
    const int* __restrict__ px, const int* __restrict__ py, float* __restrict__ out,
    int n_pixels, int width, int height, int spp, uint32_t seed, int* __restrict__ dropped) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_pixels;
  const int x = valid ? px[i] : 0, y = valid ? py[i] : 0;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  int n_dropped = 0;
  for (int s = 0; s < spp; ++s) {
    const float3 d = rte::camera_dir(cam, x, y, width, height, seed, s);
    int pops = 0;
    const float3 c = rte::trace_wavefront_warp(T, P, valid, cam[0], cam[1], cam[2], d.x, d.y,
                                               d.z, pops, n_dropped);
    ar += c.x;
    ag += c.y;
    ab += c.z;
  }
  if (!valid) return;
  const float inv_spp = 1.0f / static_cast<float>(spp);
  out[3 * i] = ar * inv_spp;
  out[3 * i + 1] = ag * inv_spp;
  out[3 * i + 2] = ab * inv_spp;
  if (n_dropped) atomicAdd(dropped, n_dropped);
}

}  // namespace

extern "C" int rte_wavefront_spp_trace(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* taabb, int n_blocks,
    const float* cam, const int* px, const int* py, float* out, int n_pixels, int width,
    int height, int spp, uint32_t seed, int max_depth, float bias, float min_weight, int march,
    int shadow_max_steps, float shadow_min_t, int budget, int* dropped, void* stream) {
  if (max_depth < 0 || max_depth + 2 > rte::kMaxCap) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pixels <= 0) return 0;
  const rte::Tables T = rte::with_culling(
      rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat, mat_cols,
                       light, light_cols, nl),
      taabb, n_blocks);
  const rte::WavefrontParams P{max_depth, bias, min_weight, march, shadow_max_steps,
                               shadow_min_t, budget};
  const int threads = 128;
  const int blocks = (n_pixels + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (T.taabb) {
    wavefront_spp_trace_culled_kernel<<<blocks, threads, 0, s>>>(
        T, P, cam, px, py, out, n_pixels, width, height, spp, seed, dropped);
  } else {
    wavefront_spp_trace_kernel<<<blocks, threads, 0, s>>>(
        T, P, cam, px, py, out, n_pixels, width, height, spp, seed, dropped);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs per SM of the kernel, on culled tables (culled != 0) or linear ones.
extern "C" int rte_wavefront_spp_trace_occupancy(int culled) {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, culled ? wavefront_spp_trace_culled_kernel : wavefront_spp_trace_kernel, 128, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
