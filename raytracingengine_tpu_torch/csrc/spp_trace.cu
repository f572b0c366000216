// In-kernel anti-aliasing: pixel coordinates -> mean HDR over spp samples.
//
// Replaces raytracingengine_tpu/kernels/spp_trace.py::spp_trace_pallas.
// One thread per pixel builds its camera ray per sample (Math.h:100-120:
// sx = x - w/2 + jx, sy = h/2 - y + jy, dir = normalize((sx, sy, f) - pos)
// with the position's x/y subtracted, as the TPU kernel), traces it with
// the shared chain body (trace_common.cuh) and writes the mean once.
// Sample 0 is unjittered (Scene.h:289-296).
//
// Jitter: the TPU kernel's hardware generator has no counterpart here.
// Philox4x32-10, keyed by (seed, 0) and counting (pixel id, sample, 0, 0),
// gives two uint32 words per sample; the top 23 bits of each, under
// exponent 0x3F8, give jx and jy in [0, 1) (trace_common.cuh::camera_dir).
// kernels/spp_trace.py computes the same bits in PyTorch, so the plain
// version draws the same jitter.
//
// What bounds it on the H100: as chain_trace.cu, fp32 ALU work and warp
// divergence; a pixel reads 8 bytes and writes 12 for spp whole traces.
// The sample loop inside the thread keeps the per-sample rays, their
// jitter and the running sum out of device memory entirely. Culled tables
// take the CTA-cooperative scan of chain_trace.cu; the sample loop is
// CTA-uniform (every thread runs spp samples).
#include "trace_common.cuh"

namespace {

template <class Tris>
__global__ void __launch_bounds__(rte::kCtaThreads, Tris::kMinCtas) spp_trace_kernel(
    rte::Tables T, const float* __restrict__ cam, const int* __restrict__ px,
    const int* __restrict__ py, float* __restrict__ out, long long n_pixels, int width,
    int height, int spp, uint32_t seed, int max_depth, float bias, float min_weight) {
  Tris tris = Tris::make();
  const long long i = rte::ray_of_thread(n_pixels);
  const bool valid = i >= 0;
  const int x = valid ? px[i] : 0, y = valid ? py[i] : 0;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const float3 d = rte::camera_dir(cam, x, y, width, height, seed, s);
    const float3 c = rte::trace_ray(T, tris, valid, cam[0], cam[1], cam[2], d.x, d.y, d.z,
                                    max_depth, bias, min_weight);
    ar += c.x;
    ag += c.y;
    ab += c.z;
  }
  if (!valid) return;
  const float inv_spp = 1.0f / static_cast<float>(spp);
  out[3 * i] = ar * inv_spp;
  out[3 * i + 1] = ag * inv_spp;
  out[3 * i + 2] = ab * inv_spp;
}

}  // namespace

extern "C" int rte_spp_trace(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* taabb, int n_blocks,
    const float* cam, const int* px, const int* py, float* out, int n_pixels, int width,
    int height, int spp, uint32_t seed, int max_depth, float bias, float min_weight,
    void* stream) {
  if (n_pixels <= 0) return 0;
  const rte::Tables T = rte::with_culling(
      rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat, mat_cols,
                       light, light_cols, nl),
      taabb, n_blocks);
  if (taabb && !rte::stageable(T)) return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned blocks = rte::ray_ctas(n_pixels);
  const auto s = static_cast<cudaStream_t>(stream);
  if (taabb) {
    spp_trace_kernel<rte::CtaCulledTris><<<blocks, rte::kCtaThreads, 0, s>>>(
        T, cam, px, py, out, n_pixels, width, height, spp, seed, max_depth, bias,
        min_weight);
  } else {
    spp_trace_kernel<rte::LinearTris><<<blocks, rte::kCtaThreads, 0, s>>>(
        T, cam, px, py, out, n_pixels, width, height, spp, seed, max_depth, bias,
        min_weight);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rte_spp_trace_occupancy(int culled) {
  int n = 0;
  const cudaError_t e = culled
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, spp_trace_kernel<rte::CtaCulledTris>, rte::kCtaThreads, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, spp_trace_kernel<rte::LinearTris>, rte::kCtaThreads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
