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
// exponent 0x3F8, give jx and jy in [0, 1). kernels/spp_trace.py computes
// the same bits in PyTorch, so the plain version draws the same jitter.
//
// What bounds it on the H100: as chain_trace.cu, fp32 ALU work and warp
// divergence; a pixel reads 8 bytes and writes 12 for spp whole traces.
// The sample loop inside the thread keeps the per-sample rays, their
// jitter and the running sum out of device memory entirely.
#include "trace_common.cuh"

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., SC'11); returns the first two output words.
__device__ __forceinline__ uint2 philox_xy(uint32_t seed, uint32_t pid, uint32_t sample) {
  uint32_t c0 = pid, c1 = sample, c2 = 0u, c3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint2(c0, c1);
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void __launch_bounds__(128) spp_trace_kernel(
    rte::Tables T, const float* __restrict__ cam, const int* __restrict__ px,
    const int* __restrict__ py, float* __restrict__ out, int n_pixels, int width,
    int height, int spp, uint32_t seed, int max_depth, float bias, float min_weight) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pixels) return;
  const float cx = cam[0], cy = cam[1], cz = cam[2], focal = cam[3];
  const int x = px[i], y = py[i];
  const float sx0 = static_cast<float>(x) - 0.5f * static_cast<float>(width);
  const float sy0 = 0.5f * static_cast<float>(height) - static_cast<float>(y);
  const uint32_t pid = static_cast<uint32_t>(y) * static_cast<uint32_t>(width) +
                       static_cast<uint32_t>(x);
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  for (int s = 0; s < spp; ++s) {
    float jx = 0.0f, jy = 0.0f;
    if (s > 0) {
      const uint2 bits = philox_xy(seed, pid, static_cast<uint32_t>(s));
      jx = uniform01(bits.x);
      jy = uniform01(bits.y);
    }
    const float ddx = (sx0 + jx) - cx;
    const float ddy = (sy0 + jy) - cy;
    const float ddz = focal;
    const float inv = rsqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
    const float3 c = rte::trace_ray(T, cx, cy, cz, ddx * inv, ddy * inv, ddz * inv,
                                    max_depth, bias, min_weight);
    ar += c.x;
    ag += c.y;
    ab += c.z;
  }
  const float inv_spp = 1.0f / static_cast<float>(spp);
  out[3 * i] = ar * inv_spp;
  out[3 * i + 1] = ag * inv_spp;
  out[3 * i + 2] = ab * inv_spp;
}

}  // namespace

extern "C" int rte_spp_trace(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* cam, const int* px,
    const int* py, float* out, int n_pixels, int width, int height, int spp,
    uint32_t seed, int max_depth, float bias, float min_weight, void* stream) {
  if (n_pixels <= 0) return 0;
  const rte::Tables T = rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols,
                                         nt, mat, mat_cols, light, light_cols, nl);
  const int threads = 128;
  const int blocks = (n_pixels + threads - 1) / threads;
  spp_trace_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      T, cam, px, py, out, n_pixels, width, height, spp, seed, max_depth, bias, min_weight);
  return static_cast<int>(cudaGetLastError());
}
