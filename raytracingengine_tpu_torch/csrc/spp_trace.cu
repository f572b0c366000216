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
// On linear tables the floor is twice roofline.py's bound (the tests round
// every product on its own: no FMA; chain_trace.cu). The sample loop inside
// the thread keeps the per-sample rays, their jitter and the running sum
// out of device memory entirely. Culled tables take the CTA-cooperative
// scan of chain_trace.cu; the sample loop is CTA-uniform (every thread runs
// spp samples). Linear tables take chain_trace.cu's staged route up to
// kStageMaxBytes of stage (the in-place scan past it): the tables in shared
// memory as 16-byte entries, and a packet of kSppPacket samples of one
// pixel per thread, whose rays start at one point a fraction of a pixel
// apart and so mostly meet the same surfaces at the same depths. Each
// sample keeps its Philox bits (pixel, sample), its arithmetic is the
// in-place scan's, and the pixel's sum takes the samples in order 0 ..
// spp - 1, so the mean is the in-place kernel's bit for bit.
#include "trace_common.cuh"

namespace {

// The staged route: kSppPacket samples of one pixel per thread, and the
// CTAs per SM asked of the register allocator (as chain_trace.cu's).
constexpr int kSppPacket = 2;
constexpr int kSppStagedMinCtas = 7;

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

// One thread per pixel; samples s0 .. s0 + K - 1 trace as one packet, and
// the pixel's sum takes them in sample order.
template <int K>
__global__ void __launch_bounds__(rte::kCtaThreads, kSppStagedMinCtas) spp_trace_staged_kernel(
    rte::Tables T, const float* __restrict__ cam, const int* __restrict__ px,
    const int* __restrict__ py, float* __restrict__ out, long long n_pixels, int width,
    int height, int spp, uint32_t seed, int max_depth, float bias, float min_weight) {
  const rte::StagedScan<K> sc = rte::StagedScan<K>::make(T);
  const long long i = rte::ray_of_thread(n_pixels);
  if (i < 0) return;  // no barrier follows the stage
  const int x = px[i], y = py[i];
  float ar = 0.0f, ag = 0.0f, ab = 0.0f;
  for (int s0 = 0; s0 < spp; s0 += K) {
    bool live[K];
    rte::Rays<K> r;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      live[k] = s0 + k < spp;
      const float3 d = rte::camera_dir(cam, x, y, width, height, seed, live[k] ? s0 + k : s0);
      r.ox[k] = cam[0];
      r.oy[k] = cam[1];
      r.oz[k] = cam[2];
      r.dx[k] = d.x;
      r.dy[k] = d.y;
      r.dz[k] = d.z;
    }
    float3 c[K];
    rte::trace_packet<K>(sc, live, r, max_depth, bias, min_weight, c);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (s0 + k >= spp) break;
      ar += c[k].x;
      ag += c[k].y;
      ab += c[k].z;
    }
  }
  const float inv_spp = 1.0f / static_cast<float>(spp);
  out[3 * i] = ar * inv_spp;
  out[3 * i + 1] = ag * inv_spp;
  out[3 * i + 2] = ab * inv_spp;
}

}  // namespace

// The scan and *route as in rte_chain_trace.
extern "C" int rte_spp_trace(
    const float* sph, int sph_cols, int ns, const float* pl, int pl_cols, int np,
    const float* tri, int tri_cols, int nt, const float* mat, int mat_cols,
    const float* light, int light_cols, int nl, const float* taabb, int n_blocks,
    const float* cam, const int* px, const int* py, float* out, int n_pixels, int width,
    int height, int spp, uint32_t seed, int* route, int max_depth, float bias,
    float min_weight, void* stream) {
  const rte::Tables T = rte::with_culling(
      rte::make_tables(sph, sph_cols, ns, pl, pl_cols, np, tri, tri_cols, nt, mat, mat_cols,
                       light, light_cols, nl),
      taabb, n_blocks);
  const rte::Route r = rte::trace_route(T);
  *route = r;
  if (n_pixels <= 0) return 0;
  if (taabb && !rte::stageable(T)) return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned blocks = rte::ray_ctas(n_pixels);
  const auto s = static_cast<cudaStream_t>(stream);
  if (r == rte::kStaged) {
    spp_trace_staged_kernel<kSppPacket><<<blocks, rte::kCtaThreads, rte::stage_bytes(T), s>>>(
        T, cam, px, py, out, n_pixels, width, height, spp, seed, max_depth, bias, min_weight);
  } else if (r == rte::kCulled) {
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

// CTAs per SM of each route, as rte_chain_trace_occupancy.
extern "C" int rte_spp_trace_occupancy(int route) {
  int n = 0;
  const cudaError_t e =
      route == rte::kStaged ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                  &n, spp_trace_staged_kernel<kSppPacket>, rte::kCtaThreads,
                                  rte::kStageMaxBytes)
      : route == rte::kCulled ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    &n, spp_trace_kernel<rte::CtaCulledTris>, rte::kCtaThreads, 0)
                              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                    &n, spp_trace_kernel<rte::LinearTris>, rte::kCtaThreads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
