// K2 / K3: one separable pass of the edge-aware spatial filters.
//
// K2 replaces the TPU kernel raytracedggx_tpu/ops/spatial_pallas.py:
// _refl_kernel (reflection filter pass), K3 replaces _diff_kernel
// (diffuse filter pass); both were launched by _run_pass.
//
// Per output pixel c, over the 33 taps p = c + i (i in [-16, 16]) along
// the pass axis, in the tone-mapped domain:
//   K2: w = hit(p) * gauss(|i|; sigma = (br(c)+1)/3)
//           * clip(n(c).n(p), 0, 1)^512 * exp(-|z(c)-z(p)| * z(c) * 4)
//           * (1 - smoothstep(0, 0.5, |rough(p)-rough(c)|)),
//       br(c) = int(clip(0.1 * rough(c) * width, 0, 0.05 * height)) with
//       the full image's width and height for both axes;
//   K3: w = (hit(p) & metal(p) < 1) * clip(n(c).n(p), 0, 1)^32
//           * exp(-|z(c)-z(p)| * z(c) * 4);
//   out(c) = sum w*src(p) / max(sum w, 1e-30).
// Taps outside the image are skipped; the reference reads them as zeros,
// and there the hit gate is 0 and the clipped normal term finite, so
// their weight is exactly 0 either way.  No fast math: pow(x, 512) must
// stay accurate.
//
// The TPU kernel ran on (H, W+32) lane-padded planes in 8-row tiles and
// did the vertical pass on transposed planes.  Here one thread computes
// one output pixel and reads the channel-last (H, W, C) tensors directly;
// a row kernel and a column kernel take the two axes, so nothing is
// padded or transposed.
//
// What bounds it on this card: the 33 taps each read 36 B (normal float4,
// src rgb, depth, rough or metal) and compute one powf and one or two
// expf.  Neighbouring threads of a warp lie along x, so both the row and
// the column taps of a warp are contiguous loads that L1 and L2 serve
// after the first touch; the 720p planes (about 33 MB) stay in the 50 MB
// L2 across the two passes.  The transcendental count (~100 per pixel)
// is what is left; a later shared-memory tile with the weights' shared
// factors hoisted is the next step.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 16;
constexpr float kSigmaZ = 4.0f;

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

template <bool REFL, int AXIS>
__global__ void spatial_pass_kernel(const float* __restrict__ src,
                                    const float* __restrict__ normal,
                                    const float* __restrict__ aux,
                                    const float* __restrict__ depth,
                                    float* __restrict__ out, int H, int W,
                                    float width, float br_max) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int c = y * W + x;
  const float4 nc = __ldg(reinterpret_cast<const float4*>(normal) + c);
  const float ncx = nc.x * 2.0f - 1.0f;
  const float ncy = nc.y * 2.0f - 1.0f;
  const float ncz = nc.z * 2.0f - 1.0f;
  const float dep_c = __ldg(depth + c);
  const float aux_c = __ldg(aux + c);
  float sigma = 1.0f;
  if (REFL) {
    const float br = truncf(fminf(fmaxf(0.1f * aux_c * width, 0.0f), br_max));
    sigma = (br + 1.0f) / 3.0f;
  }
  float mu0 = 0.0f, mu1 = 0.0f, mu2 = 0.0f, wsum = 0.0f;
#pragma unroll 4
  for (int i = -kRadius; i <= kRadius; ++i) {
    const int tx = AXIS == 1 ? x + i : x;
    const int ty = AXIS == 0 ? y + i : y;
    if (tx < 0 || tx >= W || ty < 0 || ty >= H) continue;
    const int p = ty * W + tx;
    const float4 n = __ldg(reinterpret_cast<const float4*>(normal) + p);
    const float ndot = ncx * (n.x * 2.0f - 1.0f) + ncy * (n.y * 2.0f - 1.0f) +
                       ncz * (n.z * 2.0f - 1.0f);
    const float dwgt = expf(-fabsf(dep_c - __ldg(depth + p)) * dep_c * kSigmaZ);
    const float aux_p = __ldg(aux + p);
    float w;
    if (REFL) {
      const float gate = n.w > 0.0f ? 1.0f : 0.0f;
      const float a = fabsf((float)i) / sigma;
      const float g = expf(-0.5f * a * a);
      const float s = clip01(fabsf(aux_p - aux_c) / 0.5f);
      const float rwgt = 1.0f - s * s * (3.0f - 2.0f * s);
      w = gate * g * powf(clip01(ndot), 512.0f) * dwgt * rwgt;
    } else {
      const float gate = (n.w > 0.0f && aux_p < 1.0f) ? 1.0f : 0.0f;
      w = gate * powf(clip01(ndot), 32.0f) * dwgt;
    }
    mu0 += __ldg(src + 3 * p) * w;
    mu1 += __ldg(src + 3 * p + 1) * w;
    mu2 += __ldg(src + 3 * p + 2) * w;
    wsum += w;
  }
  const float d = fmaxf(wsum, 1e-30f);
  out[3 * c] = mu0 / d;
  out[3 * c + 1] = mu1 / d;
  out[3 * c + 2] = mu2 / d;
}

template <bool REFL>
void launch(int axis, const float* src, const float* normal, const float* aux,
            const float* depth, float* out, int H, int W, float width,
            float br_max, cudaStream_t stream) {
  const dim3 threads(32, 8);
  const dim3 blocks((W + 31) / 32, (H + 7) / 8);
  if (axis == 1)
    spatial_pass_kernel<REFL, 1><<<blocks, threads, 0, stream>>>(
        src, normal, aux, depth, out, H, W, width, br_max);
  else
    spatial_pass_kernel<REFL, 0><<<blocks, threads, 0, stream>>>(
        src, normal, aux, depth, out, H, W, width, br_max);
}

}  // namespace

// refl != 0: K2 (aux = roughness); refl == 0: K3 (aux = metallic).
// axis 1 = horizontal (row) pass, axis 0 = vertical (column) pass.
extern "C" int rtggx_spatial_pass(int refl, int axis, const void* src,
                                  const void* normal, const void* aux,
                                  const void* depth, void* out, int H, int W,
                                  float width, float br_max, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  if (refl)
    launch<true>(axis, (const float*)src, (const float*)normal,
                 (const float*)aux, (const float*)depth, (float*)out, H, W,
                 width, br_max, (cudaStream_t)stream);
  else
    launch<false>(axis, (const float*)src, (const float*)normal,
                  (const float*)aux, (const float*)depth, (float*)out, H, W,
                  width, br_max, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
