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
// The TPU kernel ran on (H, W+32) lane-padded planes in 8-row tiles and
// did the vertical pass on transposed planes; here a row kernel and a
// column kernel read the channel-last (H, W, C) tensors directly.
//
// What bounds it on this card: instructions.  The 33 taps of a pixel each
// cost a powf, a depth expf and some 30 other operations, while the
// pixel's inputs are 36 bytes.  The design removes what is repeated:
//   * a tile in shared memory.  A block stages its outputs' pixels plus
//     the 16-pixel halo along the pass axis once, with coalesced loads:
//     the row kernel 128 x 2 outputs (160 x 2 staged, one output per
//     thread), the column kernel 8 x 128 outputs (8 x 160 staged, four
//     per thread; eight pixels of a row are one 128-byte line of the
//     normals), so the halo adds 25% to the loads.  The tile holds the
//     decoded normal (n*2-1, once per pixel) with the tap's gate folded in
//     (a gated-off tap stores a zero normal, so its clipped dot and its
//     weight are exactly 0, as the gate's factor 0 made them), depth,
//     roughness (K2) and the source rgb, in planes, so a warp's taps read
//     32 consecutive words.  Taps outside the image are zero-filled as
//     the reference's padding is: weight exactly 0.  The tap loop is fully
//     unrolled with no bounds branch;
//   * a tabulated Gaussian (K2).  br is an integer in [0, br_max], so the
//     Gaussian takes at most (br_max+1) x 17 values; the wrapper builds
//     that table once (ops/spatial_cuda.py:gaussian_table, the plain
//     pass's own arithmetic) and each block copies it to shared memory,
//     which saves a divide and an expf per tap;
//   * powf(x, 512) and the depth expf stay: nine squarings would cost the
//     pow ~3e-5 relative error, on the filters' 2e-5 bar.
// The center normal is read from the tensor (its own gate does not apply
// to it).  A block computes one tile: no TMA ring or wgmma, nothing to
// overlap and no matrix product.  No fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 16;
constexpr int kHalf = kRadius + 1;  // Gaussian table columns |i| = 0..16
constexpr float kSigmaZ = 4.0f;
constexpr int kThreads = 256;

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Output tile (OW x OH), threads (TX x TY) and staged tile (LW x LH) of
// each axis: AXIS 1 = row pass, AXIS 0 = column pass.
template <int AXIS>
struct Tile;
template <>
struct Tile<1> {
  static constexpr int OW = 128, OH = 2, TX = 128, TY = 2;
  static constexpr int LW = OW + 2 * kRadius, LH = OH, STEP = 1;
};
template <>
struct Tile<0> {
  static constexpr int OW = 8, OH = 128, TX = 8, TY = 32;
  static constexpr int LW = OW, LH = OH + 2 * kRadius, STEP = LW;
};

// shared planes: nx ny nz z r g b, and K2's roughness
template <bool REFL>
struct Planes {
  static constexpr int N = REFL ? 8 : 7;
};

template <bool REFL, int AXIS>
size_t smem_bytes(int n_br) {
  return sizeof(float) * (Planes<REFL>::N * Tile<AXIS>::LW * Tile<AXIS>::LH +
                          (REFL ? n_br * kHalf : 0));
}

template <bool REFL, int AXIS>
__global__ void __launch_bounds__(kThreads)
spatial_pass_kernel(const float* __restrict__ src,
                    const float* __restrict__ normal,
                    const float* __restrict__ aux,
                    const float* __restrict__ depth,
                    const float* __restrict__ gauss_table, int n_br,
                    float* __restrict__ out, int H, int W, float width,
                    float br_max) {
  using T = Tile<AXIS>;
  constexpr int NPIX = T::LW * T::LH;
  extern __shared__ float smem[];
  float* const s_nx = smem;
  float* const s_ny = smem + NPIX;
  float* const s_nz = smem + 2 * NPIX;
  float* const s_z = smem + 3 * NPIX;
  float* const s_r = smem + 4 * NPIX;
  float* const s_g = smem + 5 * NPIX;
  float* const s_b = smem + 6 * NPIX;
  float* const s_rough = smem + 7 * NPIX;  // K2 only
  float* const s_gauss = smem + Planes<REFL>::N * NPIX;
  const float4* __restrict__ normal4 = reinterpret_cast<const float4*>(normal);

  const int tid = threadIdx.y * T::TX + threadIdx.x;
  const int x0 = blockIdx.x * T::OW, y0 = blockIdx.y * T::OH;
  const int gx0 = x0 - (AXIS == 1 ? kRadius : 0);
  const int gy0 = y0 - (AXIS == 0 ? kRadius : 0);
  if (REFL)
    for (int k = tid; k < n_br * kHalf; k += kThreads) s_gauss[k] = __ldg(gauss_table + k);
  for (int p = tid; p < NPIX; p += kThreads) {
    const int gx = gx0 + p % T::LW, gy = gy0 + p / T::LW;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f, z = 0.0f, a = 0.0f;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
      const int q = gy * W + gx;
      const float4 n = __ldg(normal4 + q);
      z = __ldg(depth + q);
      a = __ldg(aux + q);
      r = __ldg(src + 3 * q);
      g = __ldg(src + 3 * q + 1);
      b = __ldg(src + 3 * q + 2);
      const bool gate = REFL ? n.w > 0.0f : (n.w > 0.0f && a < 1.0f);
      if (gate) {
        nx = n.x * 2.0f - 1.0f;
        ny = n.y * 2.0f - 1.0f;
        nz = n.z * 2.0f - 1.0f;
      }
    }
    s_nx[p] = nx;
    s_ny[p] = ny;
    s_nz[p] = nz;
    s_z[p] = z;
    s_r[p] = r;
    s_g[p] = g;
    s_b[p] = b;
    if (REFL) s_rough[p] = a;
  }
  __syncthreads();

#pragma unroll 1
  for (int oy = threadIdx.y; oy < T::OH; oy += T::TY) {
    const int ox = threadIdx.x;
    const int x = x0 + ox, y = y0 + oy;
    if (x >= W || y >= H) continue;
    const int c = y * W + x;
    const int pc = (oy + (AXIS == 0 ? kRadius : 0)) * T::LW + ox +
                   (AXIS == 1 ? kRadius : 0);
    const float4 nc = __ldg(normal4 + c);
    const float ncx = nc.x * 2.0f - 1.0f;
    const float ncy = nc.y * 2.0f - 1.0f;
    const float ncz = nc.z * 2.0f - 1.0f;
    const float dep_c = s_z[pc];
    float rough_c = 0.0f;
    const float* gauss = s_gauss;
    if (REFL) {
      rough_c = s_rough[pc];
      const float br = truncf(fminf(fmaxf(0.1f * rough_c * width, 0.0f), br_max));
      gauss = s_gauss + (int)br * kHalf;
    }
    float mu0 = 0.0f, mu1 = 0.0f, mu2 = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int i = -kRadius; i <= kRadius; ++i) {
      const int p = pc + i * T::STEP;
      const float ndot = ncx * s_nx[p] + ncy * s_ny[p] + ncz * s_nz[p];
      const float dwgt = expf(-fabsf(dep_c - s_z[p]) * dep_c * kSigmaZ);
      float w;
      if (REFL) {
        // 1 - smoothstep with the plain pass's roundings: a fused
        // multiply-add leaves a residual where it is 0, and that residual
        // alone sets a pixel whose other weights are below 1e-30
        const float s = clip01(fabsf(s_rough[p] - rough_c) / 0.5f);
        const float rwgt = __fsub_rn(
            1.0f, __fmul_rn(__fmul_rn(s, s), __fsub_rn(3.0f, __fmul_rn(2.0f, s))));
        w = gauss[i < 0 ? -i : i] * powf(clip01(ndot), 512.0f) * dwgt * rwgt;
      } else {
        w = powf(clip01(ndot), 32.0f) * dwgt;
      }
      mu0 += s_r[p] * w;
      mu1 += s_g[p] * w;
      mu2 += s_b[p] * w;
      wsum += w;
    }
    const float d = fmaxf(wsum, 1e-30f);
    out[3 * c] = mu0 / d;
    out[3 * c + 1] = mu1 / d;
    out[3 * c + 2] = mu2 / d;
  }
}

template <bool REFL, int AXIS>
int launch(const float* src, const float* normal, const float* aux,
           const float* depth, const float* gauss_table, int n_br, float* out,
           int H, int W, float width, float br_max, cudaStream_t stream) {
  using T = Tile<AXIS>;
  const size_t smem = smem_bytes<REFL, AXIS>(n_br);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spatial_pass_kernel<REFL, AXIS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 threads(T::TX, T::TY);
  const dim3 blocks((W + T::OW - 1) / T::OW, (H + T::OH - 1) / T::OH);
  spatial_pass_kernel<REFL, AXIS><<<blocks, threads, smem, stream>>>(
      src, normal, aux, depth, gauss_table, n_br, out, H, W, width, br_max);
  return (int)cudaGetLastError();
}

}  // namespace

// refl != 0: K2 (aux = roughness, gauss_table (n_br, 17) with n_br =
// floor(br_max) + 1); refl == 0: K3 (aux = metallic, no table).
// axis 1 = horizontal (row) pass, axis 0 = vertical (column) pass.
extern "C" int rtggx_spatial_pass(int refl, int axis, const void* src,
                                  const void* normal, const void* aux,
                                  const void* depth, const void* gauss_table,
                                  int n_br, void* out, int H, int W,
                                  float width, float br_max, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const float* s = (const float*)src;
  const float* n = (const float*)normal;
  const float* a = (const float*)aux;
  const float* z = (const float*)depth;
  const float* g = (const float*)gauss_table;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (refl) {
    if (g == nullptr || br_max < 0.0f || n_br < (int)br_max + 1)
      return (int)cudaErrorInvalidValue;
    return axis == 1 ? launch<true, 1>(s, n, a, z, g, n_br, o, H, W, width, br_max, st)
                     : launch<true, 0>(s, n, a, z, g, n_br, o, H, W, width, br_max, st);
  }
  return axis == 1 ? launch<false, 1>(s, n, a, z, g, 0, o, H, W, width, br_max, st)
                   : launch<false, 0>(s, n, a, z, g, 0, o, H, W, width, br_max, st);
}
