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
// What bounds them on this card: instructions issued.  A pixel's inputs
// are 36 bytes, while its 33 taps each cost some 25 operations, plus a
// pow and an expf.  Both kernels stage a tile in shared memory: a block
// loads its outputs' pixels plus the 16-pixel halo along the pass axis
// once, with coalesced loads, decoding the normal (n*2-1) once per pixel,
// in planes, so a warp's taps read 32 consecutive words.  Taps outside the
// image are zero-filled as the reference's padding is: weight exactly 0.
// A block computes one tile: no TMA ring or wgmma, nothing to overlap and
// no matrix product.  No fast math.
//
// K2 (reflection_pass_kernel): one output per thread.  The row kernel
// stages 160 x 2 pixels for 128 x 2 outputs, the column kernel 8 x 160
// for 8 x 128 (four per thread; eight pixels of a row are one 128-byte
// line of the normals), so the halo adds 25% to the loads.  The staged
// normal has the tap's gate folded in (a gated-off tap stores a zero
// normal, so its clipped dot and its weight are exactly 0, as the gate's
// factor 0 made them); the centre normal is read from the tensor (its own
// gate does not apply to it).  The Gaussian is tabulated: br is an
// integer in [0, br_max], so it takes at most (br_max+1) x 17 values; the
// wrapper builds that table once (ops/spatial_cuda.py:gaussian_table, the
// plain pass's own arithmetic) and each block copies it to shared memory,
// which saves a divide and an expf per tap.  powf(x, 512) and the depth
// expf stay: nine squarings would cost the pow ~3e-5 relative error, on
// the filters' 2e-5 bar.
//
// K3 (diffuse_pass_kernel<AXIS, K>): K consecutive outputs per thread
// along the pass axis (register blocking; K = 4 by measurement: at 8 the
// kernel took 128 registers, two blocks an SM, and ran slower on both
// axes, PERF.md).  A thread walks the 32 + K staged taps of its
// outputs once and applies each to every output whose window holds it,
// so a tap's eight shared loads serve up to K outputs: (32 + K) * 8 / K
// loads per output, not 33 * 7.  The outputs' decoded normals and depths
// stay in registers, read from the staged tile, which holds the ungated
// normal and the tap's gate as a plane of its own (a tap's normal times
// its gate is the zero normal of a gated-off tap, as in K2).
// clip(n.n, 0, 1)^32 is five squarings, at most ~16 ulp (2e-6) from the
// exact power, inside the 1e-4 bar (the plain pass's pow is rounded once);
// the depth weight keeps expf.  Taps are applied in the order i = -16..16
// for every output, as the plain pass sums them.  A warp's 32 lanes lie
// along x and each row of threads is a warp: in the column kernel the
// lanes' taps are 32 consecutive words of a row; in the row kernel a
// staged row is laid out with column lx at (lx % K) * S + lx / K, S odd,
// so the 32 lanes' taps at one offset are again 32 consecutive words.
// The row kernel stages (32K + 32) x 8 pixels for 32K x 8 outputs, the
// column kernel 32 x (8K + 32) for 32 x 8K; outputs past the image's
// ragged edge are computed from zero taps and not written.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 16;
constexpr int kHalf = kRadius + 1;  // Gaussian table columns |i| = 0..16
constexpr float kSigmaZ = 4.0f;
constexpr int kThreads = 256;
constexpr int kDiffPerThread = 4;  // K3's K

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// ------------------------------------------------------------------ K2
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

// shared planes: nx ny nz z r g b rough, then the Gaussian table
constexpr int kReflPlanes = 8;

template <int AXIS>
size_t refl_smem_bytes(int n_br) {
  return sizeof(float) * (kReflPlanes * Tile<AXIS>::LW * Tile<AXIS>::LH + n_br * kHalf);
}

template <int AXIS>
__global__ void __launch_bounds__(kThreads)
reflection_pass_kernel(const float* __restrict__ src,
                       const float* __restrict__ normal,
                       const float* __restrict__ rough,
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
  float* const s_rough = smem + 7 * NPIX;
  float* const s_gauss = smem + kReflPlanes * NPIX;
  const float4* __restrict__ normal4 = reinterpret_cast<const float4*>(normal);

  const int tid = threadIdx.y * T::TX + threadIdx.x;
  const int x0 = blockIdx.x * T::OW, y0 = blockIdx.y * T::OH;
  const int gx0 = x0 - (AXIS == 1 ? kRadius : 0);
  const int gy0 = y0 - (AXIS == 0 ? kRadius : 0);
  for (int k = tid; k < n_br * kHalf; k += kThreads) s_gauss[k] = __ldg(gauss_table + k);
  for (int p = tid; p < NPIX; p += kThreads) {
    const int gx = gx0 + p % T::LW, gy = gy0 + p / T::LW;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f, z = 0.0f, a = 0.0f;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
      const int q = gy * W + gx;
      const float4 n = __ldg(normal4 + q);
      z = __ldg(depth + q);
      a = __ldg(rough + q);
      r = __ldg(src + 3 * q);
      g = __ldg(src + 3 * q + 1);
      b = __ldg(src + 3 * q + 2);
      if (n.w > 0.0f) {
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
    s_rough[p] = a;
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
    const float rough_c = s_rough[pc];
    const float br = truncf(fminf(fmaxf(0.1f * rough_c * width, 0.0f), br_max));
    const float* gauss = s_gauss + (int)br * kHalf;
    float mu0 = 0.0f, mu1 = 0.0f, mu2 = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int i = -kRadius; i <= kRadius; ++i) {
      const int p = pc + i * T::STEP;
      const float ndot = ncx * s_nx[p] + ncy * s_ny[p] + ncz * s_nz[p];
      const float dwgt = expf(-fabsf(dep_c - s_z[p]) * dep_c * kSigmaZ);
      // 1 - smoothstep with the plain pass's roundings: a fused
      // multiply-add leaves a residual where it is 0, and that residual
      // alone sets a pixel whose other weights are below 1e-30
      const float s = clip01(fabsf(s_rough[p] - rough_c) / 0.5f);
      const float rwgt = __fsub_rn(
          1.0f, __fmul_rn(__fmul_rn(s, s), __fsub_rn(3.0f, __fmul_rn(2.0f, s))));
      const float w = gauss[i < 0 ? -i : i] * powf(clip01(ndot), 512.0f) * dwgt * rwgt;
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

template <int AXIS>
int launch_reflection(const float* src, const float* normal, const float* rough,
                      const float* depth, const float* gauss_table, int n_br,
                      float* out, int H, int W, float width, float br_max,
                      cudaStream_t stream) {
  using T = Tile<AXIS>;
  const size_t smem = refl_smem_bytes<AXIS>(n_br);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reflection_pass_kernel<AXIS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 threads(T::TX, T::TY);
  const dim3 blocks((W + T::OW - 1) / T::OW, (H + T::OH - 1) / T::OH);
  reflection_pass_kernel<AXIS><<<blocks, threads, smem, stream>>>(
      src, normal, rough, depth, gauss_table, n_br, out, H, W, width, br_max);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K3
// 32 x 8 threads, each K consecutive outputs along the pass axis.  Tap t
// (0 .. 32 + K - 1) of a thread's outputs lies at word base + off(t) of a
// plane; t = g * K + m splits it into a group g and a constant m, so
// off(t) = g * GSTEP + MSTEP * m and a group's K taps are immediates.
template <int AXIS, int K>
struct DiffTile;
template <int K>
struct DiffTile<1, K> {  // row pass: 32K x 8 outputs
  static constexpr int OW = 32 * K, OH = 8;
  static constexpr int LW = OW + 2 * kRadius, LH = OH;
  static constexpr int S = (LW / K) | 1;  // odd: 32 + 32/K words, rounded up
  static constexpr int PITCH = K * S;
  static constexpr int NPIX = PITCH * LH;
  static constexpr int GSTEP = 1, MSTEP = S;
  __device__ static int pos(int lx, int ly) { return ly * PITCH + (lx % K) * S + lx / K; }
  __device__ static int base(int tx, int ty) { return ty * PITCH + tx; }
};
template <int K>
struct DiffTile<0, K> {  // column pass: 32 x 8K outputs
  static constexpr int OW = 32, OH = 8 * K;
  static constexpr int LW = OW, LH = OH + 2 * kRadius;
  static constexpr int NPIX = LW * LH;
  static constexpr int GSTEP = K * LW, MSTEP = LW;
  __device__ static int pos(int lx, int ly) { return ly * LW + lx; }
  __device__ static int base(int tx, int ty) { return ty * K * LW + tx; }
};

// shared planes: nx ny nz (ungated) gate z r g b
constexpr int kDiffPlanes = 8;

template <int AXIS, int K>
constexpr size_t diff_smem_bytes() {
  return sizeof(float) * kDiffPlanes * DiffTile<AXIS, K>::NPIX;
}

struct Centre {
  float nx, ny, nz, z, z4;  // decoded normal, depth, depth * 4
};
struct Sums {
  float r, g, b, w;
};

// One tap of one output: clip(n.n, 0, 1)^32 by five squarings, the depth
// weight with expf, the weighted source summed.
__device__ __forceinline__ void apply_tap(const Centre& c, float nx, float ny,
                                          float nz, float z, float r, float g,
                                          float b, Sums& s) {
  const float x = clip01(c.nx * nx + c.ny * ny + c.nz * nz);
  const float x2 = x * x, x4 = x2 * x2, x8 = x4 * x4, x16 = x8 * x8;
  // -|dz| * z(c) * 4 with z(c) * 4 formed once: scaling by 4 is exact
  const float w = x16 * x16 * expf(-fabsf(c.z - z) * c.z4);
  s.r += r * w;
  s.g += g * w;
  s.b += b * w;
  s.w += w;
}

// The K taps t = g*K + m of one group (q: the group's first word) against
// the thread's K outputs.  Output j takes taps j .. j+32, so the first
// group (FIRST) serves outputs j <= m, the last (LAST) outputs j >= m and
// every other group all K.
template <typename T, int K, bool FIRST, bool LAST>
__device__ __forceinline__ void apply_group(const float* __restrict__ q,
                                            const Centre (&c)[K], Sums (&s)[K]) {
  constexpr int NP = T::NPIX;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const float* __restrict__ p = q + T::MSTEP * m;
    const float gate = p[3 * NP];
    const float nx = p[0] * gate, ny = p[NP] * gate, nz = p[2 * NP] * gate;
    const float z = p[4 * NP], r = p[5 * NP], g = p[6 * NP], b = p[7 * NP];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if ((!FIRST || j <= m) && (!LAST || j >= m)) apply_tap(c[j], nx, ny, nz, z, r, g, b, s[j]);
  }
}

template <int AXIS, int K>
__global__ void __launch_bounds__(kThreads)
diffuse_pass_kernel(const float* __restrict__ src,
                    const float* __restrict__ normal,
                    const float* __restrict__ metal,
                    const float* __restrict__ depth, float* __restrict__ out,
                    int H, int W) {
  using T = DiffTile<AXIS, K>;
  constexpr int NP = T::NPIX;
  static_assert((2 * kRadius) % K == 0, "K divides the window's 32 side taps");
  extern __shared__ float smem[];
  const float4* __restrict__ normal4 = reinterpret_cast<const float4*>(normal);

  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int x0 = blockIdx.x * T::OW, y0 = blockIdx.y * T::OH;
  const int gx0 = x0 - (AXIS == 1 ? kRadius : 0);
  const int gy0 = y0 - (AXIS == 0 ? kRadius : 0);
  for (int p = tid; p < T::LW * T::LH; p += kThreads) {
    const int lx = p % T::LW, ly = p / T::LW;
    const int gx = gx0 + lx, gy = gy0 + ly;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f, gate = 0.0f, z = 0.0f;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
      const int q = gy * W + gx;
      const float4 n = __ldg(normal4 + q);
      z = __ldg(depth + q);
      r = __ldg(src + 3 * q);
      g = __ldg(src + 3 * q + 1);
      b = __ldg(src + 3 * q + 2);
      nx = n.x * 2.0f - 1.0f;
      ny = n.y * 2.0f - 1.0f;
      nz = n.z * 2.0f - 1.0f;
      gate = (n.w > 0.0f && __ldg(metal + q) < 1.0f) ? 1.0f : 0.0f;
    }
    float* const s = smem + T::pos(lx, ly);
    s[0] = nx;
    s[NP] = ny;
    s[2 * NP] = nz;
    s[3 * NP] = gate;
    s[4 * NP] = z;
    s[5 * NP] = r;
    s[6 * NP] = g;
    s[7 * NP] = b;
  }
  __syncthreads();

  const float* __restrict__ q = smem + T::base(threadIdx.x, threadIdx.y);
  Centre c[K];
  Sums s[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {  // output j is tap j + 16 of the thread
    const int t = j + kRadius;
    const float* __restrict__ p = q + (t / K) * T::GSTEP + (t % K) * T::MSTEP;
    c[j] = Centre{p[0], p[NP], p[2 * NP], p[4 * NP], p[4 * NP] * kSigmaZ};
    s[j] = Sums{0.0f, 0.0f, 0.0f, 0.0f};
  }
  apply_group<T, K, true, false>(q, c, s);
#pragma unroll 1
  for (int g = 1; g < 2 * kRadius / K; ++g) apply_group<T, K, false, false>(q + g * T::GSTEP, c, s);
  apply_group<T, K, false, true>(q + (2 * kRadius / K) * T::GSTEP, c, s);

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int x = x0 + (AXIS == 1 ? threadIdx.x * K + j : threadIdx.x);
    const int y = y0 + (AXIS == 1 ? threadIdx.y : threadIdx.y * K + j);
    if (x < W && y < H) {
      const int o = 3 * (y * W + x);
      const float d = fmaxf(s[j].w, 1e-30f);
      out[o] = s[j].r / d;
      out[o + 1] = s[j].g / d;
      out[o + 2] = s[j].b / d;
    }
  }
}

template <int AXIS, int K>
int launch_diffuse(const float* src, const float* normal, const float* metal,
                   const float* depth, float* out, int H, int W,
                   cudaStream_t stream) {
  using T = DiffTile<AXIS, K>;
  constexpr size_t smem = diff_smem_bytes<AXIS, K>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        diffuse_pass_kernel<AXIS, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 threads(32, 8);
  const dim3 blocks((W + T::OW - 1) / T::OW, (H + T::OH - 1) / T::OH);
  diffuse_pass_kernel<AXIS, K><<<blocks, threads, smem, stream>>>(
      src, normal, metal, depth, out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// K2: gauss_table (n_br, 17) with n_br = floor(br_max) + 1.
// axis 1 = horizontal (row) pass, axis 0 = vertical (column) pass.
extern "C" int rtggx_reflection_pass(int axis, const void* src,
                                     const void* normal, const void* rough,
                                     const void* depth,
                                     const void* gauss_table, int n_br,
                                     void* out, int H, int W, float width,
                                     float br_max, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const float* g = (const float*)gauss_table;
  if (g == nullptr || br_max < 0.0f || n_br < (int)br_max + 1)
    return (int)cudaErrorInvalidValue;
  const float* s = (const float*)src;
  const float* n = (const float*)normal;
  const float* a = (const float*)rough;
  const float* z = (const float*)depth;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  return axis == 1 ? launch_reflection<1>(s, n, a, z, g, n_br, o, H, W, width, br_max, st)
                   : launch_reflection<0>(s, n, a, z, g, n_br, o, H, W, width, br_max, st);
}

// K3: axis as for K2.
extern "C" int rtggx_diffuse_pass(int axis, const void* src,
                                  const void* normal, const void* metal,
                                  const void* depth, void* out, int H, int W,
                                  void* stream) {
  if (H <= 0 || W <= 0) return 0;
  const float* s = (const float*)src;
  const float* n = (const float*)normal;
  const float* m = (const float*)metal;
  const float* z = (const float*)depth;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  return axis == 1 ? launch_diffuse<1, kDiffPerThread>(s, n, m, z, o, H, W, st)
                   : launch_diffuse<0, kDiffPerThread>(s, n, m, z, o, H, W, st);
}
