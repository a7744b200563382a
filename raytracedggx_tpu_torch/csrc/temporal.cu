// TS: temporal supersampling, the frame's TAA (CSTemporalSS.hlsl), one
// pixel a thread.
//
// The frame accumulates its denoised colour into an f16 history: velocity
// dilation over the centre and 4 diagonals, a bilinear-clamp resample of
// the history at the reprojected position, a YCoCg variance box over the
// 3x3 neighbourhood with an adaptive gamma, the anti-alias add-back, the
// blend and the convergence count in alpha.  The plain version
// (denoise/temporal.py:temporal_ss) writes each of those steps as
// whole-image torch operations, some 370 device operations a frame and
// a full-size temporary each, among them an (H, W, 16) float32 quad of
// history taps.  This kernel replaces all of them.  It ports no Pallas
// kernel: the JAX package leaves denoise/temporal.py to XLA.
//
// What bounds it: bytes.  A pixel reads its colour (4 x f32), its velocity
// (2 x f32) and the history (4 x f16), and writes 4 x f32 here (the f16
// store of the history stays the frame's own cast): 40 B a pixel, 11 us
// at 1280x720 and 99 us at 3840x2160 at 3.35 TB/s.  About 150 float
// operations a pixel, among them some 15 correctly rounded divisions,
// are a few us of fp32.  The design reads each input byte once from
// device memory: a 32 x 8 block stages its tile of the colour, already
// taken to YCoCg (_tm), and of the velocity with a 1-pixel halo in
// shared memory, so the 8 neighbours and 4 diagonals are read there and
// each neighbour's three divisions are done once per tile pixel and not
// nine times (reading the neighbourhood through L1 instead measured
// 1.44-1.48x slower); the 4 history taps are read directly as 8-byte
// loads of four halves (16 for an f32 history), mostly from L1 and L2
// since a pixel's taps lie beside it.  Colour loads are float4 and
// velocity loads float2 where the strides allow (contiguous last
// dimension, aligned rows), single floats otherwise: any strides are
// taken.  On an H100 it runs at 28-30% of the byte bound (0.039 ms at
// 1280x720, 0.33 ms at 3840x2160; PERF.md).
//
// Bit for bit the plain version on the card: torch's elementwise CUDA
// operations round once each and never contract across operations, so
// every step is written in the plain version's order with the
// round-to-nearest intrinsics, which nvcc never fuses into an FMA.
// Where torch rewrites an operation the kernel does the same: a Python
// scalar over a tensor is the tensor's reciprocal times the scalar
// (Tensor.__rtruediv__), a tensor over a Python scalar is the tensor times
// the scalar's float32 reciprocal (m1 / 9 is m1 * (1.0f / 9.0f)), and
// torch.clamp / torch.maximum / torch.minimum propagate NaN.  Outside the
// array every neighbour reads zeros (HLSL OOB), as the plain version's
// padded shifts do.  No fast math.
//
// A row band of a larger image (parallel/sharded.py) runs the same code:
// the full image's size (fw, fh) scales the reprojection and the blur,
// and row0, the band's first image row (negative for the first band, which
// starts in its halo), places the band in the image's rows.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTx = 32, kTy = 8;                 // pixels of a block
constexpr int kSx = kTx + 2, kSy = kTy + 2;      // its tile with the halo
constexpr float kHistoryMax = 15.0f;             // (1 << HISTORY_BITS) - 1
constexpr int kVecCur = 1, kVecHist = 2, kVecVel = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }

// torch.maximum / torch.minimum: a NaN operand is the result
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp with scalar bounds: NaN stays NaN
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// _tm: rgb to YCoCg over (4 + luma)
__device__ __forceinline__ float3 tm(float r, float g, float b) {
  const float g2 = mul(g, 2.0f);
  const float y = add(add(r, g2), b);
  const float co = sub(mul(r, 2.0f), mul(b, 2.0f));
  const float cg = sub(add(-r, g2), b);
  const float d = add(y, 4.0f);
  return make_float3(dvd(y, d), dvd(co, d), dvd(cg, d));
}

// _itm: the inverse tone map and YCoCg to rgb
__device__ __forceinline__ float3 itm(float3 c) {
  const float s = mul(rcp(sub(1.0f, c.x)), 4.0f);
  const float y = mul(mul(c.x, s), 0.25f);
  const float co = mul(mul(c.y, s), 0.25f);
  const float cg = mul(mul(c.z, s), 0.25f);
  return make_float3(sub(add(y, co), cg), add(y, cg), sub(sub(y, co), cg));
}

__device__ __forceinline__ float4 load4(const float* p, long long off,
                                        long long sc, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + off));
  return make_float4(__ldg(p + off), __ldg(p + off + sc),
                     __ldg(p + off + 2 * sc), __ldg(p + off + 3 * sc));
}

__device__ __forceinline__ float half_bits(unsigned int b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// four history channels: f32, or f16 given as its bits
__device__ __forceinline__ float4 load_hist(const float* p, long long off,
                                            long long sc, bool vec) {
  return load4(p, off, sc, vec);
}
__device__ __forceinline__ float4 load_hist(const unsigned short* p,
                                            long long off, long long sc,
                                            bool vec) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + off));
    return make_float4(half_bits(u.x & 0xffffu), half_bits(u.x >> 16),
                       half_bits(u.y & 0xffffu), half_bits(u.y >> 16));
  }
  return make_float4(half_bits(__ldg(p + off)), half_bits(__ldg(p + off + sc)),
                     half_bits(__ldg(p + off + 2 * sc)),
                     half_bits(__ldg(p + off + 3 * sc)));
}

// current (H, W, 4) f32, hist (H, W, 4) HT, vel (H, W, 2) f32, each at its
// element strides (y, x, channel); out (H, W, 4) f32 contiguous.
template <typename HT>
__global__ void __launch_bounds__(kTx * kTy)
temporal_ss_kernel(const float* __restrict__ cur, long long c_y, long long c_x,
                   long long c_c, const HT* __restrict__ hist, long long h_y,
                   long long h_x, long long h_c, const float* __restrict__ vel,
                   long long v_y, long long v_x, long long v_c, int vec, int h,
                   int w, float fw, float fh, int row0,
                   float* __restrict__ out) {
  __shared__ float4 s_cur[kSy][kSx];   // _tm(rgb) and alpha; zeros outside
  __shared__ float2 s_vel[kSy][kSx];   // velocity; zeros outside
  const int bx = blockIdx.x * kTx - 1, by = blockIdx.y * kTy - 1;
  for (int e = threadIdx.y * kTx + threadIdx.x; e < kSx * kSy;
       e += kTx * kTy) {
    const int sy = e / kSx, sx = e % kSx, gy = by + sy, gx = bx + sx;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 v = make_float2(0.0f, 0.0f);
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      c = load4(cur, gy * c_y + gx * c_x, c_c, vec & kVecCur);
      const long long vo = gy * v_y + gx * v_x;
      v = (vec & kVecVel)
              ? __ldg(reinterpret_cast<const float2*>(vel + vo))
              : make_float2(__ldg(vel + vo), __ldg(vel + vo + v_c));
    }
    const float3 t = tm(c.x, c.y, c.z);
    s_cur[sy][sx] = make_float4(t.x, t.y, t.z, c.w);
    s_vel[sy][sx] = v;
  }
  __syncthreads();
  const int x = blockIdx.x * kTx + threadIdx.x;
  const int y = blockIdx.y * kTy + threadIdx.y;
  if (x >= w || y >= h) return;
  const int sx = threadIdx.x + 1, sy = threadIdx.y + 1;

  // VelocityMax: the centre, then the diagonals (dy, dx) of _DIAG, each
  // read at (y - dy, x - dx), taken where strictly faster
  constexpr int kDiag[4][2] = {{-1, -1}, {1, -1}, {1, 1}, {-1, 1}};
  float2 best = s_vel[sy][sx];
  float best_sq = add(mul(best.x, best.x), mul(best.y, best.y));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 nb = s_vel[sy - kDiag[k][0]][sx - kDiag[k][1]];
    const float sq = add(mul(nb.x, nb.x), mul(nb.y, nb.y));
    if (sq > best_sq) best = nb;
    best_sq = tmax(sq, best_sq);
  }

  // reprojection in the image's rows, clamped to the image, then to the
  // band; the bilinear sample of the four taps
  const float px = clamp(sub(static_cast<float>(x), mul(best.x, fw)), 0.0f,
                         static_cast<float>(w - 1));
  const float qy = clamp(sub(static_cast<float>(y + row0), mul(best.y, fh)),
                         0.0f, sub(fh, 1.0f));
  const float py = clamp(qy, static_cast<float>(row0),
                         static_cast<float>(row0 + h - 1));
  const float x0 = floorf(px), y0 = floorf(py);
  const float fx = sub(px, x0), fy = sub(py, y0);
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
  const int ix = min(max(static_cast<int>(x0), 0), w - 1);
  const int iy = min(max(static_cast<int>(y0) - row0, 0), h - 1);
  const long long r0 = iy * h_y, r1 = min(iy + 1, h - 1) * h_y;
  const long long c0 = ix * h_x, c1 = min(ix + 1, w - 1) * h_x;
  const bool hv = vec & kVecHist;
  const float4 q00 = load_hist(hist, r0 + c0, h_c, hv);
  const float4 q10 = load_hist(hist, r0 + c1, h_c, hv);
  const float4 q01 = load_hist(hist, r1 + c0, h_c, hv);
  const float4 q11 = load_hist(hist, r1 + c1, h_c, hv);
  auto bilerp = [&](float a, float b, float c, float d) {
    return add(add(add(mul(mul(a, gx), gy), mul(mul(b, fx), gy)),
                   mul(mul(c, gx), fy)),
               mul(mul(d, fx), fy));
  };
  const float hr = bilerp(q00.x, q10.x, q01.x, q11.x);
  const float hg = bilerp(q00.y, q10.y, q01.y, q11.y);
  const float hb = bilerp(q00.z, q10.z, q01.z, q11.z);
  const float ha = bilerp(q00.w, q10.w, q01.w, q11.w);

  // speed -> blur estimate; the history's count
  float cur_blur = add(mul(fabsf(best.x), mul(4.0f, fw)),
                       mul(fabsf(best.y), mul(4.0f, fh)));
  float hist_blur = tmax(sub(1.0f, ha), cur_blur);
  const float hist_count = add(mul(ha, kHistoryMax), 1.0f);

  const float4 cc = s_cur[sy][sx];
  const float cur_a = cc.w;
  float gamma = cur_a <= 0.0f
                    ? 1.0f
                    : clamp(mul(rcp(clamp_lo(hist_blur, (float)1e-6)), 8.0f),
                            1.0f, 32.0f);

  // NeighborMinMax: _OFFSETS (_CROSS then _DIAG) with weights 0.5, 0.25,
  // each neighbour read at (y - dy, x - dx)
  constexpr int kOff[8][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1},
                              {-1, -1}, {1, -1}, {1, 1}, {-1, 1}};
  float f0 = cc.x, f1 = cc.y, f2 = cc.z, f3 = cur_a;
  float m10 = cc.x, m11 = cc.y, m12 = cc.z;
  float m20 = mul(cc.x, cc.x), m21 = mul(cc.y, cc.y), m22 = mul(cc.z, cc.z);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wgt = k < 4 ? 0.5f : 0.25f;
    const float4 nb = s_cur[sy - kOff[k][0]][sx - kOff[k][1]];
    f0 = add(f0, mul(nb.x, wgt));
    f1 = add(f1, mul(nb.y, wgt));
    f2 = add(f2, mul(nb.z, wgt));
    f3 = add(f3, mul(nb.w, wgt));
    m10 = add(m10, nb.x);
    m11 = add(m11, nb.y);
    m12 = add(m12, nb.z);
    m20 = add(m20, mul(nb.x, nb.x));
    m21 = add(m21, mul(nb.y, nb.y));
    m22 = add(m22, mul(nb.z, nb.z));
  }
  f0 = mul(f0, 0.25f);
  f1 = mul(f1, 0.25f);
  f2 = mul(f2, 0.25f);
  f3 = mul(f3, 0.25f);

  // the gamma relaxation (_ALPHA_AS_ID_)
  if (!(fabsf(sub(cur_a, f3)) < (float)(1.0 / 255.0))) gamma = 1.0f;

  const float inv_n = 1.0f / 9.0f;
  const float mu0 = mul(m10, inv_n), mu1 = mul(m11, inv_n),
              mu2 = mul(m12, inv_n);
  const float sg0 = __fsqrt_rn(fabsf(sub(mul(m20, inv_n), mul(mu0, mu0))));
  const float sg1 = __fsqrt_rn(fabsf(sub(mul(m21, inv_n), mul(mu1, mu1))));
  const float sg2 = __fsqrt_rn(fabsf(sub(mul(m22, inv_n), mul(mu2, mu2))));
  const float nmin0 = tmin(sub(mu0, mul(gamma, sg0)), f0);
  const float nmin1 = tmin(sub(mu1, mul(gamma, sg1)), f1);
  const float nmin2 = tmin(sub(mu2, mul(gamma, sg2)), f2);
  const float nmax0 = tmax(add(mu0, mul(gamma, sg0)), f0);
  const float nmax1 = tmax(add(mu1, mul(gamma, sg1)), f1);
  const float nmax2 = tmax(add(mu2, mul(gamma, sg2)), f2);
  const float nmin_w = sub(mu0, sg0), nmax_w = add(mu0, sg0);

  cur_blur = clamp(cur_blur, 0.0f, 1.0f);
  hist_blur = clamp(hist_blur, 0.0f, 1.0f);

  // the history clamped in YCoCg
  const float3 ht = tm(hr, hg, hb);
  const float h0 = tmin(tmax(ht.x, nmin0), nmax0);
  const float h1 = tmin(tmax(ht.y, nmin1), nmax1);
  const float h2 = tmin(tmax(ht.z, nmin2), nmax2);
  const float contrast = sub(nmax_w, nmin_w);

  // the anti-alias add-back
  float add_alias = add(mul(hist_blur, 0.5f), 0.25f);
  add_alias = clamp(add(add_alias, rcp(add(mul(contrast, 128.0f), 1.0f))),
                    0.0f, 1.0f);
  const float3 filt = make_float3(add(f0, mul(sub(cc.x, f0), add_alias)),
                                  add(f1, mul(sub(cc.y, f1), add_alias)),
                                  add(f2, mul(sub(cc.z, f2), add_alias)));

  // the blend factor
  const float dist = tmin(fabsf(sub(nmin_w, h0)), fabsf(sub(nmax_w, h0)));
  const float amt = clamp_hi(add(rcp(hist_count), mul(hist_blur, 0.125f)),
                             1.0f);
  float blend = mul(rcp(add(mul(sub(add(dist, contrast), 8.0f), amt), 8.0f)),
                    0.25f);
  blend = clamp_hi(blend, 0.25f);
  if (!(f3 > 0.0f)) blend = 1.0f;

  float3 res = itm(make_float3(add(h0, mul(sub(filt.x, h0), blend)),
                               add(h1, mul(sub(filt.y, h1), blend)),
                               add(h2, mul(sub(filt.z, h2), blend))));
  if (isnan(res.x) || isnan(res.y) || isnan(res.z)) res = itm(filt);
  const float meta = tmin(mul(hist_count, 1.0f / kHistoryMax),
                          sub(1.0f, cur_blur));
  reinterpret_cast<float4*>(out)[static_cast<long long>(y) * w + x] =
      make_float4(res.x, res.y, res.z, meta);
}

bool aligned(const void* p, unsigned n) {
  return reinterpret_cast<std::uintptr_t>(p) % n == 0;
}

}  // namespace

extern "C" {

// out = temporal_ss(current, history, velocity, (fw, fh), row0) over an
// h x w array; current (f32), history (f32, or f16 where hist16) and
// velocity (f32) at element strides (y, x, channel); out h x w x 4 f32
// contiguous and 16-byte aligned.
int rtggx_temporal_ss(const float* cur, long long c_y, long long c_x,
                      long long c_c, const void* hist, long long h_y,
                      long long h_x, long long h_c, int hist16,
                      const float* vel, long long v_y, long long v_x,
                      long long v_c, int h, int w, float fw, float fh,
                      int row0, float* out, void* stream) {
  if (h < 0 || w < 0 || !aligned(out, 16)) return (int)cudaErrorInvalidValue;
  if (h == 0 || w == 0) return 0;
  const unsigned hist_bytes = hist16 ? 8 : 16;
  const int vec =
      (c_c == 1 && c_x == 4 && c_y % 4 == 0 && aligned(cur, 16) ? kVecCur
                                                                 : 0) |
      (h_c == 1 && h_x == 4 && h_y % 4 == 0 && aligned(hist, hist_bytes)
           ? kVecHist
           : 0) |
      (v_c == 1 && v_x == 2 && v_y % 2 == 0 && aligned(vel, 8) ? kVecVel : 0);
  const dim3 block(kTx, kTy);
  const dim3 grid((w + kTx - 1) / kTx, (h + kTy - 1) / kTy);
  const cudaStream_t s = (cudaStream_t)stream;
  if (hist16)
    temporal_ss_kernel<unsigned short><<<grid, block, 0, s>>>(
        cur, c_y, c_x, c_c, static_cast<const unsigned short*>(hist), h_y,
        h_x, h_c, vel, v_y, v_x, v_c, vec, h, w, fw, fh, row0, out);
  else
    temporal_ss_kernel<float><<<grid, block, 0, s>>>(
        cur, c_y, c_x, c_c, static_cast<const float*>(hist), h_y, h_x, h_c,
        vel, v_y, v_x, v_c, vec, h, w, fw, fh, row0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
