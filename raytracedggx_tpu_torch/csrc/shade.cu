// BS: a bounce wave's hit shading and miss tap, one ray a thread
// (closestHitReflection / closestHitDiffuse and the miss shader,
// RayTracing.hlsl:570-625).
//
// K1 hands each bounce wave's rays over in the sorted ray domain with
// their hit record (t, instance, hit) and the OBJECT-space interpolated
// normal.  A hit lane takes its hit point on the ray, its object-space
// position through the inverse world, its world normal through the
// normal matrix, the procedural UV, roughness (instance 0's checkerboard)
// and metallic, the base colour; metallic > 0.5 takes the env-specular
// route (the lerped spec direction, N.L, the mip level from the roughness,
// one trilinear tap of the packed f16 env row, EnvBRDFApprox), else the
// SH diffuse term (the albedo damped by 1 - metallic on the diffuse
// wave).  A miss lane takes the env tap of its direction at level 0.  The
// lane writes its radiance and its hit flag as one (R, 4) row, which the
// wave un-permutes.  The plain version (ops/shade_cuda.py:
// shade_bounce_plain) writes each step as whole-wave torch operations,
// some 290 device operations a wave with a full-size temporary each,
// computing both routes and the tap on every ray and selecting after; it
// runs for CPU tensors.  This kernel replaces all of them.  It ports no
// Pallas kernel: the JAX package leaves the shading to XLA.
//
// What bounds it: bytes.  A ray reads its origin and direction (24 B,
// strided rows of the wave's bundle), t, id and hit flag (13 B) and its
// normal (12 B), and writes 16 B: 65 B a ray, 60 MB at 1280x720 and 539 MB
// at 3840x2160, 18 us and 161 us at 3.35 TB/s.  The env rows (78 B, f16)
// come from L2: the table is 2.5 MB, and neighbouring sorted rays tap
// neighbouring texels.  The small per-instance tables (inverse worlds,
// normal matrices, roughness / metallic, base colours), the SH
// coefficients and the mip sizes and offsets are staged in shared memory
// by every block, as XF stages its table, so no ray gathers a row of them.
//
// Bit for bit the plain version on the card: torch's elementwise CUDA
// operations round once each and never contract across operations, so
// every step is written in the plain version's order with the
// round-to-nearest intrinsics, which nvcc never fuses into an FMA.  Where
// torch rewrites an operation the kernel does the same: a Python scalar
// over a tensor is the tensor's reciprocal times the scalar, a tensor
// over a Python scalar is the tensor times the scalar's float32
// reciprocal, a Python scalar is rounded to float32 once (2.0 * c1 in the
// SH term is one constant), torch.clamp / torch.minimum propagate NaN, and
// torch's 3-element reductions over the last dimension (sum, linalg.norm)
// add the first and third term, then the second, each term first added
// to the reduction's zero.  log2f and exp2f are the functions torch's
// kernels call.  The two transforms are XF's own product (xform.cuh), so
// they equal the plain version's XF launches.  No fast math.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "xform.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 256;      // staged rows of each per-instance table
constexpr int kMaxMips = 16;

// Python scalars as torch hands them to a float32 kernel: the double
// rounded to float32 once
constexpr float kShC1 = (float)0.42904276540489171563379376569857;
constexpr float kShC3 = (float)0.24770795610037568833406429782001;
constexpr float kShC4 = (float)0.88622692545275801364908374167057;
constexpr float kSh2C1 = (float)(2.0 * 0.42904276540489171563379376569857);
constexpr float kSh2C2 = (float)(2.0 * 0.51166335397324424423977581244463);
constexpr float kInvPi = 1.0f / (float)3.141592653589793;   // x / PI
constexpr float kUvScaleY = (float)0.2;                     // get_uv scl
constexpr float kCheckerMax = (float)4294967295.0;
constexpr float kTiny = (float)1e-20;
constexpr float kFaceTiny = (float)1e-30;
// env_brdf_approx's float32 constant rows c0 and c1
constexpr float kC00 = (float)-1.0, kC01 = (float)-0.0275,
                kC02 = (float)-0.572, kC03 = (float)0.022;
constexpr float kC10 = (float)1.0, kC11 = (float)0.0425, kC12 = (float)1.04,
                kC13 = (float)-0.04;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.minimum: a NaN operand is the result
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp with scalar bounds: NaN stays NaN
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// torch.sum(dim=-1) of three values: (0 + a + 0 + c) + (0 + b)
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(add(0.0f, a), add(0.0f, c)), add(0.0f, b));
}

__device__ __forceinline__ float half_at(const unsigned short* p) {
  return __half2float(__ushort_as_half(__ldg(p)));
}
// the two halves of a 4-byte word, low first
__device__ __forceinline__ void halves(unsigned int b, float& lo, float& hi) {
  lo = __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  hi = __half2float(__ushort_as_half(static_cast<unsigned short>(b >> 16)));
}

// dir_to_face_uv and _trilinear_packed (trace/env.py) at a float level:
// one packed row of mip m0 (its own edge-clamped quad | the parent's 3x3
// window), the level's bilinear from the quad, the parent's from the
// window, mixed by the level's fraction
__device__ float3 env_tap(const float* dir, float level, int num_mips,
                          const long long* sizes, const long long* offsets,
                          const unsigned short* __restrict__ tri,
                          long long rows) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  const bool is_x = (ax >= ay) && (ax >= az);
  const bool is_y = !is_x && (ay >= az);
  const int face = is_x ? (x >= 0.0f ? 0 : 1)
                        : (is_y ? (y >= 0.0f ? 2 : 3) : (z >= 0.0f ? 4 : 5));
  const float ma = is_x ? ax : (is_y ? ay : az);
  const float sc = is_x ? (x >= 0.0f ? -z : z)
                        : (is_y ? x : (z >= 0.0f ? x : -x));
  const float tc = is_y ? (y >= 0.0f ? z : -z) : -y;
  const float inv = mul(__fdiv_rn(1.0f, clamp_lo(ma, kFaceTiny)), 0.5f);
  const float u = add(mul(sc, inv), 0.5f);
  const float v = add(mul(tc, inv), 0.5f);

  const float lev = clamp(level, 0.0f, (float)(num_mips - 1.0));
  const float m0f = floorf(lev);
  long long m0 = static_cast<long long>(m0f);
  const float f = sub(lev, static_cast<float>(m0));
  m0 = m0 < 0 ? 0 : (m0 >= num_mips ? num_mips - 1 : m0);
  const long long s = sizes[m0];
  const float sf = static_cast<float>(s);
  const float tx = tmin(clamp_lo(sub(mul(u, sf), 0.5f), 0.0f), sub(sf, 1.0f));
  const float ty = tmin(clamp_lo(sub(mul(v, sf), 0.5f), 0.0f), sub(sf, 1.0f));
  const float x0 = floorf(tx), y0 = floorf(ty);
  const float fx = sub(tx, x0), fy = sub(ty, y0);
  long long idx = offsets[m0] + (face * s + static_cast<long long>(y0)) * s
                  + static_cast<long long>(x0);
  idx = idx < 0 ? 0 : (idx >= rows ? rows - 1 : idx);

  // the row's 39 halves in 20 loads that stay inside the row: 4-byte
  // words from its first even half, a lone half at the odd end
  float q[39];
  const unsigned short* row = tri + idx * 39;
  if (idx & 1) {                    // the row starts at an odd half
    q[0] = half_at(row);
    const unsigned int* w = reinterpret_cast<const unsigned int*>(row + 1);
#pragma unroll
    for (int k = 0; k < 19; ++k) halves(__ldg(w + k), q[1 + 2 * k],
                                        q[2 + 2 * k]);
  } else {
    const unsigned int* w = reinterpret_cast<const unsigned int*>(row);
#pragma unroll
    for (int k = 0; k < 19; ++k) halves(__ldg(w + k), q[2 * k],
                                        q[2 * k + 1]);
    q[38] = half_at(row + 38);
  }

  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
  float c0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    c0[c] = add(add(add(mul(mul(q[c], gx), gy), mul(mul(q[3 + c], fx), gy)),
                    mul(mul(q[6 + c], gx), fy)),
                mul(mul(q[9 + c], fx), fy));

  const float s2 = clamp_lo(floorf(mul(sf, 0.5f)), 1.0f);
  const float px = tmin(clamp_lo(sub(mul(u, s2), 0.5f), 0.0f), sub(s2, 1.0f));
  const float py = tmin(clamp_lo(sub(mul(v, s2), 0.5f), 0.0f), sub(s2, 1.0f));
  const float px0 = floorf(px), py0 = floorf(py);
  const float fxp = sub(px, px0), fyp = sub(py, py0);
  const bool lo_x = add(sub(px0, floorf(mul(x0, 0.5f))), 1.0f) < 0.5f;
  const bool lo_y = add(sub(py0, floorf(mul(y0, 0.5f))), 1.0f) < 0.5f;
  const float wx[3] = {lo_x ? sub(1.0f, fxp) : 0.0f,
                       lo_x ? fxp : sub(1.0f, fxp), lo_x ? 0.0f : fxp};
  const float wy[3] = {lo_y ? sub(1.0f, fyp) : 0.0f,
                       lo_y ? fyp : sub(1.0f, fyp), lo_y ? 0.0f : fyp};
  float c1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float wgt = mul(wy[r], wx[c]);
      const int o = 12 + 3 * (r * 3 + c);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c1[ch] = add(c1[ch], mul(q[o + ch], wgt));
    }
  const float g = sub(1.0f, f);
  return make_float3(add(mul(c0[0], g), mul(c1[0], f)),
                     add(mul(c0[1], g), mul(c1[1], f)),
                     add(mul(c0[2], g), mul(c1[2], f)));
}

struct Tables {
  const float* inv;  int n_inv;  long long inv_s[3];   // (I, 4, 4) inverse worlds
  const float* wit;  int n_wit;  long long wit_s[3];   // (I, 3, 3) normal matrices
  const float* rm;   int n_rm;   long long rm_s[2];    // (I, 2) roughness, metallic
  const float* bc;   int n_bc;   long long bc_s[2];    // (I, >= 3) base colours
  const float* sh;   long long sh_s[2];                // (9, 3) SH coefficients
  const long long* sizes; const long long* offsets; int num_mips;
};

struct Rays {
  const float* o; long long o_s[2];
  const float* d; long long d_s[2];
  const float* t; long long t_s;
  const void* inst; long long inst_s; int inst64;
  const unsigned char* hit; long long hit_s;
  const float* nrm; long long nrm_s[2];
};

__global__ void __launch_bounds__(kThreads)
bounce_shade_kernel(Tables tb, Rays ry, const unsigned short* __restrict__ tri,
                    long long tri_rows, int damp, int n,
                    float* __restrict__ out) {
  // shared: sizes | offsets (int64), then inv [I][4][3] | wit [I][3][3] |
  // rm [I][2] | bc [I][3] | sh [9][3] | c4 * sh[0] (float)
  extern __shared__ long long smem[];
  long long* s_sizes = smem;
  long long* s_offsets = smem + kMaxMips;
  float* s_inv = reinterpret_cast<float*>(smem + 2 * kMaxMips);
  float* s_wit = s_inv + tb.n_inv * 12;
  float* s_rm = s_wit + tb.n_wit * 9;
  float* s_bc = s_rm + tb.n_rm * 2;
  float* s_sh = s_bc + tb.n_bc * 3;
  for (int e = threadIdx.x; e < tb.num_mips; e += blockDim.x) {
    s_sizes[e] = tb.sizes[e];
    s_offsets[e] = tb.offsets[e];
  }
  for (int e = threadIdx.x; e < tb.n_inv * 12; e += blockDim.x) {
    const int r = e / 12, k = (e / 3) % 4, c = e % 3;
    s_inv[e] = tb.inv[r * tb.inv_s[0] + k * tb.inv_s[1] + c * tb.inv_s[2]];
  }
  for (int e = threadIdx.x; e < tb.n_wit * 9; e += blockDim.x) {
    const int r = e / 9, k = (e / 3) % 3, c = e % 3;
    s_wit[e] = tb.wit[r * tb.wit_s[0] + k * tb.wit_s[1] + c * tb.wit_s[2]];
  }
  for (int e = threadIdx.x; e < tb.n_rm * 2; e += blockDim.x)
    s_rm[e] = tb.rm[(e / 2) * tb.rm_s[0] + (e % 2) * tb.rm_s[1]];
  for (int e = threadIdx.x; e < tb.n_bc * 3; e += blockDim.x)
    s_bc[e] = tb.bc[(e / 3) * tb.bc_s[0] + (e % 3) * tb.bc_s[1]];
  for (int e = threadIdx.x; e < 27; e += blockDim.x)
    s_sh[e] = tb.sh[(e / 3) * tb.sh_s[0] + (e % 3) * tb.sh_s[1]];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long li = i;

  const bool hit = ry.hit[li * ry.hit_s] != 0;
  float dir[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) dir[c] = ry.d[li * ry.d_s[0] + c * ry.d_s[1]];

  // what the env tap reads: a miss its own direction at level 0, a
  // specular hit the lerped direction at its roughness's mip
  float tap_dir[3] = {dir[0], dir[1], dir[2]};
  float tap_level = 0.0f;
  bool spec = false, tap = !hit;
  float rad[3];
  float nol = 0.0f, brdf[3];
  if (hit) {
    const float t = ry.t[li * ry.t_s];
    const long long raw = ry.inst64
        ? static_cast<const long long*>(ry.inst)[li * ry.inst_s]
        : static_cast<long long>(
              static_cast<const int*>(ry.inst)[li * ry.inst_s]);
    float p[3], nobj[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = add(ry.o[li * ry.o_s[0] + c * ry.o_s[1]], mul(t, dir[c]));
      nobj[c] = ry.nrm[li * ry.nrm_s[0] + c * ry.nrm_s[1]];
    }
    // take_small: a row of each table, the id clamped to its rows
    auto row = [raw](int rows) {
      return static_cast<int>(raw < 0 ? 0 : (raw >= rows ? rows - 1 : raw));
    };
    float pos[3], nw[3];
    xform_row<3, 3, true>(s_inv + row(tb.n_inv) * 12, p, pos);
    xform_row<3, 3, false>(s_wit + row(tb.n_wit) * 9, nobj, nw);
    // n / clamp(linalg.norm(n), 1e-20)
    const float len = clamp_lo(
        __fsqrt_rn(sum3(mul(nw[0], nw[0]), mul(nw[1], nw[1]),
                        mul(nw[2], nw[2]))), kTiny);
    float nn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) nn[c] = __fdiv_rn(nw[c], len);

    // get_uv: scl (1, 0.2, 1)
    const float ax = fabsf(nobj[0]), ay = fabsf(nobj[1]), az = fabsf(nobj[2]);
    const float sx = mul(pos[0], 1.0f), sy = mul(pos[1], kUvScaleY),
                sz = mul(pos[2], 1.0f);
    const float uu = add(add(mul(ax, sy), mul(ay, sz)), mul(az, sx));
    const float vv = add(add(mul(ax, sz), mul(ay, sx)), mul(az, sy));
    const float uv0 = add(mul(uu, 0.5f), 0.5f);
    const float uv1 = add(mul(vv, 0.5f), 0.5f);
    // get_rough_metal: instance 0's checkerboard
    const float* rm = s_rm + row(tb.n_rm) * 2;
    float rough = rm[0];
    const float metal = rm[1];
    const long long p0 =
        static_cast<long long>(clamp(mul(uv0, 5.0f), 0.0f, kCheckerMax)) & 1;
    const long long p1 =
        static_cast<long long>(clamp(mul(uv1, 5.0f), 0.0f, kCheckerMax)) & 1;
    if (raw == 0 && (p0 ^ p1) != 0) rough = mul(rough, 0.25f);
    const float* color = s_bc + row(tb.n_bc) * 3;

    if (metal > 0.5f) {
      // _spec_env_shade: reflect(-v, n) with -v the ray's direction
      spec = tap = true;
      const float a = mul(rough, rough);
      const float s2 = mul(2.0f, sum3(mul(dir[0], nn[0]), mul(dir[1], nn[1]),
                                      mul(dir[2], nn[2])));
      const float one_a = sub(1.0f, a);
      const float k = mul(one_a, add(__fsqrt_rn(clamp_lo(one_a, 0.0f)), a));
      float dd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float r = sub(dir[c], mul(s2, nn[c]));
        dd[c] = add(nn[c], mul(sub(r, nn[c]), k));
        tap_dir[c] = dd[c];
      }
      nol = sum3(mul(nn[0], dd[0]), mul(nn[1], dd[1]), mul(nn[2], dd[2]));
      const float nov = clamp(sum3(mul(nn[0], -dir[0]), mul(nn[1], -dir[1]),
                                   mul(nn[2], -dir[2])), 0.0f, 1.0f);
      // _mip_level
      const float lv = sub(3.0f, mul((float)1.15, log2f(clamp_lo(rough,
                                                                kTiny))));
      tap_level = sub((float)(tb.num_mips - 1.0), lv);
      // env_brdf_approx(f0, rough, nov)
      float f0[3];
      const float dm = mul((float)0.04, sub(1.0f, metal));
#pragma unroll
      for (int c = 0; c < 3; ++c) f0[c] = add(dm, mul(color[c], metal));
      const float rr[4] = {add(mul(rough, kC00), kC10),
                           add(mul(rough, kC01), kC11),
                           add(mul(rough, kC02), kC12),
                           add(mul(rough, kC03), kC13)};
      const float e = exp2f(mul((float)-9.28, nov));
      const float a004 = add(mul(tmin(mul(rr[0], rr[0]), e), rr[0]), rr[1]);
      const float ab_x = add(mul((float)-1.04, a004), rr[2]);
      const float ab_y = mul(add(mul((float)1.04, a004), rr[3]),
                             clamp(mul(50.0f, f0[1]), 0.0f, 1.0f));
#pragma unroll
      for (int c = 0; c < 3; ++c) brdf[c] = add(mul(f0[c], ab_x), ab_y);
    } else {
      // evaluate_sh_irradiance(n) / PI * albedo
      const float x = -nn[0], y = -nn[1], z = nn[2];
      const float a1 = mul(kShC1, sub(mul(x, x), mul(y, y)));
      const float a2 = mul(kShC3, sub(mul(mul(3.0f, z), z), 1.0f));
      const float* sh = s_sh;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t4 = add(add(mul(mul(sh[12 + c], x), y),
                                 mul(mul(sh[21 + c], x), z)),
                             mul(mul(sh[15 + c], y), z));
        const float t5 = add(add(mul(sh[9 + c], x), mul(sh[3 + c], y)),
                             mul(sh[6 + c], z));
        const float irr = clamp_lo(
            add(add(add(add(mul(a1, sh[24 + c]), mul(a2, sh[18 + c])),
                        mul(kShC4, sh[c])),
                    mul(kSh2C1, t4)),
                mul(kSh2C2, t5)), 0.0f);
        const float albedo = damp ? mul(color[c], sub(1.0f, metal))
                                  : color[c];
        rad[c] = mul(mul(irr, kInvPi), albedo);
      }
    }
  }
  if (tap) {
    const float3 e = env_tap(tap_dir, tap_level, tb.num_mips, s_sizes,
                             s_offsets, tri, tri_rows);
    rad[0] = e.x;
    rad[1] = e.y;
    rad[2] = e.z;
    if (spec) {
      const bool lit = nol > 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) rad[c] = mul(lit ? rad[c] : 0.0f, brdf[c]);
    }
  }
  reinterpret_cast<float4*>(out)[li] =
      make_float4(rad[0], rad[1], rad[2], hit ? 1.0f : 0.0f);
}

}  // namespace

extern "C" {

int rtggx_shade_max_rows() { return kMaxRows; }
int rtggx_shade_max_mips() { return kMaxMips; }

// out[i] = (radiance, hit) of ray i of a bounce wave (n rays), as
// ops/shade_cuda.py:shade_bounce_plain computes it.  Every tensor is given
// by its pointer and element strides; out is n x 4 contiguous float32,
// 16-byte aligned.  Each table holds 1 to kMaxRows rows and the env 1 to
// kMaxMips mips, or the call is refused.
int rtggx_shade_bounce(
    const float* inv, int n_inv, long long inv_s0, long long inv_s1,
    long long inv_s2, const float* wit, int n_wit, long long wit_s0,
    long long wit_s1, long long wit_s2, const float* rm, int n_rm,
    long long rm_s0, long long rm_s1, const float* bc, int n_bc,
    long long bc_s0, long long bc_s1, const float* sh, long long sh_s0,
    long long sh_s1, const void* tri, long long tri_rows,
    const long long* sizes, const long long* offsets, int num_mips,
    const float* o, long long o_s0, long long o_s1, const float* d,
    long long d_s0, long long d_s1, const float* t, long long t_s,
    const void* inst, long long inst_s, int inst64, const void* hit,
    long long hit_s, const float* nrm, long long nrm_s0, long long nrm_s1,
    int damp, int n, float* out, void* stream) {
  const int rows[4] = {n_inv, n_wit, n_rm, n_bc};
  for (int k = 0; k < 4; ++k)
    if (rows[k] < 1 || rows[k] > kMaxRows) return (int)cudaErrorInvalidValue;
  if (num_mips < 1 || num_mips > kMaxMips || n < 0 || tri_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Tables tb{inv, n_inv, {inv_s0, inv_s1, inv_s2}, wit, n_wit,
            {wit_s0, wit_s1, wit_s2}, rm, n_rm, {rm_s0, rm_s1}, bc, n_bc,
            {bc_s0, bc_s1}, sh, {sh_s0, sh_s1}, sizes, offsets, num_mips};
  Rays ry{o, {o_s0, o_s1}, d, {d_s0, d_s1}, t, t_s, inst, inst_s, inst64,
          static_cast<const unsigned char*>(hit), hit_s, nrm,
          {nrm_s0, nrm_s1}};
  const size_t smem = sizeof(long long) * 2 * kMaxMips
      + sizeof(float) * (n_inv * 12 + n_wit * 9 + n_rm * 2 + n_bc * 3 + 27);
  const int blocks = (n + kThreads - 1) / kThreads;
  bounce_shade_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      tb, ry, static_cast<const unsigned short*>(tri), tri_rows, damp, n,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
