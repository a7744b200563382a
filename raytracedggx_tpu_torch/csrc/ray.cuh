// Ray set-up, slab test and Moller-Trumbore test shared by the traversal
// kernels K1 (traverse.cu), K4 (traverse_flat.cu) and K5
// (traverse_wide4.cu).  Each function takes its operands as values (K1
// reads them as float4) or from a row in memory.  The comparisons are
// those of the TPU kernels, so
// hits and exact-t ties resolve as there; no fast math, because empty
// boxes (lo = +inf, hi = -inf), NaN padding and degenerate triangles
// (det = 0 -> NaN) must fail every comparison.

#pragma once

#include <cuda_runtime.h>

namespace rtggx {

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;  // origin, direction, 1/dir
};

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-20f;
  if (fabsf(d) < eps) d = d >= 0.0f ? eps : -eps;
  return 1.0f / d;
}

// The ray (o, d) moved by an inverse world m = (a, b, c), its 12 floats
// packed three to a float4 (3x3 row-major, then the translation), as
// o*M + t and d*M, the direction left unnormalised so t stays in world
// units.
__device__ __forceinline__ Ray make_ray(const float4& a, const float4& b,
                                        const float4& c, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz) {
  Ray r;
  r.ox = ox * a.x + oy * a.w + oz * b.z + c.y;
  r.oy = ox * a.y + oy * b.x + oz * b.w + c.z;
  r.oz = ox * a.z + oy * b.y + oz * c.x + c.w;
  r.dx = dx * a.x + dy * a.w + dz * b.z;
  r.dy = dx * a.y + dy * b.x + dz * b.w;
  r.dz = dx * a.z + dy * b.y + dz * c.x;
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// The same with m read from memory; m == nullptr keeps the ray as given.
__device__ __forceinline__ Ray make_ray(const float* __restrict__ m,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  if (m != nullptr)
    return make_ray(
        make_float4(__ldg(m + 0), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3)),
        make_float4(__ldg(m + 4), __ldg(m + 5), __ldg(m + 6), __ldg(m + 7)),
        make_float4(__ldg(m + 8), __ldg(m + 9), __ldg(m + 10), __ldg(m + 11)),
        ox, oy, oz, dx, dy, dz);
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = safe_inv(dx);
  r.iy = safe_inv(dy);
  r.iz = safe_inv(dz);
  return r;
}

// Slab test of the box lo, hi: (tn <= tf) & (tf >= t_min) &
// (tn <= best_t); tn is the entry distance.
__device__ __forceinline__ bool box_hit(float lox, float loy, float loz,
                                        float hix, float hiy, float hiz,
                                        const Ray& r, float t_min,
                                        float best_t, float& tn) {
  const float t0x = (lox - r.ox) * r.ix;
  const float t1x = (hix - r.ox) * r.ix;
  const float t0y = (loy - r.oy) * r.iy;
  const float t1y = (hiy - r.oy) * r.iy;
  const float t0z = (loz - r.oz) * r.iz;
  const float t1z = (hiz - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tn <= tf) && (tf >= t_min) && (tn <= best_t);
}

// The same test on the box b = lo.xyz, hi.xyz in memory.
__device__ __forceinline__ bool box_hit(const float* __restrict__ b,
                                        const Ray& r, float t_min,
                                        float best_t, float& tn) {
  return box_hit(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
                 __ldg(b + 4), __ldg(b + 5), r, t_min, best_t, tn);
}

// Moller-Trumbore against the triangle row tr = v0, e1, e2 with an exact
// 1/det.  On u >= 0, v >= 0, u + v <= 1, t_min <= t <= best_t it takes
// (t, u, v) into (best_t, best_u, best_v) and returns true, so of two hits
// at an equal t the later one tested wins.
__device__ __forceinline__ bool tri_hit(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        const Ray& r, float t_min,
                                        float& best_t, float& best_u,
                                        float& best_v) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = 1.0f / det;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min && t <= best_t) {
    best_t = t;
    best_u = u;
    best_v = v;
    return true;
  }
  return false;
}

// The same test on the triangle row tr = v0, e1, e2 in memory.
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tr,
                                        const Ray& r, float t_min,
                                        float& best_t, float& best_u,
                                        float& best_v) {
  return tri_hit(__ldg(tr + 0), __ldg(tr + 1), __ldg(tr + 2), __ldg(tr + 3),
                 __ldg(tr + 4), __ldg(tr + 5), __ldg(tr + 6), __ldg(tr + 7),
                 __ldg(tr + 8), r, t_min, best_t, best_u, best_v);
}

}  // namespace rtggx
