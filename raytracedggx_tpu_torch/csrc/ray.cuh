// Ray set-up, slab test and Moller-Trumbore test shared by the traversal
// kernels K1 (traverse.cu), K4 (traverse_flat.cu) and K5
// (traverse_wide4.cu).  The comparisons are those of the TPU kernels, so
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

// The ray (o, d) moved by an inverse world m (3x3 row-major, then the
// translation) as o*M + t and d*M, the direction left unnormalised so t
// stays in world units; m == nullptr keeps the ray as given.
__device__ __forceinline__ Ray make_ray(const float* __restrict__ m,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  if (m == nullptr) {
    r.ox = ox; r.oy = oy; r.oz = oz;
    r.dx = dx; r.dy = dy; r.dz = dz;
  } else {
    r.ox = ox * __ldg(m + 0) + oy * __ldg(m + 3) + oz * __ldg(m + 6) + __ldg(m + 9);
    r.oy = ox * __ldg(m + 1) + oy * __ldg(m + 4) + oz * __ldg(m + 7) + __ldg(m + 10);
    r.oz = ox * __ldg(m + 2) + oy * __ldg(m + 5) + oz * __ldg(m + 8) + __ldg(m + 11);
    r.dx = dx * __ldg(m + 0) + dy * __ldg(m + 3) + dz * __ldg(m + 6);
    r.dy = dx * __ldg(m + 1) + dy * __ldg(m + 4) + dz * __ldg(m + 7);
    r.dz = dx * __ldg(m + 2) + dy * __ldg(m + 5) + dz * __ldg(m + 8);
  }
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// Slab test of the box b = lo.xyz, hi.xyz: (tn <= tf) & (tf >= t_min) &
// (tn <= best_t); tn is the entry distance.
__device__ __forceinline__ bool box_hit(const float* __restrict__ b,
                                        const Ray& r, float t_min,
                                        float best_t, float& tn) {
  const float t0x = (__ldg(b + 0) - r.ox) * r.ix;
  const float t1x = (__ldg(b + 3) - r.ox) * r.ix;
  const float t0y = (__ldg(b + 1) - r.oy) * r.iy;
  const float t1y = (__ldg(b + 4) - r.oy) * r.iy;
  const float t0z = (__ldg(b + 2) - r.oz) * r.iz;
  const float t1z = (__ldg(b + 5) - r.oz) * r.iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return (tn <= tf) && (tf >= t_min) && (tn <= best_t);
}

// Moller-Trumbore against the triangle row tr = v0, e1, e2 with an exact
// 1/det.  On u >= 0, v >= 0, u + v <= 1, t_min <= t <= best_t it takes
// (t, u, v) into (best_t, best_u, best_v) and returns true, so of two hits
// at an equal t the later one tested wins.
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tr,
                                        const Ray& r, float t_min,
                                        float& best_t, float& best_u,
                                        float& best_v) {
  const float v0x = __ldg(tr + 0), v0y = __ldg(tr + 1), v0z = __ldg(tr + 2);
  const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4), e1z = __ldg(tr + 5);
  const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7), e2z = __ldg(tr + 8);
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

}  // namespace rtggx
