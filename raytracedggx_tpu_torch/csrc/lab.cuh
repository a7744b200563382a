// Pieces shared by the kernel-lab traversals K6a/K6b (traverse_lab.cu) and
// K7 (traverse_mxu.cu): the per-ray object-space state, a slab test that
// reads its box through a generic pointer (node rows may sit in shared
// memory), the optional octant fold, the Moller-Trumbore test with an
// optional approximate reciprocal, and the 5-exchange sorting network of
// the TPU kernels.  No fast math: NaN pads and empty boxes must fail every
// comparison.

#pragma once

#include <cuda_runtime.h>

#include "ray.cuh"

#define LAB_MAX_STACK 512
#define LAB_TAG_SHIFT 20
#define LAB_NODE_MASK 0xFFFFF

namespace rtggx {

// Slab test of the box b = lo.xyz, hi.xyz against best_t; tn is the entry
// distance.  fold: the near and far planes are picked by the signs of the
// ray's own inverse direction, which for a box with lo <= hi gives the same
// tn and tf bit for bit as the min/max form (an empty child, lo > hi, may
// then pass or fail differently, and callers ignore its result).
__device__ __forceinline__ bool slab(const float* b, const Ray& r,
                                     float t_min, float best_t, bool fold,
                                     float& tn) {
  float tf;
  if (fold) {
    const bool sx = r.ix >= 0.0f, sy = r.iy >= 0.0f, sz = r.iz >= 0.0f;
    const float nx = sx ? b[0] : b[3], fx = sx ? b[3] : b[0];
    const float ny = sy ? b[1] : b[4], fy = sy ? b[4] : b[1];
    const float nz = sz ? b[2] : b[5], fz = sz ? b[5] : b[2];
    tn = fmaxf(fmaxf((nx - r.ox) * r.ix, (ny - r.oy) * r.iy), (nz - r.oz) * r.iz);
    tf = fminf(fminf((fx - r.ox) * r.ix, (fy - r.oy) * r.iy), (fz - r.oz) * r.iz);
  } else {
    const float t0x = (b[0] - r.ox) * r.ix, t1x = (b[3] - r.ox) * r.ix;
    const float t0y = (b[1] - r.oy) * r.iy, t1y = (b[4] - r.oy) * r.iy;
    const float t0z = (b[2] - r.oz) * r.iz, t1z = (b[5] - r.oz) * r.iz;
    tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  }
  return (tn <= tf) && (tf >= t_min) && (tn <= best_t);
}

// Moller-Trumbore against tr = v0, e1, e2; on a hit with t <= best_t it
// takes (t, u, v) and returns true.  RECIP: rcp.approx plus one Newton step
// in place of the divide (det = 0 gives inf, then NaN, which fails).
template <bool RECIP>
__device__ __forceinline__ bool mt_hit(const float* __restrict__ tr,
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
  float inv_det;
  if (RECIP) {
    float r0;
    asm("rcp.approx.f32 %0, %1;" : "=f"(r0) : "f"(det));
    inv_det = r0 * (2.0f - det * r0);
  } else {
    inv_det = 1.0f / det;
  }
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

// The TPU kernels' sort4_desc: exchanges (0,1) (2,3) (0,2) (1,3) (1,2), each
// swapping when key[i] < key[j], so the keys end descending and the last
// entry pushed (the nearest) is popped first.
__device__ __forceinline__ void cswap(float* key, int* ent, bool* push, int i,
                                      int j) {
  if (key[i] < key[j]) {
    const float k = key[i]; key[i] = key[j]; key[j] = k;
    const int e = ent[i]; ent[i] = ent[j]; ent[j] = e;
    const bool p = push[i]; push[i] = push[j]; push[j] = p;
  }
}

__device__ __forceinline__ void sort4_desc(float* key, int* ent, bool* push) {
  cswap(key, ent, push, 0, 1);
  cswap(key, ent, push, 2, 3);
  cswap(key, ent, push, 0, 2);
  cswap(key, ent, push, 1, 3);
  cswap(key, ent, push, 1, 2);
}

}  // namespace rtggx
