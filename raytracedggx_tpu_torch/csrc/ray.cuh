// Ray set-up, slab test, Moller-Trumbore test, leaf walk and stats shared
// by the traversal kernels K1 (traverse.cu), K4 (traverse_flat.cu) and K5
// (traverse_wide4.cu).  Each test takes its operands as values, which
// the kernels read as float4.  The comparisons are those of the TPU
// kernels, so hits and exact-t ties resolve as there; no fast math,
// because empty boxes (lo = +inf, hi = -inf), NaN padding and degenerate
// triangles (det = 0 -> NaN) must fail every comparison.

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

// Moller-Trumbore against the triangle v0, e1, e2 with an exact 1/det:
// (t, u, v), and whether u >= 0, v >= 0, u + v <= 1 and t >= t_min.  The
// caller compares t with its best.
__device__ __forceinline__ bool tri_uvt(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        const Ray& r, float t_min, float& t,
                                        float& u, float& v) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = 1.0f / det;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min;
}

// The same test accepted on t <= best_t: it takes (t, u, v) into
// (best_t, best_u, best_v) and returns true, so of two hits at an equal t
// the later one tested wins.
__device__ __forceinline__ bool tri_hit(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        const Ray& r, float t_min,
                                        float& best_t, float& best_u,
                                        float& best_v) {
  float t, u, v;
  if (tri_uvt(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, r, t_min, t, u,
              v) &&
      t <= best_t) {
    best_t = t;
    best_u = u;
    best_v = v;
    return true;
  }
  return false;
}

// The same test keeping t alone (K1's slim mode): u and v decide the hit
// and are dropped, so a leaf loop carries no best u and v.
__device__ __forceinline__ bool tri_hit_t(float v0x, float v0y, float v0z,
                                          float e1x, float e1y, float e1z,
                                          float e2x, float e2y, float e2z,
                                          const Ray& r, float t_min,
                                          float& best_t) {
  float t, u, v;
  if (tri_uvt(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, r, t_min, t, u,
              v) &&
      t <= best_t) {
    best_t = t;
    return true;
  }
  return false;
}

// The triangles [a, end) of a leaf in stream order, each v0 _ e1 _ e2 _ as
// three float4 of tris; triangle j + 1's loads go out before triangle j is
// tested, so a leaf costs about one round trip.  A hit is taken on
// t < best_t; of two at an equal t, by_pos takes the later stream
// position (the TPU's result in any visit order), otherwise the later one
// tested.
template <bool by_pos>
__device__ __forceinline__ void leaf_hit(const float4* __restrict__ tris,
                                         int a, int end, const Ray& ray,
                                         float t_min, float& best_t,
                                         float& best_u, float& best_v,
                                         int& best_pos) {
  const float4* __restrict__ tr = tris + (size_t)a * 3;
  float4 v0 = __ldg(tr), e1 = __ldg(tr + 1), e2 = __ldg(tr + 2);
  for (int j = a; j < end; ++j) {
    float4 nv0 = v0, ne1 = e1, ne2 = e2;
    if (j + 1 < end) {
      tr += 3;
      nv0 = __ldg(tr);
      ne1 = __ldg(tr + 1);
      ne2 = __ldg(tr + 2);
    }
    float t, u, v;
    if (tri_uvt(v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z, ray,
                t_min, t, u, v) &&
        (by_pos ? t < best_t || (t == best_t && j > best_pos) : t <= best_t)) {
      best_t = t;
      best_u = u;
      best_v = v;
      best_pos = j;
    }
    v0 = nv0;
    e1 = ne1;
    e2 = ne2;
  }
}

// Adds a thread's box and triangle tests to stats (2 int64, or null for
// none), summed over the warp first: one pair of atomics per warp.  Every
// thread of the warp must make the call.
__device__ __forceinline__ void add_stats(unsigned long long* __restrict__ stats,
                                          unsigned n_box, unsigned n_tri) {
  if (stats == nullptr) return;
  n_box = __reduce_add_sync(0xFFFFFFFFu, n_box);
  n_tri = __reduce_add_sync(0xFFFFFFFFu, n_tri);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(stats, (unsigned long long)n_box);
    atomicAdd(stats + 1, (unsigned long long)n_tri);
  }
}

}  // namespace rtggx
