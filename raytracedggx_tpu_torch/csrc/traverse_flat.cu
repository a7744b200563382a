// K4: closest hit of object-space rays against ONE mesh's binary BVH,
// walked in DFS order with skip links (no stack).
//
// Replaces the TPU kernel raytracedggx_tpu/ops/traverse_pallas.py:
// _traverse_kernel (launched by trace_rays_pallas).
//
// Contract (identical outputs to the TPU kernel):
//   * nodes (N, 9) f32 rows: lo.xyz, hi.xyz, skip, tri_start, tri_count,
//     the links as exact f32 integers; DFS order, so node i's first child
//     is i + 1 and skip jumps past its subtree (ops/flatten.py).
//   * tris (T, 9) f32 rows v0 e1 e2 in stream order; a leaf owns
//     [tri_start, tri_start + tri_count).
//   * inv (12 floats, or null for rays already in object space): the
//     instance's inverse world, 3x3 row-major then translation; the ray
//     goes to object space as o*M + t and d*M, direction unnormalised so
//     t stays in world units.
//   * per ray: start at node 0; while i < N, slab-test node i against the
//     ray's own best t ((tn <= tf) & (tf >= t_min) & (tn <= best_t), the
//     safe_inv epsilon 1e-20); on a hit at an internal node go to i + 1,
//     at a leaf test its triangles then go to skip; on a miss go to skip.
//     Moller-Trumbore with an exact 1/det, accepted on t <= best_t, so an
//     exact tie goes to the later triangle of the stream, as on the TPU.
//   * outputs t (t_max on a miss), u, v (0 on a miss) and the stream
//     position (-1 on a miss).  Rays with t_max < 0 are dead and return
//     at once (no triangle can pass t_min <= t <= t_max < 0).
//   * stats (null, or 2 int64): node tests and triangle tests, summed.
//
// What bounds it on this card: latency of dependent loads.  A node is one
// 36-byte row and a triangle one 36-byte row, both read through the
// read-only cache; a ray's next row depends on its own test, and the
// whole tree of one mesh (about 4 MB for 82k triangles) sits in L2.  The
// TPU kernel walked a 1024-ray packet through the tree, with a frustum
// pre-test and a tile-wide any(), so every ray paid for its packet's
// union of visits; here each thread walks only the nodes its own ray
// admits, and the caller's ray order (screen blocks, octant + Morton)
// keeps a warp's rays on the same rows.  The DFS order has no near-first
// choice, so a ray keeps testing far subtrees its best t has not yet
// ruled out; that is the TPU's visit order, kept for identical ties.

#include <cuda_runtime.h>

#include "ray.cuh"

namespace {

__global__ void __launch_bounds__(128)
trace_flat_kernel(const float* __restrict__ nodes, int num_nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ inv,
                  const float* __restrict__ ray_o,
                  const float* __restrict__ ray_d,
                  const float* __restrict__ t_max, float t_min, int n_rays,
                  float* __restrict__ out_t, float* __restrict__ out_u,
                  float* __restrict__ out_v, int* __restrict__ out_pos,
                  unsigned long long* __restrict__ stats) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_pos = -1;
  unsigned long long n_box = 0, n_tri = 0;

  if (best_t >= 0.0f) {  // t_max < 0: dead ray, no traversal
    const rtggx::Ray ray = rtggx::make_ray(
        inv, ray_o[3 * r], ray_o[3 * r + 1], ray_o[3 * r + 2],
        ray_d[3 * r], ray_d[3 * r + 1], ray_d[3 * r + 2]);
    int i = 0;
    while (i < num_nodes) {
      const float* __restrict__ nd = nodes + (size_t)i * 9;
      ++n_box;
      float tn;
      const int skip = (int)__ldg(nd + 6);
      if (!rtggx::box_hit(nd, ray, t_min, best_t, tn)) {
        i = skip;
        continue;
      }
      const int count = (int)__ldg(nd + 8);
      if (count == 0) {  // internal: descend to the first child
        ++i;
        continue;
      }
      const int start = (int)__ldg(nd + 7);
      n_tri += count;
      for (int k = start; k < start + count; ++k)
        if (rtggx::tri_hit(tris + (size_t)k * 9, ray, t_min, best_t, best_u,
                           best_v))
          best_pos = k;
      i = skip;
    }
  }
  out_t[r] = best_t;
  out_u[r] = best_u;
  out_v[r] = best_v;
  out_pos[r] = best_pos;
  if (stats != nullptr) {
    atomicAdd(stats, n_box);
    atomicAdd(stats + 1, n_tri);
  }
}

}  // namespace

extern "C" int rtggx_trace_flat(const void* nodes, int num_nodes,
                                const void* tris, const void* inv,
                                const void* ray_o, const void* ray_d,
                                const void* t_max, float t_min, int n_rays,
                                void* out_t, void* out_u, void* out_v,
                                void* out_pos, void* stats, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  trace_flat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)nodes, num_nodes, (const float*)tris, (const float*)inv,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, (float*)out_t, (float*)out_u, (float*)out_v, (int*)out_pos,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}
