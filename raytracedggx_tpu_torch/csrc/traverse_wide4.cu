// K5: closest hit of object-space rays against ONE mesh's 4-wide BVH,
// with a per-ray stack.
//
// Replaces the TPU kernel raytracedggx_tpu/ops/wide.py:_kernel (launched
// by trace_tiles4).
//
// Contract (identical outputs to the TPU kernel):
//   * nodes (N, 36) f32 rows, the layout of K1's node rows: 4 child boxes
//     (lo.xyz, hi.xyz) at 6k, child kind at 24+k (0 empty / 1 leaf /
//     2 internal), at 28+k the supernode index (internal) or tri_start
//     (leaf), at 32+k the tri_count (leaf); ints as exact f32 (< 2^24).
//     Empty slots have lo = +inf, hi = -inf and are skipped by kind.
//   * tris (T, 9) f32 rows v0 e1 e2 in stream order.
//   * inv (12 floats, or null): the instance's inverse world, 3x3
//     row-major then translation (o*M + t, d*M, t in world units).
//   * per ray: stack = [0]; pop a supernode, then for child k = 3, 2, 1, 0
//     slab-test its box against the ray's best t; a hit leaf is tested at
//     once (Moller-Trumbore, exact 1/det, accepted on t <= best_t), a hit
//     internal child is pushed, so child 0 pops first.  Same visit order
//     and comparisons as the TPU, so exact-t ties resolve as there.
//   * the stack holds at most 3 * depth + 1 entries; the wrapper raises
//     when the tree's bound exceeds K5_MAX_STACK (the TPU's 64-entry SMEM
//     stack had no check at all).
//   * outputs t (t_max on a miss), u, v (0 on a miss), stream position
//     (-1 on a miss).  Rays with t_max < 0 are dead and return at once.
//   * stats (null, or 2 int64): child box tests and triangle tests.
//
// What bounds it on this card: latency of dependent loads.  A supernode
// is one 144-byte row (4 boxes per fetch, the point of the 4-wide tree),
// a triangle one 36-byte row; the mesh's tree sits in L2.  The TPU ran a
// 1024-ray packet over one SMEM stack, so each ray paid for the packet's
// union of visits; here each thread keeps its own stack in local memory
// (L1) and visits only what its own box tests admit, with warp coherence
// from the caller's ray order.

#include <cuda_runtime.h>

#include "ray.cuh"

#define K5_MAX_STACK 64

namespace {

__global__ void __launch_bounds__(128)
trace_wide4_kernel(const float* __restrict__ nodes,
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
    int stack[K5_MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      const float* __restrict__ nd = nodes + (size_t)stack[--sp] * 36;
      for (int k = 3; k >= 0; --k) {
        const int kind = (int)__ldg(nd + 24 + k);
        if (kind == 0) continue;
        ++n_box;
        float tn;
        if (!rtggx::box_hit(nd + 6 * k, ray, t_min, best_t, tn)) continue;
        const int a = (int)__ldg(nd + 28 + k);
        if (kind == 2) {
          if (sp < K5_MAX_STACK) stack[sp++] = a;  // bound checked on the host
          continue;
        }
        const int count = (int)__ldg(nd + 32 + k);
        n_tri += count;
        for (int j = a; j < a + count; ++j)
          if (rtggx::tri_hit(tris + (size_t)j * 9, ray, t_min, best_t, best_u,
                             best_v))
            best_pos = j;
      }
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

extern "C" int rtggx_trace_wide4(const void* nodes, const void* tris,
                                 const void* inv, const void* ray_o,
                                 const void* ray_d, const void* t_max,
                                 float t_min, int n_rays, void* out_t,
                                 void* out_u, void* out_v, void* out_pos,
                                 void* stats, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  trace_wide4_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)tris, (const float*)inv,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, (float*)out_t, (float*)out_u, (float*)out_v, (int*)out_pos,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

extern "C" int rtggx_k5_max_stack() { return K5_MAX_STACK; }
