// K4: closest hit of object-space rays against ONE mesh's binary BVH.
//
// Replaces the TPU kernel raytracedggx_tpu/ops/traverse_pallas.py:
// _traverse_kernel (launched by trace_rays_pallas).
//
// Contract (the TPU kernel's outputs, its exact-t ties included):
//   * the tree is the DFS node stream of ops/flatten.py (node i's first
//     child is i + 1, skip(i) jumps past its subtree, a leaf owns the
//     stream triangles [tri_start, tri_start + tri_count)), read through
//     its float4 copies, the links as exact f32 integers (< 2^24):
//       pairs (P, 16) (FlatBVH.pairs): row 1 + k holds both children of
//         the k-th internal node i, nodes i + 1 and skip(i + 1): two boxes
//         lo.xyz hi.xyz, then per child its pair row and 0 (internal) or
//         tri_start and tri_count (leaf); row 0 holds the root beside an
//         empty slot (NaN box, count -1);
//       tris4 (T, 12) (FlatBVH.tris4): v0 _ e1 _ e2 _ in stream order.
//   * inv (12 floats, or null for rays already in object space): the
//     instance's inverse world, 3x3 row-major then translation; the ray
//     goes to object space as o*M + t and d*M, direction unnormalised so
//     t stays in world units.
//   * a box passes on (tn <= tf) & (tf >= t_min) & (tn <= best_t) (the
//     safe_inv epsilon 1e-20); Moller-Trumbore with an exact 1/det, a hit
//     taken on t < best_t, or on t == best_t at a later stream position.
//     The TPU walks the stream's DFS order and takes t <= best_t, so of
//     triangles at exactly the same t the last in the stream wins; with
//     the culling inclusive (tn <= best_t) every visit order that takes
//     hits this way returns that triangle too.
//   * outputs t (t_max on a miss), u, v (0 on a miss) and the stream
//     position (-1 on a miss).  Rays with t_max < 0 are dead and return
//     at once (no triangle can pass t_min <= t <= t_max < 0).
//   * the stack holds at most depth - 1 entries (FlatBVH.stack is the
//     depth); the wrapper raises above K4_MAX_STACK.
//   * stats (null, or 2 int64): box tests and triangle tests, summed.
//
// What bounds it on this card: the latency of dependent loads.  A ray's
// next row depends on its own last test, the rows of one mesh (about
// 5 MB for 82k triangles) sit in L2, and the arithmetic is 25 operations
// per box and 51 per triangle.  On the frame's waves nearly
// every ray leaves at the root; the kernel's time is the chain of
// dependent visits of the few warps that enter the mesh.  The TPU kernel
// walked a 1024-ray packet through the tree in DFS order with a frustum
// pre-test and a tile-wide any(), so every ray paid for its packet's
// union of visits; here each thread walks only the rows its own ray
// admits (the caller's ray order, screen blocks or octant + Morton, keeps
// a warp's rays on the same rows), and the design shortens the chain:
//   * near-first over child pairs: one visit tests both children of a
//     node from one 64-byte row (four float4 issued together); hit leaves
//     are tested at once, nearer first, each while its entry distance
//     still passes best_t; the walk descends into the nearer internal
//     child and pushes the farther with its entry distance, so a pop that
//     best_t has since passed costs no load.  The TPU's DFS order, with
//     the same loads and prefetch, kept testing far subtrees its best t
//     had not yet ruled out: 1.3-1.4x this walk's time and 1.1-1.2x its
//     box tests, 1.3-1.8x its triangle tests on the frame's waves on an
//     H100 (PERF.md);
//   * a leaf prefetch: triangle j + 1's loads go out before triangle j is
//     tested, so a leaf costs about one round trip, not one per triangle;
//   * the stack in shared memory, [entry][thread] so that the 32 threads
//     of a warp touch 32 banks, sized at launch from the tree's depth;
//   * stats summed over the warp, one pair of atomics per warp.
// No fast math: the NaN box must fail every comparison.

#include <cuda_runtime.h>

#include "ray.cuh"

#define K4_THREADS 128
#define K4_MAX_STACK 64

namespace {

__global__ void __launch_bounds__(K4_THREADS)
trace_flat_pairs_kernel(const float4* __restrict__ pairs,
                        const float4* __restrict__ tris,
                        const float* __restrict__ inv,
                        const float* __restrict__ ray_o,
                        const float* __restrict__ ray_d,
                        const float* __restrict__ t_max, float t_min,
                        int n_rays, int stack_size, float* __restrict__ out_t,
                        float* __restrict__ out_u, float* __restrict__ out_v,
                        int* __restrict__ out_pos,
                        unsigned long long* __restrict__ stats) {
  // [entry][thread]: (pair row, entry distance as bits)
  extern __shared__ int2 stack_smem[];
  int2* const stack = stack_smem + threadIdx.x;
  const int r = blockIdx.x * K4_THREADS + threadIdx.x;
  unsigned n_box = 0, n_tri = 0;  // this ray's tests
  if (r < n_rays) {
    float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
    int best_pos = -1;
    if (best_t >= 0.0f) {  // t_max < 0: dead ray, no traversal
      const rtggx::Ray ray = rtggx::make_ray(
          inv, ray_o[3 * r], ray_o[3 * r + 1], ray_o[3 * r + 2],
          ray_d[3 * r], ray_d[3 * r + 1], ray_d[3 * r + 2]);
      int row = 0, sp = 0;
      for (;;) {
        const float4* __restrict__ pr = pairs + (size_t)row * 4;
        const float4 b0 = __ldg(pr), b1 = __ldg(pr + 1), b2 = __ldg(pr + 2),
                     m = __ldg(pr + 3);
        n_box += row == 0 ? 1 : 2;  // row 0's second slot is empty
        float tn0, tn1;
        bool h0 = rtggx::box_hit(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, ray, t_min,
                                 best_t, tn0);
        bool h1 = rtggx::box_hit(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, ray, t_min,
                                 best_t, tn1);
        int a0 = (int)m.x, c0 = (int)m.y, a1 = (int)m.z, c1 = (int)m.w;
        if (h1 && (!h0 || tn1 < tn0)) {  // child 0: the nearer hit
          const bool h = h0;
          h0 = h1;
          h1 = h;
          const float tn = tn0;
          tn0 = tn1;
          tn1 = tn;
          const int a = a0, c = c0;
          a0 = a1;
          c0 = c1;
          a1 = a;
          c1 = c;
        }
        if (h0 && c0 > 0) {  // hit leaves now, nearer first
          n_tri += c0;
          rtggx::leaf_hit<true>(tris, a0, a0 + c0, ray, t_min, best_t, best_u,
                                best_v, best_pos);
        }
        if (h1 && c1 > 0 && tn1 <= best_t) {
          n_tri += c1;
          rtggx::leaf_hit<true>(tris, a1, a1 + c1, ray, t_min, best_t, best_u,
                                best_v, best_pos);
        }
        const bool in0 = h0 && c0 == 0 && tn0 <= best_t;
        const bool in1 = h1 && c1 == 0 && tn1 <= best_t;
        if (in0) {  // descend into the nearer, push the farther
          // the wrapper sizes the stack from the tree's depth, which no
          // walk exceeds; the test only keeps a malformed tree inside the
          // allocation
          if (in1 && sp < stack_size)
            stack[K4_THREADS * sp++] = make_int2(a1, __float_as_int(tn1));
          row = a0;
          continue;
        }
        if (in1) {
          row = a1;
          continue;
        }
        // pop the nearest pending subtree whose entry still passes best_t
        row = -1;
        while (sp > 0) {
          const int2 e = stack[K4_THREADS * --sp];
          if (__int_as_float(e.y) <= best_t) {
            row = e.x;
            break;
          }
        }
        if (row < 0) break;
      }
    }
    out_t[r] = best_t;
    out_u[r] = best_u;
    out_v[r] = best_v;
    out_pos[r] = best_pos;
  }
  rtggx::add_stats(stats, n_box, n_tri);  // every thread of the warp is here
}

}  // namespace

// stack_size: entries per thread, the tree's depth (1..K4_MAX_STACK); the
// launch takes stack_size * 128 * 8 bytes of shared memory per block.
extern "C" int rtggx_trace_flat(const void* pairs, const void* tris4,
                                const void* inv, const void* ray_o,
                                const void* ray_d, const void* t_max,
                                float t_min, int n_rays, int stack_size,
                                void* out_t, void* out_u, void* out_v,
                                void* out_pos, void* stats, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size < 1 || stack_size > K4_MAX_STACK)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + K4_THREADS - 1) / K4_THREADS;
  const int smem = (int)sizeof(int2) * K4_THREADS * stack_size;
  // up to 64 KB, above the default 48 KB a launch may take
  const cudaError_t err = cudaFuncSetAttribute(
      trace_flat_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  trace_flat_pairs_kernel<<<blocks, K4_THREADS, smem,
                            (cudaStream_t)stream>>>(
      (const float4*)pairs, (const float4*)tris4, (const float*)inv,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, stack_size, (float*)out_t, (float*)out_u, (float*)out_v,
      (int*)out_pos, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

extern "C" int rtggx_k4_max_stack() { return K4_MAX_STACK; }
