// K5: closest hit of object-space rays against ONE mesh's 4-wide BVH,
// with a per-ray stack.
//
// Replaces the TPU kernel raytracedggx_tpu/ops/wide.py:_kernel (launched
// by trace_tiles4).
//
// Contract (the TPU kernel's outputs, up to exact-t ties):
//   * nodes (N, 36) f32 rows, read as nine float4, the layout of K1's node
//     rows: 4 child boxes (lo.xyz, hi.xyz) at 6k, child kind at 24+k (0
//     empty / 1 leaf / 2 internal), at 28+k the supernode index (internal)
//     or tri_start (leaf), at 32+k the tri_count (leaf); ints as exact f32
//     (< 2^24).  Empty slots have lo = +inf, hi = -inf and are skipped by
//     kind.
//   * tris4 (T, 12) f32 rows, three float4 v0 _ e1 _ e2 _ in stream order
//     (WideBVH.tris4, the (T, 9) rows each padded with a 0).
//   * inv (12 floats, or null): the instance's inverse world, 3x3
//     row-major then translation (o*M + t, d*M, t in world units).
//   * per ray: stack = [0]; pop a supernode and slab-test its four
//     children's boxes against the ray's best t; the hit leaves run in
//     child order, each while its entry distance still passes the
//     shrinking best t (Moller-Trumbore, exact 1/det, accepted on
//     t <= best_t); the hit internal children that still pass are pushed
//     far to near (a 5-exchange network), so the nearest pops next, as in
//     K1.  The TPU kernel visits in a fixed order (children 3..0, a hit
//     leaf tested at once, child 0 popped first); the comparisons are the
//     same, so both find the same hits and t, but of two triangles at
//     exactly the same t they may keep different ones.
//   * the stack holds at most 3 * depth + 1 entries (WideBVH.stack); the
//     wrapper raises when that exceeds K5_MAX_STACK (the TPU's 64-entry
//     SMEM stack had no check at all).
//   * outputs t (t_max on a miss), u, v (0 on a miss), stream position
//     (-1 on a miss).  Rays with t_max < 0 are dead and return at once.
//   * stats (null, or 2 int64): child box tests and triangle tests.
//
// What bounds it on this card: the latency of dependent loads.  A ray pops
// a supernode, and only its four boxes say which rows come next, so no
// tile can be fetched ahead (no TMA) and there is no matrix product (no
// wgmma); the arithmetic is 25 operations per box and 51 per triangle,
// and the mesh's tree sits in L2.  The TPU kernel ran a 1024-ray packet
// over one SMEM stack, so each ray paid for the packet's union of visits;
// here each thread owns one ray, and the design cuts the round trips each
// visit costs, as K1 does (traverse.cu):
//   * 16-byte loads: a supernode is nine float4 (144 B, 16-byte aligned
//     rows), all issued at the pop, so its four boxes, kinds, addresses
//     and counts arrive in one round trip instead of 4 x 9 scalar loads;
//     a triangle is three float4 of tris4 instead of nine scalars;
//   * a leaf prefetch: triangle j + 1's loads go out before triangle j is
//     tested, so a leaf costs about one round trip, not one per triangle;
//   * the stack in shared memory, [entry][thread] so that the 32 threads
//     of a warp touch 32 banks, sized at launch from the tree's bound; no
//     array is indexed at run time in local memory (the children are
//     unrolled, their fields picked from the float4 by constant lanes);
//   * stats summed over the warp first, one pair of atomics per warp;
//   * near-first order.  On the frame's waves nearly all the time goes to
//     the few warps whose rays enter the mesh, each a chain of dependent
//     node and leaf visits; visiting near children first finds the hit
//     sooner and prunes more of the rest: fewer box and triangle tests
//     than the TPU's order on the same rays, and a shorter chain for the
//     slowest warps (PERF.md).
// Coherence within a warp comes from the caller's ray order.  No fast
// math: empty boxes must fail every comparison.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "ray.cuh"

#define K5_THREADS 128
#define K5_MAX_STACK 64

namespace {

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// one exchange of the sorting network: descending keys
__device__ __forceinline__ void exchange(float& ka, int& va, float& kb,
                                         int& vb) {
  if (ka < kb) {
    const float k = ka;
    ka = kb;
    kb = k;
    const int v = va;
    va = vb;
    vb = v;
  }
}

// Slab test of child k's box, floats 6k .. 6k+5 of the row b (constant
// lanes once the caller's loop over k is unrolled).
__device__ __forceinline__ bool child_hit(const float4 (&b)[6], int k,
                                          const rtggx::Ray& ray, float t_min,
                                          float best_t, float& tn) {
  return rtggx::box_hit(lane(b[(6 * k) / 4], (6 * k) % 4),
                        lane(b[(6 * k + 1) / 4], (6 * k + 1) % 4),
                        lane(b[(6 * k + 2) / 4], (6 * k + 2) % 4),
                        lane(b[(6 * k + 3) / 4], (6 * k + 3) % 4),
                        lane(b[(6 * k + 4) / 4], (6 * k + 4) % 4),
                        lane(b[(6 * k + 5) / 4], (6 * k + 5) % 4), ray, t_min,
                        best_t, tn);
}

__global__ void __launch_bounds__(K5_THREADS)
trace_wide4_kernel(const float4* __restrict__ nodes,
                   const float4* __restrict__ tris,
                   const float* __restrict__ inv,
                   const float* __restrict__ ray_o,
                   const float* __restrict__ ray_d,
                   const float* __restrict__ t_max, float t_min, int n_rays,
                   int stack_size, float* __restrict__ out_t,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   int* __restrict__ out_pos,
                   unsigned long long* __restrict__ stats) {
  extern __shared__ int stack_smem[];  // [entry][thread]
  int* const stack = stack_smem + threadIdx.x;
  const int r = blockIdx.x * K5_THREADS + threadIdx.x;
  unsigned n_box = 0, n_tri = 0;  // this ray's tests

  if (r < n_rays) {
    float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
    int best_pos = -1;
    if (best_t >= 0.0f) {  // t_max < 0: dead ray, no traversal
      const rtggx::Ray ray = rtggx::make_ray(
          inv, ray_o[3 * r], ray_o[3 * r + 1], ray_o[3 * r + 2],
          ray_d[3 * r], ray_d[3 * r + 1], ray_d[3 * r + 2]);
      int sp = 0;
      stack[K5_THREADS * sp++] = 0;
      while (sp > 0) {
        const float4* __restrict__ nd =
            nodes + (size_t)stack[K5_THREADS * --sp] * 9;
        const float4 b[6] = {__ldg(nd), __ldg(nd + 1), __ldg(nd + 2),
                             __ldg(nd + 3), __ldg(nd + 4), __ldg(nd + 5)};
        const float4 kinds = __ldg(nd + 6), addrs = __ldg(nd + 7),
                     counts = __ldg(nd + 8);
        float tn[4];  // entry distances
        bool hit[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          hit[k] = lane(kinds, k) != 0.0f &&
                   child_hit(b, k, ray, t_min, best_t, tn[k]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // leaves in child order
          const int kind = (int)lane(kinds, k);
          n_box += kind != 0;
          if (hit[k] && kind == 1 && tn[k] <= best_t) {
            const int a = (int)lane(addrs, k), end = a + (int)lane(counts, k);
            n_tri += end - a;
            rtggx::leaf_hit<false>(tris, a, end, ray, t_min, best_t, best_u,
                                   best_v, best_pos);
          }
        }
        float key[4];
        int val[4];  // -1: not pushed
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool push = hit[k] && lane(kinds, k) == 2.0f && tn[k] <= best_t;
          key[k] = push ? tn[k] : -CUDART_INF_F;
          val[k] = push ? (int)lane(addrs, k) : -1;
        }
        exchange(key[0], val[0], key[1], val[1]);
        exchange(key[2], val[2], key[3], val[3]);
        exchange(key[0], val[0], key[2], val[2]);
        exchange(key[1], val[1], key[3], val[3]);
        exchange(key[1], val[1], key[2], val[2]);
        // far first, so the nearest child is popped next.  The wrapper
        // sizes the stack from the tree's bound, which no walk exceeds;
        // the test only keeps a malformed tree inside the allocation
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (val[p] >= 0 && sp < stack_size) stack[K5_THREADS * sp++] = val[p];
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

// stack_size: entries per thread, the tree's bound (1..K5_MAX_STACK); the
// launch takes stack_size * 128 * 4 bytes of shared memory per block.
extern "C" int rtggx_trace_wide4(const void* nodes, const void* tris4,
                                 const void* inv, const void* ray_o,
                                 const void* ray_d, const void* t_max,
                                 float t_min, int n_rays, int stack_size,
                                 void* out_t, void* out_u, void* out_v,
                                 void* out_pos, void* stats, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size < 1 || stack_size > K5_MAX_STACK)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + K5_THREADS - 1) / K5_THREADS;
  const size_t smem = sizeof(int) * K5_THREADS * stack_size;
  trace_wide4_kernel<<<blocks, K5_THREADS, smem, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float4*)tris4, (const float*)inv,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, stack_size, (float*)out_t, (float*)out_u, (float*)out_v,
      (int*)out_pos, (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

extern "C" int rtggx_k5_max_stack() { return K5_MAX_STACK; }
