// K1: closest-hit traversal of the instanced 4-wide scene BVH.
//
// Replaces the TPU kernel raytracedggx_tpu/ops/fused.py:_instanced_kernel
// (launched by trace_tiles_instanced), lean layout.
//
// Contract (identical outputs to the lean TPU kernel):
//   * nodes (N, 36) f32 rows: 4 child boxes (lo.xyz, hi.xyz) at 6k, child
//     kind at 24+k (0 empty / 1 leaf / 2 internal / 3 instance entry),
//     child address at 28+k (leaf ordinal or node index), instance tag
//     at 32+k for kind 3.  The first rows are the top tree over instance
//     WORLD boxes, the rest shared OBJECT-space mesh subtrees.
//   * tris (S, 9) f32 stream slots v0 e1 e2 in object space; leaf j owns
//     slots [j*L, (j+1)*L); padding slots carry v0 = NaN and never hit.
//   * inv_mats (1+I, 12): 3x3 row-major + translation of each tag's
//     inverse world; tag 0 is the identity (world space).
//   * stack entries pack node | tag << 20; kind-3 children switch to their
//     tag, kind-2 children inherit the current one.  On a tag change the
//     ray goes to object space as o*M + t and d*M with the direction left
//     unnormalised, so t stays in world units across instances.
//   * box test (tn <= tf) & (tf >= t_min) & (tn <= best_t) with the
//     safe_inv epsilon 1e-20; triangle test u>=0, v>=0, u+v<=1, t>=t_min,
//     t<=best_t (Moller-Trumbore, exact divide in place of the TPU's
//     approximate reciprocal).
//   * outputs t (t_max on a miss), u, v (0 on a miss), slot = leaf*L + k
//     and inst = tag-1 as int32 (-1 on a miss).  Rays with t_max < 0 are
//     dead and return at once.
//   * stats (null, or 2 int64): child box tests and triangle tests, summed.
//
// What bounds it on this card: latency of dependent loads.  Each step of
// a ray pops a node (144 B) and, at leaves, streams 9*L floats; the
// arithmetic is a few hundred FLOPs per leaf.  The TPU kernel ran a
// 1024-ray packet over one shared SMEM stack, so every ray paid for the
// union of its packet's node and leaf visits.  Here each thread owns one
// ray and its own stack (local memory, L1-resident), so a ray visits only
// the nodes its own box tests admit; coherence within a warp comes from
// the caller's ray order (screen blocks for primary rays, direction
// octant + Morton for bounces), which keeps neighbouring threads on the
// same node and leaf rows so the loads hit L1.  Children are pushed far
// to near so the nearest is popped first and best_t shrinks early.

#include <cuda_runtime.h>

#include "ray.cuh"

#define K1_MAX_STACK 256
#define K1_TAG_SHIFT 20
#define K1_NODE_MASK 0xFFFFF

namespace {

__global__ void __launch_bounds__(128)
trace_instanced_kernel(const float* __restrict__ nodes,
                       const float* __restrict__ tris,
                       const float* __restrict__ inv_mats,
                       const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d,
                       const float* __restrict__ t_max, float t_min,
                       int n_rays, int L, int stack_size,
                       float* __restrict__ out_t, float* __restrict__ out_u,
                       float* __restrict__ out_v, int* __restrict__ out_slot,
                       int* __restrict__ out_inst,
                       unsigned long long* __restrict__ stats) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float wox = ray_o[3 * r], woy = ray_o[3 * r + 1], woz = ray_o[3 * r + 2];
  const float wdx = ray_d[3 * r], wdy = ray_d[3 * r + 1], wdz = ray_d[3 * r + 2];
  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1, best_inst = -1;
  unsigned long long n_box = 0, n_tri = 0;

  if (best_t >= 0.0f) {  // t_max < 0: dead ray, no traversal
    int stack[K1_MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;  // root of the top tree, tag 0
    int cur_tag = -1;
    rtggx::Ray ro;
    while (sp > 0) {
      const int e = stack[--sp];
      const int idx = e & K1_NODE_MASK;
      const int tag = e >> K1_TAG_SHIFT;
      if (tag != cur_tag) {
        ro = rtggx::make_ray(inv_mats + 12 * tag, wox, woy, woz, wdx, wdy, wdz);
        cur_tag = tag;
      }
      const float* __restrict__ nd = nodes + (size_t)idx * 36;
      float keys[4];
      int vals[4];
      int n_push = 0;
      for (int k = 0; k < 4; ++k) {
        const int kind = (int)__ldg(nd + 24 + k);
        if (kind == 0) continue;
        ++n_box;
        float tn;
        if (!rtggx::box_hit(nd + 6 * k, ro, t_min, best_t, tn)) continue;
        const int a = (int)__ldg(nd + 28 + k);
        if (kind == 1) {
          const float* __restrict__ leaf = tris + (size_t)a * L * 9;
          for (int j = 0; j < L; ++j) {
            const float* tr = leaf + 9 * j;
            // build_records4_padded fills a leaf's real triangles first,
            // then its NaN padding: the first pad ends the leaf
            if (isnan(__ldg(tr))) break;
            ++n_tri;
            if (rtggx::tri_hit(tr, ro, t_min, best_t, best_u, best_v)) {
              best_slot = a * L + j;
              best_inst = tag - 1;
            }
          }
        } else {
          const int child_tag = kind == 3 ? (int)__ldg(nd + 32 + k) : tag;
          // insertion sort, descending entry distance
          int p = n_push++;
          while (p > 0 && keys[p - 1] < tn) {
            keys[p] = keys[p - 1];
            vals[p] = vals[p - 1];
            --p;
          }
          keys[p] = tn;
          vals[p] = a | (child_tag << K1_TAG_SHIFT);
        }
      }
      // far first, so the nearest child is popped next; a full stack drops
      // the subtree (the bound from build_scene_wide makes that unreachable)
      for (int p = 0; p < n_push; ++p)
        if (sp < stack_size) stack[sp++] = vals[p];
    }
  }
  out_t[r] = best_t;
  out_u[r] = best_u;
  out_v[r] = best_v;
  out_slot[r] = best_slot;
  out_inst[r] = best_inst;
  if (stats != nullptr) {
    atomicAdd(stats, n_box);
    atomicAdd(stats + 1, n_tri);
  }
}

}  // namespace

extern "C" int rtggx_trace_instanced(const void* nodes, const void* tris,
                                     const void* inv_mats, const void* ray_o,
                                     const void* ray_d, const void* t_max,
                                     float t_min, int n_rays, int leaf_size,
                                     int stack_size, void* out_t, void* out_u,
                                     void* out_v, void* out_slot,
                                     void* out_inst, void* stats,
                                     void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size > K1_MAX_STACK) stack_size = K1_MAX_STACK;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  trace_instanced_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)tris, (const float*)inv_mats,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, leaf_size, stack_size, (float*)out_t, (float*)out_u,
      (float*)out_v, (int*)out_slot, (int*)out_inst,
      (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

extern "C" int rtggx_k1_max_stack() { return K1_MAX_STACK; }
