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

#define K1_MAX_STACK 256
#define K1_TAG_SHIFT 20
#define K1_NODE_MASK 0xFFFFF

namespace {

struct ObjRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-20f;
  if (fabsf(d) < eps) d = d >= 0.0f ? eps : -eps;
  return 1.0f / d;
}

__device__ __forceinline__ ObjRay to_object(const float* __restrict__ m,
                                            float wox, float woy, float woz,
                                            float wdx, float wdy, float wdz) {
  ObjRay r;
  r.ox = wox * __ldg(m + 0) + woy * __ldg(m + 3) + woz * __ldg(m + 6) + __ldg(m + 9);
  r.oy = wox * __ldg(m + 1) + woy * __ldg(m + 4) + woz * __ldg(m + 7) + __ldg(m + 10);
  r.oz = wox * __ldg(m + 2) + woy * __ldg(m + 5) + woz * __ldg(m + 8) + __ldg(m + 11);
  r.dx = wdx * __ldg(m + 0) + wdy * __ldg(m + 3) + wdz * __ldg(m + 6);
  r.dy = wdx * __ldg(m + 1) + wdy * __ldg(m + 4) + wdz * __ldg(m + 7);
  r.dz = wdx * __ldg(m + 2) + wdy * __ldg(m + 5) + wdz * __ldg(m + 8);
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

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
                       int* __restrict__ out_inst) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float wox = ray_o[3 * r], woy = ray_o[3 * r + 1], woz = ray_o[3 * r + 2];
  const float wdx = ray_d[3 * r], wdy = ray_d[3 * r + 1], wdz = ray_d[3 * r + 2];
  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1, best_inst = -1;

  if (best_t >= 0.0f) {  // t_max < 0: dead ray, no traversal
    int stack[K1_MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;  // root of the top tree, tag 0
    int cur_tag = -1;
    ObjRay ro;
    while (sp > 0) {
      const int e = stack[--sp];
      const int idx = e & K1_NODE_MASK;
      const int tag = e >> K1_TAG_SHIFT;
      if (tag != cur_tag) {
        ro = to_object(inv_mats + 12 * tag, wox, woy, woz, wdx, wdy, wdz);
        cur_tag = tag;
      }
      const float* __restrict__ nd = nodes + (size_t)idx * 36;
      float keys[4];
      int vals[4];
      int n_push = 0;
      for (int k = 0; k < 4; ++k) {
        const int kind = (int)__ldg(nd + 24 + k);
        if (kind == 0) continue;
        const float* b = nd + 6 * k;
        const float t0x = (__ldg(b + 0) - ro.ox) * ro.ix;
        const float t1x = (__ldg(b + 3) - ro.ox) * ro.ix;
        const float t0y = (__ldg(b + 1) - ro.oy) * ro.iy;
        const float t1y = (__ldg(b + 4) - ro.oy) * ro.iy;
        const float t0z = (__ldg(b + 2) - ro.oz) * ro.iz;
        const float t1z = (__ldg(b + 5) - ro.oz) * ro.iz;
        const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        if (!((tn <= tf) && (tf >= t_min) && (tn <= best_t))) continue;
        const int a = (int)__ldg(nd + 28 + k);
        if (kind == 1) {
          const float* __restrict__ leaf = tris + (size_t)a * L * 9;
          for (int j = 0; j < L; ++j) {
            const float* tr = leaf + 9 * j;
            const float v0x = __ldg(tr + 0);
            // build_records4_padded fills a leaf's real triangles first,
            // then its NaN padding: the first pad ends the leaf
            if (v0x != v0x) break;
            const float v0y = __ldg(tr + 1), v0z = __ldg(tr + 2);
            const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4), e1z = __ldg(tr + 5);
            const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7), e2z = __ldg(tr + 8);
            const float px = ro.dy * e2z - ro.dz * e2y;
            const float py = ro.dz * e2x - ro.dx * e2z;
            const float pz = ro.dx * e2y - ro.dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const float inv_det = 1.0f / det;
            const float tx = ro.ox - v0x, ty = ro.oy - v0y, tz = ro.oz - v0z;
            const float u = (tx * px + ty * py + tz * pz) * inv_det;
            const float qx = ty * e1z - tz * e1y;
            const float qy = tz * e1x - tx * e1z;
            const float qz = tx * e1y - ty * e1x;
            const float v = (ro.dx * qx + ro.dy * qy + ro.dz * qz) * inv_det;
            const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
            if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min && t <= best_t) {
              best_t = t;
              best_u = u;
              best_v = v;
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
}

}  // namespace

extern "C" int rtggx_trace_instanced(const void* nodes, const void* tris,
                                     const void* inv_mats, const void* ray_o,
                                     const void* ray_d, const void* t_max,
                                     float t_min, int n_rays, int leaf_size,
                                     int stack_size, void* out_t, void* out_u,
                                     void* out_v, void* out_slot,
                                     void* out_inst, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size > K1_MAX_STACK) stack_size = K1_MAX_STACK;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  trace_instanced_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)tris, (const float*)inv_mats,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, leaf_size, stack_size, (float*)out_t, (float*)out_u,
      (float*)out_v, (int*)out_slot, (int*)out_inst);
  return (int)cudaGetLastError();
}

extern "C" int rtggx_k1_max_stack() { return K1_MAX_STACK; }
