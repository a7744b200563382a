// K1: closest-hit traversal of the instanced 4-wide scene BVH.
//
// Replaces the TPU kernel raytracedggx_tpu/ops/fused.py:_instanced_kernel
// (launched by trace_tiles_instanced) in its three output modes, each an
// instance of one template on the same walk:
//   * lean (K1): t, u, v, slot, inst;
//   * slim (K1s, the TPU's slim=True): t, slot, inst only; the leaf test
//     keeps best t and its slot (rtggx::tri_hit_t), so no best u and v
//     are carried, and the caller recomputes u, v from the slot with
//     slim_uv_kernel below (K1e);
//   * fat (K1f, the TPU's lean=False): t, u, v, the interpolated
//     OBJECT-space normal (R, 3) and prim, inst.  The TPU kernel read
//     19L-column fat leaves and interpolated at every accepted hit; here
//     the walk is lean's, and after it the winner's slot row of attrs4
//     gives n0, n1, n2 and prim: w0*n0 + u*n1 + v*n2, w0 = (1 - u) - v,
//     rounded op by op (__fmul_rn / __fadd_rn) in the plain version's
//     order, so it equals that interpolation of the same u, v bit for
//     bit; a miss writes a zero normal and prim -1.
//
// Contract (identical outputs to the TPU kernel in each mode):
//   * nodes (N, 36) f32 rows, read as nine float4: 4 child boxes (lo.xyz,
//     hi.xyz) at 6k, child kind at 24+k (0 empty / 1 leaf / 2 internal /
//     3 instance entry), child address at 28+k (leaf ordinal or node
//     index), instance tag at 32+k for kind 3.  The first rows are the top
//     tree over instance WORLD boxes, the rest shared OBJECT-space mesh
//     subtrees.
//   * tris4 (S, 12) f32 stream slots, three float4 v0 _ e1 _ e2 _ in
//     object space; leaf j owns slots [j*L, (j+1)*L) for any L given at
//     run time; padding slots carry v0 = NaN and never hit.
//   * inv_mats (1+I, 12), three float4 per row: 3x3 row-major +
//     translation of each tag's inverse world; tag 0 is the identity.
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
//   * stats (null, or stat_slots rows of stat_width int64): child box
//     tests and triangle tests, summed, and with stat_width 3 the instance
//     entries besides: the kind-3 children pushed (each popped once),
//     each one instance's object-space subtree that the ray walks.  Block
//     b adds to row b % stat_slots.  One row for the whole grid
//     serialises every warp's atomics on the same addresses at the end of
//     a wave (K1 +9-15% a frame on the NVIDIA H100); the caller sums the
//     rows.
//
// What bounds it on this card: the latency of dependent loads.  A ray
// pops a node, and only the node's four boxes say which rows come next,
// so no tile can be fetched ahead (no TMA) and there is no matrix product
// (no wgmma); the arithmetic is 25 operations per box and 51 per
// triangle.  The TPU kernel ran a 1024-ray packet over one shared SMEM
// stack, so every ray paid for the union of its packet's visits.  Here
// each thread owns one ray, and the design spends what the card offers on
// the loads and on warps in flight:
//   * a leaf size chosen on this card (RenderConfig.wide_leaf_size, 8):
//     small leaves trade a few more node visits for far fewer triangle
//     tests, and any L still works;
//   * 16-byte loads: a node is nine float4 (144 B, 16-byte aligned rows),
//     a triangle three, the inverse world three.  A node's loads go out
//     before a tag switch's transform, and a leaf's next slot is loaded
//     while the current one is tested, so a leaf costs about one round
//     trip to the cache, not two per triangle;
//   * the stack in shared memory, [entry][thread] so that the 32 threads
//     of a warp touch 32 banks, sized at launch from the tree's bound
//     (3 * depth + 1, at most the compiled 64); the wrapper refuses a
//     deeper tree, so no push is ever dropped.  No array is indexed at run
//     time in local memory: the four children live in registers, sorted
//     by a 5-exchange network, and leaves are walked from a bit mask;
//   * near-first order: the four boxes are tested against best_t at the
//     pop; the node's leaves run in child order, each while its entry
//     distance still passes the shrinking best_t; the internal children
//     that still pass are pushed far to near, so the nearest is popped
//     next.
// Coherence within a warp comes from the caller's ray order (screen
// blocks for primary rays, direction octant + Morton for bounces).  No
// fast math: NaN pads and empty boxes must fail every comparison.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "ray.cuh"

#define K1_THREADS 128
#define K1E_THREADS 256
#define K1_MAX_STACK 64
#define K1_LEAN 0
#define K1_SLIM 1
#define K1_FAT 2
#define K1_TAG_SHIFT 20
#define K1_NODE_MASK 0xFFFFF

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

// w0*n0 + u*n1 + v*n2, each product and sum rounded on its own
__device__ __forceinline__ float interp(float w0, float n0, float u, float n1,
                                        float v, float n2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(w0, n0), __fmul_rn(u, n1)),
                   __fmul_rn(v, n2));
}

template <int MODE>
__global__ void __launch_bounds__(K1_THREADS)
trace_instanced_kernel(const float4* __restrict__ nodes,
                       const float4* __restrict__ tris,
                       const float4* __restrict__ inv_mats,
                       const float4* __restrict__ attrs4,
                       const float* __restrict__ ray_o,
                       const float* __restrict__ ray_d,
                       const float* __restrict__ t_max, float t_min,
                       int n_rays, int L, int stack_size,
                       float* __restrict__ out_t, float* __restrict__ out_u,
                       float* __restrict__ out_v, float* __restrict__ out_n,
                       int* __restrict__ out_id, int* __restrict__ out_inst,
                       unsigned long long* __restrict__ stats,
                       int stat_slots, int stat_width) {
  extern __shared__ int stack_smem[];  // [entry][thread]
  int* const stack = stack_smem + threadIdx.x;
  const int r = blockIdx.x * K1_THREADS + threadIdx.x;
  unsigned n_box = 0, n_tri = 0, n_inst = 0;  // this ray's tests, entries

  if (r < n_rays) {
    const float wox = ray_o[3 * r], woy = ray_o[3 * r + 1], woz = ray_o[3 * r + 2];
    const float wdx = ray_d[3 * r], wdy = ray_d[3 * r + 1], wdz = ray_d[3 * r + 2];
    float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
    int best_slot = -1, best_inst = -1;

    if (best_t >= 0.0f) {  // t_max < 0: dead ray, no traversal
      int sp = 0;
      stack[K1_THREADS * sp++] = 0;  // root of the top tree, tag 0
      int cur_tag = -1;
      rtggx::Ray ro;
      while (sp > 0) {
        const int e = stack[K1_THREADS * --sp];
        const int idx = e & K1_NODE_MASK;
        const int tag = e >> K1_TAG_SHIFT;
        // the node's loads first: they do not wait for a tag switch
        const float4* __restrict__ nd = nodes + (size_t)idx * 9;
        const float4 b0 = __ldg(nd), b1 = __ldg(nd + 1), b2 = __ldg(nd + 2);
        const float4 b3 = __ldg(nd + 3), b4 = __ldg(nd + 4), b5 = __ldg(nd + 5);
        const float4 kinds = __ldg(nd + 6), addrs = __ldg(nd + 7);
        if (tag != cur_tag) {
          const float4* __restrict__ m = inv_mats + 3 * tag;
          ro = rtggx::make_ray(__ldg(m), __ldg(m + 1), __ldg(m + 2), wox, woy,
                               woz, wdx, wdy, wdz);
          // a pushed instance entry is popped once, and the walk finishes
          // its subtree before anything below it on the stack: so the
          // switches to a tag other than the top tree's count the
          // instance entries, off the per-child path
          n_inst += tag != 0;
          cur_tag = tag;
        }
        const int kind[4] = {(int)kinds.x, (int)kinds.y, (int)kinds.z,
                             (int)kinds.w};
        float4 tn = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // entry distances
        bool hit[4];
        hit[0] = kind[0] != 0 && rtggx::box_hit(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y,
                                                ro, t_min, best_t, tn.x);
        hit[1] = kind[1] != 0 && rtggx::box_hit(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w,
                                                ro, t_min, best_t, tn.y);
        hit[2] = kind[2] != 0 && rtggx::box_hit(b3.x, b3.y, b3.z, b3.w, b4.x, b4.y,
                                                ro, t_min, best_t, tn.z);
        hit[3] = kind[3] != 0 && rtggx::box_hit(b4.z, b4.w, b5.x, b5.y, b5.z, b5.w,
                                                ro, t_min, best_t, tn.w);
        unsigned leaves = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          n_box += kind[k] != 0;
          if (hit[k] && kind[k] == 1) leaves |= 1u << k;
        }
        while (leaves) {  // leaves in child order
          const int k = __ffs(leaves) - 1;
          leaves &= leaves - 1;
          if (!(lane(tn, k) <= best_t)) continue;  // an earlier leaf was nearer
          const int a = (int)lane(addrs, k);
          const float4* __restrict__ tr = tris + (size_t)a * L * 3;
          float4 v0 = __ldg(tr), e1 = __ldg(tr + 1), e2 = __ldg(tr + 2);
          for (int j = 0; j < L; ++j) {
            // build_records4_padded fills a leaf's real triangles first,
            // then its NaN padding: the first pad ends the leaf
            if (isnan(v0.x)) break;
            ++n_tri;
            // the next slot's loads go out before this slot's test
            float4 nv0 = v0, ne1 = e1, ne2 = e2;
            if (j + 1 < L) {
              tr += 3;
              nv0 = __ldg(tr);
              ne1 = __ldg(tr + 1);
              ne2 = __ldg(tr + 2);
            }
            bool took;
            if constexpr (MODE == K1_SLIM)
              took = rtggx::tri_hit_t(v0.x, v0.y, v0.z, e1.x, e1.y, e1.z,
                                      e2.x, e2.y, e2.z, ro, t_min, best_t);
            else
              took = rtggx::tri_hit(v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x,
                                    e2.y, e2.z, ro, t_min, best_t, best_u,
                                    best_v);
            if (took) {
              best_slot = a * L + j;
              best_inst = tag - 1;
            }
            v0 = nv0;
            e1 = ne1;
            e2 = ne2;
          }
        }
        const bool any_inst = kind[0] == 3 || kind[1] == 3 || kind[2] == 3 ||
                              kind[3] == 3;
        const float4 tags = any_inst ? __ldg(nd + 8) : make_float4(0, 0, 0, 0);
        float key[4];
        int val[4];  // -1: not pushed
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float t_in = lane(tn, k);
          const bool push = hit[k] && kind[k] >= 2 && t_in <= best_t;
          const int child_tag = kind[k] == 3 ? (int)lane(tags, k) : tag;
          key[k] = push ? t_in : -CUDART_INF_F;
          val[k] = push ? (int)lane(addrs, k) | (child_tag << K1_TAG_SHIFT) : -1;
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
          if (val[p] >= 0 && sp < stack_size) stack[K1_THREADS * sp++] = val[p];
      }
    }
    out_t[r] = best_t;
    if constexpr (MODE != K1_SLIM) {
      out_u[r] = best_u;
      out_v[r] = best_v;
    }
    if constexpr (MODE == K1_FAT) {
      float nx = 0.0f, ny = 0.0f, nz = 0.0f;
      int prim = -1;
      if (best_slot >= 0) {
        // the winner's row: n0.xyz n1.x | n1.yz n2.xy | n2.z prim _ _
        const float4* __restrict__ ar = attrs4 + (size_t)best_slot * 3;
        const float4 a0 = __ldg(ar), a1 = __ldg(ar + 1), a2 = __ldg(ar + 2);
        const float w0 = __fsub_rn(__fsub_rn(1.0f, best_u), best_v);
        nx = interp(w0, a0.x, best_u, a0.w, best_v, a1.z);
        ny = interp(w0, a0.y, best_u, a1.x, best_v, a1.w);
        nz = interp(w0, a0.z, best_u, a1.y, best_v, a2.x);
        prim = (int)a2.y;
      }
      out_n[3 * r] = nx;
      out_n[3 * r + 1] = ny;
      out_n[3 * r + 2] = nz;
      out_id[r] = prim;
    } else {
      out_id[r] = best_slot;
    }
    out_inst[r] = best_inst;
  }
  // every thread of the warp is here
  unsigned long long* const row =
      stats == nullptr ? nullptr
                       : stats + stat_width * (blockIdx.x % stat_slots);
  rtggx::add_stats(row, n_box, n_tri);
  if (row != nullptr && stat_width == 3) {
    n_inst = __reduce_add_sync(0xFFFFFFFFu, n_inst);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(row + 2, (unsigned long long)n_inst);
  }
}

template <int MODE>
void launch(const void* nodes, const void* tris4, const void* inv_mats,
            const void* attrs4, const void* ray_o, const void* ray_d,
            const void* t_max, float t_min, int n_rays, int leaf_size,
            int stack_size, void* out_t, void* out_u, void* out_v,
            void* out_n, void* out_id, void* out_inst, void* stats,
            int stat_slots, int stat_width, void* stream) {
  const int blocks = (n_rays + K1_THREADS - 1) / K1_THREADS;
  const size_t smem = sizeof(int) * K1_THREADS * stack_size;
  trace_instanced_kernel<MODE>
      <<<blocks, K1_THREADS, smem, (cudaStream_t)stream>>>(
          (const float4*)nodes, (const float4*)tris4,
          (const float4*)inv_mats, (const float4*)attrs4,
          (const float*)ray_o, (const float*)ray_d, (const float*)t_max,
          t_min, n_rays, leaf_size, stack_size, (float*)out_t,
          (float*)out_u, (float*)out_v, (float*)out_n, (int*)out_id,
          (int*)out_inst, (unsigned long long*)stats, stat_slots,
          stat_width);
}

// K1e, K1s's epilogue: u, v of each ray's winning slot (0 where slot < 0),
// from the walk's own object-space ray (rtggx::make_ray of the winner's
// inverse world, tag inst + 1) and its Moller-Trumbore (rtggx::tri_uvt),
// so they equal lean K1's bit for bit.  The TPU recomputed them in XLA
// after its slim kernel (raytracedggx_tpu/ops/scene_wide.py:456-470); a
// float32 recompute in another order differs from the walk's by more than
// 1e-4 on grazing hits (its error grows as |o - v0| / (|e1| cos)), so the
// port runs the walk's arithmetic again.  One thread per ray, bound by its
// dependent loads: slot and inst, then six float4.
__global__ void __launch_bounds__(K1E_THREADS)
slim_uv_kernel(const float4* __restrict__ tris,
               const float4* __restrict__ inv_mats,
               const float* __restrict__ ray_o,
               const float* __restrict__ ray_d,
               const int* __restrict__ slot, const int* __restrict__ inst,
               int n_rays, float* __restrict__ out_u,
               float* __restrict__ out_v) {
  const int r = blockIdx.x * K1E_THREADS + threadIdx.x;
  if (r >= n_rays) return;
  float u = 0.0f, v = 0.0f;
  const int s = slot[r];
  if (s >= 0) {
    const float4* __restrict__ m = inv_mats + 3 * (inst[r] + 1);
    const float4* __restrict__ tr = tris + (size_t)s * 3;
    const float4 m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
    const float4 v0 = __ldg(tr), e1 = __ldg(tr + 1), e2 = __ldg(tr + 2);
    const rtggx::Ray ro = rtggx::make_ray(
        m0, m1, m2, ray_o[3 * r], ray_o[3 * r + 1], ray_o[3 * r + 2],
        ray_d[3 * r], ray_d[3 * r + 1], ray_d[3 * r + 2]);
    float t;
    rtggx::tri_uvt(v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z, ro,
                   0.0f, t, u, v);
  }
  out_u[r] = u;
  out_v[r] = v;
}

}  // namespace

// K1e over n_rays rays: slot, inst as K1s wrote them.
extern "C" int rtggx_slim_uv(const void* tris4, const void* inv_mats,
                             const void* ray_o, const void* ray_d,
                             const void* slot, const void* inst, int n_rays,
                             void* out_u, void* out_v, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + K1E_THREADS - 1) / K1E_THREADS;
  slim_uv_kernel<<<blocks, K1E_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)tris4, (const float4*)inv_mats, (const float*)ray_o,
      (const float*)ray_d, (const int*)slot, (const int*)inst, n_rays,
      (float*)out_u, (float*)out_v);
  return (int)cudaGetLastError();
}

// mode: 0 lean, 1 slim (out_u, out_v, out_n and attrs4 unused), 2 fat
// (out_id takes prim).  stack_size: entries per thread, the tree's bound
// (1..K1_MAX_STACK); the launch takes stack_size * 128 * 4 bytes of
// shared memory per block.  stats: null, or stat_slots (>= 1) rows of
// stat_width (2: box and triangle tests; 3: instance entries besides).
extern "C" int rtggx_trace_instanced(const void* nodes, const void* tris4,
                                     const void* inv_mats, const void* attrs4,
                                     const void* ray_o, const void* ray_d,
                                     const void* t_max, float t_min,
                                     int n_rays, int leaf_size,
                                     int stack_size, int mode, void* out_t,
                                     void* out_u, void* out_v, void* out_n,
                                     void* out_id, void* out_inst,
                                     void* stats, int stat_slots,
                                     int stat_width, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size < 1 || stack_size > K1_MAX_STACK || stat_slots < 1 ||
      (stat_width != 2 && stat_width != 3))
    return (int)cudaErrorInvalidValue;
  if (mode == K1_LEAN && out_u && out_v)
    launch<K1_LEAN>(nodes, tris4, inv_mats, nullptr, ray_o, ray_d, t_max,
                    t_min, n_rays, leaf_size, stack_size, out_t, out_u, out_v,
                    nullptr, out_id, out_inst, stats, stat_slots, stat_width,
                    stream);
  else if (mode == K1_SLIM)
    launch<K1_SLIM>(nodes, tris4, inv_mats, nullptr, ray_o, ray_d, t_max,
                    t_min, n_rays, leaf_size, stack_size, out_t, nullptr,
                    nullptr, nullptr, out_id, out_inst, stats, stat_slots,
                    stat_width, stream);
  else if (mode == K1_FAT && attrs4 && out_u && out_v && out_n)
    launch<K1_FAT>(nodes, tris4, inv_mats, attrs4, ray_o, ray_d, t_max,
                   t_min, n_rays, leaf_size, stack_size, out_t, out_u, out_v,
                   out_n, out_id, out_inst, stats, stat_slots, stat_width,
                   stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int rtggx_k1_max_stack() { return K1_MAX_STACK; }
