// K6a / K6b: the kernel lab's closest-hit traversals of the instanced 4-wide
// scene BVH, each variant one structural change to K1, with per-ray visit
// counters.
//
// Replaces the TPU kernels raytracedggx_tpu/ops/lab/fused_lab.py:_lab_kernel
// (K6a) and :_ls_kernel (K6b), launched by trace_tiles_lab.
//
// Contract (layouts as K1, csrc/traverse.cu):
//   * nodes (N, 36) f32 rows; tris (S, 9) f32 slots v0 e1 e2, leaf j owns
//     slots [j*L, (j+1)*L), pads carry v0 = NaN; attrs (S, 10) f32 n0 n1 n2
//     prim per slot; inv_mats (1+I, 12) inverse worlds, tag 0 the identity.
//   * stack entries pack node | tag << 20 (K6b adds bit 30 for a leaf and
//     reads a 10-bit tag).  Rays go to object space on a tag change with
//     the direction unnormalised, so t stays in world units.
//   * K6a pops up to npop entries per step; each popped node tests its four
//     child boxes against best_t as it was when the node was popped, then
//     tests its hit leaves in child order, and the popped nodes' children
//     are pushed in the TPU kernel's order (the first popped node's last, its
//     nearest child on top).  K6b pops two entries per step and makes one
//     choice per entry: a leaf entry runs its triangle tests, a node entry
//     its box tests and pushes, leaves included.
//   * ordered: the pushed children of a node go through the TPU kernels'
//     5-exchange network on the ray's own entry distance (children that are
//     not pushed carry -inf), so the nearest is popped first; unordered
//     pushes children 0..3 as they come.
//   * outputs t (t_max on a miss), u, v (0 on a miss or under slim), nrm
//     (fat: w0*n0 + u*n1 + v*n2 of the winner's attrs, resolved once after
//     the walk; lean: 0), prim = attrs[slot, 9] (sub: the stream slot) and
//     inst = tag - 1 (noinst: 0), both int32 and -1 on a miss.  Rays with
//     t_max < 0 return at once.
//   * counts (null, or (R, 2) int32): node visits and leaf visits of each
//     ray; totals (null, or 2 int64): box tests (child and sub boxes) and
//     triangle tests, summed.
//   * flags that change an inner loop are template parameters (RECIP, the
//     leaf mode lean / fat / sub, and the K6b kernel); the others are
//     uniform runtime flags: ORDERED, FOLD, PRE (a (tags, R, 9) table of
//     o*M+t | d*M | 1/(d*M) read on a tag switch in place of the transform),
//     SLIM, NOINST, SMEM (the first LAB_SMEM_ROWS node rows staged in
//     shared memory per block: in node order these are the top tree and
//     each mesh's root with the first nodes of its preorder).
//
// What bounds it on this card: as K1, the latency of dependent loads per
// ray (a node row, then a leaf's 9*L floats), not bytes or FLOPs.  The TPU
// kernel walked a 1024-ray packet over one shared stack, so its counters
// were per packet; here each thread owns one ray, its own stack in local
// memory (L1-resident) and its own counters, and coherence within a warp
// comes from the caller's ray order.  The lab flags were answers to TPU
// costs (vector-to-scalar extracts, masked lane reductions, SMEM scalars);
// on this card they are re-priced as what they become per thread.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lab.cuh"

#define LAB_SMEM_ROWS 256
#define LAB_LEAF_BIT (1 << 30)

enum LabFlag : int {
  LAB_ORDERED = 1,
  LAB_FOLD = 2,
  LAB_PRE = 4,
  LAB_SLIM = 8,
  LAB_NOINST = 16,
  LAB_RECIP = 32,
  LAB_FAT = 64,
  LAB_LEAF_STACK = 128,
  LAB_SMEM = 256,
};

namespace {

struct LabArgs {
  const float* nodes;
  const float* tris;
  const float* attrs;
  const float* boxes;
  const float* inv_mats;
  const float* pre;
  const float* ray_o;
  const float* ray_d;
  const float* t_max;
  float t_min;
  int n_rays, L, nq, stack_size, flags, npop, smem_rows;
  float* out_t;
  float* out_u;
  float* out_v;
  float* out_n;
  int* out_prim;
  int* out_inst;
  int* counts;
  unsigned long long* totals;
};

struct Best {
  float t, u, v;
  int slot, inst;
};

__device__ __forceinline__ rtggx::Ray lab_ray(const LabArgs& a, int tag, int r) {
  if (a.flags & LAB_PRE) {
    const float* p = a.pre + ((size_t)tag * a.n_rays + r) * 9;
    rtggx::Ray ro;
    ro.ox = __ldg(p + 0); ro.oy = __ldg(p + 1); ro.oz = __ldg(p + 2);
    ro.dx = __ldg(p + 3); ro.dy = __ldg(p + 4); ro.dz = __ldg(p + 5);
    ro.ix = __ldg(p + 6); ro.iy = __ldg(p + 7); ro.iz = __ldg(p + 8);
    return ro;
  }
  const float* o = a.ray_o + 3 * r;
  const float* d = a.ray_d + 3 * r;
  return rtggx::make_ray(a.inv_mats + 12 * tag, __ldg(o), __ldg(o + 1),
                         __ldg(o + 2), __ldg(d), __ldg(d + 1), __ldg(d + 2));
}

// Triangle tests of leaf lf.  MODE 0 lean and 1 fat test every slot up to
// the first pad; MODE 2 (sub) first tests the leaf's nq sub-boxes against
// best_t at leaf entry and runs only the chunks of L/nq slots that pass.
template <bool RECIP, int MODE>
__device__ __forceinline__ void lab_leaf(const LabArgs& a, int lf, int tag,
                                         const rtggx::Ray& ro, Best& b,
                                         unsigned long long& n_box,
                                         unsigned long long& n_tri) {
  const float* __restrict__ leaf = a.tris + (size_t)lf * a.L * 9;
  int q1 = 1, lq = a.L;
  unsigned live = 1u;
  if (MODE == 2) {
    const float* bx = a.boxes + (size_t)lf * 6 * a.nq;
    const float bt0 = b.t;
    q1 = a.nq;
    lq = a.L / a.nq;
    live = 0u;
    for (int q = 0; q < a.nq; ++q) {
      float tn;
      ++n_box;
      if (rtggx::slab(bx + 6 * q, ro, a.t_min, bt0, false, tn)) live |= 1u << q;
    }
  }
  for (int q = 0; q < q1; ++q) {
    if (!((live >> q) & 1u)) continue;
    for (int j = q * lq; j < (q + 1) * lq; ++j) {
      const float* tr = leaf + 9 * j;
      // pads follow a leaf's real triangles: the first one ends the chunk
      if (isnan(__ldg(tr))) break;
      ++n_tri;
      if (rtggx::mt_hit<RECIP>(tr, ro, a.t_min, b.t, b.u, b.v)) {
        b.slot = lf * a.L + j;
        b.inst = tag - 1;
      }
    }
  }
}

// Stage the first smem_rows node rows in shared memory.  Every thread of
// the block reaches the barrier (no thread has returned yet).
__device__ __forceinline__ void stage_nodes(const LabArgs& a, float* s_nodes) {
  for (int i = threadIdx.x; i < a.smem_rows * 36; i += blockDim.x)
    s_nodes[i] = __ldg(a.nodes + i);
  if (a.smem_rows > 0) __syncthreads();
}

__device__ __forceinline__ const float* node_row(const LabArgs& a,
                                                 const float* s_nodes,
                                                 int idx) {
  return idx < a.smem_rows ? s_nodes + idx * 36 : a.nodes + (size_t)idx * 36;
}

// Box tests of one node's children against best_t = bt: fills the child
// entries, their push flags and sort keys; returns the hit mask.
__device__ __forceinline__ unsigned node_children(
    const LabArgs& a, const float* row, const rtggx::Ray& ro, int tag,
    float bt, bool fold, bool ordered, int leaf_bit, int* kind, int* child,
    float* key, int* ent, bool* push, unsigned long long& n_box) {
  unsigned hit = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    kind[k] = (int)row[24 + k];
    child[k] = (int)row[28 + k];
    float tn = 0.0f;
    bool h = false;
    if (kind[k] != 0) {
      ++n_box;
      h = rtggx::slab(row + 6 * k, ro, a.t_min, bt, fold, tn);
    }
    hit |= (unsigned)h << k;
    const int child_tag = kind[k] == 3 ? (int)row[32 + k] : tag;
    ent[k] = child[k] | (child_tag << LAB_TAG_SHIFT) |
             (kind[k] == 1 ? leaf_bit : 0);
    push[k] = h && kind[k] >= (leaf_bit ? 1 : 2);
    key[k] = ordered ? (push[k] ? tn : -CUDART_INF_F) : 0.0f;
  }
  return hit;
}

template <int MODE>
__device__ __forceinline__ void write_out(const LabArgs& a, int r,
                                          const Best& b, bool slim,
                                          bool noinst, int n_node, int n_leaf,
                                          unsigned long long n_box,
                                          unsigned long long n_tri) {
  const bool hit = b.slot >= 0;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  int prim = -1;
  if (hit) {
    const float* at = a.attrs + (size_t)b.slot * 10;
    prim = MODE == 2 ? b.slot : (int)__ldg(at + 9);
    if (MODE == 1) {
      const float w0 = 1.0f - b.u - b.v;
      nx = w0 * __ldg(at + 0) + b.u * __ldg(at + 3) + b.v * __ldg(at + 6);
      ny = w0 * __ldg(at + 1) + b.u * __ldg(at + 4) + b.v * __ldg(at + 7);
      nz = w0 * __ldg(at + 2) + b.u * __ldg(at + 5) + b.v * __ldg(at + 8);
    }
  }
  a.out_t[r] = b.t;
  a.out_u[r] = slim ? 0.0f : b.u;
  a.out_v[r] = slim ? 0.0f : b.v;
  a.out_n[3 * r] = nx;
  a.out_n[3 * r + 1] = ny;
  a.out_n[3 * r + 2] = nz;
  a.out_prim[r] = prim;
  a.out_inst[r] = hit ? (noinst ? 0 : b.inst) : -1;
  if (a.counts != nullptr) {
    a.counts[2 * r] = n_node;
    a.counts[2 * r + 1] = n_leaf;
  }
  if (a.totals != nullptr && (n_box | n_tri) != 0) {
    atomicAdd(a.totals, n_box);
    atomicAdd(a.totals + 1, n_tri);
  }
}

// K6a: _lab_kernel.
template <bool RECIP, int MODE>
__global__ void __launch_bounds__(512) lab_kernel(const LabArgs a) {
  extern __shared__ float s_nodes[];
  stage_nodes(a, s_nodes);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n_rays) return;
  const bool ordered = a.flags & LAB_ORDERED, fold = a.flags & LAB_FOLD;
  Best b{a.t_max[r], 0.0f, 0.0f, -1, -1};
  int n_node = 0, n_leaf = 0;
  unsigned long long n_box = 0, n_tri = 0;

  if (b.t >= 0.0f) {  // t_max < 0: dead ray, no traversal
    int stack[LAB_MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;  // root of the top tree, tag 0
    int cur_tag = -1;
    rtggx::Ray ro;
    while (sp > 0) {
      const int top = sp;
      const int n = min(a.npop, top);
      sp -= n;
      int pend[4][4], pcnt[4];
      for (int p = 0; p < n; ++p) {
        const int e = stack[top - 1 - p];
        const int idx = e & LAB_NODE_MASK, tag = e >> LAB_TAG_SHIFT;
        if (tag != cur_tag) {
          ro = lab_ray(a, tag, r);
          cur_tag = tag;
        }
        ++n_node;
        int kind[4], child[4], ent[4];
        float key[4];
        bool push[4];
        const unsigned hit =
            node_children(a, node_row(a, s_nodes, idx), ro, tag, b.t, fold,
                          ordered, 0, kind, child, key, ent, push, n_box);
        for (int k = 0; k < 4; ++k) {
          if (((hit >> k) & 1u) && kind[k] == 1) {
            ++n_leaf;
            lab_leaf<RECIP, MODE>(a, child[k], tag, ro, b, n_box, n_tri);
          }
        }
        if (ordered) rtggx::sort4_desc(key, ent, push);
        int c = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (push[k]) pend[p][c++] = ent[k];
        pcnt[p] = c;
      }
      // the last popped node's children go in first; a full stack drops
      // the subtree (the callers size the stack from the tree's bound)
      for (int p = n - 1; p >= 0; --p)
        for (int i = 0; i < pcnt[p]; ++i)
          if (sp < a.stack_size) stack[sp++] = pend[p][i];
    }
  }
  write_out<MODE>(a, r, b, a.flags & LAB_SLIM, a.flags & LAB_NOINST, n_node,
                  n_leaf, n_box, n_tri);
}

// K6b: _ls_kernel.  Exact divide, no fold, pre, slim or noinst (the TPU
// kernel has none of them either).
template <bool FAT>
__global__ void __launch_bounds__(512) ls_kernel(const LabArgs a) {
  extern __shared__ float s_nodes[];
  stage_nodes(a, s_nodes);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n_rays) return;
  const bool ordered = a.flags & LAB_ORDERED;
  Best b{a.t_max[r], 0.0f, 0.0f, -1, -1};
  int n_node = 0, n_leaf = 0;
  unsigned long long n_box = 0, n_tri = 0;

  if (b.t >= 0.0f) {
    int stack[LAB_MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;
    int cur_tag = -1;
    rtggx::Ray ro;
    while (sp > 0) {
      const int top = sp;
      const int n = top >= 2 ? 2 : 1;
      sp -= n;
      int pend[2][4], pcnt[2];
      for (int p = 0; p < n; ++p) {
        const int e = stack[top - 1 - p];
        const int idx = e & LAB_NODE_MASK;
        const int tag = (e >> LAB_TAG_SHIFT) & 0x3FF;
        if (tag != cur_tag) {
          ro = lab_ray(a, tag, r);
          cur_tag = tag;
        }
        pcnt[p] = 0;
        if (e & LAB_LEAF_BIT) {
          ++n_leaf;
          lab_leaf<false, FAT ? 1 : 0>(a, idx, tag, ro, b, n_box, n_tri);
          continue;
        }
        ++n_node;
        int kind[4], child[4], ent[4];
        float key[4];
        bool push[4];
        node_children(a, node_row(a, s_nodes, idx), ro, tag, b.t, false,
                      ordered, LAB_LEAF_BIT, kind, child, key, ent, push,
                      n_box);
        if (ordered) rtggx::sort4_desc(key, ent, push);
        int c = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (push[k]) pend[p][c++] = ent[k];
        pcnt[p] = c;
      }
      for (int p = n - 1; p >= 0; --p)
        for (int i = 0; i < pcnt[p]; ++i)
          if (sp < a.stack_size) stack[sp++] = pend[p][i];
    }
  }
  write_out<FAT ? 1 : 0>(a, r, b, false, false, n_node, n_leaf, n_box, n_tri);
}

template <bool RECIP>
void launch_lab(int mode, int blocks, int threads, size_t smem,
                cudaStream_t s, const LabArgs& a) {
  if (mode == 2)
    lab_kernel<RECIP, 2><<<blocks, threads, smem, s>>>(a);
  else if (mode == 1)
    lab_kernel<RECIP, 1><<<blocks, threads, smem, s>>>(a);
  else
    lab_kernel<RECIP, 0><<<blocks, threads, smem, s>>>(a);
}

}  // namespace

extern "C" int rtggx_trace_lab(
    const void* nodes, int num_nodes, const void* tris, const void* attrs,
    const void* boxes, int nq, const void* inv_mats, const void* pre,
    const void* ray_o, const void* ray_d, const void* t_max, float t_min,
    int n_rays, int leaf_size, int stack_size, int flags, int npop,
    int threads, void* out_t, void* out_u, void* out_v, void* out_n,
    void* out_prim, void* out_inst, void* counts, void* totals,
    void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size > LAB_MAX_STACK) stack_size = LAB_MAX_STACK;
  LabArgs a;
  a.nodes = (const float*)nodes;
  a.tris = (const float*)tris;
  a.attrs = (const float*)attrs;
  a.boxes = (const float*)boxes;
  a.inv_mats = (const float*)inv_mats;
  a.pre = (const float*)pre;
  a.ray_o = (const float*)ray_o;
  a.ray_d = (const float*)ray_d;
  a.t_max = (const float*)t_max;
  a.t_min = t_min;
  a.n_rays = n_rays;
  a.L = leaf_size;
  a.nq = nq;
  a.stack_size = stack_size;
  a.flags = flags;
  a.npop = npop < 1 ? 1 : (npop > 4 ? 4 : npop);
  a.smem_rows = !(flags & LAB_SMEM) ? 0
                : (num_nodes < LAB_SMEM_ROWS ? num_nodes : LAB_SMEM_ROWS);
  a.out_t = (float*)out_t;
  a.out_u = (float*)out_u;
  a.out_v = (float*)out_v;
  a.out_n = (float*)out_n;
  a.out_prim = (int*)out_prim;
  a.out_inst = (int*)out_inst;
  a.counts = (int*)counts;
  a.totals = (unsigned long long*)totals;
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t smem = (size_t)a.smem_rows * 36 * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (flags & LAB_LEAF_STACK) {
    if (flags & LAB_FAT)
      ls_kernel<true><<<blocks, threads, smem, s>>>(a);
    else
      ls_kernel<false><<<blocks, threads, smem, s>>>(a);
  } else {
    const int mode = nq > 0 ? 2 : ((flags & LAB_FAT) ? 1 : 0);
    if (flags & LAB_RECIP)
      launch_lab<true>(mode, blocks, threads, smem, s, a);
    else
      launch_lab<false>(mode, blocks, threads, smem, s, a);
  }
  return (int)cudaGetLastError();
}

extern "C" int rtggx_lab_max_stack() { return LAB_MAX_STACK; }

extern "C" int rtggx_lab_smem_rows() { return LAB_SMEM_ROWS; }
