// K6a / K6b: the kernel lab's closest-hit traversals of the instanced 4-wide
// scene BVH, each variant one structural change to K1, with per-ray visit
// counters.
//
// Replaces the TPU kernels raytracedggx_tpu/ops/lab/fused_lab.py:_lab_kernel
// (K6a) and :_ls_kernel (K6b), launched by trace_tiles_lab.
//
// Contract (layouts as K1, csrc/traverse.cu):
//   * nodes (N, 36) f32 rows, read as nine float4 (16-byte aligned); tris4
//     (S, 12) f32 slots, three float4 v0 _ e1 _ e2 _, leaf j owns slots
//     [j*L, (j+1)*L), pads carry v0 = NaN; attrs (S, 10) f32 n0 n1 n2 prim
//     per slot; inv_mats (1+I, 12) inverse worlds, tag 0 the identity.
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
//     t_max < 0 do not traverse.
//   * counts (null, or (R, 2) int32): node visits and leaf visits of each
//     ray; totals (null, or 2 int64): box tests (child and sub boxes) and
//     triangle tests, summed.
//   * flags that change an inner loop are template parameters (RECIP, the
//     leaf mode lean / fat / sub, and the K6b kernel); the others are
//     uniform runtime flags: ORDERED, FOLD, PRE (a (tags, R, 9) table of
//     o*M+t | d*M | 1/(d*M) read on a tag switch in place of the transform),
//     SLIM, NOINST; smem_rows > 0 stages the first node rows in shared
//     memory per block (in node order these are the top tree and each
//     mesh's root with the first nodes of its preorder).
//
// What bounds it on this card: as K1, the latency of dependent loads per
// ray (a node row, then a leaf's slots), not bytes or FLOPs.  The TPU
// kernel walked a 1024-ray packet over one shared stack, so its counters
// were per packet; here each thread owns one ray and its own counters,
// and coherence within a warp comes from the caller's ray order.  The lab
// prices each flag against K1, so K6a and K6b carry K1's memory design and
// the walk stays the lab's (the two-pop order is its subject):
//   * the stack in shared memory, [entry][thread], sized at launch from
//     the walk's bound beside the staged rows: npop * (3 * depth - 2) for
//     K6a, 6 * depth - 2 for K6b (both derived in lab.cuh); the pushes of
//     the popped nodes wait in registers, so no array is indexed at run
//     time in local memory (the first port kept a 512-entry stack, 2 KB of
//     local memory per thread);
//   * a node is nine 16-byte loads, from the staged rows or device memory,
//     issued before the ray's tag switch; a slot three float4 of tris4,
//     slot j + 1's loads out before slot j is tested, and the NaN v0
//     already loaded ends the leaf;
//   * totals summed over the warp first, one pair of atomics per warp.
// The lab flags were answers to TPU costs (vector-to-scalar extracts,
// masked lane reductions, SMEM scalars); on this card they are re-priced
// as what they become per thread.  K6b shares the leaf test, the node
// loads, the stack and the totals; only its walk is its own.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lab.cuh"

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
};

namespace {

struct LabArgs {
  const float4* nodes;
  const float4* tris4;
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
                                         unsigned& n_box, unsigned& n_tri) {
  int q1 = 1, lq = a.L;
  unsigned live = 1u;
  if (MODE == 2) {
    const float* bx = a.boxes + (size_t)lf * 6 * a.nq;
    const float bt0 = b.t;
    q1 = a.nq;
    lq = a.L / a.nq;
    live = 0u;
    for (int q = 0; q < a.nq; ++q, bx += 6) {
      float tn;
      ++n_box;
      if (rtggx::box_hit(__ldg(bx), __ldg(bx + 1), __ldg(bx + 2),
                         __ldg(bx + 3), __ldg(bx + 4), __ldg(bx + 5), ro,
                         a.t_min, bt0, tn))
        live |= 1u << q;
    }
  }
  for (int q = 0; q < q1; ++q) {
    if (!((live >> q) & 1u)) continue;
    const int j0 = lf * a.L + q * lq, j1 = j0 + lq;
    const float4* __restrict__ tr = a.tris4 + (size_t)j0 * 3;
    float4 v0 = __ldg(tr), e1 = __ldg(tr + 1), e2 = __ldg(tr + 2);
    for (int j = j0; j < j1; ++j) {
      // pads follow a leaf's real triangles: the first one ends the chunk
      if (isnan(v0.x)) break;
      ++n_tri;
      // the next slot's loads go out before this slot's test
      float4 nv0 = v0, ne1 = e1, ne2 = e2;
      if (j + 1 < j1) {
        tr += 3;
        nv0 = __ldg(tr);
        ne1 = __ldg(tr + 1);
        ne2 = __ldg(tr + 2);
      }
      if (rtggx::mt_hit<RECIP>(v0, e1, e2, ro, a.t_min, b.t, b.u, b.v)) {
        b.slot = j;
        b.inst = tag - 1;
      }
      v0 = nv0;
      e1 = ne1;
      e2 = ne2;
    }
  }
}

// Stage the first smem_rows node rows in shared memory.  Every thread of
// the block reaches the barrier.
__device__ __forceinline__ void stage_nodes(const LabArgs& a, float4* s_rows) {
  for (int i = threadIdx.x; i < a.smem_rows * 9; i += blockDim.x)
    s_rows[i] = __ldg(a.nodes + i);
  if (a.smem_rows > 0) __syncthreads();
}

template <int MODE>
__device__ __forceinline__ void write_out(const LabArgs& a, int r,
                                          const Best& b, bool slim,
                                          bool noinst, int n_node,
                                          int n_leaf) {
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
}

// K6a: _lab_kernel.  Dynamic shared memory: smem_rows node rows, then
// stack_size entries per thread.
template <bool RECIP, int MODE>
__global__ void __launch_bounds__(512) lab_kernel(const LabArgs a) {
  extern __shared__ float4 lab_smem[];
  stage_nodes(a, lab_smem);
  rtggx::SmemStack stack(reinterpret_cast<int*>(lab_smem + a.smem_rows * 9),
                         a.stack_size);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned n_box = 0, n_tri = 0;

  if (r < a.n_rays) {
    const bool ordered = a.flags & LAB_ORDERED, fold = a.flags & LAB_FOLD;
    Best b{a.t_max[r], 0.0f, 0.0f, -1, -1};
    int n_node = 0, n_leaf = 0;
    if (b.t >= 0.0f) {  // t_max < 0: dead ray, no traversal
      stack.push(0);    // root of the top tree, tag 0
      int cur_tag = -1;
      rtggx::Ray ro;
      while (stack.sp > 0) {
        const int top = stack.sp;
        const int n = min(a.npop, top);
        stack.sp -= n;
        rtggx::Pending<4> pend;
        for (int p = 0; p < n; ++p) {
          const int e = stack.at(top - 1 - p);
          const int idx = e & LAB_NODE_MASK, tag = e >> LAB_TAG_SHIFT;
          // the row's loads first: they do not wait for a tag switch
          const rtggx::NodeRow row =
              rtggx::load_row(a.nodes, lab_smem, a.smem_rows, idx);
          if (tag != cur_tag) {
            ro = lab_ray(a, tag, r);
            cur_tag = tag;
          }
          ++n_node;
          unsigned leaves, push;
          int4 ent;
          rtggx::children(row, ro, a.t_min, b.t, fold, ordered, tag, 0,
                          leaves, ent, push, n_box);
          pend.put(p, ent, push);
          while (leaves) {  // hit leaves in child order
            const int k = __ffs(leaves) - 1;
            leaves &= leaves - 1;
            ++n_leaf;
            lab_leaf<RECIP, MODE>(a, (int)rtggx::lane(row.addr, k), tag, ro,
                                  b, n_box, n_tri);
          }
        }
        pend.flush(n, stack);
      }
    }
    write_out<MODE>(a, r, b, a.flags & LAB_SLIM, a.flags & LAB_NOINST,
                    n_node, n_leaf);
  }
  rtggx::add_stats(a.totals, n_box, n_tri);  // every thread of the warp
}

// K6b: _ls_kernel.  Exact divide, no fold, pre, slim or noinst (the TPU
// kernel has none of them either).  Dynamic shared memory as K6a's:
// smem_rows node rows, then stack_size entries per thread.  Each step pops
// two entries (one at the last); a leaf runs its triangle tests, a node
// its box tests against best_t as it stands after the first entry's visit,
// and the nodes' hit children, leaves included, wait in registers until
// both entries have been visited.
template <bool FAT>
__global__ void __launch_bounds__(512) ls_kernel(const LabArgs a) {
  extern __shared__ float4 lab_smem[];
  stage_nodes(a, lab_smem);
  rtggx::SmemStack stack(reinterpret_cast<int*>(lab_smem + a.smem_rows * 9),
                         a.stack_size);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned n_box = 0, n_tri = 0;

  if (r < a.n_rays) {
    const bool ordered = a.flags & LAB_ORDERED;
    Best b{a.t_max[r], 0.0f, 0.0f, -1, -1};
    int n_node = 0, n_leaf = 0;
    if (b.t >= 0.0f) {
      stack.push(0);
      int cur_tag = -1;
      rtggx::Ray ro;
      while (stack.sp > 0) {
        const int top = stack.sp;
        const int n = min(2, top);
        stack.sp -= n;
        rtggx::Pending<2> pend;
        for (int p = 0; p < n; ++p) {
          const int e = stack.at(top - 1 - p);
          const int idx = e & LAB_NODE_MASK;
          const int tag = (e >> LAB_TAG_SHIFT) & 0x3FF;
          if (e & LAB_LEAF_BIT) {
            if (tag != cur_tag) {
              ro = lab_ray(a, tag, r);
              cur_tag = tag;
            }
            ++n_leaf;
            lab_leaf<false, FAT ? 1 : 0>(a, idx, tag, ro, b, n_box, n_tri);
            continue;
          }
          // a node's row loads first: they do not wait for a tag switch.
          // Each branch has its own switch so that the row is live only on
          // a node's path: a row loaded before one shared switch stays live
          // across the leaf test (113 registers against 92).
          const rtggx::NodeRow row =
              rtggx::load_row(a.nodes, lab_smem, a.smem_rows, idx);
          if (tag != cur_tag) {
            ro = lab_ray(a, tag, r);
            cur_tag = tag;
          }
          ++n_node;
          unsigned leaves, push;
          int4 ent;
          rtggx::children(row, ro, a.t_min, b.t, false, ordered, tag,
                          LAB_LEAF_BIT, leaves, ent, push, n_box);
          pend.put(p, ent, push);
        }
        pend.flush(n, stack);
      }
    }
    write_out<FAT ? 1 : 0>(a, r, b, false, false, n_node, n_leaf);
  }
  rtggx::add_stats(a.totals, n_box, n_tri);
}

// Launch with smem bytes of dynamic shared memory, opting in above the
// default 48 KB.
int launch(void (*kernel)(const LabArgs), int blocks, int threads,
           size_t smem, cudaStream_t s, const LabArgs& a) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool RECIP>
int launch_lab(int mode, int blocks, int threads, size_t smem,
               cudaStream_t s, const LabArgs& a) {
  if (mode == 2)
    return launch(lab_kernel<RECIP, 2>, blocks, threads, smem, s, a);
  if (mode == 1)
    return launch(lab_kernel<RECIP, 1>, blocks, threads, smem, s, a);
  return launch(lab_kernel<RECIP, 0>, blocks, threads, smem, s, a);
}

}  // namespace

// smem_rows: node rows staged in shared memory per block (0: none);
// stack_size: entries per thread in shared memory (the walk's bound).  A
// block takes smem_rows * 144 + threads * stack_size * 4 bytes of shared
// memory.
extern "C" int rtggx_trace_lab(
    const void* nodes, int smem_rows, const void* tris4, const void* attrs,
    const void* boxes, int nq, const void* inv_mats, const void* pre,
    const void* ray_o, const void* ray_d, const void* t_max, float t_min,
    int n_rays, int leaf_size, int stack_size, int flags, int npop,
    int threads, void* out_t, void* out_u, void* out_v, void* out_n,
    void* out_prim, void* out_inst, void* counts, void* totals,
    void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size < 1) return (int)cudaErrorInvalidValue;
  LabArgs a;
  a.nodes = (const float4*)nodes;
  a.tris4 = (const float4*)tris4;
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
  a.smem_rows = smem_rows;
  a.out_t = (float*)out_t;
  a.out_u = (float*)out_u;
  a.out_v = (float*)out_v;
  a.out_n = (float*)out_n;
  a.out_prim = (int*)out_prim;
  a.out_inst = (int*)out_inst;
  a.counts = (int*)counts;
  a.totals = (unsigned long long*)totals;
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t smem = (size_t)smem_rows * 9 * sizeof(float4) +
                      (size_t)threads * stack_size * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (flags & LAB_LEAF_STACK)
    return flags & LAB_FAT ? launch(ls_kernel<true>, blocks, threads, smem, s, a)
                           : launch(ls_kernel<false>, blocks, threads, smem, s, a);
  const int mode = nq > 0 ? 2 : ((flags & LAB_FAT) ? 1 : 0);
  return flags & LAB_RECIP ? launch_lab<true>(mode, blocks, threads, smem, s, a)
                           : launch_lab<false>(mode, blocks, threads, smem, s, a);
}
