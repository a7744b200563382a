// Pieces shared by the kernel-lab traversals K6a/K6b (traverse_lab.cu) and
// K7 (traverse_mxu.cu): node rows as nine float4, the child box tests with
// the optional octant fold and the TPU kernels' 5-exchange sorting network,
// the Moller-Trumbore test with an optional approximate reciprocal, a
// per-thread stack in shared memory with the pushes of up to four popped
// nodes held in registers, and the per-ray object-space state.  No fast
// math: NaN pads and empty boxes must fail every comparison.
//
// The stack bound of the lab's walk (ops/lab/fused_lab.py:stack_bound).
// A step pops n = min(npop, sp) entries, visits them top first and then
// pushes each popped node's internal children, the last popped node's
// first.  Give an entry the level of its path from the root (the root 1,
// a child one more than its parent; at most D, the tree's depth).
//   * The stack's levels never decrease from bottom to top: the popped
//     entries' levels decrease from the first popped to the last, and the
//     pushes go in the reverse order, each one level deeper than its
//     parent, onto a stack whose top is no deeper than the last popped.
//   * All entries of one level were pushed in one step: a later step
//     that pushes that level pops a parent lying below all of them, so it
//     pops them too.
//   * So the top level holds at most 4 * npop entries.  A level below the
//     top holds at most 3 * npop: if it was the top when pushed, the next
//     step took npop of its at most 4 * npop entries (or all of them); if
//     not, a deeper node was popped in its step, so at most npop - 1
//     parents pushed it, 4 * (npop - 1) <= 3 * npop for npop <= 4.
//   * Pushed entries have levels 2..D: at most 4 * npop + 3 * npop *
//     (D - 2) = npop * (3D - 2) entries (npop = 1: 3D - 2, inside K1's
//     3D + 1).  A full 4-ary tree whose boxes all pass reaches 3D - 2 at
//     npop 1 and 6D - 8 at npop 2.
//
// K6b's bound (ops/lab/fused_lab.py:ls_stack_bound).  K6b pops n = min(2,
// sp) entries per step, leaves among them: a popped leaf pushes nothing, a
// popped node pushes its hit children, leaves included.  A leaf sits one
// level below its parent, so levels run to D + 1.
//   * The first two points above hold as they stand: a popped leaf only
//     drops out of the pushes.
//   * A level's entries have at most 2 parents, 8 entries.  Level 2 has
//     the root alone, 4, and step 1 pops the root alone, so level 2 is
//     the top when pushed.  A level stops being the top only when one of
//     its nodes, popped while it is the top, pushes a deeper level; that
//     step pops 2 of its entries (or all): below the top a level holds at
//     most 8 - 2 = 6, level 2 at most 4 - 2 = 2.  A level pushed under a
//     deeper one had 1 parent: 4.
//   * With T <= D + 1 the deepest level, on top: 8 + 2 + 6 * (T - 3) =
//     6T - 8 entries for T >= 2 (T = 2: the root's 4).  So 6D - 2.  A
//     full 4-ary tree of depth D with leaf children at its bottom level,
//     every box passing, reaches it.
// (Counted the same way, K6a's walk holds at most 3D - 2, 6D - 8 and
// 12D - 20 entries at npop 1, 2 and 4, which a full tree reaches; K6a and
// K7 keep the looser npop * (3D - 2).)
// A push onto a full stack is dropped, as in the plain version.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "ray.cuh"

#define LAB_TAG_SHIFT 20
#define LAB_NODE_MASK 0xFFFFF

namespace rtggx {

// A node row: child k's box at floats 6k (lo.xyz, hi.xyz), then kind,
// address and instance tag of each child.
struct NodeRow {
  float4 b0, b1, b2, b3, b4, b5, kind, addr, tag;
};

// Row idx from the first n_smem rows staged in shared memory, or from
// device memory.
__device__ __forceinline__ NodeRow load_row(const float4* __restrict__ nodes,
                                            const float4* s_rows, int n_smem,
                                            int idx) {
  NodeRow n;
  if (idx < n_smem) {
    const float4* p = s_rows + idx * 9;
    n.b0 = p[0]; n.b1 = p[1]; n.b2 = p[2]; n.b3 = p[3]; n.b4 = p[4];
    n.b5 = p[5]; n.kind = p[6]; n.addr = p[7]; n.tag = p[8];
  } else {
    const float4* __restrict__ p = nodes + (size_t)idx * 9;
    n.b0 = __ldg(p); n.b1 = __ldg(p + 1); n.b2 = __ldg(p + 2);
    n.b3 = __ldg(p + 3); n.b4 = __ldg(p + 4); n.b5 = __ldg(p + 5);
    n.kind = __ldg(p + 6); n.addr = __ldg(p + 7); n.tag = __ldg(p + 8);
  }
  return n;
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Slab test of the box lo, hi against best_t; tn is the entry distance.
// fold: the near and far planes are picked by the signs of the ray's own
// inverse direction, which for a box with lo <= hi gives the same tn and
// tf bit for bit as the min/max form (an empty child, lo > hi, may then
// pass or fail differently, and callers ignore its result).
__device__ __forceinline__ bool slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     const Ray& r, float t_min, float best_t,
                                     bool fold, float& tn) {
  if (!fold) return box_hit(lox, loy, loz, hix, hiy, hiz, r, t_min, best_t, tn);
  const bool sx = r.ix >= 0.0f, sy = r.iy >= 0.0f, sz = r.iz >= 0.0f;
  const float nx = sx ? lox : hix, fx = sx ? hix : lox;
  const float ny = sy ? loy : hiy, fy = sy ? hiy : loy;
  const float nz = sz ? loz : hiz, fz = sz ? hiz : loz;
  tn = fmaxf(fmaxf((nx - r.ox) * r.ix, (ny - r.oy) * r.iy), (nz - r.oz) * r.iz);
  const float tf =
      fminf(fminf((fx - r.ox) * r.ix, (fy - r.oy) * r.iy), (fz - r.oz) * r.iz);
  return (tn <= tf) && (tf >= t_min) && (tn <= best_t);
}

// One exchange of the TPU kernels' sort4_desc: swap when key[i] < key[j].
__device__ __forceinline__ void exchange(float& ka, int& ea, bool& pa,
                                         float& kb, int& eb, bool& pb) {
  if (ka < kb) {
    const float k = ka; ka = kb; kb = k;
    const int e = ea; ea = eb; eb = e;
    const bool p = pa; pa = pb; pb = p;
  }
}

// A popped node's four children: box tests against bt (the best t at the
// pop), ++n_box for each non-empty child.  Returns the hit mask; leaves:
// the hit kind-1 children; ent / push: the entries node | tag << 20
// (| leaf_bit for a leaf) of the hit children of kind >= 2 (>= 1 with a
// leaf_bit), through the exchanges (0,1) (2,3) (0,2) (1,3) (1,2) on
// their entry distance when ordered (children not pushed keyed -inf), so
// that pushing ent.x, .y, .z, .w in turn leaves the nearest on top;
// unordered keeps children 0..3.
__device__ __forceinline__ unsigned children(const NodeRow& n, const Ray& ro,
                                             float t_min, float bt, bool fold,
                                             bool ordered, int tag,
                                             int leaf_bit, unsigned& leaves,
                                             int4& ent, unsigned& push,
                                             unsigned& n_box) {
  const int kind[4] = {(int)n.kind.x, (int)n.kind.y, (int)n.kind.z,
                       (int)n.kind.w};
  float tn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool hit[4];
  hit[0] = kind[0] != 0 && slab(n.b0.x, n.b0.y, n.b0.z, n.b0.w, n.b1.x,
                                n.b1.y, ro, t_min, bt, fold, tn[0]);
  hit[1] = kind[1] != 0 && slab(n.b1.z, n.b1.w, n.b2.x, n.b2.y, n.b2.z,
                                n.b2.w, ro, t_min, bt, fold, tn[1]);
  hit[2] = kind[2] != 0 && slab(n.b3.x, n.b3.y, n.b3.z, n.b3.w, n.b4.x,
                                n.b4.y, ro, t_min, bt, fold, tn[2]);
  hit[3] = kind[3] != 0 && slab(n.b4.z, n.b4.w, n.b5.x, n.b5.y, n.b5.z,
                                n.b5.w, ro, t_min, bt, fold, tn[3]);
  const int min_push = leaf_bit ? 1 : 2;
  unsigned mask = 0u;
  leaves = 0u;
  float key[4];
  int e[4];
  bool p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    n_box += kind[k] != 0;
    mask |= (unsigned)hit[k] << k;
    if (hit[k] && kind[k] == 1) leaves |= 1u << k;
    const int child_tag = kind[k] == 3 ? (int)lane(n.tag, k) : tag;
    e[k] = (int)lane(n.addr, k) | (child_tag << LAB_TAG_SHIFT) |
           (kind[k] == 1 ? leaf_bit : 0);
    p[k] = hit[k] && kind[k] >= min_push;
    key[k] = p[k] ? tn[k] : -CUDART_INF_F;
  }
  if (ordered) {
    exchange(key[0], e[0], p[0], key[1], e[1], p[1]);
    exchange(key[2], e[2], p[2], key[3], e[3], p[3]);
    exchange(key[0], e[0], p[0], key[2], e[2], p[2]);
    exchange(key[1], e[1], p[1], key[3], e[3], p[3]);
    exchange(key[1], e[1], p[1], key[2], e[2], p[2]);
  }
  ent = make_int4(e[0], e[1], e[2], e[3]);
  push = (unsigned)p[0] | (unsigned)p[1] << 1 | (unsigned)p[2] << 2 |
         (unsigned)p[3] << 3;
  return mask;
}

// A thread's stack in shared memory, [entry][thread] so that a warp's 32
// threads touch 32 banks; a push onto a full stack is dropped.
struct SmemStack {
  int* base;  // the block's stack region + threadIdx.x
  int stride, cap, sp;

  __device__ __forceinline__ SmemStack(int* region, int capacity)
      : base(region + threadIdx.x), stride(blockDim.x), cap(capacity),
        sp(0) {}
  __device__ __forceinline__ int at(int i) const { return base[i * stride]; }
  __device__ __forceinline__ void push(int e) {
    if (sp < cap) base[(sp++) * stride] = e;
  }
  __device__ __forceinline__ void push4(const int4& e, unsigned m) {
    if (m & 1u) push(e.x);
    if (m & 2u) push(e.y);
    if (m & 4u) push(e.z);
    if (m & 8u) push(e.w);
  }
};

// The pushes of up to MAXPOP (2 or 4) popped nodes, held in registers until
// every popped node has been visited: no array indexed at run time and no
// reference picked at run time, either of which would put them in local
// memory.
template <int MAXPOP>
struct Pending {
  int4 q0, q1, q2, q3;
  unsigned masks = 0u;

  __device__ __forceinline__ void put(int p, const int4& e, unsigned m) {
    if (p == 0) q0 = e;
    else if (MAXPOP == 2 || p == 1) q1 = e;
    else if (p == 2) q2 = e;
    else q3 = e;
    masks |= m << (4 * p);
  }
  __device__ __forceinline__ int4 pick(int p) const {
    if (p == 0) return q0;
    if (MAXPOP == 2 || p == 1) return q1;
    if (p == 2) return q2;
    return q3;
  }
  // the last popped node's children first, the first popped's on top
  __device__ __forceinline__ void flush(int n, SmemStack& s) const {
    for (int p = n - 1; p >= 0; --p) s.push4(pick(p), (masks >> (4 * p)) & 15u);
  }
};

// Moller-Trumbore against v0, e1, e2 (the .xyz of three float4); on a hit
// with t <= best_t it takes (t, u, v) and returns true.  RECIP: rcp.approx
// plus one Newton step in place of the divide (det = 0 gives inf, then
// NaN, which fails).
template <bool RECIP>
__device__ __forceinline__ bool mt_hit(const float4& v0, const float4& e1,
                                       const float4& e2, const Ray& r,
                                       float t_min, float& best_t,
                                       float& best_u, float& best_v) {
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  float inv_det;
  if (RECIP) {
    float r0;
    asm("rcp.approx.f32 %0, %1;" : "=f"(r0) : "f"(det));
    inv_det = r0 * (2.0f - det * r0);
  } else {
    inv_det = 1.0f / det;
  }
  const float tx = r.ox - v0.x, ty = r.oy - v0.y, tz = r.oz - v0.z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min && t <= best_t) {
    best_t = t;
    best_u = u;
    best_v = v;
    return true;
  }
  return false;
}

}  // namespace rtggx
