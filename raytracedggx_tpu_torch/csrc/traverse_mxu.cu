// K7: closest-hit traversal of the instanced 4-wide scene BVH with the leaf
// test written as a linear form.
//
// Replaces the TPU kernel raytracedggx_tpu/ops/lab/fused_mxu.py:_mxu_kernel,
// launched by trace_tiles_mxu.
//
// Contract:
//   * nodes (N, 36) f32 rows and inv_mats (1+I, 12) as K1; coef
//     (n_leaves, 10, 4L) f32 from ops/lab/fused_mxu.mxu_stream: for the
//     features F = [o, d, o x d, 1] of the object-space ray, output column
//     j of a leaf is sum_f coef[f, j] * F[f], and columns [0, L), [L, 2L),
//     [2L, 3L), [3L, 4L) are det, u*det, v*det and t*det of its slots (pads
//     carry NaN in the last three and never hit).
//   * two pops per step, ordered as K6a (csrc/traverse_lab.cu): a popped
//     node's boxes are tested against best_t at the pop, its hit leaves in
//     child order, its pushed children through the 5-exchange network.
//   * a leaf's winner is the least t among its slots with u >= 0, v >= 0,
//     u + v <= 1 and t_min <= t <= best_t, the lowest slot on ties; it
//     replaces the best hit (so a later leaf wins an exact tie).
//   * outputs t (t_max on a miss), u, v (0 on a miss), slot = leaf*L + k and
//     inst = tag - 1 as int32 (-1 on a miss); rays with t_max < 0 return at
//     once; totals (null, or 2 int64): box tests and slot tests, summed.
//   * fp32 FMAs throughout: not TF32, whose 10-bit mantissa would break
//     the t bar, and the TPU kernel ran its product at "highest" precision.
//
// What bounds it on this card: each leaf visit is 40*L FMAs and 40*L
// coefficient loads per ray (all threads of a warp at one leaf read the
// same coefficients, a broadcast), so at L = 32 a leaf costs 3x the
// operations of Moller-Trumbore's ~51 per slot.  The TPU kernel used its
// matrix unit for this product over a 1024-ray packet; a tensor-core form
// here needs a warp that shares its leaf (a packet design), which is later
// work.  One ray per thread keeps K1's per-ray visits.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lab.cuh"

namespace {

__global__ void __launch_bounds__(512)
mxu_kernel(const float* __restrict__ nodes, const float* __restrict__ coef,
           const float* __restrict__ inv_mats,
           const float* __restrict__ ray_o, const float* __restrict__ ray_d,
           const float* __restrict__ t_max, float t_min, int n_rays, int L,
           int stack_size, float* __restrict__ out_t,
           float* __restrict__ out_u, float* __restrict__ out_v,
           int* __restrict__ out_slot, int* __restrict__ out_inst,
           unsigned long long* __restrict__ totals) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float wox = ray_o[3 * r], woy = ray_o[3 * r + 1], woz = ray_o[3 * r + 2];
  const float wdx = ray_d[3 * r], wdy = ray_d[3 * r + 1], wdz = ray_d[3 * r + 2];
  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1, best_inst = -1;
  unsigned long long n_box = 0, n_slot = 0;

  if (best_t >= 0.0f) {
    int stack[LAB_MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;
    int cur_tag = -1;
    rtggx::Ray ro;
    float F[10];
    const int w = 4 * L;
    while (sp > 0) {
      const int top = sp;
      const int n = top >= 2 ? 2 : 1;
      sp -= n;
      int pend[2][4], pcnt[2];
      for (int p = 0; p < n; ++p) {
        const int e = stack[top - 1 - p];
        const int idx = e & LAB_NODE_MASK, tag = e >> LAB_TAG_SHIFT;
        if (tag != cur_tag) {
          ro = rtggx::make_ray(inv_mats + 12 * tag, wox, woy, woz, wdx, wdy, wdz);
          cur_tag = tag;
          F[0] = ro.ox; F[1] = ro.oy; F[2] = ro.oz;
          F[3] = ro.dx; F[4] = ro.dy; F[5] = ro.dz;
          F[6] = ro.oy * ro.dz - ro.oz * ro.dy;
          F[7] = ro.oz * ro.dx - ro.ox * ro.dz;
          F[8] = ro.ox * ro.dy - ro.oy * ro.dx;
          F[9] = 1.0f;
        }
        const float* row = nodes + (size_t)idx * 36;
        const float bt0 = best_t;
        int kind[4], child[4], ent[4];
        float key[4];
        bool hit[4], push[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          kind[k] = (int)__ldg(row + 24 + k);
          child[k] = (int)__ldg(row + 28 + k);
          float tn = 0.0f;
          hit[k] = false;
          if (kind[k] != 0) {
            ++n_box;
            hit[k] = rtggx::slab(row + 6 * k, ro, t_min, bt0, false, tn);
          }
          const int child_tag = kind[k] == 3 ? (int)__ldg(row + 32 + k) : tag;
          ent[k] = child[k] | (child_tag << LAB_TAG_SHIFT);
          push[k] = hit[k] && kind[k] >= 2;
          key[k] = push[k] ? tn : -CUDART_INF_F;
        }
        for (int k = 0; k < 4; ++k) {
          if (!hit[k] || kind[k] != 1) continue;
          const int lf = child[k];
          const float* C = coef + (size_t)lf * 10 * w;
          int kl = -1;
          float tl = 0.0f, ul = 0.0f, vl = 0.0f;
          n_slot += L;
          for (int j = 0; j < L; ++j) {
            float acc[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const float* c = C + g * L + j;
              float s = __ldg(c) * F[0];
#pragma unroll
              for (int f = 1; f < 10; ++f) s += __ldg(c + f * w) * F[f];
              acc[g] = s;
            }
            const float rcp = 1.0f / acc[0];
            const float u = acc[1] * rcp, v = acc[2] * rcp, t = acc[3] * rcp;
            if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min &&
                t <= best_t && (kl < 0 || t < tl)) {
              kl = j;
              tl = t;
              ul = u;
              vl = v;
            }
          }
          if (kl >= 0) {
            best_t = tl;
            best_u = ul;
            best_v = vl;
            best_slot = lf * L + kl;
            best_inst = tag - 1;
          }
        }
        rtggx::sort4_desc(key, ent, push);
        int c = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (push[k]) pend[p][c++] = ent[k];
        pcnt[p] = c;
      }
      for (int p = n - 1; p >= 0; --p)
        for (int i = 0; i < pcnt[p]; ++i)
          if (sp < stack_size) stack[sp++] = pend[p][i];
    }
  }
  out_t[r] = best_t;
  out_u[r] = best_u;
  out_v[r] = best_v;
  out_slot[r] = best_slot;
  out_inst[r] = best_inst;
  if (totals != nullptr && (n_box | n_slot) != 0) {
    atomicAdd(totals, n_box);
    atomicAdd(totals + 1, n_slot);
  }
}

}  // namespace

extern "C" int rtggx_trace_mxu(const void* nodes, const void* coef,
                               const void* inv_mats, const void* ray_o,
                               const void* ray_d, const void* t_max,
                               float t_min, int n_rays, int leaf_size,
                               int stack_size, int threads, void* out_t,
                               void* out_u, void* out_v, void* out_slot,
                               void* out_inst, void* totals, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size > LAB_MAX_STACK) stack_size = LAB_MAX_STACK;
  const int blocks = (n_rays + threads - 1) / threads;
  mxu_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)nodes, (const float*)coef, (const float*)inv_mats,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, leaf_size, stack_size, (float*)out_t, (float*)out_u,
      (float*)out_v, (int*)out_slot, (int*)out_inst,
      (unsigned long long*)totals);
  return (int)cudaGetLastError();
}
