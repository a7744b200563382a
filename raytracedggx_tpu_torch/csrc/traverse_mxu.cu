// K7: closest-hit traversal of the instanced 4-wide scene BVH with the leaf
// test written as a linear form.
//
// Replaces the TPU kernel raytracedggx_tpu/ops/lab/fused_mxu.py:_mxu_kernel,
// launched by trace_tiles_mxu.
//
// Contract:
//   * nodes (N, 36) f32 rows, read as nine float4, and inv_mats (1+I, 12) as
//     K1; rec (S, 40) f32 per-slot records (ops/lab/fused_mxu.mxu_records
//     of mxu_stream's (n_leaves, 10, 4L) table, element for element): for
//     the features F = [o, d, o x d, 1] of the object-space ray, slot
//     j = leaf*L + k holds ten float4, one per feature f, of the
//     coefficients of its (det, u*det, v*det, t*det), so that det = sum_f
//     rec[j, f].x * F[f] and so on (pads carry NaN in the last three and
//     never hit).
//   * two pops per step, ordered as K6a (csrc/traverse_lab.cu): a popped
//     node's boxes are tested against best_t at the pop, its hit leaves in
//     child order, its pushed children through the 5-exchange network.
//   * a leaf's winner is the least t among its slots with u >= 0, v >= 0,
//     u + v <= 1 and t_min <= t <= best_t, the lowest slot on ties; it
//     replaces the best hit (so a later leaf wins an exact tie).
//   * outputs t (t_max on a miss), u, v (0 on a miss), slot = leaf*L + k and
//     inst = tag - 1 as int32 (-1 on a miss); rays with t_max < 0 do not
//     traverse; totals (null, or 2 int64): box tests and slot tests, summed.
//   * each of the four sums runs over f = 0..9 in turn, F[0]'s product
//     first and every later one added to it, in fp32.
//
// What bounds it on this card: as K1, the latency of dependent loads per
// ray, and per slot 40 FMAs against Moller-Trumbore's ~51 operations.
// The TPU kernel ran the product on its matrix unit over a 1024-ray
// packet; here each thread owns one ray, and the design cuts what a visit
// costs:
//   * a slot's 40 coefficients are one contiguous 160-byte record, ten
//     16-byte loads in place of 40 scalar loads strided by 4L floats; the
//     next slot's record is loaded feature by feature as the current one's
//     products consume it, so a leaf costs about one round trip;
//   * the stack in shared memory, [entry][thread], sized at launch from
//     the two-pop walk's bound 2 * (3 * depth - 2) (lab.cuh), the pushes of
//     both popped nodes held in registers; nine float4 per node row; box
//     and slot tests summed over the warp, one pair of atomics per warp.
// Tensor cores stay out.  TF32 keeps 10 mantissa bits: rounding the
// coefficients and features alone puts a relative error of up to
// 2^-11 = 4.9e-4 on t*det and on det, about 5x the t bar's rtol of 1e-4
// before any cancellation.  3xTF32 (each operand split into a TF32 high
// and low part) restores fp32 at three mma per product, and the
// contraction is only 10 deep, two k-steps of 8 with 6 of 16 empty: at
// the data sheet's 495 TF32 TFLOP/s that is 495 / 3 * 10 / 16 = 103
// TFLOP/s of useful work against 67 in FMAs, at most 1.5x on the slot
// arithmetic (the reference found the same trade a loss on the TPU,
// fused_mxu.py:36-45).  And an mma needs the warp's 32 rays at one leaf,
// which is a packet design, not one ray per thread.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lab.cuh"

namespace {

__global__ void __launch_bounds__(512)
mxu_kernel(const float4* __restrict__ nodes, const float4* __restrict__ rec,
           const float* __restrict__ inv_mats,
           const float* __restrict__ ray_o, const float* __restrict__ ray_d,
           const float* __restrict__ t_max, float t_min, int n_rays, int L,
           int stack_size, float* __restrict__ out_t,
           float* __restrict__ out_u, float* __restrict__ out_v,
           int* __restrict__ out_slot, int* __restrict__ out_inst,
           unsigned long long* __restrict__ totals) {
  extern __shared__ int mxu_smem[];  // the stack, [entry][thread]
  rtggx::SmemStack stack(mxu_smem, stack_size);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned n_box = 0, n_slot = 0;

  if (r < n_rays) {
    const float wox = ray_o[3 * r], woy = ray_o[3 * r + 1], woz = ray_o[3 * r + 2];
    const float wdx = ray_d[3 * r], wdy = ray_d[3 * r + 1], wdz = ray_d[3 * r + 2];
    float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
    int best_slot = -1, best_inst = -1;
    if (best_t >= 0.0f) {
      stack.push(0);
      int cur_tag = -1;
      rtggx::Ray ro;
      float F[10];
      while (stack.sp > 0) {
        const int top = stack.sp;
        const int n = top >= 2 ? 2 : 1;
        stack.sp -= n;
        rtggx::Pending<2> pend;
        for (int p = 0; p < n; ++p) {
          const int e = stack.at(top - 1 - p);
          const int idx = e & LAB_NODE_MASK, tag = e >> LAB_TAG_SHIFT;
          const rtggx::NodeRow row = rtggx::load_row(nodes, nullptr, 0, idx);
          if (tag != cur_tag) {
            ro = rtggx::make_ray(inv_mats + 12 * tag, wox, woy, woz, wdx, wdy,
                                 wdz);
            cur_tag = tag;
            F[0] = ro.ox; F[1] = ro.oy; F[2] = ro.oz;
            F[3] = ro.dx; F[4] = ro.dy; F[5] = ro.dz;
            F[6] = ro.oy * ro.dz - ro.oz * ro.dy;
            F[7] = ro.oz * ro.dx - ro.ox * ro.dz;
            F[8] = ro.ox * ro.dy - ro.oy * ro.dx;
            F[9] = 1.0f;
          }
          unsigned leaves, push;
          int4 ent;
          rtggx::children(row, ro, t_min, best_t, false, true, tag, 0, leaves,
                          ent, push, n_box);
          pend.put(p, ent, push);
          while (leaves) {  // hit leaves in child order
            const int k = __ffs(leaves) - 1;
            leaves &= leaves - 1;
            const int lf = (int)rtggx::lane(row.addr, k);
            const float4* __restrict__ R = rec + (size_t)lf * L * 10;
            int kl = -1;
            float tl = 0.0f, ul = 0.0f, vl = 0.0f;
            n_slot += L;
            float4 c[10];
#pragma unroll
            for (int f = 0; f < 10; ++f) c[f] = __ldg(R + f);
            for (int j = 0; j < L; ++j) {
              // slot j + 1's record replaces slot j's feature by feature
              const float4* __restrict__ nx = R + 10 * min(j + 1, L - 1);
              float dt = c[0].x * F[0], ud = c[0].y * F[0];
              float vd = c[0].z * F[0], td = c[0].w * F[0];
              c[0] = __ldg(nx);
#pragma unroll
              for (int f = 1; f < 10; ++f) {
                dt += c[f].x * F[f];
                ud += c[f].y * F[f];
                vd += c[f].z * F[f];
                td += c[f].w * F[f];
                c[f] = __ldg(nx + f);
              }
              const float rcp = 1.0f / dt;
              const float u = ud * rcp, v = vd * rcp, t = td * rcp;
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
        }
        pend.flush(n, stack);
      }
    }
    out_t[r] = best_t;
    out_u[r] = best_u;
    out_v[r] = best_v;
    out_slot[r] = best_slot;
    out_inst[r] = best_inst;
  }
  rtggx::add_stats(totals, n_box, n_slot);  // every thread of the warp
}

}  // namespace

// stack_size: entries per thread (the walk's bound); the launch takes
// threads * stack_size * 4 bytes of shared memory per block.
extern "C" int rtggx_trace_mxu(const void* nodes, const void* rec,
                               const void* inv_mats, const void* ray_o,
                               const void* ray_d, const void* t_max,
                               float t_min, int n_rays, int leaf_size,
                               int stack_size, int threads, void* out_t,
                               void* out_u, void* out_v, void* out_slot,
                               void* out_inst, void* totals, void* stream) {
  if (n_rays <= 0) return 0;
  if (stack_size < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t smem = (size_t)threads * stack_size * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mxu_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float4*)nodes, (const float4*)rec, (const float*)inv_mats,
      (const float*)ray_o, (const float*)ray_d, (const float*)t_max, t_min,
      n_rays, leaf_size, stack_size, (float*)out_t, (float*)out_u,
      (float*)out_v, (int*)out_slot, (int*)out_inst,
      (unsigned long long*)totals);
  return (int)cudaGetLastError();
}
