// XF's per-ray product, y = x . M, shared by the kernels that transform a
// ray's vector by its instance's matrix (xform.cu: XF; shade.cu: BS), so
// every one of them rounds the product the same way and BS's transforms
// are XF's bit for bit.
//
// m: the matrix staged row-major as [K][D] floats, K = C + AFFINE (the
// translation row last); x: C floats.  y_d = sum_c x_c M[c][d],
// accumulated in c order, plus M[C][d] where AFFINE.  Compiled as plain
// float arithmetic, without fast math, as XF always was.

#pragma once

template <int C, int D, bool AFFINE>
__device__ __forceinline__ void xform_row(const float* m, const float* x,
                                          float* y) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float acc = x[0] * m[d];
#pragma unroll
    for (int c = 1; c < C; ++c) acc += x[c] * m[c * D + d];
    if (AFFINE) acc += m[C * D + d];
    y[d] = acc;
  }
}
