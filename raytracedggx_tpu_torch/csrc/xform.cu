// XF: per-ray transforms by per-instance matrices, y = x . M[inst].
//
// The frame's glue multiplies every ray's vector by its hit instance's
// matrix: object to world and back, the normal matrix, the current and
// previous clip transforms (trace/raygen.py).  The plain version gathers
// a (3, 3) or (4, 4) matrix per ray from a table of a few rows
// (take_small) and hands the batch of 1x3 . 3x3 products to a batched
// GEMV (einsum); this kernel replaces both.  It is no port of a Pallas
// kernel: the JAX package leaves the product to XLA as a one-hot matmul.
//
// What bounds it: bytes.  A ray reads its instance id (4 or 8 bytes) and
// its 3-vector (12), and writes 12 or 16 bytes; a few FMAs per output are
// nothing beside that (28-36 bytes a ray, ~9 us for 921,600 rays at
// 3.35 TB/s).  The matrix table (R rows of at most 4 x 4 floats) is staged
// in shared memory by every block, so no ray reads its matrix from
// global memory and no per-ray matrix is ever written out: that staging
// is what removes the plain version's gather of 36-64 bytes a ray.
//
// Per ray, one thread: the id is clamped to [0, R - 1], so a miss (-1)
// reads row 0 as take_small does; y_d = sum_c x_c M[c][d] accumulated in
// c order, plus the translation row M[C][d] where the call is affine (x
// has C = K - 1 columns and its implicit w = 1 reads row K - 1): the
// product of xform.cuh, which BS (shade.cu) shares.  No
// reduction runs across rays: a ray's result depends on nothing but its
// own inputs, so row bands equal the full frame bit for bit.  Inputs may
// be strided views (the un-permuted rows of a wave); the output is a
// contiguous (N, D) float32 tensor.  No fast math.

#include <cuda_runtime.h>

#include "xform.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 512;   // staged rows: at most 512 x 16 x 4 = 32 KiB

// K rows of the matrix are read (C of x, plus the translation row when
// AFFINE), D columns of each; the table is (R, K', D') with any strides.
template <int C, int D, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
instance_xform_kernel(const float* __restrict__ table, int rows,
                      long long s_row, long long s_k, long long s_d,
                      const void* __restrict__ inst, long long inst_stride,
                      int inst64, const float* __restrict__ x,
                      long long x_row, long long x_col, int n,
                      float* __restrict__ out) {
  constexpr int K = C + (AFFINE ? 1 : 0);
  extern __shared__ float tab[];          // [rows][K][D]
  for (int e = threadIdx.x; e < rows * K * D; e += blockDim.x) {
    const int r = e / (K * D), k = (e / D) % K, d = e % D;
    tab[e] = table[r * s_row + k * s_k + d * s_d];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long id = inst64
      ? static_cast<const long long*>(inst)[i * inst_stride]
      : static_cast<long long>(static_cast<const int*>(inst)[i * inst_stride]);
  id = id < 0 ? 0 : (id >= rows ? rows - 1 : id);
  float xv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) xv[c] = x[i * x_row + c * x_col];
  float y[D];
  xform_row<C, D, AFFINE>(tab + id * (K * D), xv, y);
#pragma unroll
  for (int d = 0; d < D; ++d) out[static_cast<long long>(i) * D + d] = y[d];
}

template <int C, int D, bool AFFINE>
int launch(const float* table, int rows, long long s_row, long long s_k,
           long long s_d, const void* inst, long long inst_stride, int inst64,
           const float* x, long long x_row, long long x_col, int n,
           float* out, cudaStream_t stream) {
  constexpr int K = C + (AFFINE ? 1 : 0);
  const size_t smem = sizeof(float) * rows * K * D;
  const int blocks = (n + kThreads - 1) / kThreads;
  instance_xform_kernel<C, D, AFFINE><<<blocks, kThreads, smem, stream>>>(
      table, rows, s_row, s_k, s_d, inst, inst_stride, inst64, x, x_row,
      x_col, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rtggx_xform_max_rows() { return kMaxRows; }

// out[i] = x[i] . M[clamp(inst[i])] (+ the row after x's last column when
// affine).  table: rows x (>= C + affine) x (>= D) floats at the given
// element strides; inst: int32 or int64 (inst64) at element stride
// inst_stride; x: n rows of C floats at element strides (x_row, x_col);
// out: n x D contiguous.  (C, D, affine) is (3, 3, 0), (3, 3, 1)
// or (3, 4, 1); anything else, or rows outside [1, kMaxRows], is refused.
int rtggx_instance_xform(const float* table, int rows, long long s_row,
                         long long s_k, long long s_d, const void* inst,
                         long long inst_stride, int inst64, const float* x,
                         long long x_row, long long x_col, int c, int d,
                         int affine, int n, float* out, void* stream) {
  if (rows < 1 || rows > kMaxRows || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (c == 3 && d == 3 && !affine)
    return launch<3, 3, false>(table, rows, s_row, s_k, s_d, inst,
                               inst_stride, inst64, x, x_row, x_col, n, out,
                               s);
  if (c == 3 && d == 3 && affine)
    return launch<3, 3, true>(table, rows, s_row, s_k, s_d, inst, inst_stride,
                              inst64, x, x_row, x_col, n, out, s);
  if (c == 3 && d == 4 && affine)
    return launch<3, 4, true>(table, rows, s_row, s_k, s_d, inst, inst_stride,
                              inst64, x, x_row, x_col, n, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
