// K2.3 / K2.4 — the differentiable tracer's row gather and its transpose.
//
// K2.3 clrt_gather_rows replaces clraytracer_tpu/ops/gather_pallas.py
// _gather_kernel (launched by _gather_rows):
//     out[w, p] = table[clip(idx[p], 0, T-1), w]
// table [T, W] f32 row-major, idx [N] i32, out [W, N] f32 field-planar.
// Bit-exact: each output is a copy of one table value.
//
// K2.4 clrt_scatter_rows replaces gather_pallas.py _scatter_kernel
// (launched by _scatter_rows), the VJP of the gather:
//     d[t, w] += g[w, p] for every p with clip(idx[p], 0, T-1) == t
// g [W, N] f32 field-planar, d [T, W] f32 zero-filled by the caller.
// Terms whose g is exactly 0 (either sign) are skipped: the accumulator
// starts at +0 and x + (+-0) == x for every x, +0 + -0 = +0 included, so
// the sum is the same. Miss and dead lanes are pinned to row 0 by the
// caller and carry zero cotangents; without the skip their atomics would
// all land on row 0's W addresses and serialise.
// The atomics make the order of summation vary from run to run, so the
// result may differ from a sequential sum (and between runs) by rounding.
//
// Bound on the H100: both move bytes and do almost no arithmetic.
//   K2.3 bytes = N*4 (idx) + N*W*4 (out) + T*W*4 (table)
//   K2.4 bytes = N*4 (idx) + N*W*4 (g)   + T*W*4 (d)
// At the 1920x1080 differentiable step (N = 2,080,768 padded rays, T =
// 5952 slots: 4224 triangles in 186 clusters of 32, W = 25) each is
// 216,995,072 bytes, 0.0648 ms at 3.35 TB/s.
//
// The TPU kernels computed both directions as chunk-predicated one-hot
// matmuls over a 3-plane bf16 split of the table (the MXU was the TPU's
// only fast gather) with the table resident in VMEM (<= 16384 rows). None
// of that carries over: one thread per ray reads its clamped row and
// writes (or atomically adds) its W values, so neighbouring threads touch
// neighbouring addresses of each [N] plane; the table is small enough to
// stay in L2 and any T is taken.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ int clip_row(int r, int t_rows) {
  return r < 0 ? 0 : (r >= t_rows ? t_rows - 1 : r);
}

__global__ void __launch_bounds__(256)
gather_rows_kernel(const float* __restrict__ table, int t_rows, int w,
                   const int* __restrict__ idx, int n,
                   float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float* row = table + (size_t)clip_row(idx[p], t_rows) * w;
  for (int k = 0; k < w; ++k) out[(size_t)k * n + p] = __ldg(row + k);
}

__global__ void __launch_bounds__(256)
scatter_rows_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                    int n, int t_rows, int w, float* __restrict__ d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float* row = d + (size_t)clip_row(idx[p], t_rows) * w;
  for (int k = 0; k < w; ++k) {
    const float gv = g[(size_t)k * n + p];
    if (gv != 0.0f) atomicAdd(row + k, gv);
  }
}

}  // namespace

extern "C" int clrt_gather_rows(const float* table, int t_rows, int w,
                                const int* idx, int n, float* out,
                                void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  gather_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, t_rows, w, idx, n, out);
  return (int)cudaGetLastError();
}

extern "C" int clrt_scatter_rows(const float* g, const int* idx, int n,
                                 int t_rows, int w, float* d, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  scatter_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, idx, n, t_rows, w, d);
  return (int)cudaGetLastError();
}
