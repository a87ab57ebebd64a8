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
// Sums that are exactly 0 (either sign) are not added: the accumulator
// starts at +0, never becomes -0, and x + (+-0) == x for every other x, so
// the sum is the same. Miss and dead lanes are pinned to row 0 by the
// caller and carry zero cotangents; without the skip their atomics would
// all land on row 0's W addresses and serialise.
// Warp sums and atomics make the order of summation vary from run to run,
// so the result may differ from a sequential sum (and between runs) by
// rounding.
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
// of that carries over; the table is small enough to stay in L2 and any T
// is taken.
//
// K2.3: one thread per ray reads its clamped row and writes its W values,
// so neighbouring threads write neighbouring addresses of each [N] plane.
//
// K2.4: its bytes are the [W, N] cotangents, read once. One thread per ray
// with one 4-byte load in flight (its design before) kept too few bytes in
// flight to cover HBM latency, and the same-address atomics of hit rays
// that share a triangle serialised within their warp. So:
//  * a thread takes 4 neighbouring rays (where N % 4 == 0 and g and idx are
//    16-byte aligned, else one): its index and each column's cotangents
//    are one 16-byte load each, SCATTER_COLS columns loaded before any is
//    used (W taken in chunks of 8, the tail masked);
//  * a warp skips the atomic phase of a ray slot and chunk where every
//    lane's cotangents are zero (missed and dead rays, most of a frame);
//  * otherwise the lanes that share a clipped row (__match_any_sync) sum
//    their values by shuffles, and the group's lowest lane does one
//    atomicAdd per (row, column) with a nonzero sum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

// K2.4: columns taken SCATTER_COLS at a time, each a 16-byte load per
// thread where VEC = 4 (4 and 16 were no faster, PERF.md)
constexpr int SCATTER_COLS = 8;
#define FULL_MASK 0xffffffffu

// Sums x over the lanes of `peers` (this lane's group, this lane in it)
// into the group's lowest lane, in log2(group size) rounds: in round r a
// lane of relative position i (i divisible by 2^r) adds the running sum of
// the group's next remaining lane, and the lanes with bit r of i set drop
// out. Every lane of the warp must call it.
__device__ __forceinline__ void sum_peers(unsigned peers, int lane,
                                          float (&x)[SCATTER_COLS]) {
  unsigned rel = __popc(peers & ((1u << lane) - 1u));  // peers below
  unsigned above = peers & ~((2u << lane) - 1u);        // peers above
  while (__any_sync(FULL_MASK, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, 0 if none
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int j = 0; j < SCATTER_COLS; ++j) {
      const float t = __shfl_sync(FULL_MASK, x[j], src);
      if (next) x[j] += t;
    }
    above &= ~__ballot_sync(FULL_MASK, rel & 1u);
    rel >>= 1;
  }
}

// Thread k of the grid takes rays VEC k .. VEC k + VEC - 1: with VEC = 4
// its index and each column's cotangents are one 16-byte load each
// (n % 4 == 0 and 16-byte aligned g and idx), else one ray a thread.
// Rays past n take row -1 and zero cotangents, and stay for the warp's
// collectives.
template <int VEC>
__global__ void __launch_bounds__(256)
scatter_rows_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                    int n, int t_rows, int w, float* __restrict__ d) {
  const int lane = threadIdx.x & 31;
  const long long p0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool full = p0 + VEC <= n;
  int row[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) row[v] = -1;
  if constexpr (VEC == 4) {
    if (full) {
      const int4 r = __ldg(reinterpret_cast<const int4*>(idx + p0));
      row[0] = r.x;
      row[1] = r.y;
      row[2] = r.z;
      row[3] = r.w;
    }
  } else {
    if (full) row[0] = __ldg(idx + p0);
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    if (full) row[v] = clip_row(row[v], t_rows);
  }
  unsigned peers[VEC];
  unsigned matched = 0u;  // slots whose peers are known (warp-uniform)
  for (int k0 = 0; k0 < w; k0 += SCATTER_COLS) {
    // every load of the chunk in flight before any is used
    float x[SCATTER_COLS][VEC];
#pragma unroll
    for (int j = 0; j < SCATTER_COLS; ++j) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[j][v] = 0.0f;
      if (k0 + j < w && full) {
        const float* col = g + (size_t)(k0 + j) * (size_t)n + p0;
        if constexpr (VEC == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(col));
          x[j][0] = q.x;
          x[j][1] = q.y;
          x[j][2] = q.z;
          x[j][3] = q.w;
        } else {
          x[j][0] = __ldg(col);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      bool nz = false;
#pragma unroll
      for (int j = 0; j < SCATTER_COLS; ++j) nz |= x[j][v] != 0.0f;
      // most warps carry only zero cotangents (missed and dead rays)
      if (!__any_sync(FULL_MASK, nz)) continue;
      if (!((matched >> v) & 1u)) {
        peers[v] = __match_any_sync(FULL_MASK, row[v]);
        matched |= 1u << v;
      }
      float s[SCATTER_COLS];
#pragma unroll
      for (int j = 0; j < SCATTER_COLS; ++j) s[j] = x[j][v];
      sum_peers(peers[v], lane, s);
      // the group's lowest lane adds its sums: one atomic per distinct
      // (row, column) of the warp; a zero sum adds nothing
      if (lane == __ffs(peers[v]) - 1 && row[v] >= 0) {
        float* dst = d + (size_t)row[v] * w + k0;
#pragma unroll
        for (int j = 0; j < SCATTER_COLS; ++j) {
          if (k0 + j < w && s[j] != 0.0f) atomicAdd(dst + j, s[j]);
        }
      }
    }
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
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = n % 4 == 0 && ((uintptr_t)g % 16) == 0 && ((uintptr_t)idx % 16) == 0;
  if (vec) {
    const int blocks = (n / 4 + threads - 1) / threads;
    scatter_rows_kernel<4><<<blocks, threads, 0, st>>>(g, idx, n, t_rows, w, d);
  } else {
    const int blocks = (n + threads - 1) / threads;
    scatter_rows_kernel<1><<<blocks, threads, 0, st>>>(g, idx, n, t_rows, w, d);
  }
  return (int)cudaGetLastError();
}
