// K2.1 — hit-record kernel: nearest hit per ray over all instances, plus
// the winner's interpolated shading attributes.
//
// Replaces clraytracer_tpu/ops/trace_pallas.py:_make_kernel (launched by
// _trace_tiles, entry trace_pallas). Output [11, n] f32 planes:
// t | u | v | cluster slot (i32 bits) | instance (i32 bits) | n xyz | uu |
// vv | mat_local. Dead lanes (live[i] == 0) report t = -BIG and zeros, as
// the TPU kernel does.
//
// Bound on the H100: see traverse.cuh (latency/issue-bound traversal).
// Design: one thread per ray, 128 threads per block; rays arrive as six
// [n] planes so neighbouring threads read neighbouring addresses.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (no FMA contraction: parity with the JAX reference's expression order).
#include "traverse.cuh"

__global__ void __launch_bounds__(128)
trace_kernel(SceneTables s, const float* __restrict__ rays,
             const float* __restrict__ live, int n, float* __restrict__ out,
             unsigned long long* counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  TestCount cnt = {0ull, 0ull, 0ull, 0ull};
  if (i < n) {
    const bool alive = live == nullptr || live[i] != 0.0f;
    Hit h;
    h.t = alive ? CLRT_BIG : -CLRT_BIG;
    h.u = 0.0f;
    h.v = 0.0f;
    h.slot = 0;
    h.inst = 0;
    if (alive) {
      traverse(s, rays[i], rays[(size_t)n + i], rays[2 * (size_t)n + i],
               rays[3 * (size_t)n + i], rays[4 * (size_t)n + i],
               rays[5 * (size_t)n + i], h, cnt);
    }
    HitAttrs a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (fabsf(h.t) < CLRT_BIG) a = interpolate(s, h, cnt);
    const size_t N = (size_t)n;
    out[i] = h.t;
    out[N + i] = h.u;
    out[2 * N + i] = h.v;
    out[3 * N + i] = __int_as_float(h.slot);
    out[4 * N + i] = __int_as_float(h.inst);
    out[5 * N + i] = a.nx;
    out[6 * N + i] = a.ny;
    out[7 * N + i] = a.nz;
    out[8 * N + i] = a.uu;
    out[9 * N + i] = a.vv;
    out[10 * N + i] = a.mat;
  }
  if (counters != nullptr) add_counts(counters, cnt);
}

extern "C" int clrt_trace(const SceneTables* s, const float* rays,
                          const float* live, int n, float* out,
                          unsigned long long* counters, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  trace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *s, rays, live, n, out, counters);
  return (int)cudaGetLastError();
}
