// K2.1 — hit-record kernel: nearest hit per ray over all instances, plus
// the winner's interpolated shading attributes.
//
// Replaces clraytracer_tpu/ops/trace_pallas.py:_make_kernel (launched by
// _trace_tiles, entry trace_pallas). Output [11, n] f32 planes:
// t | u | v | cluster slot (i32 bits) | instance (i32 bits) | n xyz | uu |
// vv | mat_local. Dead lanes (live[i] == 0) report t = -BIG and zeros, as
// the TPU kernel does.
//
// Bound on the H100: its least time is the 68 B/ray of rays in and planes
// out where most rays miss, the walk's operations in a large scene; what
// holds it above both is the walk (traverse.cuh): a warp's ray loads, its
// instance row, its boxes and its stores form one dependent chain, hidden
// only by the 20 warps an SM keeps resident. Design: one thread per ray,
// 128 threads per block, each warp walking its 32 rays together (rays
// i .. i + 31 are neighbours in screen order when the caller gives camera
// rays); rays arrive as six [n] planes so neighbouring threads read
// neighbouring addresses. Out-of-range and dead lanes stay in the warp's
// walk and pass no box.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (no FMA contraction: parity with the JAX reference's expression order).
#include "traverse.cuh"

// Five blocks of 128 threads resident per SM: registers capped at 96, none
// spilled, 20 warps to hide the walk's latency. Six blocks (80 registers,
// a few bytes spilled) measured faster than 16 warps with the walk before
// the present one; with the present one they spilled 42 bytes and ran the
// ground's shadow rays 7% slower than it, five 2% faster (PERF.md).
// render.cu, which holds shading state across the walk, measured the other
// way and keeps its registers.
__global__ void __launch_bounds__(128, 5)
trace_kernel(SceneTables s, const float* __restrict__ rays,
             const float* __restrict__ live, int n, float* __restrict__ out,
             unsigned long long* counters) {
  __shared__ WarpStage stage[4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  const bool alive = valid && (live == nullptr || live[i] != 0.0f);
  TestCount cnt = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
  const size_t N = (size_t)n;
  float ray[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (valid) {
    for (int c = 0; c < 6; ++c) ray[c] = rays[c * N + i];
  }
  Hit h;
  h.t = alive ? CLRT_BIG : -CLRT_BIG;
  h.u = 0.0f;
  h.v = 0.0f;
  h.slot = 0;
  h.inst = 0;
  traverse(s, stage[threadIdx.x >> 5], alive, ray[0], ray[1], ray[2], ray[3],
           ray[4], ray[5], h, cnt);
  if (valid) {
    HitAttrs a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (fabsf(h.t) < CLRT_BIG) a = interpolate(s, h, cnt);
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
