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
// The file's second entry, clrt_pick, is the editor's pick: one ray's walk
// and its whole hit record in one launch (below).
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


// ---------------------------------------------------------------------------
// The pick: one ray, walked and shaded in one launch
// ---------------------------------------------------------------------------
//
// raycast.pick on the card (the reference's CPU_RayCast -> HitRecord,
// CPURayTrace.cpp:186-249). One warp: lane 0 walks the ray as lane 0 of a
// one-ray trace_kernel launch does (lanes 1-31 dead, their rays zero), so
// its hit is K2.1's; then lane 0 finishes the record in raycast.raycast's
// torch composition, op for op in its order (its plain version): the slot's
// arena triangle (tri_gid), that triangle's tri_attr row blended as
// attr[c]*w0 + attr[3+c]*u + attr[6+c]*v, the normal through rows 0/4/8,
// 1/5/9, 2/6/10 of the instance row and v / sqrt(dot(v, v)), the material
// row inst[16] + attr[15], shade._pool_index's texel and
// shade._modulate_bytes. Every gather clamps its row as gather.take_rows
// does; a miss finishes slot 0, instance 0, u = v = 0, as the composition
// does. The ray arrives by value, so nothing is uploaded. Bound: one ray's
// walk and six rows, a few kilobytes: the launch's own latency.

// words of the record (ops/trace.py PICK_WORDS): hit (1 or 0) | distance
// (CLRT_BIG on a miss) | triangle (i32 bits) | instance (i32 bits) | normal
// xyz | uv | colour rgb
#define CLRT_PICK_WORDS 12

struct PickParams {
  float ray[6];              // world origin xyz | direction xyz
  const long long* tri_gid;  // [n_slots]: cluster slot -> arena triangle
  const float* tri_attr;     // [n_tri, 16]: n0 n1 n2 | uv0 uv1 uv2 | mat_local
  const float* mat_rows;     // [n_mat, 16]: albedo(3) ... | aw ah aoff_hi aoff_lo | ...
  const float* texels;       // [n_texels, tex_cols] in [0, 1]
  int n_slots, n_tri, n_mat, n_texels, tex_cols;
};

// gather.take_rows' row: the index clamped to [0, n - 1]
__device__ __forceinline__ size_t take_row(long long i, int n) {
  return (size_t)(i < 0 ? 0 : (i > n - 1 ? n - 1 : i));
}

// torch.clamp(x, 0, 1), NaN kept
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(32, 1)
pick_kernel(SceneTables s, PickParams p, float* __restrict__ out) {
  __shared__ WarpStage stage;
  const bool alive = threadIdx.x == 0;
  TestCount cnt = {0u, 0u, 0u, 0u, 0u, 0u};
  float ray[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (alive) {
    for (int c = 0; c < 6; ++c) ray[c] = p.ray[c];
  }
  Hit h;
  h.t = alive ? CLRT_BIG : -CLRT_BIG;
  h.u = 0.0f;
  h.v = 0.0f;
  h.slot = 0;
  h.inst = 0;
  traverse(s, stage, alive, ray[0], ray[1], ray[2], ray[3], ray[4], ray[5], h, cnt);
  if (!alive) return;

  const bool hit = h.t < CLRT_BIG;
  const int tri = (int)p.tri_gid[take_row(h.slot, p.n_slots)];
  const float* a = p.tri_attr + take_row(tri, p.n_tri) * 16;
  const float* m = s.inst + take_row(h.inst, s.n_inst) * 17;
  const float u = h.u, v = h.v;
  const float w0 = 1.0f - u - v;
  const float n0 = a[0] * w0 + a[3] * u + a[6] * v;
  const float n1 = a[1] * w0 + a[4] * u + a[7] * v;
  const float n2 = a[2] * w0 + a[5] * u + a[8] * v;
  const float wx = n0 * m[0] + n1 * m[4] + n2 * m[8];
  const float wy = n0 * m[1] + n1 * m[5] + n2 * m[9];
  const float wz = n0 * m[2] + n1 * m[6] + n2 * m[10];
  const float len = sqrtf(wx * wx + wy * wy + wz * wz);
  const float uu = a[9] * w0 + a[11] * u + a[13] * v;
  const float vv = a[10] * w0 + a[12] * u + a[14] * v;

  const float* mr = p.mat_rows + take_row((int)m[16] + (int)a[15], p.n_mat) * 16;
  const float aw = mr[8], ah = mr[9];
  // shade._pool_index in i32 (wrapping, as torch's)
  const unsigned aoff = (unsigned)(int)mr[10] * (1u << 12) + (unsigned)(int)mr[11];
  const unsigned us = (unsigned)(int)((uu - floorf(uu)) * aw);
  const unsigned vs = (unsigned)(int)((vv - floorf(vv)) * ah);
  const int texel = (int)(vs * (unsigned)(int)aw + us + aoff);
  const float* tx = p.texels + take_row(texel, p.n_texels) * p.tex_cols;

  out[0] = hit ? 1.0f : 0.0f;
  out[1] = hit ? h.t : CLRT_BIG;
  out[2] = __int_as_float(tri);
  out[3] = __int_as_float(h.inst);
  out[4] = wx / len;
  out[5] = wy / len;
  out[6] = wz / len;
  out[7] = uu;
  out[8] = vv;
  for (int c = 0; c < 3; ++c) {
    // shade._modulate_bytes: the reference's byte modulate
    const float mat_b = rintf(clamp01(mr[c]) * 255.0f);
    const float tex_b = rintf(tx[c] * 255.0f);
    out[9 + c] = floorf(mat_b * tex_b * (1.0f / 256.0f)) * (float)(1.0 / 255.0);
  }
}

extern "C" int clrt_pick(const SceneTables* s, const PickParams* p, float* out,
                         void* stream) {
  pick_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(*s, *p, out);
  return (int)cudaGetLastError();
}
