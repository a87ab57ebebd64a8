// The world boxes of the walk's instance level (traverse.cuh): per
// instance, its mesh's object-space root box (the union of its hyper
// boxes) mapped to world space by the inverse of the instance's stored
// inverse transform, and above CLRT_ICHUNK (traverse.cuh) instances the
// union of each chunk of CLRT_ICHUNK instance boxes. Its plain version is
// ops/trace.py instance_boxes_plain, bit for bit.
//
// Replaces no TPU kernel: the TPU kernels loop over every instance a ray
// (trace_pallas.py:_emit_traversal), as the upstream does
// (kernel_main.cl:205-207). It exists for the card's instance level, and
// runs wherever ops/trace.py makes the tables' instance rows (_with_rows),
// so the boxes always follow the rows the walk transforms by.
//
// Bound on the H100: launch latency; 401 instances are 13 KB of boxes. One
// block: a thread an instance, then a thread a chunk.
//
// The box (row of 8 floats, the layout of the other levels' boxes): min xyz
// | max x, max yz | alpha | beta. The walk grows it by alpha + beta * |o|_inf
// for a ray from o: alpha = 64 eps (|F| |m| + cond R), beta = 64 eps cond,
// F = M^-1, cond = |M| |F| (column-sum norms), R = the world box's largest
// coordinate, eps = 2^-24. That is over 4 times the float32 error of the
// walk's transform of the ray (o' = o M + m, d' = d M), of its
// object-space slab test and of its world-space one, at any t where the
// ray is inside the root box, in world units: eps (13 cond |o|_inf +
// 4 |F| |m| + 9 cond R). Arithmetic in double: the inverse by
// cofactors, the box as centre and half extent (|F| applied to the half
// extent), rounded outwards to float. A singular or non-finite transform
// gives an unbounded box, an instance without triangles one at +inf on
// every axis (every ray misses it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
#include "traverse.cuh"

#define CLRT_BOX_K 64.0  // the margin's factor
#define CLRT_EPS32 5.9604644775390625e-08  // 2^-24

__device__ __forceinline__ void instance_box(const float* __restrict__ inst,
                                             const int* __restrict__ ranges,
                                             const float* __restrict__ hyper_box,
                                             int i, float* __restrict__ out) {
  const int sc0 = ranges[4 * i], sc_n = ranges[4 * i + 1];
  const int hy0 = sc0 / CLRT_GROUP, nh = (sc_n + CLRT_GROUP - 1) / CLRT_GROUP;
  float* o = out + 8 * i;
  if (nh == 0) {
    for (int k = 0; k < 6; ++k) o[k] = CLRT_INF;
    o[6] = 0.0f;
    o[7] = 0.0f;
    return;
  }
  float blo[3] = {CLRT_INF, CLRT_INF, CLRT_INF}, bhi[3] = {-CLRT_INF, -CLRT_INF, -CLRT_INF};
  for (int k = 0; k < nh; ++k) {
    const float* hb = hyper_box + 8 * (hy0 + k);
    for (int c = 0; c < 3; ++c) {
      blo[c] = fminf(blo[c], hb[c]);
      bhi[c] = fmaxf(bhi[c], hb[3 + c]);
    }
  }
  const float* m = inst + 17 * i;
  double a[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) a[r][c] = (double)m[4 * r + c];
  const double t[3] = {(double)m[12], (double)m[13], (double)m[14]};
  // F = a^-1: the transposed cofactors over the determinant
  const double c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const double c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const double c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const double det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
  double f[3][3];
  f[0][0] = c00 / det;
  f[1][0] = c01 / det;
  f[2][0] = c02 / det;
  f[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
  f[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
  f[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
  f[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
  f[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
  f[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
  // world point = (object point - t) F; the box as centre and half extent
  double ctr[3], half[3];
  for (int r = 0; r < 3; ++r) {
    ctr[r] = ((double)blo[r] + (double)bhi[r]) * 0.5 - t[r];
    half[r] = ((double)bhi[r] - (double)blo[r]) * 0.5;
  }
  double lo[3], hi[3], rw = 0.0, n_a = 0.0, n_f = 0.0, n_t = 0.0;
  for (int c = 0; c < 3; ++c) {
    const double wc = ctr[0] * f[0][c] + ctr[1] * f[1][c] + ctr[2] * f[2][c];
    const double we = half[0] * fabs(f[0][c]) + half[1] * fabs(f[1][c]) + half[2] * fabs(f[2][c]);
    lo[c] = wc - we;
    hi[c] = wc + we;
    rw = fmax(rw, fmax(fabs(lo[c]), fabs(hi[c])));
    n_a = fmax(n_a, fabs(a[0][c]) + fabs(a[1][c]) + fabs(a[2][c]));
    n_f = fmax(n_f, fabs(f[0][c]) + fabs(f[1][c]) + fabs(f[2][c]));
    n_t = fmax(n_t, fabs(t[c]));
  }
  const double cond = n_a * n_f;
  const double alpha = CLRT_BOX_K * CLRT_EPS32 * (n_f * n_t + cond * rw);
  const double beta = CLRT_BOX_K * CLRT_EPS32 * cond;
  bool finite = det != 0.0 && isfinite(alpha) && isfinite(beta);
  for (int c = 0; c < 3; ++c) finite = finite && isfinite(lo[c]) && isfinite(hi[c]);
  if (!finite) {
    for (int c = 0; c < 3; ++c) {
      lo[c] = -(double)CLRT_INF;
      hi[c] = (double)CLRT_INF;
    }
  }
  o[0] = __double2float_rd(lo[0]);
  o[1] = __double2float_rd(lo[1]);
  o[2] = __double2float_rd(lo[2]);
  o[3] = __double2float_ru(hi[0]);
  o[4] = __double2float_ru(hi[1]);
  o[5] = __double2float_ru(hi[2]);
  o[6] = finite ? __double2float_ru(alpha) : 0.0f;
  o[7] = finite ? __double2float_ru(beta) : 0.0f;
}

__global__ void __launch_bounds__(256)
instance_boxes_kernel(const float* __restrict__ inst, const int* __restrict__ ranges,
                      const float* __restrict__ hyper_box, int n,
                      float* __restrict__ inst_box, float* __restrict__ chunk_box,
                      int n_chunks) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    instance_box(inst, ranges, hyper_box, i, inst_box);
  }
  __syncthreads();
  // chunk c: the union of its instances' boxes that hold triangles (an
  // empty one, +inf on every axis, would widen nothing), the largest margin
  for (int c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    float u[8] = {CLRT_INF, CLRT_INF, CLRT_INF, -CLRT_INF, -CLRT_INF, -CLRT_INF, 0.0f, 0.0f};
    const int last = min(n, CLRT_ICHUNK * (c + 1));
    for (int i = CLRT_ICHUNK * c; i < last; ++i) {
      const float* b = inst_box + 8 * i;
      if (b[0] == CLRT_INF) continue;
      for (int k = 0; k < 3; ++k) {
        u[k] = fminf(u[k], b[k]);
        u[3 + k] = fmaxf(u[3 + k], b[3 + k]);
      }
      u[6] = fmaxf(u[6], b[6]);
      u[7] = fmaxf(u[7], b[7]);
    }
    if (u[0] == CLRT_INF) {
      for (int k = 3; k < 6; ++k) u[k] = CLRT_INF;
    }
    for (int k = 0; k < 8; ++k) chunk_box[8 * c + k] = u[k];
  }
}

extern "C" int clrt_instance_boxes(const float* inst, const int* ranges,
                                   const float* hyper_box, int n, float* inst_box,
                                   float* chunk_box, int n_chunks, void* stream) {
  if (n <= 0) return 0;
  instance_boxes_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      inst, ranges, hyper_box, n, inst_box, chunk_box, n_chunks);
  return (int)cudaGetLastError();
}
