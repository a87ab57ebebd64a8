// Per-ray nearest-hit traversal over the cluster hierarchy, as __device__
// code shared by the hit-record kernel (trace.cu) and the fused frame
// kernel (render.cu).
//
// Replaces the traversal body of the TPU kernels,
// clraytracer_tpu/ops/trace_pallas.py:_emit_traversal. Semantics kept:
//  * per instance, the ray moves to object space by the row-vector inverse
//    transform (o' = o @ M + M[3,:], d' = d @ M), same operation order;
//  * culling is the conservative slab test ((box - o) * (1/d), NaN on
//    axis-parallel rays culls, as jnp.minimum/maximum propagate NaN): a box
//    passes when tnear <= tfar, tfar > 0 and tnear < best_t;
//  * leaves are the Baldwin-Weber plane test of ops/clusters.py; a hit is
//    accepted when t > 0, t < best_t (strict), u >= 0, v >= 0, u + v <= 1;
//  * padding supers (inverted-empty boxes that PASS the slab test) are
//    masked by count, never by box value; padding triangles have all-zero
//    planes, give NaN and never accept.
// Dropped, because Hopper has no such limit: the 128-lane bitmask OR-trees
// and SMEM survivor lists, the front-to-back survivor sort, the scalar
// origin, the VMEM budget and the HBM-streamed geometry copy. One thread
// walks one ray through hyper -> super -> cluster -> 32 triangles in index
// order, reading every table from global memory (L2/L1 cached).
//
// Bound on the H100: the per-ray loops are divergent and every box and
// triangle is a dependent global load, so the traversal is latency- and
// issue-bound rather than bound by DRAM bytes or peak FP32 rate. This
// first version keeps one code path and exact semantics; coherent
// packet traversal and shared-memory staging are later work.
//
// Build with --fmad=false: the JAX reference evaluates these expressions
// without fused multiply-adds, and the plain torch versions do too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CLRT_BIG 1e30f
#define CLRT_CLUSTER 32
#define CLRT_GROUP 32  // clusters per super, supers per hyper

struct SceneTables {
  const float* inst;         // [I, 17]: inverse transform (row-major) | mat_start
  const int* ranges;         // [I, 4]: super start, super count, cluster start, cluster count
  const float* hyper_box;    // [H, 8]: min xyz | max xyz | 2 pad
  const float* super_box;    // [S, 8]
  const float* cluster_box;  // [C, 8]
  const float* planes;       // [C * 32, 12]: N xyzw | U xyzw | V xyzw
  const float* attrs;        // [C * 32, 16]: n0 n1 n2 | uv0 uv1 uv2 | mat_local
  int n_inst;
};

struct Hit {
  float t, u, v;
  int slot, inst;
};

// Work a launch did, for the operation bound: box (slab) tests, triangle
// (plane) tests, per-instance ray transforms, and interpolated hits.
struct TestCount {
  unsigned long long boxes, tris, xforms, hits;
};

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct ObjRay {
  float ox, oy, oz, dx, dy, dz, idx, idy, idz;
};

__device__ __forceinline__ bool slab(const float* b, const ObjRay& r, float bt) {
  float t0x = (b[0] - r.ox) * r.idx;
  float t1x = (b[3] - r.ox) * r.idx;
  float t0y = (b[1] - r.oy) * r.idy;
  float t1y = (b[4] - r.oy) * r.idy;
  float t0z = (b[2] - r.oz) * r.idz;
  float t1z = (b[5] - r.oz) * r.idz;
  float tnear = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                        nan_min(t0z, t1z));
  float tfar = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                       nan_max(t0z, t1z));
  return (tnear <= tfar) && (tfar > 0.0f) && (tnear < bt);
}

// Nearest hit over every instance; `h` arrives with h.t = CLRT_BIG (live)
// and leaves with the winner's (t, u, v, cluster slot, instance).
__device__ void traverse(const SceneTables& s, float ox_w, float oy_w,
                         float oz_w, float dx_w, float dy_w, float dz_w,
                         Hit& h, TestCount& cnt) {
  for (int inst = 0; inst < s.n_inst; ++inst) {
    const float* m = s.inst + inst * 17;
    ++cnt.xforms;
    ObjRay r;
    r.ox = ox_w * m[0] + oy_w * m[4] + oz_w * m[8] + m[12];
    r.oy = ox_w * m[1] + oy_w * m[5] + oz_w * m[9] + m[13];
    r.oz = ox_w * m[2] + oy_w * m[6] + oz_w * m[10] + m[14];
    r.dx = dx_w * m[0] + dy_w * m[4] + dz_w * m[8];
    r.dy = dx_w * m[1] + dy_w * m[5] + dz_w * m[9];
    r.dz = dx_w * m[2] + dy_w * m[6] + dz_w * m[10];
    r.idx = 1.0f / r.dx;
    r.idy = 1.0f / r.dy;
    r.idz = 1.0f / r.dz;
    const int* rg = s.ranges + inst * 4;
    const int sc0 = rg[0], sc_n = rg[1], cl0 = rg[2], cl_n = rg[3];
    const int hy0 = sc0 / CLRT_GROUP;
    const int n_hyper = (sc_n + CLRT_GROUP - 1) / CLRT_GROUP;
    for (int hy = 0; hy < n_hyper; ++hy) {
      ++cnt.boxes;
      if (!slab(s.hyper_box + (size_t)(hy0 + hy) * 8, r, h.t)) continue;
      const int s_end = min(sc_n, (hy + 1) * CLRT_GROUP);
      for (int sl = hy * CLRT_GROUP; sl < s_end; ++sl) {
        ++cnt.boxes;
        if (!slab(s.super_box + (size_t)(sc0 + sl) * 8, r, h.t)) continue;
        const int c_end = min(cl_n, (sl + 1) * CLRT_GROUP);
        for (int cl = sl * CLRT_GROUP; cl < c_end; ++cl) {
          const int c = cl0 + cl;
          ++cnt.boxes;
          if (!slab(s.cluster_box + (size_t)c * 8, r, h.t)) continue;
          cnt.tris += CLRT_CLUSTER;
          const float4* p4 =
              reinterpret_cast<const float4*>(s.planes) + (size_t)c * CLRT_CLUSTER * 3;
          for (int k = 0; k < CLRT_CLUSTER; ++k) {
            const float4 N = __ldg(p4 + 3 * k);
            const float4 U = __ldg(p4 + 3 * k + 1);
            const float4 V = __ldg(p4 + 3 * k + 2);
            float den = r.dx * N.x + r.dy * N.y + r.dz * N.z;
            float b_n = r.ox * N.x + r.oy * N.y + r.oz * N.z + N.w;
            float t = b_n * (-1.0f / den);
            float u = (r.ox * U.x + r.oy * U.y + r.oz * U.z + U.w) +
                      t * (r.dx * U.x + r.dy * U.y + r.dz * U.z);
            float v = (r.ox * V.x + r.oy * V.y + r.oz * V.z + V.w) +
                      t * (r.dx * V.x + r.dy * V.y + r.dz * V.z);
            if ((t > 0.0f) && (t < h.t) && (u >= 0.0f) && (v >= 0.0f) &&
                (u + v <= 1.0f)) {
              h.t = t;
              h.u = u;
              h.v = v;
              h.slot = c * CLRT_CLUSTER + k;
              h.inst = inst;
            }
          }
        }
      }
    }
  }
}

// Shading attributes of the winning slot: w0*a0 + u*a1 + v*a2 (the JAX
// kernel's deferred interpolation, same expression tree).
struct HitAttrs {
  float nx, ny, nz, uu, vv, mat;
};

__device__ __forceinline__ HitAttrs interpolate(const SceneTables& s,
                                                const Hit& h,
                                                TestCount& cnt) {
  ++cnt.hits;
  const float* a = s.attrs + (size_t)h.slot * 16;
  const float u = h.u, v = h.v;
  const float w0 = 1.0f - u - v;
  HitAttrs o;
  o.nx = a[0] * w0 + a[3] * u + a[6] * v;
  o.ny = a[1] * w0 + a[4] * u + a[7] * v;
  o.nz = a[2] * w0 + a[5] * u + a[8] * v;
  o.uu = a[9] * w0 + a[11] * u + a[13] * v;
  o.vv = a[10] * w0 + a[12] * u + a[14] * v;
  o.mat = a[15];
  return o;
}

// Adds this block's counts to counters[0..3] (boxes, triangles, ray
// transforms, hits). Every thread of the block must call it.
__device__ __forceinline__ void add_counts(unsigned long long* counters,
                                           const TestCount& cnt) {
  __shared__ unsigned long long blk[4];
  if (threadIdx.x < 4) blk[threadIdx.x] = 0ull;
  __syncthreads();
  atomicAdd(&blk[0], cnt.boxes);
  atomicAdd(&blk[1], cnt.tris);
  atomicAdd(&blk[2], cnt.xforms);
  atomicAdd(&blk[3], cnt.hits);
  __syncthreads();
  if (threadIdx.x < 4) atomicAdd(&counters[threadIdx.x], blk[threadIdx.x]);
}
