// Traversal over the cluster hierarchy, walked by a whole warp at once, as
// __device__ code shared by the hit-record kernel (trace.cu) and the fused
// frame kernel (render.cu), in two modes (the template parameter ANY of
// Walk and traverse): nearest hit (K2.1, every walk of K2.2 but one), and
// any hit (K2.2's sun-shadow ray, which asks only whether an occluder
// exists).
//
// Replaces the traversal body of the TPU kernels,
// clraytracer_tpu/ops/trace_pallas.py:_emit_traversal: its algorithm (a
// tile of rays walks hyper -> super -> cluster -> 32 triangles together,
// survivors as bitmasks, front to back by min-tnear keys, occlusion skip,
// leaf geometry copied asynchronously into fast memory), not its TPU layout.
//
// What bounds it on the H100: latency, not bytes or FP32 rate. The walk
// is a chain of dependent steps (load a node's boxes, test, pick the next
// node) with few warps per SM to hide it, and in a large scene it stays
// far above its operation bound. A walk of one ray per thread in index
// order (this file before) ran the union of 32 lanes' nested loops one node
// at a time, with a dependent global load per box and triangle: 44x its
// operation bound on the 1M-triangle sphere. The hierarchy's branching
// factor is 32 at every level, the warp's width, so:
//  * the warp is the tile: lane r carries ray r, and when the warp opens a
//    node, lane k loads child k's 32-byte box (two coalesced float4 loads);
//  * a node's children are tested in one of two orders, whichever runs
//    fewer iterations: each lane tests its child box against every ray of
//    the parent's mask, reading the rays from shared memory as broadcasts
//    (rays outer), or each lane tests its own ray against every child box,
//    shuffled from its lane, with a ballot and a min-reduce per child
//    (children outer). Either gives, per child, the mask of rays that pass
//    and the least tnear over them (the child's key);
//  * an instance of several hyper groups is first tested as one box, the
//    union of its hyper boxes, so that warps whose rays all miss it test
//    one box instead of every hyper box;
//  * survivors are visited in key order (warp min-reduce over
//    order-preserving integer keys), and a node is skipped when no ray of
//    its mask still has best t >= its key (occlusion); once no live ray of
//    the warp has, the rest of that level is skipped;
//  * a surviving cluster's 32 triangles (1536 contiguous bytes of `planes`)
//    are copied by cp.async into one of two shared-memory slots while the
//    previous cluster is tested. Few of a warp's rays reach a given cluster
//    (4.5 on average on the 1M-triangle sphere), so a cluster that few rays
//    reached is tested rays outer (lane k holds triangle k and tests each
//    of those rays, a warp min-reduce picks each ray's winner), one that
//    many reached triangles outer (each lane its own ray against the 32
//    staged triangles, as broadcast reads); padding triangles are skipped.
// Every lane stays in the walk, dead, finished and out-of-range rays
// included (as rays that pass nothing), so the warp collectives always run
// with the full mask. Measured choices (thresholds, registers, what was
// tried and dropped) are in PERF.md.
//
// Semantics, kept exactly:
//  * per instance, the ray moves to object space by the row-vector inverse
//    transform (o' = o @ M + M[3,:], d' = d @ M), same operation order;
//  * culling is the conservative slab test ((box - o) * (1/d), NaN on
//    axis-parallel rays culls, as jnp.minimum/maximum propagate NaN): a box
//    passes a ray when tnear <= tfar, tfar > 0 and tnear <= best_t;
//  * leaves are the Baldwin-Weber plane test of ops/clusters.py; a hit is
//    accepted when t > 0, u >= 0, v >= 0, u + v <= 1 and (t, instance,
//    slot) is lexicographically below the best so far. That is the plain
//    version's rule (least t, ties to the lowest instance, then slot) and
//    does not depend on the visit order; culling with tnear <= best_t keeps
//    every box that could hold an equal-t winner of lower index;
//  * padding supers (inverted-empty boxes that PASS the slab test) are
//    masked by count, never by box value; padding triangles have all-zero
//    planes, give NaN and never accept.
//
// Any-hit mode. A shadow ray needs one accepted hit (t > 0, u >= 0, v >= 0,
// u + v <= 1, t below its starting CLRT_BIG), not the nearest: a nearest
// walk keeps opening boxes and leaves that could hold a nearer hit after
// its first accept. Here a lane that accepts is resolved: its best t drops
// to -CLRT_BIG, so every later box and leaf culls it as it culls a dead
// lane (the occlusion masks of pop and leaves), and its leaf loop ends.
// When no lane of the warp is open, the levels end through pop and the
// instance loop stops. Until its first accept a lane has best t =
// CLRT_BIG in both modes, so in both it reaches every leaf whose boxes pass
// it at that t, whatever the other lanes do and in whatever order, and tests
// it with the same arithmetic: it accepts in one mode if and only if in the
// other. So a lane resolves exactly when the nearest walk returns t <
// CLRT_BIG, and the shadow factor is the same bit for bit. (One exception,
// in both modes alike: a leaf tested triangles outer also tests lanes whose
// own boxes culled it, so a hit behind a box that a float slab test culls
// may be found in one mode and not the other; the grazing case the frame
// rule of K2.1 and K2.2 allows against their plain versions.) With ANY =
// false every `if constexpr` drops out and the walk compiles as before.
//
// Build with --fmad=false: the JAX reference evaluates these expressions
// without fused multiply-adds, and the plain torch versions do too.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CLRT_BIG 1e30f
#define CLRT_CLUSTER 32
#define CLRT_GROUP 32  // clusters per super, supers per hyper
#define CLRT_FULL 0xffffffffu
#define CLRT_NOKEY 0xffffffffu  // no survivor (above every float's key)
// hyper groups of an instance held in registers at once, 32 per chunk;
// instances with more are walked in batches of CLRT_HQ * 32
#define CLRT_HQ 2

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

// Work a launch did. The first four count what the rays' own walks needed,
// for the operation bound: (ray, box) slab tests, (ray, triangle) plane
// tests (32 per cluster a ray reached), per-instance ray transforms of live
// rays, and interpolated hits. The last two count the warps' steps: child
// tests of a node (32 boxes against the warp's rays) and clusters staged
// into shared memory.
struct TestCount {
  unsigned long long boxes, tris, xforms, hits, steps, staged;
};
#define CLRT_COUNTERS 6

// A warp's shared memory: its object-space rays, read by the lanes that
// test them for other lanes, and two leaf slots.
struct WarpStage {
  float4 ray[32][3];                // (ox, oy, oz, best t) | 1 / d | (dx, dy, dz, 0)
  float4 tri[2][CLRT_CLUSTER * 3];  // one cluster's planes: N | U | V per slot
};

// A staged cluster is tested with the triangles outer (each lane its own
// ray against the 32 triangles) when more than this many of the warp's
// rays reached it, else with the rays outer (each lane its own triangle
// against each of those rays, a warp min-reduce per ray)
#define CLRT_LEAF_RAYS_OUTER 12

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

// box (lo = min xyz | max x, hi = max yz | pad) against one ray
__device__ __forceinline__ bool slab(const float4& lo, const float4& hi,
                                     float ox, float oy, float oz, float idx,
                                     float idy, float idz, float bt,
                                     float& tnear) {
  float t0x = (lo.x - ox) * idx;
  float t1x = (lo.w - ox) * idx;
  float t0y = (lo.y - oy) * idy;
  float t1y = (hi.x - oy) * idy;
  float t0z = (lo.z - oz) * idz;
  float t1z = (hi.y - oz) * idz;
  tnear = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                  nan_min(t0z, t1z));
  float tfar = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                       nan_max(t0z, t1z));
  return (tnear <= tfar) && (tfar > 0.0f) && (tnear <= bt);
}

// float -> unsigned with the same order (no NaN reaches here: a passing
// box has tnear <= tfar)
__device__ __forceinline__ uint32_t key_of(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One lane's view of the warp's walk; ANY: any-hit mode (see the header).
template <bool ANY>
struct Walk {
  const SceneTables& s;
  WarpStage& ws;
  Hit& h;
  TestCount& cnt;
  ObjRay r;
  int lane, inst;
  bool alive;

  // Children base .. base + n - 1 of a node (lane k holds child k) against
  // the rays of `pmask`: per child, the mask of rays that pass and its key.
  __device__ __forceinline__ void test_children(const float* table, int base,
                                                int n, uint32_t pmask,
                                                uint32_t& cmask,
                                                uint32_t& ckey) {
    const bool valid = lane < n;
    float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
    if (valid) {
      const float4* p = reinterpret_cast<const float4*>(table) + (size_t)(base + lane) * 2;
      lo = __ldg(p);
      hi = __ldg(p + 1);
    }
    const int np = __popc(pmask);
    if (lane == 0) {
      cnt.boxes += (unsigned long long)(np * n);
      ++cnt.steps;
    }
    cmask = 0u;
    ckey = CLRT_NOKEY;
    if (np <= n) {  // rays outer: lane k tests child k against each ray
      __syncwarp();  // the rays' best t, as the last leaf tests left them
      uint32_t m = pmask;
      while (m) {
        const int q = __ffs(m) - 1;
        m &= m - 1u;
        const float4 a = ws.ray[q][0];
        const float4 b = ws.ray[q][1];
        float tn;
        if (slab(lo, hi, a.x, a.y, a.z, b.x, b.y, b.z, a.w, tn) && valid) {
          cmask |= 1u << q;
          ckey = min(ckey, key_of(tn));
        }
      }
    } else {  // children outer: each lane tests its own ray against child j
      const bool in = (pmask >> lane) & 1u;
      for (int j = 0; j < n; ++j) {
        float4 blo, bhi;
        blo.x = __shfl_sync(CLRT_FULL, lo.x, j);
        blo.y = __shfl_sync(CLRT_FULL, lo.y, j);
        blo.z = __shfl_sync(CLRT_FULL, lo.z, j);
        blo.w = __shfl_sync(CLRT_FULL, lo.w, j);
        bhi.x = __shfl_sync(CLRT_FULL, hi.x, j);
        bhi.y = __shfl_sync(CLRT_FULL, hi.y, j);
        bhi.z = 0.0f;
        bhi.w = 0.0f;
        float tn;
        const bool pass =
            slab(blo, bhi, r.ox, r.oy, r.oz, r.idx, r.idy, r.idz, h.t, tn) && in;
        const uint32_t mj = __ballot_sync(CLRT_FULL, pass);
        const uint32_t kj = __reduce_min_sync(CLRT_FULL, pass ? key_of(tn) : CLRT_NOKEY);
        if (lane == j) {
          cmask = mj;
          ckey = kj;
        }
      }
    }
  }

  // Pops the surviving child of least key (slot q * 32 + lane of `key`);
  // returns its index and `m`, the rays of its mask that may still hit
  // inside it (best t >= key), or -1 when the level is done. Keys pop in
  // rising order and best t only falls, so once no live ray of the warp
  // has best t >= key, no later child can pass either: the level ends.
  template <int Q>
  __device__ __forceinline__ int pop(uint32_t (&key)[Q],
                                     const uint32_t (&mask)[Q], uint32_t& m,
                                     float& kf) {
    for (;;) {
      uint32_t lmin = key[0], lmask = mask[0];
      int lq = 0;
#pragma unroll
      for (int q = 1; q < Q; ++q) {
        if (key[q] < lmin) {
          lmin = key[q];
          lmask = mask[q];
          lq = q;
        }
      }
      const uint32_t kmin = __reduce_min_sync(CLRT_FULL, lmin);
      if (kmin == CLRT_NOKEY) return -1;
      const int win = __ffs(__ballot_sync(CLRT_FULL, lmin == kmin)) - 1;
      const int q = __shfl_sync(CLRT_FULL, lq, win);
      m = __shfl_sync(CLRT_FULL, lmask, win);
      if (lane == win) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          if (i == lq) key[i] = CLRT_NOKEY;
        }
      }
      kf = float_of(kmin);
      const uint32_t open = __ballot_sync(CLRT_FULL, alive && h.t >= kf);
      if (open == 0u) {
#pragma unroll
        for (int i = 0; i < Q; ++i) key[i] = CLRT_NOKEY;
        return -1;
      }
      m &= open;
      if (m) return q * 32 + win;
    }
  }

  // Copies cluster c's 32 triangle planes into leaf slot `slot`.
  __device__ __forceinline__ void stage(int c, int slot) {
    __syncwarp();  // every lane is done reading the slot
    const float4* src = reinterpret_cast<const float4*>(s.planes) +
                        (size_t)c * (CLRT_CLUSTER * 3) + lane * 3;
    float4* dst = &ws.tri[slot][lane * 3];
    cp_async16(dst, src);
    cp_async16(dst + 1, src + 1);
    cp_async16(dst + 2, src + 2);
    cp_async_commit();
    if (lane == 0) ++cnt.staged;
  }

  // Triangles outer: this lane's ray against the 32 triangles of cluster c
  // in `slot`. Padding triangles (all-zero planes, which never accept) are
  // skipped, so that no lane takes the division's slow path on them.
  __device__ __forceinline__ void test_leaf(int c, int slot) {
    const float4* tri = ws.tri[slot];
#pragma unroll 4
    for (int k = 0; k < CLRT_CLUSTER; ++k) {
      const float4 N = tri[3 * k];
      const float4 U = tri[3 * k + 1];
      const float4 V = tri[3 * k + 2];
      if (N.x == 0.0f && N.y == 0.0f && N.z == 0.0f) continue;
      float den = r.dx * N.x + r.dy * N.y + r.dz * N.z;
      float b_n = r.ox * N.x + r.oy * N.y + r.oz * N.z + N.w;
      float t = b_n * (-1.0f / den);
      float u = (r.ox * U.x + r.oy * U.y + r.oz * U.z + U.w) +
                t * (r.dx * U.x + r.dy * U.y + r.dz * U.z);
      float v = (r.ox * V.x + r.oy * V.y + r.oz * V.z + V.w) +
                t * (r.dx * V.x + r.dy * V.y + r.dz * V.z);
      if constexpr (ANY) {
        // an open lane's h.t is CLRT_BIG; a resolved or dead one (h.t =
        // -CLRT_BIG) accepts nothing
        if ((t > 0.0f) && (t < h.t) && (u >= 0.0f) && (v >= 0.0f) &&
            (u + v <= 1.0f)) {
          h.t = -CLRT_BIG;
          break;
        }
      } else {
        const int slot_id = c * CLRT_CLUSTER + k;
        const bool closer =
            (t < h.t) ||
            (t == h.t && (inst < h.inst || (inst == h.inst && slot_id < h.slot)));
        if ((t > 0.0f) && closer && (u >= 0.0f) && (v >= 0.0f) &&
            (u + v <= 1.0f)) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.slot = slot_id;
          h.inst = inst;
        }
      }
    }
    ws.ray[lane][0].w = h.t;
  }

  // Rays outer: lane k's triangle of cluster c in `slot` against each ray q
  // of `m` (read from shared memory); the least (t, slot) that accepts goes
  // to lane q, which keeps it if it beats its best by the tie rule. The
  // arithmetic per (ray, triangle) is test_leaf's, bit for bit.
  __device__ __forceinline__ void test_leaf_rays(int c, int slot, uint32_t m) {
    const float4* tri = ws.tri[slot];
    const float4 N = tri[3 * lane];
    const float4 U = tri[3 * lane + 1];
    const float4 V = tri[3 * lane + 2];
    // padding (and degenerate) triangles never accept: keep their lanes off
    // the division's slow path
    const bool real = !(N.x == 0.0f && N.y == 0.0f && N.z == 0.0f);
    while (m) {
      const int q = __ffs(m) - 1;
      m &= m - 1u;
      const float4 a = ws.ray[q][0];
      const float4 e = ws.ray[q][2];
      float den = e.x * N.x + e.y * N.y + e.z * N.z;
      float b_n = a.x * N.x + a.y * N.y + a.z * N.z + N.w;
      float t = b_n * (-1.0f / (real ? den : 1.0f));
      float u = (a.x * U.x + a.y * U.y + a.z * U.z + U.w) +
                t * (e.x * U.x + e.y * U.y + e.z * U.z);
      float v = (a.x * V.x + a.y * V.y + a.z * V.z + V.w) +
                t * (e.x * V.x + e.y * V.y + e.z * V.z);
      const bool ok = real && (t > 0.0f) && (u >= 0.0f) && (v >= 0.0f) &&
                      (u + v <= 1.0f);
      if constexpr (ANY) {
        // ray q is open (h.t = CLRT_BIG): one accept below that resolves it
        const bool acc = __ballot_sync(CLRT_FULL, ok && t < CLRT_BIG) != 0u;
        if (acc && lane == q) h.t = -CLRT_BIG;
        continue;
      }
      // t > 0: its bits order as its values; NaN never passes `ok`
      const uint32_t kt = ok ? __float_as_uint(t) : CLRT_NOKEY;
      const uint32_t kmin = __reduce_min_sync(CLRT_FULL, kt);
      if (kmin == CLRT_NOKEY) continue;
      const int win = __ffs(__ballot_sync(CLRT_FULL, kt == kmin)) - 1;
      const float wu = __shfl_sync(CLRT_FULL, u, win);
      const float wv = __shfl_sync(CLRT_FULL, v, win);
      if (lane == q) {
        const float tw = __uint_as_float(kmin);
        const int slot_id = c * CLRT_CLUSTER + win;
        const bool closer =
            (tw < h.t) ||
            (tw == h.t && (inst < h.inst || (inst == h.inst && slot_id < h.slot)));
        if (closer) {
          h.t = tw;
          h.u = wu;
          h.v = wv;
          h.slot = slot_id;
          h.inst = inst;
        }
      }
    }
    ws.ray[lane][0].w = h.t;
  }

  // The surviving clusters of one super (first cluster c0), front to back;
  // the next cluster's copy runs while the current one is tested.
  __device__ __forceinline__ void leaves(int c0, uint32_t (&ck)[1],
                                         const uint32_t (&cm)[1]) {
    uint32_t m_cur;
    float k_cur;
    int cur = pop(ck, cm, m_cur, k_cur);
    if (cur < 0) return;
    int slot = 0;
    stage(c0 + cur, slot);
    for (;;) {
      uint32_t m_nxt;
      float k_nxt;
      const int nxt = pop(ck, cm, m_nxt, k_nxt);
      if (nxt >= 0) {
        stage(c0 + nxt, slot ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      // best t may have fallen since the pop: the occlusion skip again
      m_cur &= __ballot_sync(CLRT_FULL, alive && h.t >= k_cur);
      if (m_cur) {
        const int np = __popc(m_cur);
        if (lane == 0) cnt.tris += (unsigned long long)(CLRT_CLUSTER * np);
        if (np > CLRT_LEAF_RAYS_OUTER) {
          test_leaf(c0 + cur, slot);
        } else {
          test_leaf_rays(c0 + cur, slot, m_cur);
        }
      }
      if (nxt < 0) return;
      cur = nxt;
      m_cur = m_nxt;
      k_cur = k_nxt;
      slot ^= 1;
    }
  }

  // The warp's rays of `live` that pass the union of hyper boxes
  // hy0 .. hy0 + n - 1 (each lane tests its own ray).
  __device__ __forceinline__ uint32_t root(int hy0, int n, uint32_t live) {
    float4 lo = make_float4(CLRT_BIG, CLRT_BIG, CLRT_BIG, -CLRT_BIG);
    float4 hi = make_float4(-CLRT_BIG, -CLRT_BIG, 0.0f, 0.0f);
    for (int k = lane; k < n; k += 32) {
      const float4* p = reinterpret_cast<const float4*>(s.hyper_box) + (size_t)(hy0 + k) * 2;
      const float4 a = __ldg(p), b = __ldg(p + 1);
      lo.x = fminf(lo.x, a.x);
      lo.y = fminf(lo.y, a.y);
      lo.z = fminf(lo.z, a.z);
      lo.w = fmaxf(lo.w, a.w);
      hi.x = fmaxf(hi.x, b.x);
      hi.y = fmaxf(hi.y, b.y);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo.x = fminf(lo.x, __shfl_xor_sync(CLRT_FULL, lo.x, off));
      lo.y = fminf(lo.y, __shfl_xor_sync(CLRT_FULL, lo.y, off));
      lo.z = fminf(lo.z, __shfl_xor_sync(CLRT_FULL, lo.z, off));
      lo.w = fmaxf(lo.w, __shfl_xor_sync(CLRT_FULL, lo.w, off));
      hi.x = fmaxf(hi.x, __shfl_xor_sync(CLRT_FULL, hi.x, off));
      hi.y = fmaxf(hi.y, __shfl_xor_sync(CLRT_FULL, hi.y, off));
    }
    if (lane == 0) {
      cnt.boxes += (unsigned long long)__popc(live);
      ++cnt.steps;
    }
    float tn;
    const bool in = (live >> lane) & 1u;
    return __ballot_sync(
        CLRT_FULL, slab(lo, hi, r.ox, r.oy, r.oz, r.idx, r.idy, r.idz, h.t, tn) && in);
  }

  // One instance's hierarchy, the warp's live rays `live`.
  __device__ __forceinline__ void instance(uint32_t live) {
    const int* rg = s.ranges + inst * 4;
    const int sc0 = rg[0], sc_n = rg[1], cl0 = rg[2], cl_n = rg[3];
    const int hy0 = sc0 / CLRT_GROUP;
    const int n_hyper = (sc_n + CLRT_GROUP - 1) / CLRT_GROUP;
    // several hyper groups: first the box around them all, so that a warp
    // whose rays all miss the instance tests one box, not n_hyper
    if (n_hyper > 1) live = root(hy0, n_hyper, live);
    if (live == 0u) return;
    for (int hb = 0; hb < n_hyper; hb += CLRT_HQ * 32) {
      uint32_t hk[CLRT_HQ], hm[CLRT_HQ];
#pragma unroll
      for (int q = 0; q < CLRT_HQ; ++q) {
        const int first = hb + q * 32;
        hm[q] = 0u;
        hk[q] = CLRT_NOKEY;
        if (first < n_hyper) {
          test_children(s.hyper_box, hy0 + first, min(32, n_hyper - first),
                        live, hm[q], hk[q]);
        }
      }
      for (;;) {
        uint32_t m_h;
        float k_h;
        const int hy = pop(hk, hm, m_h, k_h);
        if (hy < 0) break;
        const int s_first = (hb + hy) * CLRT_GROUP;  // local super index
        uint32_t sk[1], sm[1];
        test_children(s.super_box, sc0 + s_first,
                      max(0, min(CLRT_GROUP, sc_n - s_first)), m_h, sm[0], sk[0]);
        for (;;) {
          uint32_t m_s;
          float k_s;
          const int sj = pop(sk, sm, m_s, k_s);
          if (sj < 0) break;
          const int c_first = (s_first + sj) * CLRT_GROUP;  // local cluster index
          uint32_t ck[1], cm[1];
          test_children(s.cluster_box, cl0 + c_first,
                        max(0, min(CLRT_GROUP, cl_n - c_first)), m_s, cm[0], ck[0]);
          leaves(cl0 + c_first, ck, cm);
        }
      }
    }
  }
};

// Nearest hit over every instance. Every lane of the warp calls it: `alive`
// lanes arrive with h.t = CLRT_BIG and leave with the winner's (t, u, v,
// cluster slot, instance); the others (h.t = -CLRT_BIG) pass no box.
// ANY (any-hit mode): an alive lane leaves with h.t = -CLRT_BIG if it
// accepted a hit, else CLRT_BIG (h.t < CLRT_BIG as in nearest mode); u, v,
// slot and instance stay as they came. The instances after the one where
// the warp's last open lane resolved are not walked.
template <bool ANY = false>
__device__ __forceinline__ void traverse(const SceneTables& s, WarpStage& ws,
                                         bool alive, float ox_w, float oy_w,
                                         float oz_w, float dx_w, float dy_w,
                                         float dz_w, Hit& h, TestCount& cnt) {
  uint32_t live = __ballot_sync(CLRT_FULL, alive);
  if (live == 0u) return;
  Walk<ANY> w{s, ws, h, cnt, {}, (int)(threadIdx.x & 31), 0, alive};
  for (int inst = 0; inst < s.n_inst; ++inst) {
    if constexpr (ANY) {
      live = __ballot_sync(CLRT_FULL, alive && h.t >= CLRT_BIG);  // open lanes
      if (live == 0u) break;
    }
    const float* m = s.inst + inst * 17;
    if (ANY ? ((live >> w.lane) & 1u) != 0u : alive) ++cnt.xforms;
    ObjRay& r = w.r;
    r.ox = ox_w * m[0] + oy_w * m[4] + oz_w * m[8] + m[12];
    r.oy = ox_w * m[1] + oy_w * m[5] + oz_w * m[9] + m[13];
    r.oz = ox_w * m[2] + oy_w * m[6] + oz_w * m[10] + m[14];
    r.dx = dx_w * m[0] + dy_w * m[4] + dz_w * m[8];
    r.dy = dx_w * m[1] + dy_w * m[5] + dz_w * m[9];
    r.dz = dx_w * m[2] + dy_w * m[6] + dz_w * m[10];
    r.idx = 1.0f / r.dx;
    r.idy = 1.0f / r.dy;
    r.idz = 1.0f / r.dz;
    w.inst = inst;
    __syncwarp();  // every lane is done reading the last instance's rays
    ws.ray[w.lane][0] = make_float4(r.ox, r.oy, r.oz, h.t);
    ws.ray[w.lane][1] = make_float4(r.idx, r.idy, r.idz, 0.0f);
    ws.ray[w.lane][2] = make_float4(r.dx, r.dy, r.dz, 0.0f);
    w.instance(live);
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

// Adds this block's counts to counters[0..5] (TestCount's order). Every
// thread of the block must call it.
__device__ __forceinline__ void add_counts(unsigned long long* counters,
                                           const TestCount& cnt) {
  __shared__ unsigned long long blk[CLRT_COUNTERS];
  if (threadIdx.x < CLRT_COUNTERS) blk[threadIdx.x] = 0ull;
  __syncthreads();
  atomicAdd(&blk[0], cnt.boxes);
  atomicAdd(&blk[1], cnt.tris);
  atomicAdd(&blk[2], cnt.xforms);
  atomicAdd(&blk[3], cnt.hits);
  atomicAdd(&blk[4], cnt.steps);
  atomicAdd(&blk[5], cnt.staged);
  __syncthreads();
  if (threadIdx.x < CLRT_COUNTERS) atomicAdd(&counters[threadIdx.x], blk[threadIdx.x]);
}

// Adds this warp's counts to counters[0..5]. Every lane of the warp must
// call it (a walk's counts, where not every warp of the block walks).
__device__ __forceinline__ void add_counts_warp(unsigned long long* counters,
                                                const TestCount& cnt) {
  unsigned long long v[CLRT_COUNTERS] = {cnt.boxes, cnt.tris, cnt.xforms,
                                         cnt.hits, cnt.steps, cnt.staged};
#pragma unroll
  for (int k = 0; k < CLRT_COUNTERS; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(CLRT_FULL, v[k], off);
    if ((threadIdx.x & 31) == 0 && v[k] != 0ull) atomicAdd(&counters[k], v[k]);
  }
}
