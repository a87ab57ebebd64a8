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
// What bounds it on the H100: the instructions it issues, not bytes or
// FP32 rate. Where a scene is large or the camera stands inside it, the
// warps test hundreds of boxes a ray (about 490 a pixel over two bounces in
// the museum-class scene of chip_smoke.py's cell (t)), and the child test
// that runs them is most of the issued instructions; the leaf tests most
// of the rest. A walk of one ray per thread in index order (this file
// before) ran the union of 32 lanes' nested loops one node at a time, with
// a dependent global load per box and triangle: 44x its operation bound on
// the 1M-triangle sphere. The hierarchy's branching factor is 32 at every
// level, the warp's width, so:
//  * the warp is the tile: lane r carries ray r, and when the warp opens a
//    node, lane k loads child k's 32-byte box (two coalesced float4 loads);
//  * a node's children are tested in one of two orders, whichever runs
//    fewer iterations: each lane tests its child box against every ray of
//    the parent's mask, reading the rays from shared memory as broadcasts,
//    CLRT_RAYS_PER_PASS rays a pass (rays outer), or each lane tests its
//    own ray against every child box, read from shared memory as
//    broadcasts, with a ballot and a min-reduce per child (children
//    outer). Either gives, per child, the mask of rays that pass and the
//    least tnear over them (the child's key). The slab test's NaN-carrying
//    min and max are one instruction each (min.NaN / max.NaN);
//  * an instance of at most CLRT_FQ hyper groups tests them in one step,
//    then the supers of every hyper group a ray passes, and pops those
//    supers in one key order across the instance (an interior scene's
//    instance boxes all hold the camera, so no hyper group is skipped and
//    a per-hyper order would walk far supers before near ones); an
//    instance of more is first tested as one box, the union of its hyper
//    boxes, then walked hyper by hyper;
//  * above the hierarchy of each instance sits an instance level, walked
//    in world space (n_inst > 1; the boxes of instbox.cu): one step
//    tests the warp's world rays against 32 instances' world boxes (above
//    32 instances, first against the chunk boxes, each the union of 32
//    instances' boxes, then against the boxes of each chunk popped), and
//    only the instances that a ray passes are popped, nearest first, their
//    rays moved to object space and walked. A lone instance is walked at
//    once: its own hyper test culls as well as a world box would;
//  * survivors are visited in key order (warp min-reduce over
//    order-preserving integer keys), and a node is skipped when no ray of
//    its mask still has best t >= its key (occlusion); once no live ray of
//    the warp has, the rest of that level is skipped;
//  * a surviving cluster's 32 triangles (1536 contiguous bytes of `planes`)
//    are copied by cp.async into one of two shared-memory slots while the
//    previous cluster is tested. A cluster that more than 16 of the warp's
//    rays reached is tested triangles outer (each lane its own ray against
//    the 32 staged triangles, as broadcast reads); one that fewer reached
//    as a tile of rays x triangles (each of those rays on 32 / P lanes, P
//    its count rounded up to a power of two, each lane P of the
//    triangles, the winners merged by shuffles): P triangle iterations
//    instead of 32. Padding triangles are skipped.
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
//    planes, give NaN and never accept;
//  * the instance level skips an instance for a warp only where no ray of
//    the warp could pass the instance's object-space root test: a world
//    box holds the instance's root box mapped to world space, and the
//    world test grows it by a margin (alpha + beta * |o|_inf, instbox.cu)
//    over the float32 error of the ray's transform and of both slab tests;
//    it ignores NaN (an axis-parallel ray starting on a face plane passes
//    that axis), and passes a box at tnear <= best t. An affine map keeps
//    the ray parameter, so best t compares across both spaces. Which
//    instances a warp enters, and in what order, changes the hit no more
//    than the order of clusters does (the accept rule above).
//
// Any-hit mode. A shadow ray needs one accepted hit (t > 0, u >= 0, v >= 0,
// u + v <= 1, t below its starting CLRT_BIG), not the nearest: a nearest
// walk keeps opening boxes and leaves that could hold a nearer hit after
// its first accept. Here a lane that accepts is resolved: its best t drops
// to -CLRT_BIG, so every later box and leaf culls it as it culls a dead
// lane (the occlusion masks of pop and leaves), and its leaf loop ends.
// When no lane of the warp is open, the levels end through pop, the
// instance level's too. Until its first accept a lane has best t =
// CLRT_BIG in both modes, so in both it reaches every leaf whose boxes pass
// it at that t, whatever the other lanes do and in whatever order, and tests
// it with the same arithmetic: it accepts in one mode if and only if in the
// other. So a lane resolves exactly when the nearest walk returns t <
// CLRT_BIG, and the shadow factor is the same bit for bit. (One exception,
// in both modes alike: a leaf tested triangles outer also tests lanes whose
// own boxes culled it, so a hit behind a box that a float slab test culls
// may be found in one mode and not the other; the grazing case the frame
// rule of K2.1 and K2.2 allows against their plain versions.) The argument
// holds for any visit order: the supers popped in one order across an
// instance, and the rays-by-triangles leaf test (which tests only the
// lanes whose boxes reached the leaf), leave it as it is. With ANY =
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
#define CLRT_INF __int_as_float(0x7f800000)
// instances a chunk box holds (ops/trace.py INSTANCE_CHUNK): scenes of more
// take the chunk step first, and chunk c holds instances CLRT_ICHUNK c ..
// CLRT_ICHUNK c + CLRT_ICHUNK - 1 (instbox.cu builds them)
#define CLRT_ICHUNK 32
static_assert(CLRT_ICHUNK <= 32, "a chunk's instance boxes are one child test");
// instances walked in index order by every live lane, without the instance
// level
#define CLRT_INST_LOOP 1
// hyper groups of an instance held in registers at once, 32 per chunk;
// instances with more are walked in batches of CLRT_HQ * 32
#define CLRT_HQ 2
// an instance of at most CLRT_FQ hyper groups pops its supers in one order
#define CLRT_FQ 3
// rays a pass of the rays-outer child test (4 measured slower, PERF.md)
#define CLRT_RAYS_PER_PASS 2

struct SceneTables {
  const float* inst;         // [I, 17]: inverse transform (row-major) | mat_start
  const int* ranges;         // [I, 4]: super start, super count, cluster start, cluster count
  const float* hyper_box;    // [H, 8]: min xyz | max xyz | 2 pad
  const float* super_box;    // [S, 8]
  const float* cluster_box;  // [C, 8]
  const float* planes;       // [C * 32, 12]: N xyzw | U xyzw | V xyzw
  const float* attrs;        // [C * 32, 16]: n0 n1 n2 | uv0 uv1 uv2 | mat_local
  int n_inst;
  // world boxes of the instance level (instbox.cu): min xyz | max x, max yz
  // | alpha | beta, the world test's margin alpha + beta * |o|_inf
  const float* inst_box;   // [I, 8]
  const float* chunk_box;  // [n_chunks, 8]: instances CLRT_ICHUNK c, ...
  int n_chunks;            // 0 where n_inst <= CLRT_ICHUNK
};

struct Hit {
  float t, u, v;
  int slot, inst;
};

// Work a launch did. The first four count what the rays' own walks needed,
// for the operation bound: (ray, box) slab tests (world boxes of the
// instance level included), (ray, triangle) plane tests (the real,
// non-padding slots of each cluster a ray reached), ray transforms (a live
// ray moved into an instance whose world box it passes), and interpolated
// hits. The last two count the warps' steps: child tests of a node (32
// boxes against the warp's rays) and clusters staged into shared memory.
// Every walk counts, given counters or not: the kernels add them out only
// where given, in 64 bits. A lane's counts are 32-bit (lane 0 holds its
// warp's, which stay far below 2^32 in a launch): 64-bit ones held 6 more
// registers through the walk, which spilled in the shadow instantiations
// (PERF.md). A runtime flag around the triangle count's ballot took
// render.cu's GI instantiation from 128 registers and 18 bytes spilled to
// 96 and 178 (PERF.md).
struct TestCount {
  unsigned int boxes, tris, xforms, hits, steps, staged;
};
#define CLRT_COUNTERS 6

// A warp's shared memory: its object-space rays (each lane reads its own,
// and the lanes that test them for other lanes read those), its world
// rays, the boxes of the node it tests with children outer, read by every
// lane, two leaf slots, and the instance level's state, which the
// hierarchy's walk below it leaves alone (lane k's key and mask of the
// instance and of the chunk in its slot, each lane reading and writing its
// own; the level's first instance and chunk): no register carries the
// level or the ray through the walk.
struct WarpStage {
  float4 ray[32][3];                // (ox, oy, oz, best t) | 1 / d | (dx, dy, dz, 0)
  float4 wray[32][3];               // world: (ox, oy, oz, best t) | 1 / d, |o|_inf | d
  float4 box[32][2];                // child k's lo | hi
  float4 tri[2][CLRT_CLUSTER * 3];  // one cluster's planes: N | U | V per slot
  uint32_t ikey[32], imask[32];     // instance base + k
  uint32_t ckey[32], cmask[32];     // chunk cbase + k
  int base, cbase;
};

// jnp.minimum / jnp.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// nan_min / nan_max as one instruction each (min.NaN / max.NaN, sm_80 and
// later): NaN if either operand is NaN. They may differ from nan_min /
// nan_max only in the sign of a zero result, which the slab test's
// comparisons do not see; the shading keeps nan_min / nan_max.
__device__ __forceinline__ float box_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float box_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

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
  tnear = box_max(box_max(box_min(t0x, t1x), box_min(t0y, t1y)),
                  box_min(t0z, t1z));
  float tfar = box_min(box_min(box_max(t0x, t1x), box_max(t0y, t1y)),
                       box_max(t0z, t1z));
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

// One axis of the world test: the slab of [lo, hi] on the ray's axis,
// intersected into [tn, tf]; an axis whose slab is NaN (the ray parallel to
// it, its origin on a face plane) is left open
__device__ __forceinline__ void world_axis(float lo, float hi, float o, float inv,
                                           float& tn, float& tf) {
  const float t0 = (lo - o) * inv, t1 = (hi - o) * inv;
  if (t0 == t0 && t1 == t1) {
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
}

// A world box (the layout of the other levels' boxes, the margin's alpha
// and beta in the pad) against a world ray a = (o, best t), b = (1 / d,
// |o|_inf): the box grown by alpha + beta * |o|_inf, NaN-ignoring.
__device__ __forceinline__ bool world_slab(const float4& lo, const float4& hi,
                                           const float4& a, const float4& b,
                                           float& tnear) {
  const float mu = hi.z + hi.w * b.w;
  float tn = -CLRT_INF, tf = CLRT_INF;
  world_axis(lo.x - mu, lo.w + mu, a.x, b.x, tn, tf);
  world_axis(lo.y - mu, hi.x + mu, a.y, b.y, tn, tf);
  world_axis(lo.z - mu, hi.y + mu, a.z, b.z, tn, tf);
  tnear = tn;
  return (tn <= tf) && (tf > 0.0f) && (tn <= a.w);
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
      float kmin = CLRT_BIG;
      while (m) {
        // CLRT_RAYS_PER_PASS rays a pass (the last ray again where fewer
        // are left: it sets the same bit and key)
        int q[CLRT_RAYS_PER_PASS];
        q[0] = __ffs(m) - 1;
        m &= m - 1u;
#pragma unroll
        for (int k = 1; k < CLRT_RAYS_PER_PASS; ++k) {
          q[k] = m ? __ffs(m) - 1 : q[0];
          m &= m - 1u;
        }
        float4 a[CLRT_RAYS_PER_PASS], b[CLRT_RAYS_PER_PASS];
#pragma unroll
        for (int k = 0; k < CLRT_RAYS_PER_PASS; ++k) {
          a[k] = ws.ray[q[k]][0];
          b[k] = ws.ray[q[k]][1];
        }
#pragma unroll
        for (int k = 0; k < CLRT_RAYS_PER_PASS; ++k) {
          float tn;
          if (slab(lo, hi, a[k].x, a[k].y, a[k].z, b[k].x, b[k].y, b[k].z, a[k].w, tn)) {
            cmask |= 1u << q[k];
            kmin = fminf(kmin, tn);
          }
        }
      }
      if (!valid) cmask = 0u;
      if (cmask) ckey = key_of(kmin);
    } else {  // children outer: each lane tests its own ray against child j
      // the boxes go through shared memory, each read by all lanes at once
      __syncwarp();  // every lane is done reading the last node's boxes
      ws.box[lane][0] = lo;
      ws.box[lane][1] = hi;
      __syncwarp();
      const bool in = (pmask >> lane) & 1u;
      const float4 ro = ws.ray[lane][0], ri = ws.ray[lane][1];
      for (int j = 0; j < n; ++j) {
        const float4 blo = ws.box[j][0];
        const float4 bhi = ws.box[j][1];
        float tn;
        const bool pass =
            slab(blo, bhi, ro.x, ro.y, ro.z, ri.x, ri.y, ri.z, h.t, tn) && in;
        const uint32_t mj = __ballot_sync(CLRT_FULL, pass);
        const uint32_t kj = __reduce_min_sync(CLRT_FULL, pass ? key_of(tn) : CLRT_NOKEY);
        if (lane == j) {
          cmask = mj;
          ckey = kj;
        }
      }
    }
  }

  // The instance level's child test: world boxes base .. base + n - 1
  // (lane k holds box k; instance or chunk boxes) against the world rays
  // of `pmask` in ws.wray, whose best t the caller stored. Rays outer where
  // fewer rays than boxes, else each lane its own ray against every box.
  __device__ __forceinline__ void test_world(const float* table, int base, int n,
                                             uint32_t pmask, uint32_t* keys,
                                             uint32_t* masks) {
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
    uint32_t cmask = 0u, ckey = CLRT_NOKEY;
    __syncwarp();  // every lane's world ray and best t are stored
    if (np <= n) {
      uint32_t m = pmask;
      float kmin = CLRT_BIG;
      while (m) {
        const int q = __ffs(m) - 1;
        m &= m - 1u;
        float tn;
        if (world_slab(lo, hi, ws.wray[q][0], ws.wray[q][1], tn)) {
          cmask |= 1u << q;
          kmin = fminf(kmin, tn);
        }
      }
      if (!valid) cmask = 0u;
      if (cmask) ckey = key_of(kmin);
    } else {  // children outer: each lane tests its own world ray against box j
      ws.box[lane][0] = lo;
      ws.box[lane][1] = hi;
      __syncwarp();
      const float4 a = ws.wray[lane][0], b = ws.wray[lane][1];
      const bool in = (pmask >> lane) & 1u;
      for (int j = 0; j < n; ++j) {
        float tn;
        const bool pass = world_slab(ws.box[j][0], ws.box[j][1], a, b, tn) && in;
        const uint32_t mj = __ballot_sync(CLRT_FULL, pass);
        const uint32_t kj = __reduce_min_sync(CLRT_FULL, pass ? key_of(tn) : CLRT_NOKEY);
        if (lane == j) {
          cmask = mj;
          ckey = kj;
        }
      }
    }
    keys[lane] = ckey;
    masks[lane] = cmask;
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

  // pop() over a level whose keys and masks are in shared memory (lane k
  // holding slot k; each lane touches only its own).
  __device__ __forceinline__ int pop_level(uint32_t* key, const uint32_t* mask,
                                           uint32_t& m) {
    for (;;) {
      const uint32_t lkey = key[lane];
      const uint32_t kmin = __reduce_min_sync(CLRT_FULL, lkey);
      if (kmin == CLRT_NOKEY) return -1;
      const int win = __ffs(__ballot_sync(CLRT_FULL, lkey == kmin)) - 1;
      m = __shfl_sync(CLRT_FULL, mask[lane], win);
      if (lane == win) key[lane] = CLRT_NOKEY;
      const float kf = float_of(kmin);
      const uint32_t open = __ballot_sync(CLRT_FULL, alive && h.t >= kf);
      if (open == 0u) {
        key[lane] = CLRT_NOKEY;
        return -1;
      }
      m &= open;
      if (m) return win;
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
    const float4 ro = ws.ray[lane][0], rd = ws.ray[lane][2];
#pragma unroll 4
    for (int k = 0; k < CLRT_CLUSTER; ++k) {
      const float4 N = tri[3 * k];
      const float4 U = tri[3 * k + 1];
      const float4 V = tri[3 * k + 2];
      if (N.x == 0.0f && N.y == 0.0f && N.z == 0.0f) continue;
      float den = rd.x * N.x + rd.y * N.y + rd.z * N.z;
      float b_n = ro.x * N.x + ro.y * N.y + ro.z * N.z + N.w;
      float t = b_n * (-1.0f / den);
      float u = (ro.x * U.x + ro.y * U.y + ro.z * U.z + U.w) +
                t * (rd.x * U.x + rd.y * U.y + rd.z * U.z);
      float v = (ro.x * V.x + ro.y * V.y + ro.z * V.z + V.w) +
                t * (rd.x * V.x + rd.y * V.y + rd.z * V.z);
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

  // Rays x triangles, for a cluster that at most 16 rays reached: the np
  // rays of m take P ray slots (np rounded up to a power of two) and the
  // warp's lanes split into 32 / P groups; lane l tests the ray of slot
  // l % P against triangles l / P, l / P + 32 / P, ... (P of them, in
  // rising order), so the warp runs P triangle iterations where test_leaf
  // runs 32. The groups' winners (least t, then least slot) merge by
  // butterfly shuffles, and each ray's own lane takes its slot's and keeps
  // it if it beats its best by the tie rule. The arithmetic per (ray,
  // triangle) is test_leaf's, bit for bit.
  __device__ __forceinline__ void test_leaf_tiles(int c, int slot, uint32_t m, int np) {
    const int P = np <= 1 ? 1 : 1 << (32 - __clz(np - 1));
    const int g = 32 / P;
    const int rs = lane & (P - 1);
    const bool has = rs < np;
    const int q = has ? (int)__fns(m, 0, rs + 1) : 0;
    const float4 a = ws.ray[q][0];
    const float4 e = ws.ray[q][2];
    const float4* tri = ws.tri[slot];
    uint32_t kb = CLRT_NOKEY;  // the least accepted t's bits (t > 0)
    int kslot = 0;
    float bu = 0.0f, bv = 0.0f;
    if (has) {
      for (int k = lane / P; k < CLRT_CLUSTER; k += g) {
        const float4 N = tri[3 * k];
        const float4 U = tri[3 * k + 1];
        const float4 V = tri[3 * k + 2];
        if (N.x == 0.0f && N.y == 0.0f && N.z == 0.0f) continue;
        float den = e.x * N.x + e.y * N.y + e.z * N.z;
        float b_n = a.x * N.x + a.y * N.y + a.z * N.z + N.w;
        float t = b_n * (-1.0f / den);
        float u = (a.x * U.x + a.y * U.y + a.z * U.z + U.w) +
                  t * (e.x * U.x + e.y * U.y + e.z * U.z);
        float v = (a.x * V.x + a.y * V.y + a.z * V.z + V.w) +
                  t * (e.x * V.x + e.y * V.y + e.z * V.z);
        const bool ok = (t > 0.0f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
        if constexpr (ANY) {
          // ray q is open (h.t = CLRT_BIG): one accept below that resolves it
          if (ok && t < CLRT_BIG) {
            kb = 0u;
            break;
          }
        } else {
          const uint32_t kt = ok ? __float_as_uint(t) : CLRT_NOKEY;
          if (kt < kb) {  // rising k: an equal t keeps the lower slot
            kb = kt;
            kslot = k;
            bu = u;
            bv = v;
          }
        }
      }
    }
    for (int off = P; off < 32; off <<= 1) {
      const uint32_t ok_ = __shfl_xor_sync(CLRT_FULL, kb, off);
      const int os = __shfl_xor_sync(CLRT_FULL, kslot, off);
      const float ou = __shfl_xor_sync(CLRT_FULL, bu, off);
      const float ov = __shfl_xor_sync(CLRT_FULL, bv, off);
      if (ok_ < kb || (ok_ == kb && os < kslot)) {
        kb = ok_;
        kslot = os;
        bu = ou;
        bv = ov;
      }
    }
    // lane q's slot is its rank among the rays of m
    const int mine = __popc(m & ((1u << lane) - 1u));
    const uint32_t wk = __shfl_sync(CLRT_FULL, kb, mine);
    const int wslot = __shfl_sync(CLRT_FULL, kslot, mine);
    const float wu = __shfl_sync(CLRT_FULL, bu, mine);
    const float wv = __shfl_sync(CLRT_FULL, bv, mine);
    if (((m >> lane) & 1u) && wk != CLRT_NOKEY) {
      if constexpr (ANY) {
        h.t = -CLRT_BIG;
      } else {
        const float tw = __uint_as_float(wk);
        const int slot_id = c * CLRT_CLUSTER + wslot;
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
        {
          // both leaf tests skip padding slots (all-zero N): count the
          // staged cluster's real slots, lane k reading slot k
          const float4 N = ws.tri[slot][3 * lane];
          const int real =
              __popc(__ballot_sync(CLRT_FULL, !(N.x == 0.0f && N.y == 0.0f && N.z == 0.0f)));
          if (lane == 0) cnt.tris += (unsigned long long)(real * np);
        }
        if (np > 16) {
          test_leaf(c0 + cur, slot);
        } else {
          test_leaf_tiles(c0 + cur, slot, m_cur, np);
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
    const float4 ro = ws.ray[lane][0], ri = ws.ray[lane][1];
    return __ballot_sync(
        CLRT_FULL, slab(lo, hi, ro.x, ro.y, ro.z, ri.x, ri.y, ri.z, h.t, tn) && in);
  }

  // Super sj (local index) of an instance whose clusters start at cl0
  // (cl_n of them): its clusters, then their leaves, for the rays of m.
  __device__ __forceinline__ void super_node(int sj, int cl0, int cl_n, uint32_t m) {
    const int c_first = sj * CLRT_GROUP;  // local cluster index
    uint32_t ck[1], cm[1];
    test_children(s.cluster_box, cl0 + c_first,
                  max(0, min(CLRT_GROUP, cl_n - c_first)), m, cm[0], ck[0]);
    leaves(cl0 + c_first, ck, cm);
  }

  // Moves every lane's world ray into instance i (the leaf test reads every
  // lane's ray) and walks the instance with the rays of `m`, which count
  // the transform.
  __device__ __forceinline__ void enter(int i, uint32_t m, float ox_w, float oy_w,
                                        float oz_w, float dx_w, float dy_w, float dz_w) {
    const float* mi = s.inst + i * 17;
    if ((m >> lane) & 1u) ++cnt.xforms;
    const float ox = ox_w * mi[0] + oy_w * mi[4] + oz_w * mi[8] + mi[12];
    const float oy = ox_w * mi[1] + oy_w * mi[5] + oz_w * mi[9] + mi[13];
    const float oz = ox_w * mi[2] + oy_w * mi[6] + oz_w * mi[10] + mi[14];
    const float dx = dx_w * mi[0] + dy_w * mi[4] + dz_w * mi[8];
    const float dy = dx_w * mi[1] + dy_w * mi[5] + dz_w * mi[9];
    const float dz = dx_w * mi[2] + dy_w * mi[6] + dz_w * mi[10];
    inst = i;
    __syncwarp();  // every lane is done reading the last instance's rays
    ws.ray[lane][0] = make_float4(ox, oy, oz, h.t);
    ws.ray[lane][1] = make_float4(1.0f / dx, 1.0f / dy, 1.0f / dz, 0.0f);
    ws.ray[lane][2] = make_float4(dx, dy, dz, 0.0f);
    instance(m);
  }

  // One instance's hierarchy, the warp's live rays `live`.
  __device__ __forceinline__ void instance(uint32_t live) {
    const int* rg = s.ranges + inst * 4;
    const int sc0 = rg[0], sc_n = rg[1], cl0 = rg[2], cl_n = rg[3];
    const int hy0 = sc0 / CLRT_GROUP;
    const int n_hyper = (sc_n + CLRT_GROUP - 1) / CLRT_GROUP;
    if (n_hyper <= CLRT_FQ) {
      // few hyper groups: one step tests them (lane q holds hyper q), then
      // the supers of each hyper that any ray passes, with that hyper's
      // rays, and the warp pops those supers in one key order across the
      // whole instance (super q * 32 + k is slot q, lane k)
      uint32_t hk0, hm0;
      test_children(s.hyper_box, hy0, n_hyper, live, hm0, hk0);
      uint32_t sk[CLRT_FQ], sm[CLRT_FQ];
#pragma unroll
      for (int q = 0; q < CLRT_FQ; ++q) {
        const uint32_t mq = __shfl_sync(CLRT_FULL, hm0, q);
        sm[q] = 0u;
        sk[q] = CLRT_NOKEY;
        if (q < n_hyper && mq != 0u) {
          test_children(s.super_box, sc0 + q * 32, min(32, sc_n - q * 32), mq, sm[q], sk[q]);
        }
      }
      for (;;) {
        uint32_t m_s;
        float k_s;
        const int sj = pop(sk, sm, m_s, k_s);
        if (sj < 0) return;
        super_node(sj, cl0, cl_n, m_s);
      }
    }
    // many hyper groups: first the box around them all, so that a warp
    // whose rays all miss the instance tests one box, not n_hyper
    live = root(hy0, n_hyper, live);
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
          super_node(s_first + sj, cl0, cl_n, m_s);
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
// slot and instance stay as they came. Once no lane is open the walk ends,
// at whatever level it is.
//
// A lone instance (CLRT_INST_LOOP) is walked at once with every live lane
// (its own root test culls as a world box would). Above, the instance
// level: the warp's world rays against the world boxes of instances base ..
// base + 31 (lane k instance base + k), popped in key order; above
// CLRT_ICHUNK instances the chunks of CLRT_ICHUNK instances (lane c chunk
// cbase + c) come first, each chunk popped tested against its instances'
// boxes. More than 32 chunks are taken 32 (a warp's lanes) at a time, in
// index order.
template <bool ANY = false>
__device__ __forceinline__ void traverse(const SceneTables& s, WarpStage& ws,
                                         bool alive, float ox_w, float oy_w,
                                         float oz_w, float dx_w, float dy_w,
                                         float dz_w, Hit& h, TestCount& cnt) {
  if (!__any_sync(CLRT_FULL, alive)) return;
  Walk<ANY> w{s, ws, h, cnt, (int)(threadIdx.x & 31), 0, alive};
  const int lane = w.lane;
  const bool plain = s.n_inst <= CLRT_INST_LOOP;
  __syncwarp();  // every lane is done reading the last walk's world rays and level
  ws.wray[lane][0] = make_float4(ox_w, oy_w, oz_w, h.t);
  ws.wray[lane][2] = make_float4(dx_w, dy_w, dz_w, 0.0f);
  ws.ikey[lane] = CLRT_NOKEY;
  ws.ckey[lane] = CLRT_NOKEY;
  // plain: base 0, cbase the next instance; else base the instances' first
  // (-1 before the first step), cbase the chunks' first (-32 before)
  ws.base = plain ? 0 : -1;
  ws.cbase = plain ? 0 : -32;
  if (!plain) {
    ws.wray[lane][1] = make_float4(1.0f / dx_w, 1.0f / dy_w, 1.0f / dz_w,
                                   fmaxf(fmaxf(fabsf(ox_w), fabsf(oy_w)), fabsf(oz_w)));
  }
  // Nothing but shared memory carries the level from one instance's walk
  // to the next, so that no register is held through the walk.
  for (;;) {
    uint32_t m;
    int j;
    if (plain) {
      // every instance in index order, with every live lane (any-hit: the
      // open ones)
      j = ws.cbase;
      m = __ballot_sync(CLRT_FULL, alive && (!ANY || h.t >= CLRT_BIG));
      if (j >= s.n_inst || m == 0u) return;
      __syncwarp();  // every lane has read cbase
      ws.cbase = j + 1;
    } else {
      j = w.pop_level(ws.ikey, ws.imask, m);
      while (j < 0) {
        // this level's instances are done: the next world step, over the
        // instance boxes of all (up to CLRT_ICHUNK instances, once) or of
        // the next chunk a ray passes, or over the next 32 chunks' boxes
        const float* table = s.inst_box;
        int first, count;
        uint32_t mask;
        bool chunks = false;
        if (s.n_inst <= CLRT_ICHUNK) {
          if (ws.base >= 0) return;
          first = 0;
          count = s.n_inst;
          mask = __ballot_sync(CLRT_FULL, alive);
        } else {
          const int c = w.pop_level(ws.ckey, ws.cmask, mask);
          if (c >= 0) {
            first = (ws.cbase + c) * CLRT_ICHUNK;
            count = min(CLRT_ICHUNK, s.n_inst - first);
          } else {
            // the live lanes (any-hit: the open ones) against 32 more chunks
            first = ws.cbase + 32;
            mask = __ballot_sync(CLRT_FULL, alive && (!ANY || h.t >= CLRT_BIG));
            if (first >= s.n_chunks || mask == 0u) return;
            chunks = true;
            table = s.chunk_box;
            count = min(32, s.n_chunks - first);
          }
        }
        __syncwarp();  // every lane is done reading the world rays, base and cbase
        if (chunks) {
          ws.cbase = first;
        } else {
          ws.base = first;
        }
        ws.wray[lane][0].w = h.t;  // test_world syncs before it reads
        w.test_world(table, first, count, mask, chunks ? ws.ckey : ws.ikey,
                     chunks ? ws.cmask : ws.imask);
        j = w.pop_level(ws.ikey, ws.imask, m);
      }
    }
    const float4 o = ws.wray[lane][0], d = ws.wray[lane][2];
    w.enter(ws.base + j, m, o.x, o.y, o.z, d.x, d.y, d.z);
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
