// Native binned-SAH BVH builder.
//
// Clean-room C++ implementation of the same algorithm as bvh.py (and the
// reference's BVH.cpp:103-255): 8-bin x 3-axis SAH with prefix/suffix area
// sweeps, split-vs-leaf by SAH cost against the parent, adjacent children
// (right = left + 1), in-place partition, optional hard max_leaf bound with
// object-median fallback. This is the cold-start performance path for large
// scenes; the level-synchronous numpy builder is the portable default.
//
// Performance structure (vs the reference's single-threaded SIMD build,
// BVH.cpp:220-222):
//  * One 40-byte record {tri AABB, centroid, original index} per triangle,
//    partitioned IN PLACE — every pass is a linear scan, no permutation
//    indirection (the reference swaps its 80-byte Tri records for the same
//    reason, BVH.cpp:186-197).
//  * Fused passes per node: one scan computes geometry bounds + centroid
//    bounds for all 3 axes; one scan bins all 3 axes at once; one scan
//    partitions. (The naive form is 8 scans.)
//  * Deterministic parallelism: the tree top is expanded sequentially
//    (largest node first) until there are enough independent subtrees, then
//    worker threads build each subtree into a task-local node pool; pools
//    are concatenated at offsets fixed by task order, so the output is
//    bit-identical regardless of thread scheduling.
//
// The builder returns a permutation (record original indices in final
// order); the Python side reorders its SoA arrays with it.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 mn{1e30f, 1e30f, 1e30f};
  Vec3 mx{-1e30f, -1e30f, -1e30f};
  void grow(const Vec3& p) {
    mn = vmin(mn, p);
    mx = vmax(mx, p);
  }
  void grow_box(const Vec3& bmn, const Vec3& bmx) {
    mn = vmin(mn, bmn);
    mx = vmax(mx, bmx);
  }
  void grow(const AABB& o) {
    mn = vmin(mn, o.mn);
    mx = vmax(mx, o.mx);
  }
  double half_area() const {
    double ex = (double)mx.x - mn.x, ey = (double)mx.y - mn.y,
           ez = (double)mx.z - mn.z;
    return ex * ey + ey * ez + ez * ex;
  }
};

struct Rec {  // per-triangle build record, partitioned in place
  Vec3 mn, mx, c;
  int32_t orig;
};

struct NodeOut {  // SoA views over caller-owned output arrays
  float* node_min;
  float* node_max;
  int32_t* left_first;
  int32_t* tri_count;
  void store(long node, const AABB& b, long first_or_left, long count) const {
    node_min[node * 3 + 0] = b.mn.x;
    node_min[node * 3 + 1] = b.mn.y;
    node_min[node * 3 + 2] = b.mn.z;
    node_max[node * 3 + 0] = b.mx.x;
    node_max[node * 3 + 1] = b.mx.y;
    node_max[node * 3 + 2] = b.mx.z;
    left_first[node] = (int32_t)first_or_left;
    tri_count[node] = (int32_t)count;  // 0 = inner node
  }
};

struct PlaneScan {
  AABB bounds;       // geometry bounds of the range (node AABB)
  int axis = -1;     // best split axis (-1: none valid)
  float pos = 0.0f;  // split position on that axis
  double cost = 1e300;
};

// One fused bounds pass + one fused binning pass over [first, first+count).
PlaneScan scan_range(Rec* recs, long first, long count) {
  constexpr int BINS = 8;
  PlaneScan out;
  Vec3 cmn{1e30f, 1e30f, 1e30f}, cmx{-1e30f, -1e30f, -1e30f};
  for (long i = first; i < first + count; ++i) {
    const Rec& r = recs[i];
    out.bounds.grow_box(r.mn, r.mx);
    cmn = vmin(cmn, r.c);
    cmx = vmax(cmx, r.c);
  }
  if (count < 2) return out;

  float scale[3];
  bool valid[3];
  for (int a = 0; a < 3; ++a) {
    float lo = (&cmn.x)[a], hi = (&cmx.x)[a];
    valid[a] = hi > lo;
    scale[a] = valid[a] ? BINS / (hi - lo) : 0.0f;
  }
  AABB bins[3][BINS];
  int counts[3][BINS] = {};
  for (long i = first; i < first + count; ++i) {
    const Rec& r = recs[i];
    for (int a = 0; a < 3; ++a) {
      if (!valid[a]) continue;
      int b = (int)((((&r.c.x)[a]) - (&cmn.x)[a]) * scale[a]);
      b = b < BINS - 1 ? b : BINS - 1;
      counts[a][b]++;
      bins[a][b].grow_box(r.mn, r.mx);
    }
  }
  for (int a = 0; a < 3; ++a) {
    if (!valid[a]) continue;
    double left_area[BINS - 1], right_area[BINS - 1];
    int left_cnt[BINS - 1], right_cnt[BINS - 1];
    AABB lb, rb;
    int ls = 0, rs = 0;
    for (int i = 0; i < BINS - 1; ++i) {
      ls += counts[a][i];
      left_cnt[i] = ls;
      lb.grow(bins[a][i]);
      left_area[i] = lb.half_area();
      rs += counts[a][BINS - 1 - i];
      right_cnt[BINS - 2 - i] = rs;
      rb.grow(bins[a][BINS - 1 - i]);
      right_area[BINS - 2 - i] = rb.half_area();
    }
    float lo = (&cmn.x)[a];
    float step = ((&cmx.x)[a] - lo) / BINS;
    for (int i = 0; i < BINS - 1; ++i) {
      if (left_cnt[i] == 0 || right_cnt[i] == 0) continue;
      double cost = left_cnt[i] * left_area[i] + right_cnt[i] * right_area[i];
      if (cost < out.cost) {
        out.cost = cost;
        out.axis = a;
        out.pos = lo + step * (i + 1);
      }
    }
  }
  return out;
}

// In-place partition by centroid side on axis; returns the split point.
long partition_range(Rec* recs, long first, long count, int axis, float pos) {
  long i = first, j = first + count - 1;
  while (i <= j) {
    if ((&recs[i].c.x)[axis] < pos) {
      ++i;
    } else {
      std::swap(recs[i], recs[j]);
      --j;
    }
  }
  return i;
}

struct SplitDecision {
  bool split;
  long mid;  // only when split
};

SplitDecision decide(Rec* recs, long first, long count, int depth,
                     int min_leaf, int max_leaf, const PlaneScan& ps) {
  bool must_split = max_leaf > 0 && count > max_leaf && depth < 64;
  double parent_cost = (double)count * ps.bounds.half_area();
  bool sah_split = ps.axis >= 0 && ps.cost < parent_cost && count > min_leaf;
  if (!(sah_split || must_split) || count < 2 || depth >= 64)
    return {false, 0};
  long mid = ps.axis >= 0
                 ? partition_range(recs, first, count, ps.axis, ps.pos)
                 : first;
  if (mid == first || mid == first + count) {
    if (!must_split) return {false, 0};
    mid = first + count / 2;  // object-median fallback
  }
  return {true, mid};
}

// ---- task-local subtree build ---------------------------------------------

struct LocalPool {
  std::vector<float> nmin, nmax;
  std::vector<int32_t> lf, tc;
  long alloc_pair() {
    long idx = (long)lf.size();
    nmin.resize(nmin.size() + 6);
    nmax.resize(nmax.size() + 6);
    lf.resize(lf.size() + 2);
    tc.resize(tc.size() + 2);
    return idx;
  }
  void store(long node, const AABB& b, long first_or_left, long count) {
    nmin[node * 3 + 0] = b.mn.x;
    nmin[node * 3 + 1] = b.mn.y;
    nmin[node * 3 + 2] = b.mn.z;
    nmax[node * 3 + 0] = b.mx.x;
    nmax[node * 3 + 1] = b.mx.y;
    nmax[node * 3 + 2] = b.mx.z;
    lf[node] = (int32_t)first_or_left;
    tc[node] = (int32_t)count;
  }
  long size() const { return (long)lf.size(); }
};

struct Task {
  long root;  // GLOBAL node id (pre-allocated by the sequential phase)
  long first, count;
  int depth;
  LocalPool pool;  // descendants; local index i -> global base + i
};

// Builds the subtree under task.root: the root's record goes straight to
// the global arrays; descendants go to the local pool with LOCAL child
// indices (negated-1 markers are not needed: every lf in the local pool
// that belongs to an inner node is a local index, fixed up at merge).
void build_subtree(Rec* recs, const NodeOut& g, Task& t, int min_leaf,
                   int max_leaf) {
  struct Item {
    long node;  // local index, or -1 for the task root
    long first, count;
    int depth;
  };
  std::vector<Item> stack;
  stack.push_back({-1, t.first, t.count, t.depth});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    PlaneScan ps = scan_range(recs, it.first, it.count);
    SplitDecision d =
        decide(recs, it.first, it.count, it.depth, min_leaf, max_leaf, ps);
    if (!d.split) {
      if (it.node < 0)
        g.store(t.root, ps.bounds, it.first, it.count);
      else
        t.pool.store(it.node, ps.bounds, it.first, it.count);
      continue;
    }
    long left = t.pool.alloc_pair();  // local pair, adjacent
    if (it.node < 0)
      g.store(t.root, ps.bounds, left, 0);
    else
      t.pool.store(it.node, ps.bounds, left, 0);
    // push right first so the left child is processed next (DFS order —
    // irrelevant for determinism, the ids are already assigned)
    stack.push_back({left + 1, d.mid, it.first + it.count - d.mid,
                     it.depth + 1});
    stack.push_back({left, it.first, d.mid - it.first, it.depth + 1});
  }
}

}  // namespace

extern "C" {

// Builds one BVH per mesh over the shared triangle arena.
// v0/v1/v2: [T, 3] f32; mesh_counts: [n_meshes]; outputs preallocated:
// node_min/node_max [max_nodes, 3], left_first/tri_count [max_nodes],
// roots [n_meshes], perm [T]. Returns node count, or -1 on overflow.
long clrt_build_bvh(const float* v0, const float* v1, const float* v2, long T,
                    const long* mesh_counts, int n_meshes, int min_leaf,
                    int max_leaf, float* node_min, float* node_max,
                    int32_t* left_first, int32_t* tri_count, int32_t* roots,
                    int32_t* perm, long max_nodes) {
  std::vector<Rec> recs(T);
  for (long i = 0; i < T; ++i) {
    Vec3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
    Vec3 b{v1[i * 3], v1[i * 3 + 1], v1[i * 3 + 2]};
    Vec3 c{v2[i * 3], v2[i * 3 + 1], v2[i * 3 + 2]};
    Rec& r = recs[i];
    r.mn = vmin(a, vmin(b, c));
    r.mx = vmax(a, vmax(b, c));
    r.c = {(a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
           (a.z + b.z + c.z) / 3.0f};
    r.orig = (int32_t)i;
  }

  NodeOut g{node_min, node_max, left_first, tri_count};
  long n_nodes = n_meshes;  // per-mesh roots occupy ids 0..n_meshes-1
  if (n_nodes > max_nodes) return -1;

  // ---- sequential phase: expand the largest nodes until there are enough
  // independent subtrees to keep the workers busy -----------------------
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = (int)std::min<unsigned>(hw ? hw : 1, 16);
  const long kSeqCutoff = 16384;  // below this a subtree is a task as-is
  const long kTaskTarget = (long)n_threads * 4;

  std::vector<Task> frontier;
  frontier.reserve(64);
  {
    long start = 0;
    for (int m = 0; m < n_meshes; ++m) {
      roots[m] = m;
      Task t;
      t.root = m;
      t.first = start;
      t.count = mesh_counts[m];
      t.depth = 0;
      frontier.push_back(std::move(t));
      start += mesh_counts[m];
    }
  }
  std::vector<Task> tasks;
  while (!frontier.empty()) {
    // deterministic: largest count first, ties by root id
    size_t big = 0;
    for (size_t i = 1; i < frontier.size(); ++i) {
      if (frontier[i].count > frontier[big].count ||
          (frontier[i].count == frontier[big].count &&
           frontier[i].root < frontier[big].root))
        big = i;
    }
    if (frontier[big].count < kSeqCutoff ||
        (long)(frontier.size() + tasks.size()) >= kTaskTarget) {
      for (auto& t : frontier) tasks.push_back(std::move(t));
      frontier.clear();
      break;
    }
    Task t = std::move(frontier[big]);
    frontier.erase(frontier.begin() + big);
    PlaneScan ps = scan_range(recs.data(), t.first, t.count);
    SplitDecision d = decide(recs.data(), t.first, t.count, t.depth,
                             min_leaf, max_leaf, ps);
    if (!d.split) {
      g.store(t.root, ps.bounds, t.first, t.count);
      continue;
    }
    if (n_nodes + 2 > max_nodes) return -1;
    long left = n_nodes;
    n_nodes += 2;
    g.store(t.root, ps.bounds, left, 0);
    Task l, r;
    l.root = left;
    l.first = t.first;
    l.count = d.mid - t.first;
    l.depth = t.depth + 1;
    r.root = left + 1;
    r.first = d.mid;
    r.count = t.first + t.count - d.mid;
    r.depth = t.depth + 1;
    frontier.push_back(std::move(l));
    frontier.push_back(std::move(r));
  }

  // ---- parallel phase: one worker per subtree, task-local pools --------
  // (records ranges are disjoint, output slots disjoint — data-race free;
  // node ids fixed by task order, not by scheduling)
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= tasks.size()) return;
      build_subtree(recs.data(), g, tasks[i], min_leaf, max_leaf);
    }
  };
  if ((int)tasks.size() > 1 && n_threads > 1) {
    std::vector<std::thread> pool;
    int n_spawn = std::min<int>(n_threads, (int)tasks.size());
    pool.reserve(n_spawn - 1);
    for (int i = 0; i < n_spawn - 1; ++i) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  } else {
    worker();
  }

  // ---- merge: concatenate local pools at deterministic offsets ---------
  for (auto& t : tasks) {
    long base = n_nodes;
    long sz = t.pool.size();
    if (base + sz > max_nodes) return -1;
    n_nodes += sz;
    if (sz > 0) {
      std::memcpy(node_min + base * 3, t.pool.nmin.data(),
                  sz * 3 * sizeof(float));
      std::memcpy(node_max + base * 3, t.pool.nmax.data(),
                  sz * 3 * sizeof(float));
      for (long i = 0; i < sz; ++i) {
        bool inner = t.pool.tc[i] == 0;
        left_first[base + i] =
            inner ? (int32_t)(t.pool.lf[i] + base) : t.pool.lf[i];
        tri_count[base + i] = t.pool.tc[i];
      }
    }
    // the task root's children live at local 0/1 -> base/base+1
    if (tri_count[t.root] == 0 && sz > 0) left_first[t.root] += base;
  }

  for (long i = 0; i < T; ++i) perm[i] = recs[i].orig;
  return n_nodes;
}

}  // extern "C"
