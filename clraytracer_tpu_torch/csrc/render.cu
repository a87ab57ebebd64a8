// K2.2 — fused forward frame: raygen (or given rays), then per bounce
// traverse, shade (reference-parity integer-colour Phong) and continue,
// per ray in registers.
//
// Replaces clraytracer_tpu/ops/render_pallas.py:_make_render_kernel
// (launched by _render_tiles, entries render_fused_camera and
// render_fused) in both its ray sources, with its options as template
// parameters (atlas_mode, shadows, gi, rays, carry):
//  * camera mode: each lane unprojects its pixel (the in-kernel raygen);
//  * ray mode (the template parameter RAYS, RenderParams::rays given): each
//    lane reads its origin and direction from six f32 planes [n], ray i
//    at i, c * n + i. Everything after is the same code; nothing in the
//    walk assumes that a warp's rays share an origin (traverse.cuh moves
//    each lane's own ray to object space), so the bounce-0 walk is the
//    one later bounces make. Lanes past n walk as dead rays;
//  * atlas mode 0 (every texture procedural): texels evaluated per ray in
//    registers, the full Phong sum accumulated here;
//  * atlas modes 1 and 2 (imported textures): the kernel is texel-blind.
//    Radiance is linear in the albedo texel under reference-parity
//    shading, so only spec_light is accumulated and each bounce emits
//    deferred planes; the frame finish (clrt_finish below, its plain
//    version ops/render_fused.py _finish_frame) gathers every bounce's
//    texels (and the sky's) at once. Mode 1 (M <= 64 materials)
//    reads the material row and emits the texel-pool index; mode 2 reads
//    no material data and emits the material id and (uu, vv);
//  * shadows: on bounce 0 every lane walks a second ray from the offset
//    hit point toward the sun, in traverse.cuh's any-hit mode; an occluded
//    hit loses dif, spec_s and spec_light (render_pallas.py:476-515);
//  * gi: Monte-Carlo continuation in a uniform hemisphere direction with
//    throughput colour * 2 cos(theta) (render_pallas.py:542-604), from a
//    per-ray Wang-hash/xorshift32 stream seeded by the ray's strip index;
//  * carry (render_fused_camera's split_rebin, render_pallas.py:121-123,
//    :284-309, :707-715; atlas mode 0 without GI only), laid out for the
//    card rather than the TPU's 128-ray rows. The CARRY_OUT launch (camera
//    mode) writes, after its last bounce, the continuation o(3) | d(3) |
//    energy(3) at planes 9..17 of the rays still alive (at their strip
//    index i, as the 9 frame planes; a dead ray's are left unwritten) and
//    at plane 18 one i32 sort key per ray in thread order (blockIdx * 128
//    + threadIdx, so 32 consecutive keys are one warp's 8 x 4 tile):
//    ray_key of the ray's own direction octant and coarse origin cells,
//    CLRT_KEY_DEAD for a ray that missed. The host sorts the key plane
//    (stable); the CARRY_IN launch (ray mode) takes the sorted keys
//    (RenderParams::keys) and the thread index each came from
//    (RenderParams::order). Its thread t is the t-th sorted ray: a warp
//    whose 32 keys are dead returns before any other read (dead keys sort
//    last), a live lane maps its index back to the ray's strip index i and
//    reads o | d (RenderParams::rays, the carry's planes 9..14) and energy
//    (RenderParams::carry, planes 15..17) at i, walks from global bounce
//    start_bounce >= 1 with light = d, and reads its running result and
//    writes it, and its miss planes when it misses, in place at i through
//    out, which is the carry buffer. A live ray has not
//    missed, so the carry-out wrote its miss planes as zeros. Shadows are
//    gated to global bounce 0, so a carry-in launch has no shadow walk.
// Every shading formula
// keeps the JAX kernel's expression tree (which replicates ops/shade.py);
// the equirect sky stays outside the kernel (it is clrt_finish's): each
// ray's throughput and direction at its first miss are recorded.
//
// Output [9 + K*B, n] f32 planes: result rgb | miss energy rgb | miss dir
// xyz, then for bounce b the K deferred planes at 9 + K*b (atlas modes):
// mode 1 (K = 7): pool index (i32 bits; -1 miss now, 0 dead) | material
// colour bytes rgb | coefficient E*dif + atm*amb rgb; mode 2 (K = 6):
// material id (-1 miss now, -2 dead) | uu | vv | coefficient rgb. With gi
// the coefficient splits into E*dif and, as 3 more planes, atm*amb.
// Lanes that are not shaded at a bounce write zeros beside the sentinel.
// Ray i = row i / 128, lane i % 128 of the screen-tile order (a trows x
// 128 pixel strip per trows rows) in camera mode, of the given planes in
// ray mode; its GI stream is seeded by i in both.
//
// Bound on the H100: its least time is the output bytes in a small scene
// (36 B/ray, plus 4 K B bytes a ray in the atlas modes, plus the 24 B/ray
// of input planes in ray mode; carry-out 4 B/ray of keys and 36 B more a
// live ray, carry-in 4 B/ray of keys, then a live ray's 8 B index, 48 B
// in and 12 B out, 24 B more where it misses) and the walk's
// operations in a large one; shading is a few hundred FP32 operations per
// hit ray, GI about 80 more. What holds it above both is the traversal's
// latency (traverse.cuh). Design here: a block of 128 threads is four
// warps; each warp takes an 8 x 4 pixel tile (4 consecutive strip rows, 32
// columns per block), so the warp's bounce-0 rays are coherent in both
// screen directions, and writes its outputs at their strip-order index i.
// Ray mode keeps that mapping over (row, lane) of the given planes: rays
// laid out in screen-tile order (camera.ray_directions_tiled) are as
// coherent as camera mode's, and any other order is right, only less so.
// Rays that missed stay in the warp's walks as dead lanes; a bounce ends
// the loop only when every lane of the warp has missed. The shadow walk
// sits between two shading blocks, outside any per-lane branch, so every
// lane of the warp reaches it. The material row and texture descriptor are
// read directly by index instead of the TPU kernel's static select loops;
// everything is inlined, so the per-ray arrays live in registers. The
// options are compile-time, so the default frame's instantiation compiles
// to the same code as the option-free kernel before them.
//
// The shadow walk. What bounds it is the same latency, on up to one shadow
// ray per pixel (60% of the rays on a ground scene), and two costs of its
// own: a nearest-hit walk keeps opening boxes and leaves after the ray's
// first occluder, and a second inlined walk holds the hit's shading state
// (normal, next origin, colour inputs) live across it, which under the
// default instantiation's register bound spilled. So the shadow ray walks in
// any-hit mode (a lane leaves at its first accepted hit, the warp when none
// is left open). The shadow factor is the nearest walk's, but for a grazing
// hit that a triangles-outer leaf finds behind a box the lane's own slab
// test culled (traverse.cuh's one exception, under the frame rule of at
// most 16 rays). The shadow instantiations are their own kernel,
// render_shadow_kernel, with their own register bound. The shadow walk's
// counts can be read apart (the shadow_counters of clrt_render).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// No --use_fast_math: divisions, sqrtf, cosf and sinf stay IEEE/accurate,
// and 1.0f / sqrtf(x) is kept where the reference writes 1 / sqrt.
#include "traverse.cuh"

struct RenderParams {
  float cam[36];  // invProj (16) | invView (16) | position (3) | row0
  float sun_sin, sun_cos;
  const float* atm;       // [bounces, 3]: the f32 chain 0.255*0.4^b (etc.)
  const float* mat_rows;  // [M, 16]: albedo rgb | ... | aw ah aoff_hi aoff_lo @ 8..11
  const float* tex;       // [D, 20]: procedural_tex.descriptor_row
  int n_mat, n_tex;
  int trows, tiles_x, width, height, n_rays, bounces;
  int atlas_mode;           // 0, 1 or 2
  int shadows;              // sun shadow walk on bounce 0
  int gi;                   // Monte-Carlo GI continuation
  unsigned int gi_base;     // GI seed base of bounce 0 (+1237 per bounce)
  const float* rays;        // ray mode: [6, n_rays] origin xyz | direction xyz
  const float* carry;       // carry-in: the carry-out's [19, n_rays] buffer (== out)
  int start_bounce;         // carry-in: global index of the first bounce (>= 1)
  int carry_out;            // carry-out: continuation and key planes after the 9
  const int* keys;          // carry-in: [n_rays] the key plane, sorted
  const long long* order;   // carry-in: [n_rays] the thread index of each sorted key
};

// The carry mode of an instantiation (template parameter CARRY)
enum { CARRY_NONE = 0, CARRY_OUT = 1, CARRY_IN = 2 };
// The sort key of a ray that is dead after the carry-out's bounce
#define CLRT_KEY_DEAD 0x7FFFFFFF

// The strip index of thread tid of block b: block b takes strip rows
// 4 (b / 4) .. + 3, columns 32 (b % 4) .. + 31, and its warp w columns
// + 8 w .. + 8 w + 7 of those rows, one 8 x 4 tile
__device__ __forceinline__ int strip_ray(int b, int tid) {
  const int warp = tid >> 5, wl = tid & 31;
  return ((b >> 2) * 4 + (wl >> 3)) * 128 + (b & 3) * 32 + warp * 8 + (wl & 7);
}

// rebin_key (render_pallas.py:850) of one ray: its direction octant in
// bits 18-20, then its three 6-bit wrapped coarse origin cells
// floor(o * 0.25) & 63, x highest
__device__ __forceinline__ int ray_key(const float (&o)[3], const float (&d)[3]) {
  int key = ((d[0] > 0.0f) << 20) | ((d[1] > 0.0f) << 19) | ((d[2] > 0.0f) << 18);
  for (int c = 0; c < 3; ++c) key |= ((int)floorf(o[c] * 0.25f) & 63) << (6 * (2 - c));
  return key;
}

// procedural_tex.descriptor_row columns
enum {
  TEX_OFF_HI = 0, TEX_OFF_LO, TEX_KIND, TEX_W, TEX_H, TEX_RGB0, TEX_RGB1 = 8,
  TEX_RATIO = 11, TEX_HALF, TEX_INV_HALF, TEX_GROUND, TEX_SUN_I = 17,
  TEX_SUN_J, TEX_SUN_R2, TEX_COLS
};
enum { KIND_CONSTANT = 0, KIND_CHECKER = 1, KIND_SKY = 2 };
// shade._OFF_SHIFT: texel-pool offsets are stored split as (hi, lo)
#define CLRT_OFF_SHIFT 12

struct Rgb {
  float c[3];
};

// procedural_tex._eval at integer texel coords (i, j): byte values
__device__ __forceinline__ Rgb eval_texel(const float* d, float i, float j) {
  Rgb rgb;
  const int kind = (int)d[TEX_KIND];
  if (kind == KIND_CONSTANT) {
    for (int c = 0; c < 3; ++c) rgb.c[c] = d[TEX_RGB0 + c];
  } else if (kind == KIND_CHECKER) {
    const float ci = floorf(i * d[TEX_RATIO]);
    const float cj = floorf(j * d[TEX_RATIO]);
    const bool odd = floorf((ci + cj) * 0.5f) * 2.0f != (ci + cj);
    for (int c = 0; c < 3; ++c) rgb.c[c] = odd ? d[TEX_RGB1 + c] : d[TEX_RGB0 + c];
  } else {
    const float half = d[TEX_HALF];
    const bool upper = j < half;
    const float jj = nan_min(j, half - 1.0f);
    for (int c = 0; c < 3; ++c) {
      const float z = d[TEX_RGB0 + c], hz = d[TEX_RGB1 + c];
      const float grad = floorf((z * (half - jj) + hz * jj) * d[TEX_INV_HALF]);
      rgb.c[c] = upper ? grad : d[TEX_GROUND + c];
    }
    const float dx = i - d[TEX_SUN_I];
    const float dy = j - d[TEX_SUN_J];
    if (dx * dx + dy * dy < d[TEX_SUN_R2]) {
      for (int c = 0; c < 3; ++c) rgb.c[c] = 255.0f;
    }
  }
  return rgb;
}

// deferred planes per bounce (see the header)
template <int ATLAS, bool GI>
struct Defer {
  static constexpr int K = ATLAS == 0 ? 0 : (ATLAS == 1 ? 7 : 6) + (GI ? 3 : 0);
};

// A lane not shaded at this bounce: its sentinel (mode 1: pool index -1
// for a miss now, 0 for a dead lane; mode 2: material id -1 / -2), zeros
// in the bounce's other planes.
template <int ATLAS, bool GI>
__device__ __forceinline__ void write_unshaded(float* out, size_t N, int i,
                                              int b, bool miss_now) {
  constexpr int K = Defer<ATLAS, GI>::K;
  float* o = out + (size_t)(9 + K * b) * N + i;
  o[0] = ATLAS == 1 ? (miss_now ? __int_as_float(-1) : 0.0f)
                    : (miss_now ? -1.0f : -2.0f);
  for (int k = 1; k < K; ++k) o[k * N] = 0.0f;
}

// GI continuation (render_pallas.py:549-604): the ray's stream from
// wang_hash(i * 9999 + seed), two xorshift32 draws, a uniform-hemisphere
// sample about n in the tangent frame (helper +X, or +Z when n is nearly
// +X), flipped to n's side; returns the weight 2 |cos theta|.
__device__ __forceinline__ float gi_sample(uint32_t sg, const float (&n)[3],
                                           float (&dir)[3]) {
  sg = (sg ^ 61u) ^ (sg >> 16);
  sg = sg * 9u;
  sg = sg ^ (sg >> 4);
  sg = sg * 0x27D4EB2Du;
  sg = sg ^ (sg >> 15);
  sg ^= sg << 13;
  sg ^= sg >> 17;
  sg ^= sg << 5;
  const float cos_t = (float)(sg >> 8) * (1.0f / 16777216.0f);
  sg ^= sg << 13;
  sg ^= sg >> 17;
  sg ^= sg << 5;
  const float u2 = (float)(sg >> 8) * (1.0f / 16777216.0f);
  const float sin_t = sqrtf(nan_max(0.0f, 1.0f - cos_t * cos_t));
  const float phi = (float)(2.0 * 3.14159265358979323846) * u2;
  const float px = cosf(phi) * sin_t;
  const float py = sinf(phi) * sin_t;
  const bool nx_big = fabsf(n[0]) > 0.99f;
  const float hx = nx_big ? 0.0f : 1.0f;
  const float hz = nx_big ? 1.0f : 0.0f;
  float tx = n[1] * hz;
  float ty = n[2] * hx - n[0] * hz;
  float tz = -n[1] * hx;
  const float tn = 1.0f / sqrtf(tx * tx + ty * ty + tz * tz);
  tx = tx * tn;
  ty = ty * tn;
  tz = tz * tn;
  float bx = n[1] * tz - n[2] * ty;
  float by = n[2] * tx - n[0] * tz;
  float bz = n[0] * ty - n[1] * tx;
  const float bn = 1.0f / sqrtf(bx * bx + by * by + bz * bz);
  bx = bx * bn;
  by = by * bn;
  bz = bz * bn;
  dir[0] = tx * px + bx * py + n[0] * cos_t;
  dir[1] = ty * px + by * py + n[1] * cos_t;
  dir[2] = tz * px + bz * py + n[2] * cos_t;
  const float dot = dir[0] * n[0] + dir[1] * n[1] + dir[2] * n[2];
  if (dot < 0.0f) {
    for (int c = 0; c < 3; ++c) dir[c] = -dir[c];
  }
  return 2.0f * fabsf(dot);
}

// The frame, one thread per ray; render_kernel and render_shadow_kernel
// inline it under their own register bounds.
template <int ATLAS, bool SHADOWS, bool GI, bool RAYS, int CARRY>
__device__ __forceinline__ void render_frame(const SceneTables& s,
                                             const RenderParams& p,
                                             float* __restrict__ out,
                                             unsigned long long* counters,
                                             unsigned long long* shadow_counters) {
  static_assert(CARRY == CARRY_NONE || (ATLAS == 0 && !GI),
                "the carry is gated to atlas mode 0 without GI");
  static_assert(CARRY != CARRY_OUT || !RAYS, "carry-out is camera mode");
  static_assert(CARRY != CARRY_IN || (RAYS && !SHADOWS),
                "carry-in is ray mode, past the shadowed bounce 0");
  constexpr int K = Defer<ATLAS, GI>::K;
  __shared__ WarpStage stage[4];
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  // strip_ray's mapping: block b takes strip rows 4 (b / 4) .. + 3,
  // columns 32 (b % 4) .. + 31; its warp w columns + 8 w .. + 8 w + 7
  const int r = (blockIdx.x >> 2) * 4 + (wl >> 3);
  const int lane = (blockIdx.x & 3) * 32 + warp * 8 + (wl & 7);
  int i = r * 128 + lane;
  bool valid = i < p.n_rays;
  if constexpr (CARRY == CARRY_IN) {
    // the thread's sorted key: a live one is a carried ray, at the strip
    // index of the carry-out thread it came from. A warp of dead keys has
    // nothing to do (its counts are zero, and the carry-in counts by warp)
    const int t = blockIdx.x * 128 + threadIdx.x;
    valid = t < p.n_rays && p.keys[t] != CLRT_KEY_DEAD;
    if (!__any_sync(CLRT_FULL, valid)) return;
    const int from = valid ? (int)p.order[t] : 0;
    i = strip_ray(from >> 7, from & 127);
  }
  TestCount cnt = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};

  float d[3], o[3];
  if constexpr (RAYS) {
    // ---- ray mode: the lane's ray from the six input planes
    const size_t NR = (size_t)p.n_rays;
    for (int c = 0; c < 3; ++c) {
      o[c] = valid ? p.rays[c * NR + i] : 0.0f;
      d[c] = valid ? p.rays[(3 + c) * NR + i] : 0.0f;
    }
  } else {
    // ---- raygen: strip tile -> pixel -> unproject (camera._unproject_grid)
    const int tile = r / p.trows;
    const float px = (float)((tile % p.tiles_x) * 128 + lane);
    const float py = (float)((tile / p.tiles_x) * p.trows + r % p.trows) + p.cam[35];
    const float cx = (px / (float)p.width) * 2.0f - 1.0f;
    const float cy = (py / (float)p.height) * 2.0f - 1.0f;
    const float* ip = p.cam;
    const float* iv = p.cam + 16;
    float tx = cx * ip[0] + cy * ip[4] + ip[8] + ip[12];
    float ty = cx * ip[1] + cy * ip[5] + ip[9] + ip[13];
    float tz = cx * ip[2] + cy * ip[6] + ip[10] + ip[14];
    const float tw = cx * ip[3] + cy * ip[7] + ip[11] + ip[15];
    const float inv_w = 1.0f / tw;
    tx = tx * inv_w;
    ty = ty * inv_w;
    tz = tz * inv_w;
    const float wx = tx * iv[0] + ty * iv[4] + tz * iv[8] + iv[12];
    const float wy = tx * iv[1] + ty * iv[5] + tz * iv[9] + iv[13];
    const float wz = tx * iv[2] + ty * iv[6] + tz * iv[10] + iv[14];
    const float rn = 1.0f / sqrtf(wx * wx + wy * wy + wz * wz);
    d[0] = wx * rn;
    d[1] = wy * rn;
    d[2] = wz * rn;
    o[0] = p.cam[32];
    o[1] = p.cam[33];
    o[2] = p.cam[34];
  }

  float result[3] = {0.0f, 0.0f, 0.0f};
  float energy[3] = {1.0f, 1.0f, 1.0f};
  const float U8 = (float)(1.0 / 255.0);
  const size_t N = (size_t)p.n_rays;

  // Only the state that later bounces read stays in registers across the
  // walk: the miss planes are written at the first miss, and the light
  // direction is the sun's at global bounce 0 (shade.initial_bounce_state)
  // and the ray's own direction after every continuation.
  bool alive = valid;  // no miss yet
  bool missed = false;
  if constexpr (CARRY == CARRY_IN) {
    // resume a live carried ray (its o and d came in through p.rays). Its
    // running result is read through out, which writes it back: the
    // planes out writes are accessed through out alone, and those that
    // p.rays and p.carry read (9..17) are not written here
    if (valid) {
      for (int c = 0; c < 3; ++c) {
        result[c] = out[c * N + i];
        energy[c] = p.carry[(15 + c) * N + i];
      }
    }
    missed = true;  // the carry-out zeroed its miss planes: no zeroing below
  }
  int b = 0;
  for (; b < p.bounces; ++b) {
    // the global bounce: shadows, the sun as the light and the atmospheric
    // chain (the host offsets p.atm) are keyed by it
    const int gb = CARRY == CARRY_IN ? b + p.start_bounce : b;
    if (!__any_sync(CLRT_FULL, alive)) break;
    const bool was_alive = alive;
    Hit h;
    h.t = alive ? CLRT_BIG : -CLRT_BIG;
    h.u = 0.0f;
    h.v = 0.0f;
    h.slot = 0;
    h.inst = 0;
    traverse(s, stage[warp], alive, o[0], o[1], o[2], d[0], d[1], d[2], h, cnt);
    if (alive && !(h.t < CLRT_BIG)) {  // first miss: the sky is added outside
      for (int c = 0; c < 3; ++c) {
        out[(3 + c) * N + i] = energy[c];
        out[(6 + c) * N + i] = d[c];
      }
      if (ATLAS != 0) write_unshaded<ATLAS, GI>(out, N, i, b, true);
      alive = false;
      missed = true;
    }
    if (ATLAS != 0 && valid && !was_alive) write_unshaded<ATLAS, GI>(out, N, i, b, false);

    // ---- winning instance: world normal, object-space ray, next origin
    HitAttrs a;
    float n[3] = {0.0f, 0.0f, 0.0f}, md[3] = {0.0f, 0.0f, 0.0f};
    float new_o[3] = {0.0f, 0.0f, 0.0f};
    // the material id (an f32-exact int), taken before the shadow walk so
    // that the instance row's pointer is not held through it
    float mat_idf = 0.0f;
    const float t = h.t;
    if (alive) {
      a = interpolate(s, h, cnt);
      const float* m = s.inst + h.inst * 17;
      const float nw[3] = {
          a.nx * m[0] + a.ny * m[4] + a.nz * m[8],
          a.nx * m[1] + a.ny * m[5] + a.nz * m[9],
          a.nx * m[2] + a.ny * m[6] + a.nz * m[10]};
      float mo[3];
      for (int c = 0; c < 3; ++c) {
        mo[c] = o[0] * m[c] + o[1] * m[4 + c] + o[2] * m[8 + c] + m[12 + c];
        md[c] = d[0] * m[c] + d[1] * m[4 + c] + d[2] * m[8 + c];
      }
      const float sn = sqrtf(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2]);
      for (int c = 0; c < 3; ++c) n[c] = nw[c] / sn;
      // the reference reuses the object-space hit point as the next world
      // origin (kernel_main.cl:246-253); it is also the shadow ray's
      for (int c = 0; c < 3; ++c) new_o[c] = (mo[c] + md[c] * t) + n[c] * (float)0.01;
      mat_idf = m[16] + a.mat;
    }

    // ---- sun shadow on bounce 0: every lane walks, the unshaded ones as
    // rays that pass nothing; an occluded hit keeps only the ambient term.
    // Any hit will do (traverse.cuh's any-hit mode). Its counts go out on
    // their own: the warp's counts so far first, then the walk's to both
    // counter sets.
    float shadow = 1.0f;
    if (SHADOWS && gb == 0) {
      if (counters != nullptr) add_counts_warp(counters, cnt);
      cnt = TestCount{0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
      Hit sh;
      sh.t = alive ? CLRT_BIG : -CLRT_BIG;
      sh.u = 0.0f;
      sh.v = 0.0f;
      sh.slot = 0;
      sh.inst = 0;
      traverse<true>(s, stage[warp], alive, new_o[0], new_o[1], new_o[2], 0.0f,
                     0.0f - p.sun_sin, 0.0f - p.sun_cos, sh, cnt);
      if (counters != nullptr) add_counts_warp(counters, cnt);
      if (shadow_counters != nullptr) add_counts_warp(shadow_counters, cnt);
      cnt = TestCount{0ull, 0ull, 0ull, 0ull, 0ull, 0ull};
      if (alive && sh.t < CLRT_BIG) shadow = 0.0f;
    }

    if (alive) {
      // ---- material row, indexed directly
      float alb[3] = {0.0f, 0.0f, 0.0f}, ahi = 0.0f, alo = 0.0f, aw = 0.0f, ah = 0.0f;
      if (ATLAS != 2 && mat_idf >= 0.0f && mat_idf < (float)p.n_mat) {
        const int mi = (int)mat_idf;
        if ((float)mi == mat_idf) {
          const float* mr = p.mat_rows + mi * 16;
          alb[0] = mr[0];
          alb[1] = mr[1];
          alb[2] = mr[2];
          if (ATLAS == 1) {
            aw = mr[8];
            ah = mr[9];
          }
          ahi = mr[10];
          alo = mr[11];
        }
      }

      float color[3] = {0.0f, 0.0f, 0.0f};
      if (ATLAS == 0) {
        // ---- procedural texel, selected by (off_hi, off_lo); last match wins
        float texel[3] = {0.0f, 0.0f, 0.0f};
        for (int k = 0; k < p.n_tex; ++k) {
          const float* td = p.tex + k * TEX_COLS;
          if (!(ahi == td[TEX_OFF_HI] && alo == td[TEX_OFF_LO])) continue;
          const float uw = a.uu - floorf(a.uu);
          const float ui = floorf(uw * td[TEX_W]);
          const float vw = a.vv - floorf(a.vv);
          const float vi = floorf(vw * td[TEX_H]);
          const Rgb rgb = eval_texel(td, ui, vi);
          for (int c = 0; c < 3; ++c) texel[c] = rgb.c[c];
        }
        // ---- integer colour modulate (shade._modulate_bytes)
        for (int c = 0; c < 3; ++c) {
          const float mat_b = rintf(fminf(fmaxf(alb[c], 0.0f), 1.0f) * 255.0f);
          color[c] = floorf(mat_b * texel[c] * (float)(1.0 / 256.0)) * U8;
        }
      }

      // ---- Phong, reference-parity overrides (kernel_main.cl:248-271)
      const float light[3] = {gb == 0 ? 0.0f : d[0], gb == 0 ? p.sun_sin : d[1],
                              gb == 0 ? p.sun_cos : d[2]};
      const float ndl_raw =
          n[0] * (-light[0]) + n[1] * (-light[1]) + n[2] * (-light[2]);
      const float amb_m = nan_max(-ndl_raw, (float)0.1);
      const float ndl = nan_max(ndl_raw, 0.0f);
      const float spec_s = SHADOWS ? (((float)0.5 * ndl) * shadow) * ndl
                                   : ((float)0.5 * ndl) * ndl;
      float rl[3];
      for (int c = 0; c < 3; ++c) rl[c] = (-light[c]) - n[c] * (2.0f * ndl_raw);
      const float rdm =
          nan_max(rl[0] * md[0] + rl[1] * md[1] + rl[2] * md[2], 0.0f);
      float spec_light = (ndl * rdm) * (float)0.2;
      if (SHADOWS) spec_light = spec_light * shadow;
      const float ndd = n[0] * d[0] + n[1] * d[1] + n[2] * d[2];
      const float dif = SHADOWS ? ndl * shadow : ndl;
      const float* atm = p.atm + b * 3;

      float gdir[3] = {0.0f, 0.0f, 0.0f}, gi_weight = 0.0f;
      if (GI) {
        const uint32_t seed = (uint32_t)i * 9999u + (p.gi_base + (uint32_t)b * 1237u);
        gi_weight = gi_sample(seed, n, gdir);
      }

      if (ATLAS != 0) {
        // ---- deferred planes of this bounce (texel-blind shading)
        float* op = out + (size_t)(9 + K * b) * N + i;
        if (ATLAS == 1) {
          // shade._pool_index's op sequence, in i32 (pool offsets exceed
          // f32's 2^24 integer range on large pools)
          const int ui = (int)((a.uu - floorf(a.uu)) * aw);
          const int vi = (int)((a.vv - floorf(a.vv)) * ah);
          const int off_i = (int)ahi * (1 << CLRT_OFF_SHIFT) + (int)alo;
          op[0] = __int_as_float(vi * (int)aw + ui + off_i);
          for (int c = 0; c < 3; ++c)
            op[(1 + c) * N] = rintf(fminf(fmaxf(alb[c], 0.0f), 1.0f) * 255.0f);
        } else {
          op[0] = mat_idf;
          op[N] = a.uu;
          op[2 * N] = a.vv;
        }
        const int kc = ATLAS == 1 ? 4 : 3;
        for (int c = 0; c < 3; ++c) {
          if (GI) {
            op[(kc + c) * N] = energy[c] * dif;
            op[(kc + 3 + c) * N] = atm[c] * amb_m;
          } else {
            op[(kc + c) * N] = energy[c] * dif + atm[c] * amb_m;
          }
        }
      }

      for (int c = 0; c < 3; ++c) {
        const float contrib =
            ATLAS != 0 ? spec_light
                       : ((energy[c] * color[c]) * dif + (atm[c] * color[c]) * amb_m) +
                             spec_light;
        result[c] = result[c] + contrib;
        if (GI) {
          // diffuse throughput albedo * 2 cos(theta); the atlas modes
          // carry the weight alone, _finish_frame multiplies the colour in
          energy[c] = energy[c] * (ATLAS != 0 ? gi_weight : color[c] * gi_weight);
        } else {
          energy[c] = energy[c] * ((float)0.2 * spec_s);
        }
        o[c] = new_o[c];
        d[c] = GI ? gdir[c] : d[c] - n[c] * (2.0f * ndd);
      }
    }
  }
  if (ATLAS != 0 && valid) {
    for (; b < p.bounces; ++b) write_unshaded<ATLAS, GI>(out, N, i, b, false);
  }
  if (valid) {
    for (int c = 0; c < 3; ++c) {
      out[c * N + i] = result[c];
      if (!missed) {
        out[(3 + c) * N + i] = 0.0f;
        out[(6 + c) * N + i] = 0.0f;
      }
    }
  }
  if constexpr (CARRY == CARRY_OUT) {
    // the continuation of a ray still alive, and every ray's sort key in
    // thread order
    int key = CLRT_KEY_DEAD;
    if (alive) {
      for (int c = 0; c < 3; ++c) {
        out[(9 + c) * N + i] = o[c];
        out[(12 + c) * N + i] = d[c];
        out[(15 + c) * N + i] = energy[c];
      }
      key = ray_key(o, d);
    }
    const int t = blockIdx.x * 128 + threadIdx.x;
    if (t < p.n_rays) reinterpret_cast<int*>(out)[18 * N + t] = key;
  }
  if (counters != nullptr) {
    if constexpr (CARRY == CARRY_IN) {
      add_counts_warp(counters, cnt);  // whole dead warps have returned
    } else {
      add_counts(counters, cnt);
    }
  }
}

// Register bounds, one per kind of instantiation. Without shadows: 128
// threads and a floor of 4 resident blocks, so at most 128 registers (16
// warps an SM): the walk's rays-outer test two rays a pass and its
// rays-by-triangles leaf test took them to 116-124 registers without
// spills, where the bare bound had let ptxas cap them at 96 and spill
// 102-214 bytes; a floor of 5 (at most 102 registers) spilled 46-62 bytes
// and made atlas mode 1 on (h) 8% slower (PERF.md). With shadows the two
// walks' state overlaps on bounce 0, and the bare bound made ptxas cap
// them at 96 registers and spill 170-182 bytes; under a floor of one
// resident block the present walk took them to 135-137 registers, 3
// blocks an SM, and shadows with GI 9% slower than the walk before it, so
// they too take a floor of 4 (at most 128 registers, none spilled). Ray mode and
// carry-in keep the bound of the camera mode they share their options
// with. Carry-out holds the continuation state to the end: under the bare
// bound ptxas capped it at 96 registers and spilled 186 bytes, so it takes
// a floor of one resident block (118 registers, none spilled, before the
// per-ray key).
template <int ATLAS, bool GI, bool RAYS, int CARRY>
__global__ void __launch_bounds__(128, CARRY == CARRY_OUT ? 1 : 4)
render_kernel(SceneTables s, RenderParams p, float* __restrict__ out,
              unsigned long long* counters) {
  render_frame<ATLAS, false, GI, RAYS, CARRY>(s, p, out, counters, nullptr);
}

template <int ATLAS, bool GI, bool RAYS, int CARRY>
__global__ void __launch_bounds__(128, 4)
render_shadow_kernel(SceneTables s, RenderParams p, float* __restrict__ out,
                     unsigned long long* counters,
                     unsigned long long* shadow_counters) {
  render_frame<ATLAS, true, GI, RAYS, CARRY>(s, p, out, counters, shadow_counters);
}

template <int ATLAS, bool SHADOWS, bool GI, bool RAYS, int CARRY = CARRY_NONE>
static int launch(const SceneTables* s, const RenderParams* p, float* out,
                  unsigned long long* counters, unsigned long long* shadow_counters,
                  cudaStream_t stream, int blocks) {
  if constexpr (SHADOWS) {
    render_shadow_kernel<ATLAS, GI, RAYS, CARRY><<<blocks, 128, 0, stream>>>(
        *s, *p, out, counters, shadow_counters);
  } else {
    render_kernel<ATLAS, GI, RAYS, CARRY><<<blocks, 128, 0, stream>>>(*s, *p, out, counters);
  }
  return (int)cudaGetLastError();
}

// The 12 instantiations of one ray source, by atlas mode, shadows and GI.
template <bool RAYS>
static int dispatch(int sel, const SceneTables* s, const RenderParams* p, float* out,
                    unsigned long long* counters, unsigned long long* sc,
                    cudaStream_t st, int blocks) {
  switch (sel) {
    case 0: return launch<0, false, false, RAYS>(s, p, out, counters, sc, st, blocks);
    case 1: return launch<0, false, true, RAYS>(s, p, out, counters, sc, st, blocks);
    case 2: return launch<0, true, false, RAYS>(s, p, out, counters, sc, st, blocks);
    case 3: return launch<0, true, true, RAYS>(s, p, out, counters, sc, st, blocks);
    case 4: return launch<1, false, false, RAYS>(s, p, out, counters, sc, st, blocks);
    case 5: return launch<1, false, true, RAYS>(s, p, out, counters, sc, st, blocks);
    case 6: return launch<1, true, false, RAYS>(s, p, out, counters, sc, st, blocks);
    case 7: return launch<1, true, true, RAYS>(s, p, out, counters, sc, st, blocks);
    case 8: return launch<2, false, false, RAYS>(s, p, out, counters, sc, st, blocks);
    case 9: return launch<2, false, true, RAYS>(s, p, out, counters, sc, st, blocks);
    case 10: return launch<2, true, false, RAYS>(s, p, out, counters, sc, st, blocks);
    case 11: return launch<2, true, true, RAYS>(s, p, out, counters, sc, st, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// shadow_counters: optional int64[6], the shadow walk's counts alone (it
// needs p->shadows; counters, when given, count both walks as before).
// p->rays selects ray mode; p->carry_out (camera mode) and p->carry (ray
// mode, with start_bounce >= 1, p->shadows off, the sorted keys and their
// order, out the carry buffer itself and p->rays its planes 9..14) the
// carry instantiations, which take atlas mode 0 without GI and n_rays a
// multiple of 512 (whole blocks: the key plane's thread order covers
// every ray).
extern "C" int clrt_render(const SceneTables* s, const RenderParams* p,
                           float* out, unsigned long long* counters,
                           unsigned long long* shadow_counters, void* stream) {
  if (p->n_rays <= 0) return 0;
  if (shadow_counters != nullptr && !p->shadows) return (int)cudaErrorInvalidValue;
  const int rows = (p->n_rays + 127) / 128;
  const int blocks = (rows + 3) / 4 * 4;  // four blocks per 4 strip rows
  cudaStream_t st = (cudaStream_t)stream;
  if (p->carry != nullptr || p->carry_out || p->start_bounce != 0 || p->keys != nullptr ||
      p->order != nullptr) {
    const bool plain_opts = p->atlas_mode == 0 && !p->gi && p->n_rays % 512 == 0;
    const size_t n = (size_t)p->n_rays;
    if (p->carry != nullptr && plain_opts && p->carry == out && p->rays == out + 9 * n &&
        p->keys != nullptr && p->order != nullptr && !p->carry_out && !p->shadows &&
        p->start_bounce >= 1) {
      return launch<0, false, false, true, CARRY_IN>(s, p, out, counters, nullptr, st,
                                                     blocks);
    }
    if (p->carry == nullptr && plain_opts && p->rays == nullptr && p->keys == nullptr &&
        p->order == nullptr && p->carry_out && p->start_bounce == 0) {
      return p->shadows ? launch<0, true, false, false, CARRY_OUT>(
                              s, p, out, counters, shadow_counters, st, blocks)
                        : launch<0, false, false, false, CARRY_OUT>(
                              s, p, out, counters, nullptr, st, blocks);
    }
    return (int)cudaErrorInvalidValue;
  }
  const int sel = p->atlas_mode * 4 + (p->shadows ? 2 : 0) + (p->gi ? 1 : 0);
  if (p->rays != nullptr) {
    return dispatch<true>(sel, s, p, out, counters, shadow_counters, st, blocks);
  }
  return dispatch<false>(sel, s, p, out, counters, shadow_counters, st, blocks);
}

// ---------------------------------------------------------------------------
// The frame finish (clrt_finish): K2.2's deferred sky and texels, and on
// request the post chain and the untiling, in one launch.
//
// Replaces no TPU kernel: on the TPU this is XLA code around K2.2
// (render_pallas.py:936 _finish_frame, then post.py's tiled chain and
// render.py's untile), which the port ran as about a hundred torch
// launches over the frame's planes. ops/render_fused.py _finish_frame,
// ops/post.py post_process_tiled and ops/render_fused.py untile are its
// plain version; it keeps their expression trees and roundings, so on the
// same K2.2 planes its output equals theirs bit for bit.
//
// One thread a strip ray i (row i / 128, lane i % 128):
//  * the sky index of the miss direction (shade._skybox_index: atan2f,
//    acosf, truncation to i32), in atlas mode 0 the sky's procedural texel
//    (shade._eval_skybox_inline), in the atlas modes only where a bounce
//    missed;
//  * atlas modes, per bounce: the texel-pool index (mode 1 from the plane,
//    mode 2 from the material row by id, shade._pool_index's i32
//    arithmetic), the sky index where the ray missed at that bounce, one
//    texel read (a packed-RGB8 word, or an f32 pool row), the integer
//    modulate floor(mat_b * round(texel*255) / 256) / 255, the coefficient
//    sums, with GI the running colour product; then + sky * miss energy;
//  * POST: the tiled post chain (post._post_core: saturation, Reinhard,
//    merged pow, the vignette computed from the pixel) and the untiling:
//    the pixel (x, y) of ray i is written to out[(y * width + x) * 3 + c];
//    pad lanes and strip rows past the frame write nothing. Otherwise the
//    radiance goes to out[c * n + i], strip order, pad lanes included.
//
// Bound on the H100: bytes. K2.2's planes are read once (4 (9 + K B) B a
// ray), a texel word or row a bounce (from a pool that fits in L2 at the
// scenes' sizes), the output written once (12 B a pixel or a ray); the
// arithmetic is a few hundred FP32 operations a ray. Neighbouring threads
// read neighbouring lanes of each plane and write neighbouring pixels.
struct FinishParams {
  const float* planes;   // K2.2's [9 + K*bounces, n] output (plane stride n)
  int n, bounces;
  int atlas_mode, gi, post;
  int sky_w, sky_h, sky_off;  // the packed sky record
  const float* sky_desc;      // atlas mode 0: the sky's descriptor row
  const int* texels_u32;      // the packed-RGB8 pool [n_texels], or null
  const float* texels;        // else the f32 pool [n_texels, tex_cols]
  int n_texels, tex_cols;
  const float* mat_rows;      // atlas mode 2: [n_mat, 16]
  int n_mat;
  int trows, tiles_x, width, height;  // post: the strip layout, the frame
};

// torch.clamp: NaN passes through
__device__ __forceinline__ float torch_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float torch_clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// shade._skybox_index of direction d (i32 arithmetic wraps, as torch's)
__device__ __forceinline__ int sky_index(const FinishParams& p, float d0, float d1,
                                         float d2) {
  const float pi = (float)3.14159265358979323846;
  const int theta = (int)((atan2f(d0, -d2) / pi) * ((float)0.5 * (float)p.sky_w));
  const int phi = (int)((acosf(torch_clamp(d1, -1.0f, 1.0f)) / pi) * (float)p.sky_h);
  return (int)((unsigned)phi * (unsigned)p.sky_w + (unsigned)theta + (unsigned)p.sky_off);
}

// one texel of the pool, [0, 1] (the index clamped into the pool)
__device__ __forceinline__ Rgb pool_texel(const FinishParams& p, int idx) {
  const int k = idx < 0 ? 0 : (idx > p.n_texels - 1 ? p.n_texels - 1 : idx);
  Rgb t;
  if (p.texels_u32 != nullptr) {
    const unsigned word = (unsigned)__ldg(p.texels_u32 + k);
    for (int c = 0; c < 3; ++c) t.c[c] = (float)((word >> (8 * c)) & 0xFFu) * (float)(1.0 / 255.0);
  } else {
    const float* row = p.texels + (size_t)k * p.tex_cols;
    for (int c = 0; c < 3; ++c) t.c[c] = __ldg(row + c);
  }
  return t;
}

template <int ATLAS, bool GI, bool POST>
__global__ void __launch_bounds__(256) finish_kernel(FinishParams p, float* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= p.n) return;
  int x = 0, y = 0;
  if (POST) {
    // the strip layout (render_fused.untile): tile r / trows of tiles_x
    // across, row r % trows in it
    const int r = i >> 7, tile = r / p.trows;
    x = (tile % p.tiles_x) * 128 + (i & 127);
    y = (tile / p.tiles_x) * p.trows + r % p.trows;
    if (x >= p.width || y >= p.height) return;
  }
  const size_t N = (size_t)p.n;
  const float* pl = p.planes + i;
  const float U8 = (float)(1.0 / 255.0);
  float res[3], men[3], sky[3] = {0.0f, 0.0f, 0.0f};
  for (int c = 0; c < 3; ++c) {
    res[c] = pl[c * N];
    men[c] = pl[(3 + c) * N];
  }
  if (ATLAS == 0) {
    // the deferred sky add: the sky's procedural texel at the sky index
    const int idx = sky_index(p, pl[6 * N], pl[7 * N], pl[8 * N]);
    const int rel = (int)((unsigned)idx - (unsigned)p.sky_off);
    int q = rel / p.sky_w, m = rel % p.sky_w;  // floor division and remainder
    if (m != 0 && (m < 0) != (p.sky_w < 0)) {
      q -= 1;
      m += p.sky_w;
    }
    const int jmax = (int)p.sky_desc[TEX_H] - 1;
    const int j = q < 0 ? 0 : (q > jmax ? jmax : q);
    const Rgb t = eval_texel(p.sky_desc, (float)m, (float)j);
    for (int c = 0; c < 3; ++c) sky[c] = t.c[c] * U8;
  } else {
    constexpr int K = Defer<ATLAS, GI>::K;
    float prod[3] = {1.0f, 1.0f, 1.0f};
    for (int b = 0; b < p.bounces; ++b) {
      const float* bp = pl + (size_t)(K * b + 9) * N;
      bool miss, hit;
      int tex_idx;
      float mat_b[3], coef[3], coef_a[3] = {0.0f, 0.0f, 0.0f};
      if (ATLAS == 1) {
        tex_idx = __float_as_int(bp[0]);
        miss = tex_idx < 0;
        hit = !miss;
        for (int c = 0; c < 3; ++c) {
          mat_b[c] = bp[(1 + c) * N];
          coef[c] = bp[(4 + c) * N];
          if (GI) coef_a[c] = bp[(7 + c) * N];
        }
      } else {
        // the material row by id; -1 (miss), -2 (dead) and ids out of
        // range read zeros
        const float mid = bp[0];
        float mat[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (mid >= 0.0f && mid < (float)p.n_mat) {
          const float* mr = p.mat_rows + (size_t)(long long)mid * 16;
          mat[0] = __ldg(mr);
          mat[1] = __ldg(mr + 1);
          mat[2] = __ldg(mr + 2);
          for (int k = 0; k < 4; ++k) mat[3 + k] = __ldg(mr + 8 + k);
        }
        const unsigned off_i = (unsigned)(int)mat[5] * (1u << CLRT_OFF_SHIFT) + (unsigned)(int)mat[6];
        const float uu = bp[N], vv = bp[2 * N];
        const int ui = (int)((uu - floorf(uu)) * mat[3]);
        const int vi = (int)((vv - floorf(vv)) * mat[4]);
        miss = mid == -1.0f;
        hit = mid >= 0.0f;
        tex_idx = hit ? (int)((unsigned)vi * (unsigned)(int)mat[3] + (unsigned)ui + off_i) : 0;
        for (int c = 0; c < 3; ++c) {
          mat_b[c] = rintf(torch_clamp(mat[c], 0.0f, 1.0f) * 255.0f);
          coef[c] = bp[(3 + c) * N];
          if (GI) coef_a[c] = bp[(6 + c) * N];
        }
      }
      const Rgb t = pool_texel(p, miss ? sky_index(p, pl[6 * N], pl[7 * N], pl[8 * N]) : tex_idx);
      for (int c = 0; c < 3; ++c) {
        const float color =
            floorf(mat_b[c] * rintf(t.c[c] * 255.0f) * (float)(1.0 / 256.0)) * U8;
        if (GI) {
          res[c] = (res[c] + coef[c] * color * prod[c]) + coef_a[c] * color;
          if (miss) sky[c] = sky[c] + t.c[c] * prod[c];
          if (hit) prod[c] = prod[c] * color;
        } else {
          res[c] = res[c] + coef[c] * color;
          if (miss) sky[c] = sky[c] + t.c[c];
        }
      }
    }
  }
  float v[3];
  for (int c = 0; c < 3; ++c) v[c] = res[c] + sky[c] * men[c];
  if (!POST) {
    for (int c = 0; c < 3; ++c) out[c * N + i] = v[c];
    return;
  }
  // ---- post._post_core: saturation, Reinhard, the merged pow, vignette
  const float piv = sqrtf(v[0] * v[0] * (float)0.299 + v[1] * v[1] * (float)0.587 +
                          v[2] * v[2] * (float)0.114);
  for (int c = 0; c < 3; ++c) v[c] = piv + (v[c] - piv) * (float)1.2;
  const float l_old = v[0] * (float)0.2126 + v[1] * (float)0.7152 + v[2] * (float)0.0722;
  const float l_new =
      l_old * (1.0f + l_old / (float)(0.8 * 0.8)) / (1.0f + l_old);
  const float scale = l_new / (l_old == 0.0f ? 1.0f : l_old);
  // post.vignette_mask_tiled's separable factors of the pixel
  const float s15 = sqrtf(15.0f);
  const float u = (float)x / (float)p.width, w = (float)y / (float)p.height;
  const float fu = powf(torch_clamp_min(u * (1.0f - u) * s15, 0.0f), (float)0.15);
  const float fv = powf(torch_clamp_min(w * (1.0f - w) * s15, 0.0f), (float)0.15);
  const float vig = fu * fv;
  float* o = out + ((size_t)y * p.width + x) * 3;
  for (int c = 0; c < 3; ++c) {
    o[c] = powf(torch_clamp_min(v[c] * scale, 0.0f), (float)(1.0 / (1.55 * 1.2))) * vig;
  }
}

template <int ATLAS, bool GI, bool POST>
static int launch_finish(const FinishParams* p, float* out, cudaStream_t st) {
  finish_kernel<ATLAS, GI, POST><<<(p->n + 255) / 256, 256, 0, st>>>(*p, out);
  return (int)cudaGetLastError();
}

// out: [3, n] radiance in strip order, or with p->post the [height, width,
// 3] image. Atlas mode 0 reads no deferred plane, so it has no GI
// instantiation: 10 instantiations.
extern "C" int clrt_finish(const FinishParams* p, float* out, void* stream) {
  if (p->n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool gi = p->gi != 0, post = p->post != 0;
  switch (p->atlas_mode) {
    case 0:
      return post ? launch_finish<0, false, true>(p, out, st)
                  : launch_finish<0, false, false>(p, out, st);
    case 1:
      if (gi) return post ? launch_finish<1, true, true>(p, out, st)
                          : launch_finish<1, true, false>(p, out, st);
      return post ? launch_finish<1, false, true>(p, out, st)
                  : launch_finish<1, false, false>(p, out, st);
    case 2:
      if (gi) return post ? launch_finish<2, true, true>(p, out, st)
                          : launch_finish<2, true, false>(p, out, st);
      return post ? launch_finish<2, false, true>(p, out, st)
                  : launch_finish<2, false, false>(p, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
