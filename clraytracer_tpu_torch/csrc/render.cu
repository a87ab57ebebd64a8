// K2.2 — fused forward frame: raygen, then per bounce traverse, shade
// (reference-parity integer-colour Phong) and continue, per ray in
// registers.
//
// Replaces clraytracer_tpu/ops/render_pallas.py:_make_render_kernel
// (launched by _render_tiles, entry render_fused_camera) in its camera
// mode, with its options as template parameters (atlas_mode, shadows, gi):
//  * atlas mode 0 (every texture procedural): texels evaluated per ray in
//    registers, the full Phong sum accumulated here;
//  * atlas modes 1 and 2 (imported textures): the kernel is texel-blind.
//    Radiance is linear in the albedo texel under reference-parity
//    shading, so only spec_light is accumulated and each bounce emits
//    deferred planes; ops/render_fused.py _finish_frame gathers every
//    bounce's texels (and the sky's) at once. Mode 1 (M <= 64 materials)
//    reads the material row and emits the texel-pool index; mode 2 reads
//    no material data and emits the material id and (uu, vv);
//  * shadows: on bounce 0 every lane walks a second ray from the offset
//    hit point toward the sun, in traverse.cuh's any-hit mode; an occluded
//    hit loses dif, spec_s and spec_light (render_pallas.py:476-515);
//  * gi: Monte-Carlo continuation in a uniform hemisphere direction with
//    throughput colour * 2 cos(theta) (render_pallas.py:542-604), from a
//    per-ray Wang-hash/xorshift32 stream seeded by the ray's strip index.
// Not ported: ray mode and the split-rebin carry. Every shading formula
// keeps the JAX kernel's expression tree (which replicates ops/shade.py);
// the equirect sky stays outside the kernel: each ray's throughput and
// direction at its first miss are recorded.
//
// Output [9 + K*B, n] f32 planes: result rgb | miss energy rgb | miss dir
// xyz, then for bounce b the K deferred planes at 9 + K*b (atlas modes):
// mode 1 (K = 7): pool index (i32 bits; -1 miss now, 0 dead) | material
// colour bytes rgb | coefficient E*dif + atm*amb rgb; mode 2 (K = 6):
// material id (-1 miss now, -2 dead) | uu | vv | coefficient rgb. With gi
// the coefficient splits into E*dif and, as 3 more planes, atm*amb.
// Lanes that are not shaded at a bounce write zeros beside the sentinel.
// Ray i = row i / 128, lane i % 128 of the screen-tile order (a trows x
// 128 pixel strip per trows rows).
//
// Bound on the H100: its least time is the output bytes in a small scene
// (36 B/ray, plus 4 K B bytes a ray in the atlas modes) and the walk's
// operations in a large one; shading is a few hundred FP32 operations per
// hit ray, GI about 80 more. What holds it above both is the traversal's
// latency (traverse.cuh). Design here: a block of 128 threads is four
// warps; each warp takes an 8 x 4 pixel tile (4 consecutive strip rows, 32
// columns per block), so the warp's bounce-0 rays are coherent in both
// screen directions, and writes its outputs at their strip-order index i.
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
};

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
template <int ATLAS, bool SHADOWS, bool GI>
__device__ __forceinline__ void render_frame(const SceneTables& s,
                                             const RenderParams& p,
                                             float* __restrict__ out,
                                             unsigned long long* counters,
                                             unsigned long long* shadow_counters) {
  constexpr int K = Defer<ATLAS, GI>::K;
  __shared__ WarpStage stage[4];
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  // block b: strip rows 4 (b / 4) .. + 3, columns 32 (b % 4) .. + 31; its
  // warp w takes columns + 8 w .. + 8 w + 7 of those rows
  const int r = (blockIdx.x >> 2) * 4 + (wl >> 3);
  const int lane = (blockIdx.x & 3) * 32 + warp * 8 + (wl & 7);
  const int i = r * 128 + lane;
  const bool valid = i < p.n_rays;
  TestCount cnt = {0ull, 0ull, 0ull, 0ull, 0ull, 0ull};

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
  float d[3] = {wx * rn, wy * rn, wz * rn};
  float o[3] = {p.cam[32], p.cam[33], p.cam[34]};

  float result[3] = {0.0f, 0.0f, 0.0f};
  float energy[3] = {1.0f, 1.0f, 1.0f};
  const float U8 = (float)(1.0 / 255.0);
  const size_t N = (size_t)p.n_rays;

  // Only the state that later bounces read stays in registers across the
  // walk: the miss planes are written at the first miss, and the light
  // direction is the sun's at bounce 0 (shade.initial_bounce_state) and the
  // ray's own direction after every continuation.
  bool alive = valid;  // no miss yet
  bool missed = false;
  int b = 0;
  for (; b < p.bounces; ++b) {
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
    const float* m = s.inst;
    float n[3] = {0.0f, 0.0f, 0.0f}, md[3] = {0.0f, 0.0f, 0.0f};
    float new_o[3] = {0.0f, 0.0f, 0.0f};
    const float t = h.t;
    if (alive) {
      a = interpolate(s, h, cnt);
      m = s.inst + h.inst * 17;
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
    }

    // ---- sun shadow on bounce 0: every lane walks, the unshaded ones as
    // rays that pass nothing; an occluded hit keeps only the ambient term.
    // Any hit will do (traverse.cuh's any-hit mode). Its counts go out on
    // their own: the warp's counts so far first, then the walk's to both
    // counter sets.
    float shadow = 1.0f;
    if (SHADOWS && b == 0) {
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
      // ---- material row, indexed directly (mat id is an f32-exact int)
      const float mat_idf = m[16] + a.mat;
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
      const float light[3] = {b == 0 ? 0.0f : d[0], b == 0 ? p.sun_sin : d[1],
                              b == 0 ? p.sun_cos : d[2]};
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
  if (counters != nullptr) add_counts(counters, cnt);
}

// Register bounds, one per kind of instantiation. Without shadows: 128
// threads and no floor on resident blocks, under which ptxas keeps the
// default frame at 126 registers without spills (16 warps an SM). With
// shadows the two walks' state overlaps on bounce 0, and the same bound
// made ptxas cap them at 96 registers and spill 170-182 bytes; a floor of
// one resident block lets them take what they need (a floor of 4, capping
// them at 128 registers, was slower: PERF.md).
template <int ATLAS, bool GI>
__global__ void __launch_bounds__(128)
render_kernel(SceneTables s, RenderParams p, float* __restrict__ out,
              unsigned long long* counters) {
  render_frame<ATLAS, false, GI>(s, p, out, counters, nullptr);
}

template <int ATLAS, bool GI>
__global__ void __launch_bounds__(128, 1)
render_shadow_kernel(SceneTables s, RenderParams p, float* __restrict__ out,
                     unsigned long long* counters,
                     unsigned long long* shadow_counters) {
  render_frame<ATLAS, true, GI>(s, p, out, counters, shadow_counters);
}

template <int ATLAS, bool SHADOWS, bool GI>
static int launch(const SceneTables* s, const RenderParams* p, float* out,
                  unsigned long long* counters, unsigned long long* shadow_counters,
                  cudaStream_t stream, int blocks) {
  if constexpr (SHADOWS) {
    render_shadow_kernel<ATLAS, GI><<<blocks, 128, 0, stream>>>(*s, *p, out, counters,
                                                                shadow_counters);
  } else {
    render_kernel<ATLAS, GI><<<blocks, 128, 0, stream>>>(*s, *p, out, counters);
  }
  return (int)cudaGetLastError();
}

// shadow_counters: optional int64[6], the shadow walk's counts alone (it
// needs p->shadows; counters, when given, count both walks as before).
extern "C" int clrt_render(const SceneTables* s, const RenderParams* p,
                           float* out, unsigned long long* counters,
                           unsigned long long* shadow_counters, void* stream) {
  if (p->n_rays <= 0) return 0;
  if (shadow_counters != nullptr && !p->shadows) return (int)cudaErrorInvalidValue;
  const int rows = (p->n_rays + 127) / 128;
  const int blocks = (rows + 3) / 4 * 4;  // four blocks per 4 strip rows
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* sc = shadow_counters;
  const int sel = p->atlas_mode * 4 + (p->shadows ? 2 : 0) + (p->gi ? 1 : 0);
  switch (sel) {
    case 0: return launch<0, false, false>(s, p, out, counters, sc, st, blocks);
    case 1: return launch<0, false, true>(s, p, out, counters, sc, st, blocks);
    case 2: return launch<0, true, false>(s, p, out, counters, sc, st, blocks);
    case 3: return launch<0, true, true>(s, p, out, counters, sc, st, blocks);
    case 4: return launch<1, false, false>(s, p, out, counters, sc, st, blocks);
    case 5: return launch<1, false, true>(s, p, out, counters, sc, st, blocks);
    case 6: return launch<1, true, false>(s, p, out, counters, sc, st, blocks);
    case 7: return launch<1, true, true>(s, p, out, counters, sc, st, blocks);
    case 8: return launch<2, false, false>(s, p, out, counters, sc, st, blocks);
    case 9: return launch<2, false, true>(s, p, out, counters, sc, st, blocks);
    case 10: return launch<2, true, false>(s, p, out, counters, sc, st, blocks);
    case 11: return launch<2, true, true>(s, p, out, counters, sc, st, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
