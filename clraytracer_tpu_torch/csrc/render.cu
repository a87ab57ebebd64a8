// K2.2 — fused forward frame: raygen, then per bounce traverse, shade
// (reference-parity integer-colour Phong with in-register procedural
// texels) and reflect, all per ray in registers.
//
// Replaces clraytracer_tpu/ops/render_pallas.py:_make_render_kernel
// (launched by _render_tiles, entry render_fused_camera) in its camera
// mode, atlas mode 0 (all-procedural textures), without shadows, GI or the
// split-rebin carry. Every shading formula keeps the JAX kernel's
// expression tree (which replicates ops/shade.py operation for operation);
// the equirect sky stays outside the kernel (ops/render_fused.py
// _finish_frame), as in the reference package: the kernel records each
// ray's throughput and direction at its first miss.
//
// Output [9, n] f32 planes: result rgb | miss energy rgb | miss dir xyz,
// ray i = row i / 128, lane i % 128 of the screen-tile order (a trows x 128
// pixel strip per trows rows).
//
// Bound on the H100: the traversal (traverse.cuh) dominates and is
// latency/issue-bound; shading is a few hundred FP32 operations per ray.
// The only DRAM traffic the frame needs is the 36 B/ray output plus the
// scene tables. Design: one thread per ray, 128 threads per block (one
// 128-pixel row of a strip), the material row and texture descriptor read
// directly by index instead of the TPU kernel's static select loops.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// No --use_fast_math: divisions and sqrtf stay IEEE, and 1.0f / sqrtf(x)
// is kept where the reference writes 1 / sqrt (never rsqrtf).
#include "traverse.cuh"

struct RenderParams {
  float cam[36];  // invProj (16) | invView (16) | position (3) | row0
  float sun_sin, sun_cos;
  const float* atm;       // [bounces, 3]: the f32 chain 0.255*0.4^b (etc.)
  const float* mat_rows;  // [M, 16]: albedo rgb | ... | aoff_hi aoff_lo @ 10, 11
  const float* tex;       // [D, 20]: procedural_tex.descriptor_row
  int n_mat, n_tex;
  int trows, tiles_x, width, height, n_rays, bounces;
};

// procedural_tex.descriptor_row columns
enum {
  TEX_OFF_HI = 0, TEX_OFF_LO, TEX_KIND, TEX_W, TEX_H, TEX_RGB0, TEX_RGB1 = 8,
  TEX_RATIO = 11, TEX_HALF, TEX_INV_HALF, TEX_GROUND, TEX_SUN_I = 17,
  TEX_SUN_J, TEX_SUN_R2, TEX_COLS
};
enum { KIND_CONSTANT = 0, KIND_CHECKER = 1, KIND_SKY = 2 };

// procedural_tex._eval at integer texel coords (i, j): byte values
__device__ __forceinline__ void eval_texel(const float* d, float i, float j,
                                           float rgb[3]) {
  const int kind = (int)d[TEX_KIND];
  if (kind == KIND_CONSTANT) {
    for (int c = 0; c < 3; ++c) rgb[c] = d[TEX_RGB0 + c];
  } else if (kind == KIND_CHECKER) {
    const float ci = floorf(i * d[TEX_RATIO]);
    const float cj = floorf(j * d[TEX_RATIO]);
    const bool odd = floorf((ci + cj) * 0.5f) * 2.0f != (ci + cj);
    for (int c = 0; c < 3; ++c) rgb[c] = odd ? d[TEX_RGB1 + c] : d[TEX_RGB0 + c];
  } else {
    const float half = d[TEX_HALF];
    const bool upper = j < half;
    const float jj = nan_min(j, half - 1.0f);
    for (int c = 0; c < 3; ++c) {
      const float z = d[TEX_RGB0 + c], hz = d[TEX_RGB1 + c];
      const float grad = floorf((z * (half - jj) + hz * jj) * d[TEX_INV_HALF]);
      rgb[c] = upper ? grad : d[TEX_GROUND + c];
    }
    const float dx = i - d[TEX_SUN_I];
    const float dy = j - d[TEX_SUN_J];
    if (dx * dx + dy * dy < d[TEX_SUN_R2]) {
      for (int c = 0; c < 3; ++c) rgb[c] = 255.0f;
    }
  }
}

__global__ void __launch_bounds__(128)
render_kernel(SceneTables s, RenderParams p, float* __restrict__ out,
              unsigned long long* counters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  TestCount cnt = {0ull, 0ull, 0ull, 0ull};
  if (i < p.n_rays) {
    // ---- raygen: strip tile -> pixel -> unproject (camera._unproject_grid)
    const int r = i / 128, lane = i % 128;
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

    // initial light = sun direction (shade.initial_bounce_state)
    float light[3] = {0.0f, p.sun_sin, p.sun_cos};
    float result[3] = {0.0f, 0.0f, 0.0f};
    float energy[3] = {1.0f, 1.0f, 1.0f};
    float men[3] = {0.0f, 0.0f, 0.0f};
    float mdir[3] = {0.0f, 0.0f, 0.0f};
    const float U8 = (float)(1.0 / 255.0);

    for (int b = 0; b < p.bounces; ++b) {
      Hit h;
      h.t = CLRT_BIG;
      h.u = 0.0f;
      h.v = 0.0f;
      h.slot = 0;
      h.inst = 0;
      traverse(s, o[0], o[1], o[2], d[0], d[1], d[2], h, cnt);
      if (!(h.t < CLRT_BIG)) {  // first miss: the sky is added outside
        for (int c = 0; c < 3; ++c) {
          men[c] = energy[c];
          mdir[c] = d[c];
        }
        break;
      }
      const HitAttrs a = interpolate(s, h, cnt);
      const float t = h.t;

      // ---- winning instance: world normal + object-space ray
      const float* m = s.inst + h.inst * 17;
      const float nw[3] = {
          a.nx * m[0] + a.ny * m[4] + a.nz * m[8],
          a.nx * m[1] + a.ny * m[5] + a.nz * m[9],
          a.nx * m[2] + a.ny * m[6] + a.nz * m[10]};
      float mo[3], md[3];
      for (int c = 0; c < 3; ++c) {
        mo[c] = o[0] * m[c] + o[1] * m[4 + c] + o[2] * m[8 + c] + m[12 + c];
        md[c] = d[0] * m[c] + d[1] * m[4 + c] + d[2] * m[8 + c];
      }
      const float sn = sqrtf(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2]);
      const float n[3] = {nw[0] / sn, nw[1] / sn, nw[2] / sn};

      // ---- material row, indexed directly (mat id is an f32-exact int)
      const float mat_idf = m[16] + a.mat;
      float alb[3] = {0.0f, 0.0f, 0.0f}, ahi = 0.0f, alo = 0.0f;
      if (mat_idf >= 0.0f && mat_idf < (float)p.n_mat) {
        const int mi = (int)mat_idf;
        if ((float)mi == mat_idf) {
          const float* mr = p.mat_rows + mi * 16;
          alb[0] = mr[0];
          alb[1] = mr[1];
          alb[2] = mr[2];
          ahi = mr[10];
          alo = mr[11];
        }
      }

      // ---- procedural texel, selected by (off_hi, off_lo); last match wins
      float texel[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < p.n_tex; ++k) {
        const float* td = p.tex + k * TEX_COLS;
        if (!(ahi == td[TEX_OFF_HI] && alo == td[TEX_OFF_LO])) continue;
        const float uw = a.uu - floorf(a.uu);
        const float ui = floorf(uw * td[TEX_W]);
        const float vw = a.vv - floorf(a.vv);
        const float vi = floorf(vw * td[TEX_H]);
        eval_texel(td, ui, vi, texel);
      }

      // ---- integer colour modulate (shade._modulate_bytes)
      float color[3];
      for (int c = 0; c < 3; ++c) {
        const float mat_b = rintf(fminf(fmaxf(alb[c], 0.0f), 1.0f) * 255.0f);
        color[c] = floorf(mat_b * texel[c] * (float)(1.0 / 256.0)) * U8;
      }

      // ---- Phong, reference-parity overrides (kernel_main.cl:248-271)
      const float ndl_raw =
          n[0] * (-light[0]) + n[1] * (-light[1]) + n[2] * (-light[2]);
      const float amb_m = nan_max(-ndl_raw, (float)0.1);
      const float ndl = nan_max(ndl_raw, 0.0f);
      const float spec_s = ((float)0.5 * ndl) * ndl;
      float rl[3];
      for (int c = 0; c < 3; ++c) rl[c] = (-light[c]) - n[c] * (2.0f * ndl_raw);
      const float rdm =
          nan_max(rl[0] * md[0] + rl[1] * md[1] + rl[2] * md[2], 0.0f);
      const float spec_light = (ndl * rdm) * (float)0.2;
      const float ndd = n[0] * d[0] + n[1] * d[1] + n[2] * d[2];
      const float dif = ndl;
      const float* atm = p.atm + b * 3;
      for (int c = 0; c < 3; ++c) {
        const float contrib =
            ((energy[c] * color[c]) * dif + (atm[c] * color[c]) * amb_m) +
            spec_light;
        result[c] = result[c] + contrib;
        energy[c] = energy[c] * ((float)0.2 * spec_s);
        const float new_o = (mo[c] + md[c] * t) + n[c] * (float)0.01;
        const float new_d = d[c] - n[c] * (2.0f * ndd);
        o[c] = new_o;
        d[c] = new_d;
        light[c] = new_d;
      }
    }
    const size_t N = (size_t)p.n_rays;
    for (int c = 0; c < 3; ++c) {
      out[c * N + i] = result[c];
      out[(3 + c) * N + i] = men[c];
      out[(6 + c) * N + i] = mdir[c];
    }
  }
  if (counters != nullptr) add_counts(counters, cnt);
}

extern "C" int clrt_render(const SceneTables* s, const RenderParams* p,
                           float* out, unsigned long long* counters,
                           void* stream) {
  if (p->n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (p->n_rays + threads - 1) / threads;
  render_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*s, *p, out,
                                                              counters);
  return (int)cudaGetLastError();
}
