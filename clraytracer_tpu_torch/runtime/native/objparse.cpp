// Fast OBJ parser (native runtime path).
//
// Clean-room C++ equivalent of the reference's char-level importer
// (AssetManager.cpp:90-289): single pass over the file text, custom float
// parsing, fan triangulation, v/vt/vn index resolution (1-based and
// negative-relative). Exposed via a C ABI for ctypes; Python keeps the MTL
// handling and quantization (scene/obj.py), and falls back to the pure
// Python parser when the native library is unavailable.
//
// Output layout is SoA: positions/uvs/normals accumulation arrays plus
// per-corner resolved indices and a per-face material statement id (the id
// of the last 'usemtl' statement seen — Python maps statement ids to
// material names).

#include <cstdint>
#include <cstring>

namespace {

inline bool is_ws(char c) { return c == ' ' || c == '\t' || c == '\r'; }
inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// Parse a float, advancing p. Handles sign, decimals, exponents.
inline const char* parse_float(const char* p, const char* end, float* out) {
  while (p < end && is_ws(*p)) ++p;
  double sign = 1.0;
  if (p < end && (*p == '-' || *p == '+')) {
    if (*p == '-') sign = -1.0;
    ++p;
  }
  double num = 0.0;
  while (p < end && is_digit(*p)) num = num * 10.0 + (*p++ - '0');
  if (p < end && *p == '.') {
    ++p;
    double frac = 0.0, div = 1.0;
    while (p < end && is_digit(*p)) {
      frac = frac * 10.0 + (*p++ - '0');
      div *= 10.0;
    }
    num += frac / div;
  }
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    double esign = 1.0;
    if (p < end && (*p == '-' || *p == '+')) {
      if (*p == '-') esign = -1.0;
      ++p;
    }
    double ex = 0.0;
    while (p < end && is_digit(*p)) ex = ex * 10.0 + (*p++ - '0');
    double scale = 1.0;
    for (int i = 0; i < (int)ex; ++i) scale *= 10.0;
    num = esign > 0 ? num * scale : num / scale;
  }
  *out = (float)(sign * num);
  return p;
}

// Parse a (possibly signed) integer, advancing p. Returns 0 if absent.
inline const char* parse_int(const char* p, const char* end, long* out) {
  long sign = 1;
  if (p < end && *p == '-') {
    sign = -1;
    ++p;
  }
  long v = 0;
  bool any = false;
  while (p < end && is_digit(*p)) {
    v = v * 10 + (*p++ - '0');
    any = true;
  }
  *out = any ? sign * v : 0;
  return p;
}

inline const char* skip_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

// First pass: counts[0..4] = n_positions, n_uvs, n_normals, n_triangles,
// n_usemtl_statements. Returns 0.
int clrt_obj_count(const char* text, long len, long* counts) {
  const char* p = text;
  const char* end = text + len;
  long nv = 0, nt = 0, nn = 0, ntri = 0, nmtl = 0;
  while (p < end) {
    while (p < end && (is_ws(*p) || *p == '\n')) ++p;
    if (p >= end) break;
    if (p[0] == 'v' && p + 1 < end) {
      if (p[1] == ' ') ++nv;
      else if (p[1] == 't') ++nt;
      else if (p[1] == 'n') ++nn;
    } else if (p[0] == 'f' && p + 1 < end && is_ws(p[1])) {
      // count corners for fan triangulation
      const char* q = p + 1;
      int corners = 0;
      while (q < end && *q != '\n') {
        while (q < end && is_ws(*q)) ++q;
        if (q < end && (is_digit(*q) || *q == '-')) {
          ++corners;
          while (q < end && !is_ws(*q) && *q != '\n') ++q;
        } else if (q < end && *q != '\n') {
          ++q;
        }
      }
      if (corners >= 3) ntri += corners - 2;
    } else if (p[0] == 'u' && p + 6 <= end && std::memcmp(p, "usemtl", 6) == 0) {
      ++nmtl;
    }
    p = skip_line(p, end);
  }
  counts[0] = nv;
  counts[1] = nt;
  counts[2] = nn;
  counts[3] = ntri;
  counts[4] = nmtl;
  return 0;
}

// Second pass: fill SoA arrays sized from clrt_obj_count.
//   positions [nv*3], uvs [nt*2], normals [nn*3]
//   tri_pos/tri_uv/tri_n [ntri*3]: resolved 0-based indices (-1 = absent)
//   tri_stmt [ntri]: index of the last usemtl statement (-1 before any)
// Returns 0 on success.
int clrt_obj_parse(const char* text, long len, float* positions, float* uvs,
                   float* normals, int32_t* tri_pos, int32_t* tri_uv,
                   int32_t* tri_n, int32_t* tri_stmt) {
  const char* p = text;
  const char* end = text + len;
  long nv = 0, nt = 0, nn = 0, ntri = 0;
  int stmt = -1;

  long corner_pos[64], corner_uv[64], corner_n[64];

  while (p < end) {
    while (p < end && (is_ws(*p) || *p == '\n')) ++p;
    if (p >= end) break;
    if (p[0] == 'v' && p + 1 < end && p[1] == ' ') {
      p += 2;
      p = parse_float(p, end, &positions[nv * 3 + 0]);
      p = parse_float(p, end, &positions[nv * 3 + 1]);
      p = parse_float(p, end, &positions[nv * 3 + 2]);
      ++nv;
    } else if (p[0] == 'v' && p + 1 < end && p[1] == 't') {
      p += 2;
      p = parse_float(p, end, &uvs[nt * 2 + 0]);
      p = parse_float(p, end, &uvs[nt * 2 + 1]);
      ++nt;
    } else if (p[0] == 'v' && p + 1 < end && p[1] == 'n') {
      p += 2;
      p = parse_float(p, end, &normals[nn * 3 + 0]);
      p = parse_float(p, end, &normals[nn * 3 + 1]);
      p = parse_float(p, end, &normals[nn * 3 + 2]);
      ++nn;
    } else if (p[0] == 'f' && p + 1 < end && is_ws(p[1])) {
      p += 1;
      int corners = 0;
      while (p < end && *p != '\n' && corners < 64) {
        while (p < end && is_ws(*p)) ++p;
        if (p >= end || *p == '\n') break;
        long vi = 0, ti = 0, ni = 0;
        p = parse_int(p, end, &vi);
        if (p < end && *p == '/') {
          ++p;
          p = parse_int(p, end, &ti);
          if (p < end && *p == '/') {
            ++p;
            p = parse_int(p, end, &ni);
          }
        }
        // resolve: 1-based; negative = relative to current count; 0 = absent
        corner_pos[corners] = vi > 0 ? vi - 1 : (vi < 0 ? nv + vi : -1);
        corner_uv[corners] = ti > 0 ? ti - 1 : (ti < 0 ? nt + ti : -1);
        corner_n[corners] = ni > 0 ? ni - 1 : (ni < 0 ? nn + ni : -1);
        ++corners;
      }
      for (int k = 1; k + 1 < corners; ++k) {
        int c[3] = {0, k, k + 1};
        for (int j = 0; j < 3; ++j) {
          tri_pos[ntri * 3 + j] = (int32_t)corner_pos[c[j]];
          tri_uv[ntri * 3 + j] = (int32_t)corner_uv[c[j]];
          tri_n[ntri * 3 + j] = (int32_t)corner_n[c[j]];
        }
        tri_stmt[ntri] = stmt;
        ++ntri;
      }
    } else if (p[0] == 'u' && p + 6 <= end && std::memcmp(p, "usemtl", 6) == 0) {
      ++stmt;
    }
    p = skip_line(p, end);
  }
  return 0;
}

}  // extern "C"
