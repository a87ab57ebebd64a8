// QuickLZ 1.5 level-1 container codec (decompress + compress) — an
// independent re-implementation from the wire format, used to read AND
// write the reference's `.clm` mesh caches (AssetManager.cpp:310-361
// stores the Tri arena as one quicklz level-1 stream when >= 1000 tris).
//
// Wire format (little-endian):
//   byte 0       flags: bit0 = compressed, bit1 = wide header,
//                bits 2..3 = level
//   sizes        compressed/decompressed byte counts, u8 pair (narrow) or
//                u32 pair (wide), compressed first; counts include the header
//   payload      raw bytes when bit0 = 0, else a level-1 token stream
//
// Level-1 token stream: one 32-bit control word at a time, flags consumed
// LSB-first — 1 = match, 0 = literal run. Matches do not carry an offset;
// both sides maintain a 4096-entry table mapping hash(next 3 output bytes)
// -> output position, updated in lockstep over every emitted position
// outside match bodies (plus each match's first position), and the match
// token's 12-bit hash field selects the table entry. Short match tokens
// (2 bytes) encode length 3..17 in the low nibble; a zero nibble extends
// the token to 3 bytes with a raw 8-bit length. The final 10 bytes of the
// output are always literal-coded (the "tail"), where exhausted control
// words are skipped without decoding.

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t read_le(const unsigned char* p, int nbytes) {
  uint64_t v = 0;
  for (int i = 0; i < nbytes; i++) v |= (uint64_t)p[i] << (8 * i);
  return v;
}

inline uint32_t hash3(const unsigned char* p) {
  uint32_t f = (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
  return ((f >> 12) ^ f) & 0xfffu;
}

// number of literal flags consumable at once given the low 4 control bits
// (= min(count_trailing_zeros, 4); index is even because bit0 is 0 here)
const unsigned char kLitRun[16] = {4, 0, 1, 0, 2, 0, 1, 0,
                                   3, 0, 1, 0, 2, 0, 1, 0};

}  // namespace

extern "C" {

// Decompressed size a container claims, or -1 on malformed input.
long long clrt_qlz_dsize(const unsigned char* src, long long src_len) {
  if (src_len < 3) return -1;
  const int n = (src[0] & 2) ? 4 : 1;
  if (src_len < 1 + 2 * n) return -1;
  return (long long)read_le(src + 1 + n, n);
}

// Decode one container into dst (capacity dst_cap). Returns the number of
// bytes produced, or -1 on malformed/unsupported input.
long long clrt_qlz_decompress(const unsigned char* src, long long src_len,
                              unsigned char* dst, long long dst_cap) {
  if (src_len < 3) return -1;
  const unsigned flags = src[0];
  const int n = (flags & 2) ? 4 : 1;
  const long long header = 1 + 2 * n;
  if (src_len < header) return -1;
  const long long csize = (long long)read_le(src + 1, n);
  const long long dsize = (long long)read_le(src + 1 + n, n);
  if (dsize > dst_cap || csize > src_len || csize < header) return -1;

  const unsigned char* in = src + header;
  const unsigned char* in_end = src + csize;

  if (!(flags & 1)) {  // stored container
    if (in_end - in < dsize) return -1;
    memcpy(dst, in, (size_t)dsize);
    return dsize;
  }
  if (((flags >> 2) & 3) != 1) return -1;  // only level 1 is used by .clm

  uint32_t table[4096] = {0};  // hash -> output position
  long long d = 0;             // output cursor
  long long hashed = -1;       // last output index recorded in the table
  uint32_t cw = 1;             // sentinel: fetch a control word immediately
  const long long tail_start = dsize - 1 - 6 - 4;  // match-free zone

  auto record_upto = [&](long long upto) {
    while (hashed < upto) {
      ++hashed;
      table[hash3(dst + hashed)] = (uint32_t)hashed;
    }
  };

  for (;;) {
    if (cw == 1) {
      if (in + 4 > in_end) return -1;
      cw = (uint32_t)read_le(in, 4);
      in += 4;
    }
    if (cw & 1) {  // match token
      cw >>= 1;
      if (in + 2 > in_end) return -1;
      const uint32_t tok = (uint32_t)in[0] | (uint32_t)in[1] << 8;
      const long long from = (long long)table[(tok >> 4) & 0xfffu];
      long long len;
      if (tok & 0xf) {
        len = (long long)(tok & 0xf) + 2;
        in += 2;
      } else {
        if (in + 3 > in_end) return -1;
        len = in[2];
        in += 3;
      }
      if (d + len > dsize || from >= d) return -1;
      for (long long i = 0; i < len; i++) dst[d + i] = dst[from + i];
      record_upto(d);  // the match's first position enters the table
      d += len;
      hashed = d - 1;  // the body does not
    } else if (d < tail_start) {  // literal run (1..4 bytes)
      const unsigned run = kLitRun[cw & 0xf];
      if (in + run > in_end || d + run > dsize) return -1;
      for (unsigned i = 0; i < run; i++) dst[d + i] = in[i];
      cw >>= run;
      d += run;
      in += run;
      record_upto(d - 3);
    } else {  // literal tail: flags still tick, control words skipped raw
      while (d < dsize) {
        if (cw == 1) {
          in += 4;
          cw = 1u << 31;
        }
        if (in >= in_end) return -1;
        dst[d++] = *in++;
        cw >>= 1;
      }
      return dsize;
    }
  }
}

// Encode one level-1 container (wide 9-byte header) into dst. Returns the
// container byte count, or -1 when the input is too small (< 16 bytes), the
// output would not fit in dst_cap, or compression failed to beat a stored
// container (callers fall back to the stored form in those cases).
//
// The encoder maintains the hash table with exactly the DECODER's update
// discipline (literal positions lazily up to cursor-3, each match's first
// position, match bodies skipped), so at every match token the two tables
// agree by construction and the emitted 12-bit hash field resolves to the
// verified source position on the decode side. That mirroring also makes
// every match offset >= 3 automatically (table entries are either literal
// positions <= pos-3 or starts of earlier >=3-byte matches), satisfying the
// reference decoder's MINOFFSET memory-safety check. Matches start at
// pos <= dsize-11 and end by dsize-5, matching the reference encoder's
// bounds (the final bytes are always literal-coded so both decoders finish
// in their literal-tail branch).
long long clrt_qlz_compress(const unsigned char* src, long long n,
                            unsigned char* dst, long long dst_cap) {
  const long long header = 9;
  if (n < 16 || n > 0xffffffffLL - 400) return -1;
  if (dst_cap < header + 8) return -1;

  unsigned char* out = dst + header;
  unsigned char* out_end = dst + dst_cap;
  uint32_t table[4096] = {0};
  long long hashed = -1;  // last source index recorded in the table

  auto record_upto = [&](long long upto) {
    while (hashed < upto) {
      ++hashed;
      table[hash3(src + hashed)] = (uint32_t)hashed;
    }
  };
  auto write_le32 = [](unsigned char* p, uint32_t v) {
    p[0] = (unsigned char)v;
    p[1] = (unsigned char)(v >> 8);
    p[2] = (unsigned char)(v >> 16);
    p[3] = (unsigned char)(v >> 24);
  };

  unsigned char* cw_ptr = out;  // current control word's slot
  out += 4;
  uint32_t cw_bits = 0;
  int cw_n = 0;
  bool ok = true;
  // flags fill LSB-first; a full word holds 31 + the bit-31 sentinel, and
  // the next word's slot is reserved right before the 32nd token's payload
  // (where the decoder will fetch it)
  auto put_flag = [&](uint32_t bit) {
    if (cw_n == 31) {
      write_le32(cw_ptr, cw_bits | (1u << 31));
      if (out + 4 > out_end) {
        ok = false;
        return;
      }
      cw_ptr = out;
      out += 4;
      cw_bits = 0;
      cw_n = 0;
    }
    cw_bits |= bit << cw_n;
    ++cw_n;
  };

  const long long last_matchstart = n - 11;
  long long pos = 0;
  while (pos < n) {
    long long len = 0;
    uint32_t h = 0;
    if (pos <= last_matchstart) {
      h = hash3(src + pos);
      const long long o = (long long)table[h];
      if (o + 3 <= pos && src[o] == src[pos] && src[o + 1] == src[pos + 1] &&
          src[o + 2] == src[pos + 2]) {
        long long cap = n - 5 - pos;
        if (cap > 255) cap = 255;
        len = 3;
        while (len < cap && src[o + len] == src[pos + len]) ++len;
      }
    }
    if (len >= 3) {
      put_flag(1);
      if (!ok || out + 3 > out_end) return -1;
      const uint32_t tok = (h << 4) | (len <= 17 ? (uint32_t)(len - 2) : 0u);
      out[0] = (unsigned char)tok;
      out[1] = (unsigned char)(tok >> 8);
      out += 2;
      if (len > 17) *out++ = (unsigned char)len;
      record_upto(pos);  // the match's first position enters the table
      pos += len;
      hashed = pos - 1;  // the body does not
    } else {
      put_flag(0);
      if (!ok || out >= out_end) return -1;
      *out++ = src[pos++];
      record_upto(pos - 3);
    }
  }
  write_le32(cw_ptr, cw_bits | (1u << cw_n));

  const long long csize = out - dst;
  if (csize >= n + header) return -1;  // a stored container would be smaller
  dst[0] = 0x47;  // compressed | wide sizes | level 1 | quicklz bit 6
  write_le32(dst + 1, (uint32_t)csize);
  write_le32(dst + 5, (uint32_t)n);
  return csize;
}

}  // extern "C"
