// PNG scanline unfiltering (native runtime path of scene/imagefile.py).
//
// The decoder inflates a PNG's IDAT stream with zlib in Python; what is
// left is one filter-type byte per scanline followed by the filtered bytes,
// and undoing the five filters (PNG spec section 9) is a sequential
// byte-by-byte recurrence that numpy cannot vectorise for Average and
// Paeth. Exposed via a C ABI for ctypes; scene/imagefile.py keeps a Python
// version for when the library is unavailable.

#include <cstdlib>

extern "C" {

// src: height scanlines of (1 + stride) bytes, filter type first; dst:
// height * stride bytes. bpp: bytes per complete pixel (at least 1).
// Returns 0, or -(y + 1) when scanline y has a filter type outside 0-4.
long clrt_png_unfilter(const unsigned char* src, long height, long stride,
                       int bpp, unsigned char* dst) {
  for (long y = 0; y < height; ++y) {
    const unsigned char* in = src + y * (stride + 1) + 1;
    const unsigned ft = in[-1];
    unsigned char* out = dst + y * stride;
    const unsigned char* up = y > 0 ? out - stride : nullptr;
    for (long i = 0; i < stride; ++i) {
      const int a = i >= bpp ? out[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -(y + 1);
      }
      out[i] = (unsigned char)(in[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
