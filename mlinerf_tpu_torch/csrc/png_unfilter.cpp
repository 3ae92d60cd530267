// PNG row unfiltering (the PNG specification, section 9): undoes the five
// scanline filters after inflate, on the rows of a whole image or of one
// Adam7 pass, at any bit depth (bpp: bytes per complete pixel, at least 1).
//
// Host library with a plain C interface, built with g++ into
// build/libpng_unfilter.so and loaded with ctypes by utils/image_io.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// raw: h rows of (1 filter byte + stride bytes), as inflate gives them.
// out: h x stride bytes of reconstructed samples. bpp: bytes per pixel.
// Returns -1 on success, else the first row whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t ftype = src[0];
    ++src;
    uint8_t* row = out + y * stride;
    const uint8_t* prior = y > 0 ? out + (y - 1) * stride : nullptr;
    switch (ftype) {
      case 0:  // None
        std::memcpy(row, src, stride);
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? row[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (prior ? prior[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? row[i - bpp] : 0;
          const int up = prior ? prior[i] : 0;
          row[i] = static_cast<uint8_t>(src[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          row[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

}  // extern "C"
