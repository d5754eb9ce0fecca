// Host-side kernel of the port's data runtime, called through ctypes: the
// port's copy of the JAX package's native unfilter, with the same C ABI.
//
// png_unfilter: PNG scanline unfiltering (RFC 2083 filters 0-4). The
// per-byte recurrences of the Sub, Average and Paeth filters are
// sequential along a row; here they run as a plain loop, where numpy has to
// sweep anti-diagonals (data/codecs.py::_unfilter, the plain version).

#include <cstdint>

extern "C" {

// data: h scanlines, each `stride` bytes of filtered bytes; filters[y] is
// scanline y's filter id. Unfilters in place; bpp = bytes per pixel (1 for
// bit depths below 8). Returns 0, or -1 on an unknown filter id.
int png_unfilter(uint8_t* data, int64_t h, int64_t stride, int64_t bpp,
                 const uint8_t* filters) {
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* row = data + y * stride;
    const uint8_t* prev = y > 0 ? data + (y - 1) * stride : nullptr;
    switch (filters[y]) {
      case 0:
        break;
      case 1:  // Sub
        for (int64_t i = bpp; i < stride; ++i) row[i] += row[i - bpp];
        break;
      case 2:  // Up
        if (prev)
          for (int64_t i = 0; i < stride; ++i) row[i] += prev[i];
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          unsigned left = i >= bpp ? row[i - bpp] : 0;
          unsigned up = prev ? prev[i] : 0;
          row[i] = static_cast<uint8_t>(row[i] + ((left + up) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? row[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          row[i] = static_cast<uint8_t>(row[i] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"
