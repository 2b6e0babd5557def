// Reverses the per-row filters of an 8-bit PNG image (PNG specification,
// section 9: None, Sub, Up, Average, Paeth), the host-side decoding step of
// sam_road_tpu_torch/data/png.py, which reads the dataset's tiles and masks
// where neither cv2 nor PIL is installed.
//
// The Average and Paeth filters predict each byte from the byte just
// reconstructed to its left, so a row is a serial chain of dependent steps
// that numpy cannot vectorise (about 4 M steps per 2048 px RGB tile). Here
// each step is a few integer operations.
//
// Built with g++ at first use (sam_road_tpu_torch/_native.py) and called
// through ctypes.

#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

// in: height rows of (1 filter-type byte + row_bytes filtered bytes);
// out: height * row_bytes reconstructed bytes; bpp: bytes per pixel.
// Returns 0, or 1 + the index of the first row with an unknown filter type.
extern "C" int64_t samroad_png_unfilter(const uint8_t* in, int64_t height,
                                        int64_t row_bytes, int64_t bpp,
                                        uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* f = in + y * (row_bytes + 1);
    const uint8_t kind = *f++;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* prev = y > 0 ? cur - row_bytes : nullptr;
    if (kind > 4) return y + 1;
    for (int64_t x = 0; x < row_bytes; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = prev ? prev[x] : 0;
      const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int pred = 0;
      switch (kind) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: break;
      }
      cur[x] = static_cast<uint8_t>(f[x] + pred);
    }
  }
  return 0;
}
