// Raster drawing for the label masks, the graph overlays and the legacy A*
// cost fields: 8-connected lines of any thickness and filled circles, pixel
// for pixel as OpenCV's cv2.line (LINE_8) and cv2.circle(..., -1) draw them.
// The JAX package draws with cv2; the GPU machine has no cv2, and a label
// mask that differs by a pixel is a different training target, so this file
// follows cv2's integer arithmetic step by step instead of approximating it
// (held to cv2 by tests/test_torch_label_gen.py):
//
//  - thickness 1: Bresenham's walk from the left end, over the segment
//    clipped to the image (Cohen-Sutherland, the moved ends truncated);
//  - thickness t > 1: the segment is first clipped to the image grown by t
//    on every side; then a convex quadrilateral whose corners lie
//    ceil(t / 2) pixels to either side of it, in 16.16 fixed point, is
//    outlined with fixed-point 8-connected lines and scan-filled by walking
//    each side's x down the rows (the step per row rounded once, at the
//    side's first row), and a disk of radius ceil(t / 2) is set at each end;
//  - filled circles: the midpoint circle, a horizontal run on each row.
//
// Built with g++ at first use (sam_road_tpu_torch/_native.py) and called
// through ctypes by sam_road_tpu_torch/utils/viz.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>

namespace {

constexpr int kShift = 16;
constexpr int64_t kOne = int64_t{1} << kShift;

struct Canvas {
  uint8_t* data;
  int64_t h, w, ch;
  const uint8_t* color;

  void put(int64_t x, int64_t y) const {
    if (x >= 0 && x < w && y >= 0 && y < h) std::memcpy(data + (y * w + x) * ch, color, ch);
  }
  // the run x0..x1 (inclusive) of row y, clipped to the image
  void hline(int64_t x0, int64_t x1, int64_t y) const {
    if (y < 0 || y >= h) return;
    x0 = std::max<int64_t>(x0, 0);
    x1 = std::min<int64_t>(x1, w - 1);
    for (int64_t x = x0; x <= x1; ++x) std::memcpy(data + (y * w + x) * ch, color, ch);
  }
};

// Cohen-Sutherland clipping of the segment to [0, width) x [0, height), in
// the units of the points; the second end is moved with the first end's
// new position, and the moves truncate toward zero, as OpenCV's clipLine.
bool clip_line(int64_t width, int64_t height, int64_t& x1, int64_t& y1, int64_t& x2,
               int64_t& y2) {
  if (width <= 0 || height <= 0) return false;
  const int64_t right = width - 1, bottom = height - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += static_cast<int64_t>(static_cast<double>(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += static_cast<int64_t>(static_cast<double>(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += static_cast<int64_t>(static_cast<double>(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += static_cast<int64_t>(static_cast<double>(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// The one-pixel line between integer points: Bresenham from the left end,
// dx + 1 pixels along the major axis, the minor coordinate stepping when the
// error term is negative.
void line1(const Canvas& cv, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!(x1 >= 0 && x1 < cv.w && x2 >= 0 && x2 < cv.w && y1 >= 0 && y1 < cv.h && y2 >= 0 &&
        y2 < cv.h) &&
      !clip_line(cv.w, cv.h, x1, y1, x2, y2))
    return;
  int64_t dx = x2 - x1, dy = y2 - y1;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  int64_t sx = 1, sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  const bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy);
  const int64_t plus = dx + dx, minus = -(dy + dy);
  int64_t x = x1, y = y1;
  for (int64_t i = 0; i <= dx; ++i) {
    cv.put(x, y);
    const bool step_minor = err < 0;
    err += minus + (step_minor ? plus : 0);
    if (vert) {
      y += sy;
      if (step_minor) x += sx;
    } else {
      x += sx;
      if (step_minor) y += sy;
    }
  }
}

// The outline of a polygon side: an 8-connected line between 16.16
// fixed-point points, clipped to the image first (in the points' order),
// then walked left to right (x-major) or top to bottom (y-major) from the
// rounded first end, floor(length) + 1 pixels along the major axis, the
// minor coordinate advancing by the slope truncated to 1/65536; the rounded
// last end is set as well.
void line_fixed(const Canvas& cv, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!clip_line(cv.w << kShift, cv.h << kShift, x1, y1, x2, y2)) return;
  const int64_t ax = x2 > x1 ? x2 - x1 : x1 - x2, ay = y2 > y1 ? y2 - y1 : y1 - y2;
  const bool xmajor = ax > ay;
  if (xmajor ? x2 < x1 : y2 < y1) {
    std::swap(x1, x2);
    std::swap(y1, y2);
  }
  // a: the major coordinate, c: the minor one
  const int64_t a1 = xmajor ? x1 : y1, a2 = xmajor ? x2 : y2;
  const int64_t c1 = xmajor ? y1 : x1, c2 = xmajor ? y2 : x2;
  const int64_t step = ((c2 - c1) * kOne) / ((xmajor ? ax : ay) | 1);
  const int64_t first = (a1 + (kOne >> 1)) >> kShift, count = (a2 - a1) >> kShift;
  for (int64_t k = 0; k <= count; ++k) {
    const int64_t c = (c1 + (kOne >> 1) + k * step) >> kShift;
    if (xmajor)
      cv.put(first + k, c);
    else
      cv.put(c, first + k);
  }
  cv.put((x2 + (kOne >> 1)) >> kShift, (y2 + (kOne >> 1)) >> kShift);
}

// A convex polygon with 16.16 fixed-point corners: the outline, then one
// run per row between the two sides that walk down from the top corner.
void fill_convex(const Canvas& cv, const int64_t (*v)[2], int npts) {
  const int64_t delta = kOne >> 1;
  int64_t xmin = v[0][0], xmax = v[0][0], ymin = v[0][1], ymax = v[0][1];
  int imin = 0;
  int64_t px = v[npts - 1][0], py = v[npts - 1][1];
  for (int i = 0; i < npts; ++i) {
    if (v[i][1] < ymin) {
      ymin = v[i][1];
      imin = i;
    }
    ymax = std::max(ymax, v[i][1]);
    xmax = std::max(xmax, v[i][0]);
    xmin = std::min(xmin, v[i][0]);
    line_fixed(cv, px, py, v[i][0], v[i][1]);
    px = v[i][0];
    py = v[i][1];
  }
  xmin = (xmin + delta) >> kShift;
  xmax = (xmax + delta) >> kShift;
  ymin = (ymin + delta) >> kShift;
  ymax = (ymax + delta) >> kShift;
  if (npts < 3 || xmax < 0 || ymax < 0 || xmin >= cv.w || ymin >= cv.h) return;
  ymax = std::min(ymax, cv.h - 1);

  struct Side {
    int idx, di;
    int64_t x, dx, ye;
  } side[2];
  side[0].idx = side[1].idx = imin;
  side[0].ye = side[1].ye = ymin;
  side[0].di = 1;
  side[1].di = npts - 1;
  side[0].x = side[1].x = -kOne;
  side[0].dx = side[1].dx = 0;
  int edges = npts;
  int64_t y = ymin;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y < side[i].ye) continue;
      int idx0 = side[i].idx, di = side[i].di;
      int idx = idx0 + di;
      if (idx >= npts) idx -= npts;
      for (; edges-- > 0;) {
        const int64_t ty = (v[idx][1] + delta) >> kShift;
        if (ty > y) {
          const int64_t xs = v[idx0][0], xe = v[idx][0];
          side[i].ye = ty;
          side[i].dx = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
          side[i].x = xs;
          side[i].idx = idx;
          break;
        }
        idx0 = idx;
        idx += di;
        if (idx >= npts) idx -= npts;
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      const int left = side[0].x > side[1].x ? 1 : 0;
      const int64_t x1 = (side[left].x + delta) >> kShift;
      const int64_t x2 = (side[1 - left].x + delta) >> kShift;
      if (x2 >= 0 && x1 < cv.w) cv.hline(x1, x2, y);
    }
    side[0].x += side[0].dx;
    side[1].x += side[1].dx;
  } while (++y <= ymax);
}

// The filled midpoint circle: for each octant step (dx, dy), the runs of
// half-width dx on rows cy +- dy and of half-width dy on rows cy +- dx.
void disk(const Canvas& cv, int64_t cx, int64_t cy, int64_t radius) {
  int64_t err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  while (dx >= dy) {
    cv.hline(cx - dx, cx + dx, cy - dy);
    cv.hline(cx - dx, cx + dx, cy + dy);
    cv.hline(cx - dy, cx + dy, cy - dx);
    cv.hline(cx - dy, cx + dy, cy + dx);
    dy++;
    err += plus;
    plus += 2;
    const int64_t mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

void thick_line(const Canvas& cv, int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                int64_t thickness) {
  if (thickness <= 1) {
    line1(cv, x0, y0, x1, y1);
    return;
  }
  // the segment clipped to the image grown by the thickness on every side
  x0 += thickness;
  y0 += thickness;
  x1 += thickness;
  y1 += thickness;
  if (!clip_line(cv.w + 2 * thickness, cv.h + 2 * thickness, x0, y0, x1, y1)) return;
  x0 = (x0 - thickness) << kShift;
  y0 = (y0 - thickness) << kShift;
  x1 = (x1 - thickness) << kShift;
  y1 = (y1 - thickness) << kShift;
  const double inv_one = 1.0 / static_cast<double>(kOne);
  const double dx = static_cast<double>(x0 - x1) * inv_one;
  const double dy = static_cast<double>(y1 - y0) * inv_one;
  double r = dx * dx + dy * dy;
  const int64_t odd = thickness & 1;
  const int64_t half = thickness << (kShift - 1);  // t / 2 in fixed point
  if (r > 2.220446049250313e-16) {  // DBL_EPSILON: a zero-length segment draws only its caps
    r = (static_cast<double>(half) + static_cast<double>(odd) * kOne * 0.5) / std::sqrt(r);
    const int64_t ox = std::llrint(dy * r), oy = std::llrint(dx * r);
    const int64_t pt[4][2] = {
        {x0 + ox, y0 + oy}, {x0 - ox, y0 - oy}, {x1 - ox, y1 - oy}, {x1 + ox, y1 + oy}};
    fill_convex(cv, pt, 4);
  }
  const int64_t cap = (half + (kOne >> 1)) >> kShift;
  disk(cv, (x0 + (kOne >> 1)) >> kShift, (y0 + (kOne >> 1)) >> kShift, cap);
  disk(cv, (x1 + (kOne >> 1)) >> kShift, (y1 + (kOne >> 1)) >> kShift, cap);
}

}  // namespace

// img: h x w x ch uint8, row-major; color: ch bytes; segs: n x (x0, y0, x1,
// y1) integer pixel coordinates (any value: the drawing is clipped).
extern "C" void samroad_draw_lines(uint8_t* img, int64_t h, int64_t w, int64_t ch,
                                   const int64_t* segs, int64_t n, const uint8_t* color,
                                   int64_t thickness) {
  const Canvas cv{img, h, w, ch, color};
  for (int64_t i = 0; i < n; ++i)
    thick_line(cv, segs[4 * i], segs[4 * i + 1], segs[4 * i + 2], segs[4 * i + 3], thickness);
}

// centers: n x (x, y) integer pixel coordinates.
extern "C" void samroad_draw_disks(uint8_t* img, int64_t h, int64_t w, int64_t ch,
                                   const int64_t* centers, int64_t n, const uint8_t* color,
                                   int64_t radius) {
  const Canvas cv{img, h, w, ch, color};
  for (int64_t i = 0; i < n; ++i) disk(cv, centers[2 * i], centers[2 * i + 1], radius);
}
