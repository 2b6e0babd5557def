// Greedy score-ordered point NMS for vertex extraction and the label NMS,
// called through ctypes by sam_road_tpu_torch/graph/nms.py, with the
// semantics of the reference's nms_points (graph_utils.py:572-591): points
// are visited in descending score order (the caller sorts them); a point
// still kept when it is visited clears every point within `radius`
// (float64, squared distance <= radius^2) whose score is not above 1.0,
// earlier-visited points included, and stays kept itself.
//
// A point whose score is above 1.0 is immune: nothing ever clears it, so it
// is always kept and no neighbour search ever needs to find it. Only the
// suppressible points (score <= 1.0) go into the uniform grid, whose cells
// are `radius` wide (1.0 for a radius <= 0); every kept point, immune or
// not, scans the 3 x 3 cells around its own and so touches only points it
// can clear. Where no point is suppressible, as in the keypoint and road
// passes over uint8 mask values, there is no grid and the pass is O(n).
//
// Built with g++ at first use (sam_road_tpu_torch/_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// pts: [n, 2] float64 (x, y), sorted by descending score; scores: [n] in the
// same order. Writes kept_out [n] (1 = kept) and, into *n_grid_out, how many
// points entered the grid (the suppressible ones). Returns the kept count.
int64_t samroad_nms(const double* pts, const double* scores, int64_t n,
                    double radius, uint8_t* kept_out, int64_t* n_grid_out) {
  *n_grid_out = 0;
  if (n <= 0) return 0;
  std::fill(kept_out, kept_out + n, 1);

  std::vector<int32_t> grid_pts;  // the suppressible points, in visiting order
  for (int64_t i = 0; i < n; i++)
    if (!(scores[i] > 1.0)) grid_pts.push_back(static_cast<int32_t>(i));
  const int64_t m = static_cast<int64_t>(grid_pts.size());
  *n_grid_out = m;
  if (m == 0) return n;  // every point immune: all kept

  const double cell = radius > 0 ? radius : 1.0;
  const double r2 = radius * radius;

  // Cells of the grid points; the grid spans their bounding box.
  std::vector<int64_t> gcx(m), gcy(m);
  int64_t xmin = INT64_MAX, ymin = INT64_MAX, xmax = INT64_MIN, ymax = INT64_MIN;
  for (int64_t k = 0; k < m; k++) {
    const int64_t j = grid_pts[k];
    gcx[k] = static_cast<int64_t>(std::floor(pts[2 * j] / cell));
    gcy[k] = static_cast<int64_t>(std::floor(pts[2 * j + 1] / cell));
    xmin = std::min(xmin, gcx[k]);
    xmax = std::max(xmax, gcx[k]);
    ymin = std::min(ymin, gcy[k]);
    ymax = std::max(ymax, gcy[k]);
  }
  const int64_t nx = xmax - xmin + 1, ny = ymax - ymin + 1;

  // Counting sort by cell: offsets [nx * ny + 1]; each cell's points, with
  // their coordinates beside them for the scans, in `items` / `xy`.
  std::vector<int64_t> offsets(nx * ny + 1, 0);
  for (int64_t k = 0; k < m; k++) offsets[(gcx[k] - xmin) * ny + (gcy[k] - ymin) + 1]++;
  for (int64_t c = 0; c < nx * ny; c++) offsets[c + 1] += offsets[c];
  std::vector<int32_t> items(m);
  std::vector<double> xy(2 * m);
  {
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t k = 0; k < m; k++) {
      const int64_t s = cursor[(gcx[k] - xmin) * ny + (gcy[k] - ymin)]++;
      const int32_t j = grid_pts[k];
      items[s] = j;
      xy[2 * s] = pts[2 * j];
      xy[2 * s + 1] = pts[2 * j + 1];
    }
  }

  for (int64_t i = 0; i < n; i++) {
    if (!kept_out[i]) continue;
    const double px = pts[2 * i], py = pts[2 * i + 1];
    // the point's cell, compared in double first: a point far outside the
    // grid has no neighbour in it
    const double fx = std::floor(px / cell), fy = std::floor(py / cell);
    if (!(fx >= static_cast<double>(xmin) - 1 && fx <= static_cast<double>(xmax) + 1 &&
          fy >= static_cast<double>(ymin) - 1 && fy <= static_cast<double>(ymax) + 1))
      continue;
    const int64_t gx = static_cast<int64_t>(fx) - xmin, gy = static_cast<int64_t>(fy) - ymin;
    const int64_t y0 = std::max<int64_t>(gy - 1, 0), y1 = std::min(gy + 1, ny - 1);
    for (int64_t x = std::max<int64_t>(gx - 1, 0); x <= std::min(gx + 1, nx - 1); x++) {
      // cells (x, y0..y1) are contiguous in the counting sort
      const int64_t lo = offsets[x * ny + y0], hi = offsets[x * ny + y1 + 1];
      for (int64_t s = lo; s < hi; s++) {
        const double ddx = xy[2 * s] - px;
        const double ddy = xy[2 * s + 1] - py;
        if (ddx * ddx + ddy * ddy <= r2) kept_out[items[s]] = 0;
      }
    }
    kept_out[i] = 1;
  }
  int64_t n_kept = 0;
  for (int64_t i = 0; i < n; i++) n_kept += kept_out[i];
  return n_kept;
}

}  // extern "C"
