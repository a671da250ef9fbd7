// Outer borders of a binary mask, the contours cv2.findContours(m, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
// gives (OpenCV 5.0, imgproc/src/contours.cpp: cvFindNextContour, icvFetchContour).
//
// The Suzuki-Abe border follower as OpenCV runs it for RETR_EXTERNAL: the mask (any nonzero byte is
// foreground, 8-connected) is framed by one row and column of background, so pixels on the image's
// edge are followed like any other; a raster scan starts an outer border at each 0 -> 1 step whose
// last marked border pixel on the row is not a component's left side, so holes and their islands are
// never followed. Each border is followed counter-clockwise from its first pixel, marking its pixels
// (2, or -126 where the border leaves the pixel on its right), and CHAIN_APPROX_SIMPLE keeps a point
// where the chain's direction changes. The contours come out in OpenCV's order: the last border found
// first. Host C++ behind a plain C interface, built by the host compiler (kernels/build.py) and bound
// with ctypes (ops/contours.py find_external_contours).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// the 8 chain codes: 0 right, then counter-clockwise on the screen (y down): 2 up, 4 left, 6 down
constexpr int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
constexpr int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
constexpr int8_t kMark = 2;     // a followed border pixel
constexpr int8_t kRight = -126;  // 2 | -128: a followed border pixel whose right neighbour is background

struct Contours {
  std::vector<int32_t> pts;     // x, y of every point, contour after contour, in the order found
  std::vector<int32_t> counts;  // points per contour, in the order found
};

// Follow the outer border that starts at flat index i0 (pixel x, y of the unframed mask) through the
// framed buffer img of row pitch step, marking it; append its CHAIN_APPROX_SIMPLE points to out.
void follow(int8_t* img, int64_t i0, int x, int y, int64_t step, Contours& out) {
  const int64_t d8[8] = {1, 1 - step, -step, -step - 1, -1, step - 1, step, step + 1};
  int64_t deltas[16];
  for (int k = 0; k < 16; k++) deltas[k] = d8[k & 7];
  const size_t first = out.pts.size();
  int s = 4, s_end = 4;
  int64_t i1;
  for (;;) {  // the first foreground neighbour, clockwise from the left one (which is background)
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
    if (img[i1] != 0 || s == s_end) break;
  }
  if (s == s_end) {  // a pixel with no foreground neighbour
    img[i0] = kRight;
    out.pts.push_back(x);
    out.pts.push_back(y);
    out.counts.push_back(1);
    return;
  }
  int64_t i3 = i0, i4 = i0;
  int prev_s = s ^ 4;
  for (;;) {
    s_end = s;
    while (s < 15) {  // the next foreground neighbour, counter-clockwise from where the chain came from
      s++;
      i4 = i3 + deltas[s];
      if (img[i4] != 0) break;
    }
    s &= 7;
    if (s >= 1 && s <= s_end) {
      img[i3] = kRight;
    } else if (img[i3] == 1) {
      img[i3] = kMark;
    }
    if (s != prev_s) {
      out.pts.push_back(x);
      out.pts.push_back(y);
      prev_s = s;
    }
    x += kDx[s];
    y += kDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
  out.counts.push_back(static_cast<int32_t>((out.pts.size() - first) / 2));
}

}  // namespace

extern "C" {

// Trace the outer borders of the (rows, cols) mask (nonzero is foreground). Returns a handle to the
// result, whose contour and point counts are written to ncontours and npoints; bsy_contours_take
// copies it out and frees it.
void* bsy_contours_find(const uint8_t* mask, int rows, int cols, int64_t* ncontours, int64_t* npoints) {
  auto* out = new Contours();
  if (rows > 0 && cols > 0) {
    const int64_t step = static_cast<int64_t>(cols) + 2;
    std::vector<int8_t> img(static_cast<size_t>(step) * (rows + 2), 0);
    for (int y = 0; y < rows; y++) {
      const uint8_t* src = mask + static_cast<int64_t>(y) * cols;
      int8_t* dst = img.data() + (y + 1) * step + 1;
      for (int x = 0; x < cols; x++) dst[x] = src[x] != 0;
    }
    for (int y = 1; y <= rows; y++) {
      int8_t* row = img.data() + y * step;
      int prev = 0;
      int lnbd = 0;  // x of the last border pixel met on this row (0: the frame)
      for (int x = 1; x <= cols; x++) {
        const uint64_t run = static_cast<uint8_t>(prev) * 0x0101010101010101ULL;
        uint64_t word;
        while (x + 8 <= cols + 1 && (std::memcpy(&word, row + x, 8), word == run)) x += 8;  // 8 pixels of the run
        if (x > cols) break;
        const int p = row[x];
        if (p == prev) continue;
        // an outer border starts here, unless the last marked border pixel of the row is a component's
        // left side (> 0): then this is an island in a hole. Holes are not followed.
        if (prev == 0 && p == 1 && row[lnbd] <= 0) {
          follow(img.data(), y * step + x, x - 1, y - 1, step, *out);
          lnbd = x;
          prev = row[x];
          continue;
        }
        prev = p;
        if (prev & -2) lnbd = x;
      }
    }
  }
  *ncontours = static_cast<int64_t>(out->counts.size());
  *npoints = static_cast<int64_t>(out->pts.size() / 2);
  return out;
}

// Copy the result of bsy_contours_find into pts ((x, y) int32 pairs, contour after contour) and counts
// (points per contour), both in OpenCV's order (the last border found first), and free it.
void bsy_contours_take(void* handle, int32_t* pts, int32_t* counts) {
  auto* res = static_cast<Contours*>(handle);
  const int64_t n = static_cast<int64_t>(res->counts.size());
  std::vector<int64_t> start(n + 1, 0);
  for (int64_t k = 0; k < n; k++) start[k + 1] = start[k] + res->counts[k];
  int32_t* dst = pts;
  for (int64_t k = n - 1; k >= 0; k--) {
    counts[n - 1 - k] = res->counts[k];
    dst = std::copy(res->pts.begin() + 2 * start[k], res->pts.begin() + 2 * start[k + 1], dst);
  }
  delete res;
}

}  // extern "C"
