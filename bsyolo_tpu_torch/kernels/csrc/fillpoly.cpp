// Polygon fill of one-channel 8-bit images, the pixels cv2.fillPoly sets for int32 points with
// the default 8-connected line type and no fractional bits (OpenCV 5.0, imgproc/src/drawing.cpp:
// CollectPolyEdges, FillEdgeCollection, Line, LineIterator, clipLine).
//
// Each edge is first drawn as an 8-connected line (clipped to the image), then the polygon's
// edges, x in 16.16 fixed point, are scan-converted row by row with the even-odd rule of an
// active edge list kept sorted by x. Host C++ behind a plain C interface, built by the host
// compiler (kernels/build.py) and bound with ctypes (data/cv.py fill_poly).
#include <algorithm>
#include <climits>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

constexpr int kShift = 16;             // XY_SHIFT
constexpr int64_t kOne = 1LL << kShift;  // XY_ONE

struct Pt {
  int64_t x, y;
};

struct Edge {
  int y0, y1;
  int64_t x, dx;
  Edge* next;
};

// clipLine(Size2l, Point2l&, Point2l&): Cohen-Sutherland against [0, w-1] x [0, h-1].
bool clip_line(int64_t w, int64_t h, Pt& p1, Pt& p2) {
  int64_t right = w - 1, bottom = h - 1;
  if (w <= 0 || h <= 0) return false;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Line(img, pt1, pt2, color, 8): LineIterator(leftToRight) over the clipped segment.
void line8(uint8_t* img, int rows, int cols, Pt p1, Pt p2, uint8_t color) {
  if ((uint64_t)p1.x >= (uint64_t)cols || (uint64_t)p2.x >= (uint64_t)cols || (uint64_t)p1.y >= (uint64_t)rows ||
      (uint64_t)p2.y >= (uint64_t)rows) {
    if (!clip_line(cols, rows, p1, p2)) return;
  }
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t sx = 1, sy = 1;
  if (dx < 0) {  // left to right
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  bool vert = dy > dx;
  if (vert) {
    std::swap(dx, dy);
    std::swap(sx, sy);
  }
  int64_t err = dx - (dy + dy), plus_delta = dx + dx, minus_delta = -(dy + dy);
  // the major axis moves each step, the minor one where err < 0
  int64_t major_x = vert ? 0 : sx, major_y = vert ? sx : 0;
  int64_t minor_x = vert ? sy : 0, minor_y = vert ? 0 : sy;
  int64_t x = p1.x, y = p1.y;
  for (int64_t i = 0; i <= dx; i++) {
    img[y * cols + x] = color;
    bool minor = err < 0;
    err += minus_delta + (minor ? plus_delta : 0);
    x += major_x + (minor ? minor_x : 0);
    y += major_y + (minor ? minor_y : 0);
  }
}

void collect_edges(uint8_t* img, int rows, int cols, const int32_t* v, int count, std::vector<Edge>& edges,
                   uint8_t color) {
  Pt pt0{v[2 * (count - 1)], v[2 * (count - 1) + 1]};
  for (int i = 0; i < count; i++) {
    Pt pt1{v[2 * i], v[2 * i + 1]};
    Pt t0 = pt0, t1 = pt1;
    line8(img, rows, cols, t0, t1, color);
    // the edge's x runs along the segment clipped to the image where it leaves the image
    if ((uint64_t)t0.x >= (uint64_t)cols || (uint64_t)t1.x >= (uint64_t)cols || (uint64_t)t0.y >= (uint64_t)rows ||
        (uint64_t)t1.y >= (uint64_t)rows)
      clip_line(cols, rows, t0, t1);
    if (pt0.y != pt1.y) {
      Pt p0c{t0.x * kOne, t0.y}, p1c{t1.x * kOne, t1.y};
      Edge e{};
      e.dx = p1c.y != p0c.y ? (p1c.x - p0c.x) / (p1c.y - p0c.y) : 0;
      if (pt0.y < pt1.y) {
        e.y0 = (int)pt0.y;
        e.y1 = (int)pt1.y;
        e.x = p0c.x + (e.y0 - p0c.y) * e.dx;
      } else {
        e.y0 = (int)pt1.y;
        e.y1 = (int)pt0.y;
        e.x = p1c.x + (e.y0 - p1c.y) * e.dx;
      }
      edges.push_back(e);
    }
    pt0 = pt1;
  }
}

void fill_edges(uint8_t* img, int rows, int cols, std::vector<Edge>& edges, uint8_t color) {
  int total = (int)edges.size();
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = -1, x_min = INT64_MAX;
  for (const Edge& e : edges) {
    int64_t x1 = e.x + (e.y1 - e.y0) * e.dx;
    y_min = std::min(y_min, e.y0);
    y_max = std::max(y_max, e.y1);
    x_min = std::min(x_min, std::min(e.x, x1));
    x_max = std::max(x_max, std::max(e.x, x1));
  }
  if (y_max < 0 || y_min >= rows || x_max < 0 || x_min >= ((int64_t)cols << kShift)) return;
  std::sort(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
    return a.y0 - b.y0 ? a.y0 < b.y0 : a.x - b.x ? a.x < b.x : a.dx < b.dx;
  });
  Edge tmp{};
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);  // the sentinel; edges is not resized from here on
  int i = 0;
  tmp.next = nullptr;
  Edge* e = &edges[0];
  y_max = std::min(y_max, rows);
  for (int y = e->y0; y < y_max; y++) {
    Edge *last, *prelast, *keep_prelast;
    int draw = 0;
    bool clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {  // the edge ends here
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {  // an edge starts here
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int64_t x1, x2;
          // the pixels whose left edge lies in [x_left, x_right]: x1 = ceil, x2 = floor
          if (keep_prelast->x > prelast->x) {
            x1 = (prelast->x + kOne - 1) >> kShift;
            x2 = keep_prelast->x >> kShift;
          } else {
            x1 = (keep_prelast->x + kOne - 1) >> kShift;
            x2 = prelast->x >> kShift;
          }
          if (x1 < cols && x2 >= 0) {
            x1 = std::max<int64_t>(x1, 0);
            x2 = std::min<int64_t>(x2, cols - 1);
            std::fill(img + (int64_t)y * cols + x1, img + (int64_t)y * cols + x2 + 1, color);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // keep the active list sorted by x (bubble sort)
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      Edge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        Edge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

}  // namespace

extern "C" {

// Fill ``ncontours`` polygons of ``npts[k]`` (x, y) int32 points each, one after the other in
// ``pts``, into the (rows, cols) uint8 image ``img`` with ``color``. Returns 0.
int bsy_fill_poly(uint8_t* img, int rows, int cols, const int32_t* pts, const int32_t* npts, int ncontours,
                  int color) {
  std::vector<Edge> edges;
  int64_t total = 0;
  for (int k = 0; k < ncontours; k++) total += npts[k];
  edges.reserve(total + 1);
  const int32_t* v = pts;
  for (int k = 0; k < ncontours; k++) {
    if (npts[k] > 0) collect_edges(img, rows, cols, v, npts[k], edges, (uint8_t)color);
    v += 2 * npts[k];
  }
  fill_edges(img, rows, cols, edges, (uint8_t)color);
  return 0;
}
}
