// Native RLE mask operations for COCO-style evaluation: the port's own copy
// of the JAX package's feature_intertwiner_tpu/native/maskrle.cpp.
//
// COCO's run-length format: masks are stored column-major (Fortran order)
// as alternating run lengths starting with a run of zeros. Encode, decode,
// merge (union), area, IoU, tight box, box IoU and polygon rasterisation.
//
// Compiled with g++ into a shared library at first use and bound with
// ctypes (evaluation/rle.py). All functions are thread-safe (no globals).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Encode a column-major binary mask [h*w] into run lengths.
// Returns the number of runs written (<= max_counts) or -1 on overflow.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts,
               int max_counts) {
  int64_t n = (int64_t)h * w;
  int m = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      if (m >= max_counts) return -1;
      counts[m++] = run;
      run = 0;
      prev = v;
    }
    ++run;
  }
  if (m >= max_counts) return -1;
  counts[m++] = run;
  return m;
}

// Decode run lengths into a column-major binary mask [h*w].
void rle_decode(const uint32_t* counts, int m, int h, int w, uint8_t* mask) {
  int64_t pos = 0;
  int64_t n = (int64_t)h * w;
  uint8_t v = 0;
  for (int i = 0; i < m; ++i) {
    int64_t run = counts[i];
    for (int64_t j = 0; j < run && pos < n; ++j) mask[pos++] = v;
    v = 1 - v;
  }
  while (pos < n) mask[pos++] = 0;
}

double rle_area(const uint32_t* counts, int m) {
  double a = 0;
  for (int i = 1; i < m; i += 2) a += counts[i];
  return a;
}

// Intersection area of two RLEs over the same canvas via a merge walk.
static double rle_intersection(const uint32_t* a, int ma, const uint32_t* b,
                               int mb) {
  double inter = 0;
  int64_t ca = a[0], cb = b[0];
  int ia = 1, ib = 1;
  uint8_t va = 0, vb = 0;
  // walk boundaries: current run values va/vb with remaining lengths ca/cb
  while (true) {
    while (ca == 0) {
      if (ia >= ma) break;
      ca = a[ia++];
      va = 1 - va;
    }
    while (cb == 0) {
      if (ib >= mb) break;
      cb = b[ib++];
      vb = 1 - vb;
    }
    if (ca == 0 || cb == 0) break;
    int64_t step = std::min(ca, cb);
    if (va && vb) inter += (double)step;
    ca -= step;
    cb -= step;
    if (ca == 0 && ia >= ma && cb == 0 && ib >= mb) break;
  }
  return inter;
}

// IoU between two RLE masks; iscrowd uses the detection area as denominator
// (COCO crowd convention).
double rle_iou(const uint32_t* dt, int md, const uint32_t* gt, int mg,
               int iscrowd) {
  double inter = rle_intersection(dt, md, gt, mg);
  double ad = rle_area(dt, md);
  double ag = rle_area(gt, mg);
  double uni = iscrowd ? ad : (ad + ag - inter);
  if (uni <= 0) return 0.0;
  return inter / uni;
}

// Union (merge) of two RLEs -> counts; returns run count or -1 on overflow.
int rle_merge_union(const uint32_t* a, int ma, const uint32_t* b, int mb,
                    uint32_t* out, int max_counts) {
  int m = 0;
  int64_t ca = a[0], cb = b[0];
  int ia = 1, ib = 1;
  uint8_t va = 0, vb = 0, prev = 0;
  uint32_t run = 0;
  while (true) {
    while (ca == 0 && ia < ma) {
      ca = a[ia++];
      va = 1 - va;
    }
    while (cb == 0 && ib < mb) {
      cb = b[ib++];
      vb = 1 - vb;
    }
    if (ca == 0 && cb == 0) break;
    int64_t step;
    if (ca == 0) step = cb;
    else if (cb == 0) step = ca;
    else step = std::min(ca, cb);
    uint8_t v = (va && ca > 0) || (vb && cb > 0);
    if (v != prev) {
      if (m >= max_counts) return -1;
      out[m++] = run;
      run = 0;
      prev = v;
    }
    run += (uint32_t)step;
    if (ca > 0) ca -= std::min<int64_t>(step, ca);
    if (cb > 0) cb -= std::min<int64_t>(step, cb);
  }
  if (m >= max_counts) return -1;
  out[m++] = run;
  return m;
}

// Tight bbox (x, y, w, h) of an RLE mask on an h-row canvas.
void rle_to_bbox(const uint32_t* counts, int m, int h, double* bb) {
  int64_t pos = 0;
  uint8_t v = 0;
  long xmin = 1 << 30, xmax = -1, ymin = 1 << 30, ymax = -1;
  for (int i = 0; i < m; ++i) {
    int64_t run = counts[i];
    if (v && run > 0) {
      long s = (long)pos, e = (long)(pos + run - 1);
      long x0 = s / h, y0 = s % h, x1 = e / h, y1 = e % h;
      xmin = std::min(xmin, x0);
      xmax = std::max(xmax, x1);
      if (x0 == x1) {
        ymin = std::min(ymin, y0);
        ymax = std::max(ymax, y1);
      } else {
        ymin = 0;
        ymax = h - 1;
      }
    }
    pos += run;
    v = 1 - v;
  }
  if (xmax < 0) {
    bb[0] = bb[1] = bb[2] = bb[3] = 0;
    return;
  }
  bb[0] = (double)xmin;
  bb[1] = (double)ymin;
  bb[2] = (double)(xmax - xmin + 1);
  bb[3] = (double)(ymax - ymin + 1);
}

// Box IoU matrix: dt [m,4] xywh, gt [n,4] xywh, iscrowd [n] -> out [m*n].
void bbox_iou(const double* dt, int m, const double* gt, int n,
              const uint8_t* iscrowd, double* out) {
  for (int i = 0; i < m; ++i) {
    double dx1 = dt[i * 4], dy1 = dt[i * 4 + 1];
    double dw = dt[i * 4 + 2], dh = dt[i * 4 + 3];
    double da = dw * dh;
    for (int j = 0; j < n; ++j) {
      double gx1 = gt[j * 4], gy1 = gt[j * 4 + 1];
      double gw = gt[j * 4 + 2], gh = gt[j * 4 + 3];
      double ga = gw * gh;
      double ix = std::min(dx1 + dw, gx1 + gw) - std::max(dx1, gx1);
      double iy = std::min(dy1 + dh, gy1 + gh) - std::max(dy1, gy1);
      double inter = (ix > 0 && iy > 0) ? ix * iy : 0.0;
      double uni = iscrowd && iscrowd[j] ? da : da + ga - inter;
      out[i * n + j] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

// Rasterize a polygon (xy interleaved, k vertices, pixel coords) into an RLE
// on an h x w canvas. Even-odd scanline fill at 5x supersampling of the
// boundary, matching the COCO convention of including boundary pixels.
// Returns run count or -1 on overflow.
int rle_from_poly(const double* xy, int k, int h, int w, uint32_t* out,
                  int max_counts) {
  if (k < 3) {
    out[0] = (uint32_t)((int64_t)h * w);
    return 1;
  }
  const int S = 5;  // supersampling factor
  long hs = (long)h * S, ws = (long)w * S;
  // integer upscaled vertices
  std::vector<long> px(k), py(k);
  for (int i = 0; i < k; ++i) {
    px[i] = (long)std::lround(xy[2 * i] * S);
    py[i] = (long)std::lround(xy[2 * i + 1] * S);
  }
  // column-major occupancy via per-column even-odd crossings on the
  // supersampled grid, then max-pool down to the pixel grid.
  std::vector<uint8_t> mask((size_t)h * w, 0);
  // scanline fill per supersampled row
  std::vector<double> xs;
  for (long ys = 0; ys < hs; ++ys) {
    double yc = ys + 0.5;
    xs.clear();
    for (int i = 0; i < k; ++i) {
      int j = (i + 1) % k;
      double y0 = (double)py[i], y1 = (double)py[j];
      double x0 = (double)px[i], x1 = (double)px[j];
      if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
        double t = (yc - y0) / (y1 - y0);
        xs.push_back(x0 + t * (x1 - x0));
      }
    }
    if (xs.empty()) continue;
    std::sort(xs.begin(), xs.end());
    int y_pix = (int)(ys / S);
    if (y_pix < 0 || y_pix >= h) continue;
    for (size_t p = 0; p + 1 < xs.size(); p += 2) {
      long xa = (long)std::ceil(xs[p] - 0.5);
      long xb = (long)std::floor(xs[p + 1] - 0.5);
      xa = std::max(xa, 0L);
      xb = std::min(xb, ws - 1);
      for (long xss = xa; xss <= xb; ++xss) {
        int x_pix = (int)(xss / S);
        if (x_pix >= 0 && x_pix < w) mask[(size_t)x_pix * h + y_pix] = 1;
      }
    }
  }
  // also mark boundary pixels (COCO includes the outline)
  for (int i = 0; i < k; ++i) {
    int j = (i + 1) % k;
    double x0 = xy[2 * i], y0 = xy[2 * i + 1];
    double x1 = xy[2 * j], y1 = xy[2 * j + 1];
    double len = std::max(std::abs(x1 - x0), std::abs(y1 - y0));
    int steps = (int)std::ceil(len * 2) + 1;
    for (int s = 0; s <= steps; ++s) {
      double t = steps > 0 ? (double)s / steps : 0.0;
      int xp = (int)(x0 + t * (x1 - x0));
      int yp = (int)(y0 + t * (y1 - y0));
      if (xp >= 0 && xp < w && yp >= 0 && yp < h)
        mask[(size_t)xp * h + yp] = 1;
    }
  }
  return rle_encode(mask.data(), h, w, out, max_counts);
}

}  // extern "C"
