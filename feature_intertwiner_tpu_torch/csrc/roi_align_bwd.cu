// Multilevel FPN RoIAlign backward: the gradient with respect to the maps.
//
// Replaces the Pallas kernel
//   feature_intertwiner_tpu/ops/roi_align_window_bwd.py::_bwd_kernel
// (reached from the custom VJP ops/roi_align_window.py::_hybrid_bwd). The
// TPU kernel tiles each level into row strips, accumulates every box's
// window in VMEM, spills the halo rows and folds them back with XLA; all of
// that serves the TPU's DMA windows and its sequential grid, which carries a
// strip's sum from box to box. The port's forward (roi_align_fwd.cu) has no
// window, so this kernel is the exact transpose of its sampling for every
// box.
//
// What it computes: given the cotangent g [N, ch, cw, C] of the crops, one
// fp32 map d_l [B, H_l, W_l, C] per level, where every valid sample
// (n, i, j) of box n (level l, image b) adds, per channel,
//   a = g*ly, top = g - a, bot = a
//   d[ylo][xlo] += top - top*lx    d[ylo][xhi] += top*lx
//   d[yhi][xlo] += bot - bot*lx    d[yhi][xhi] += bot*lx
// (the transpose of top = tl + (tr - tl)*lx, out = top + (bot - top)*ly, in
// the form XLA transposes it). A sample outside the map adds nothing: the
// forward wrote the constant extrapolation value there. The taps and lerps
// come from roi_align_taps.cuh, the forward's own sampling: K1's, or with
// `xla` that of the jitted single-level crop, whose forward is
// crop_and_resize.cu's `xla` mode (the Dev big-set crop's gradient). Only
// pass 1 reads the mode: every later pass, the tile cover included, works
// from the taps it packs.
//
// Bound on the card: bytes. g is read once and every map is written once;
// the work is a few flops per value. What stands in the way is the crowd:
// the second stage's zero-padded RoI slots all sample cell (0, 0) of P2, and
// a cluster of boxes around one object meets the same few map tiles, so a
// design that gives each map tile to one block runs the crowded tile's
// whole sum on one SM while the others idle. Here a crowded tile's boxes
// are split across blocks and the partial tiles folded in a second pass.
//
// The tile is (level, image, map row, kTileW map columns). Two entry points,
// each launching on the caller's stream (kernels named roi_align_bwd_<pass>):
//  roi_align_bwd_plan
//   1. taps: one thread per box packs the taps of its ch sample rows and cw
//      sample columns, and the rectangle of map cells they touch.
//   2. bin: one block per (level, image) lists its boxes in index order (a
//      stable counting sort), so that later passes scan only those.
//   3. count: one warp per tile counts the boxes whose rectangle meets it (a
//      ballot scan of its bin).
//   4. scan: one block gives each tile that more than kSplitAbove boxes
//      meet ceil(count / kChunk) work items (every other tile one), each
//      tile of several items its slots of partial tiles, and each tile the
//      start of its box list, by prefix sums; it writes the totals.
//  The caller reads the five totals back to the host (the one device-to-host
//  read per call) to size the grid and the scratch of the work lists and
//  partial tiles, then
//  roi_align_bwd
//   5. list: one warp per tile writes its box list, in index order, and the
//      tile of each of its work items.
//   6. accumulate: one block per work item (tile, q) stages the taps of the
//      boxes of ranks [q*kChunk, (q+1)*kChunk) of the tile's list (all of
//      them, for a tile of one item) in shared memory and adds their
//      weighted cotangents, box by box, row by row and sample by sample,
//      into its tile in shared memory, thread c owning
//      channel c. Along a box's sample row the x taps do not decrease, and
//      every sample of a degenerate box taps one cell, so consecutive adds
//      into one cell are summed in a register (in double) and added to
//      shared memory once. A tile of one item writes the map directly, zeros
//      included; the items of a tile of several write partial tiles.
//   7. fold: one block per (tile of several items, map column) sums the
//      partial tiles in item order (in double) into the map.
// Every sum runs in an order fixed by the data, with no atomics, so two
// launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kTileW = 32;        // map columns per tile
constexpr int kThreads = 256;     // threads per block of every pass but the scan
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kLoad = 8;          // samples of a row whose cotangents load together
// A tile that more than kSplitAbove boxes meet is split into work items of
// kChunk boxes. Small items spread a crowded tile (the zero-padded RoI
// slots) over the most blocks; leaving tiles of a few boxes whole spares a
// spread-out call the partial tiles' round trip through memory, which
// doubled its time on the H100 when every tile of more than kChunk boxes
// was split (PERF.md).
constexpr int kChunk = 2;
constexpr int kSplitAbove = 16;
static_assert(kChunk <= kSplitAbove, "an item takes at most kSplitAbove boxes");
constexpr int kTotals = 5;        // the plan's totals, read by the host

struct Levels {
  float* out[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  int tiles[kMaxLevels];            // column tiles per map row
  int tile_start[kMaxLevels + 1];   // first tile of each level
};

struct Tile {
  int level, image, row, x0, tw;
};

__device__ __forceinline__ Tile decode_tile(const Levels& lv, int num_levels, int t) {
  int l = 0;
  while (l + 1 < num_levels && t >= lv.tile_start[l + 1]) ++l;
  const int rel = t - lv.tile_start[l];
  Tile d;
  d.level = l;
  d.x0 = (rel % lv.tiles[l]) * kTileW;
  d.row = (rel / lv.tiles[l]) % lv.height[l];
  d.image = rel / lv.tiles[l] / lv.height[l];
  d.tw = min(kTileW, lv.width[l] - d.x0);
  return d;
}

__device__ __forceinline__ float* map_row(const Levels& lv, const Tile& d, int channels) {
  return lv.out[d.level] +
         (((size_t)d.image * lv.height[d.level] + d.row) * lv.width[d.level] + d.x0) * channels;
}

// info = (level*batch + image or -1, first row, last row, first column << 16
// | last column) of the cells a box's valid samples touch
__device__ __forceinline__ bool meets(int4 f, int key, int row, int x0, int tw) {
  const int c0 = f.w >> 16;
  const int c1 = f.w & 0xffff;
  return f.x == key && f.y <= row && row <= f.z && c0 < x0 + tw && c1 >= x0;
}

// Work items of a tile that `count` boxes meet: one, unless more than
// kSplitAbove boxes meet it; then one per kChunk of them.
__device__ __forceinline__ int chunks_of(int count) {
  return count <= kSplitAbove ? 1 : (count + kChunk - 1) / kChunk;
}

// Sum of v over the block (integers: the order does not matter). `red` holds
// one int per warp.
__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) s += red[q];
  return s;
}

// Writes `elems` floats of src (or zeros when src is null) to dst, four at a
// time where both are 16-byte aligned: a map row of a channel count that is
// not a multiple of 4 (an RGB crop's image) starts anywhere.
__device__ __forceinline__ void store_tile(float* dst, const float* src, int elems) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if ((elems & 3) == 0 && (at & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int e = threadIdx.x; e < (elems >> 2); e += kThreads) {
      d4[e] = src ? s4[e] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e = threadIdx.x; e < elems; e += kThreads) dst[e] = src ? src[e] : 0.0f;
  }
}

// ytap/xtap[s] = (lo | hi << 16, or -1 for an invalid sample; the lerp's bits)
__global__ void roi_align_bwd_taps(Levels lv, int num_levels, int batch,
                         const float* __restrict__ boxes,
                         const int* __restrict__ box_idx,
                         const int* __restrict__ level_idx, int n, int crop_h,
                         int crop_w, float inv_h, float inv_w, bool xla,
                         int4* __restrict__ info, int2* __restrict__ ytap,
                         int2* __restrict__ xtap) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  // The forward clamps its indices the same way.
  const int l = min(max(level_idx[k], 0), num_levels - 1);
  const int b = min(max(box_idx[k], 0), batch - 1);
  const float h = (float)lv.height[l];
  const float w = (float)lv.width[l];
  const float y1 = boxes[4 * k + 0];
  const float x1 = boxes[4 * k + 1];
  const float y2 = boxes[4 * k + 2];
  const float x2 = boxes[4 * k + 3];
  int r0 = 1 << 30, r1 = -1, c0 = 1 << 30, c1 = -1;
  for (int i = 0; i < crop_h; ++i) {
    const Taps t = corner_taps(sample_position(y1, y2, crop_h, inv_h, i, h, xla), h);
    ytap[k * crop_h + i] = make_int2(t.valid ? (t.lo | (t.hi << 16)) : -1, __float_as_int(t.lerp));
    if (t.valid) {
      r0 = min(r0, t.lo);
      r1 = max(r1, t.hi);
    }
  }
  for (int j = 0; j < crop_w; ++j) {
    const Taps t = corner_taps(sample_position(x1, x2, crop_w, inv_w, j, w, xla), w);
    xtap[k * crop_w + j] = make_int2(t.valid ? (t.lo | (t.hi << 16)) : -1, __float_as_int(t.lerp));
    if (t.valid) {
      c0 = min(c0, t.lo);
      c1 = max(c1, t.hi);
    }
  }
  const bool any = r1 >= 0 && c1 >= 0;
  info[k] = make_int4(any ? l * batch + b : -1, r0, r1, any ? (c0 << 16) | c1 : 0);
}

// Block `key`: its boxes, in index order, at bins[bin_start[key]...].
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_bin(const int4* __restrict__ info, int n, int* __restrict__ bins,
        int* __restrict__ bin_start, int* __restrict__ bin_count) {
  __shared__ int red[kWarps];
  __shared__ int warp_hits[kWarps];
  const int key = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int before = 0, mine = 0;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int x = info[k].x;
    before += x >= 0 && x < key;
    mine += x == key;
  }
  const int start = block_sum(before, red);
  const int total = block_sum(mine, red);
  int running = start;
  for (int base = 0; base < n; base += kThreads) {
    const int k = base + threadIdx.x;
    const bool hit = k < n && info[k].x == key;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, count = 0;
    for (int q = 0; q < kWarps; ++q) {
      offset += q < warp ? warp_hits[q] : 0;
      count += warp_hits[q];
    }
    if (hit) bins[running + offset + __popc(mask & ((1u << lane) - 1u))] = k;
    running += count;
    __syncthreads();  // warp_hits is rewritten next round
  }
  if (threadIdx.x == 0) {
    bin_start[key] = start;
    bin_count[key] = total;
  }
}

// One warp per tile: the boxes of its bin whose rectangle meets it.
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_count(Levels lv, int num_levels, int batch, int total_tiles,
          const int4* __restrict__ info, const int* __restrict__ bins,
          const int* __restrict__ bin_start, const int* __restrict__ bin_count,
          int* __restrict__ tile_count) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= total_tiles) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const Tile d = decode_tile(lv, num_levels, t);
  const int key = d.level * batch + d.image;
  const int* list = bins + bin_start[key];
  const int len = bin_count[key];
  int count = 0;
  for (int base = 0; base < len; base += 32) {
    const bool hit = base + lane < len && meets(info[list[base + lane]], key, d.row, d.x0, d.tw);
    count += __popc(__ballot_sync(0xffffffffu, hit));
  }
  if (lane == 0) tile_count[t] = count;
}

// One block: work items, partial-tile slots and box-list starts per tile by
// prefix sums over the tiles; totals = (work items, partial slots, tiles of
// several items, most items of one tile, (box, tile) pairs).
__global__ void __launch_bounds__(kScanThreads)
roi_align_bwd_scan(int total_tiles, const int* __restrict__ tile_count,
         int* __restrict__ item_start, int* __restrict__ part_start,
         int* __restrict__ list_start, int* __restrict__ multi_list,
         int* __restrict__ totals) {
  __shared__ int s_items[kScanThreads], s_parts[kScanThreads], s_multi[kScanThreads],
      s_pairs[kScanThreads], s_max[kScanThreads];
  const int tid = threadIdx.x;
  const int per = (total_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, total_tiles);
  const int hi = min(lo + per, total_tiles);
  int items = 0, parts = 0, multi = 0, pairs = 0, most = 0;
  for (int t = lo; t < hi; ++t) {
    const int n = tile_count[t];
    const int c = chunks_of(n);
    items += c;
    pairs += n;
    if (c > 1) {
      parts += c;
      ++multi;
    }
    most = max(most, c);
  }
  s_items[tid] = items;
  s_parts[tid] = parts;
  s_multi[tid] = multi;
  s_pairs[tid] = pairs;
  s_max[tid] = most;
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scans
    __syncthreads();
    const int a = tid >= off ? s_items[tid - off] : 0;
    const int p = tid >= off ? s_parts[tid - off] : 0;
    const int m = tid >= off ? s_multi[tid - off] : 0;
    const int r = tid >= off ? s_pairs[tid - off] : 0;
    const int x = tid >= off ? s_max[tid - off] : 0;
    __syncthreads();
    s_items[tid] += a;
    s_parts[tid] += p;
    s_multi[tid] += m;
    s_pairs[tid] += r;
    s_max[tid] = max(s_max[tid], x);
  }
  __syncthreads();
  int ib = s_items[tid] - items, pb = s_parts[tid] - parts, mb = s_multi[tid] - multi;
  int rb = s_pairs[tid] - pairs;
  for (int t = lo; t < hi; ++t) {
    const int n = tile_count[t];
    const int c = chunks_of(n);
    item_start[t] = ib;
    list_start[t] = rb;
    ib += c;
    rb += n;
    if (c > 1) {
      part_start[t] = pb;
      pb += c;
      multi_list[mb++] = t;
    } else {
      part_start[t] = -1;
    }
  }
  if (tid == kScanThreads - 1) {
    totals[0] = s_items[tid];
    totals[1] = s_parts[tid];
    totals[2] = s_multi[tid];
    totals[3] = s_max[tid];
    totals[4] = s_pairs[tid];
  }
}

// One warp per tile: its boxes, in index order, at pairs[list_start[t]...],
// and its work items' tile.
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_list(Levels lv, int num_levels, int batch, int total_tiles,
         const int4* __restrict__ info, const int* __restrict__ bins,
         const int* __restrict__ bin_start, const int* __restrict__ bin_count,
         const int* __restrict__ tile_count, const int* __restrict__ item_start,
         const int* __restrict__ list_start, int* __restrict__ item_tile,
         int* __restrict__ pairs) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= total_tiles) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int count = tile_count[t];
  for (int q = lane; q < chunks_of(count); q += 32) item_tile[item_start[t] + q] = t;
  if (count == 0) return;
  const Tile d = decode_tile(lv, num_levels, t);
  const int key = d.level * batch + d.image;
  const int* list = bins + bin_start[key];
  const int len = bin_count[key];
  int* out = pairs + list_start[t];
  int rank = 0;
  for (int base = 0; base < len; base += 32) {
    const int k = base + lane < len ? list[base + lane] : -1;
    const bool hit = k >= 0 && meets(info[k], key, d.row, d.x0, d.tw);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (hit) out[rank + __popc(mask & ((1u << lane) - 1u))] = k;
    rank += __popc(mask);
  }
}

// Adds v to the register sum of `cell`, first moving a sum of another cell
// into the shared tile.
__device__ __forceinline__ void fold_add(float* acc, int channels, int c, int& cell,
                                         double& sum, int x, float v) {
  if (x == cell) {
    sum += (double)v;
    return;
  }
  if (cell >= 0) acc[cell * channels + c] += (float)sum;
  cell = x;
  sum = (double)v;
}

__global__ void __launch_bounds__(kThreads, 4)
roi_align_bwd_accumulate(Levels lv, int num_levels, int channels, int crop_h, int crop_w,
               const float* __restrict__ g, const int2* __restrict__ ytap,
               const int2* __restrict__ xtap, const int* __restrict__ tile_count,
               const int* __restrict__ item_start, const int* __restrict__ part_start,
               const int* __restrict__ list_start, const int* __restrict__ item_tile,
               const int* __restrict__ pairs, float* __restrict__ partials) {
  extern __shared__ __align__(16) float acc[];  // [kTileW, channels], then the staged taps
  __shared__ int sbox[kSplitAbove];
  int2* sy = reinterpret_cast<int2*>(acc + kTileW * channels);  // [kSplitAbove, crop_h]
  int2* sx = sy + kSplitAbove * crop_h;                          // [kSplitAbove, crop_w]

  const int item = blockIdx.x;
  const int t = item_tile[item];
  const int q = item - item_start[t];
  const int count = tile_count[t];
  const Tile d = decode_tile(lv, num_levels, t);
  const int elems = d.tw * channels;
  float* dst = part_start[t] >= 0
                   ? partials + ((size_t)part_start[t] + q) * kTileW * channels
                   : map_row(lv, d, channels);
  if (count == 0) {
    store_tile(dst, nullptr, elems);
    return;
  }
  // this item's boxes: ranks [q*per, q*per + nb) of the tile's list
  const int per = count <= kSplitAbove ? count : kChunk;
  const int nb = min(per, count - q * per);
  const int* list = pairs + list_start[t] + q * per;
  if (threadIdx.x < nb) sbox[threadIdx.x] = list[threadIdx.x];
  for (int e = threadIdx.x; e < nb * crop_h; e += kThreads) {
    sy[e] = ytap[list[e / crop_h] * crop_h + e % crop_h];
  }
  for (int e = threadIdx.x; e < nb * crop_w; e += kThreads) {
    sx[e] = xtap[list[e / crop_w] * crop_w + e % crop_w];
  }
  for (int e = threadIdx.x; e < elems; e += kThreads) acc[e] = 0.0f;
  __syncthreads();

  for (int c = threadIdx.x; c < channels; c += kThreads) {
    int lo_cell = -1, hi_cell = -1;  // the cells of the two pending register sums
    double lo_sum = 0.0, hi_sum = 0.0;
    for (int u = 0; u < nb; ++u) {
      const int2* xt = sx + u * crop_w;
      for (int i = 0; i < crop_h; ++i) {
        const int2 yt = sy[u * crop_h + i];
        if (yt.x < 0) continue;
        const bool top = (yt.x & 0xffff) == d.row;
        const bool bot = (yt.x >> 16) == d.row;
        if (!top && !bot) continue;
        const float ly = __int_as_float(yt.y);
        const float* grow = g + ((size_t)(sbox[u] * crop_h + i) * crop_w) * channels + c;
        for (int j0 = 0; j0 < crop_w; j0 += kLoad) {
          // the samples of this group that touch the tile: their cotangents
          // are loaded together, then added in sample order
          unsigned use = 0;
#pragma unroll
          for (int v = 0; v < kLoad; ++v) {
            const int j = j0 + v;
            if (j < crop_w && xt[j].x >= 0) {
              const unsigned xl = (unsigned)((xt[j].x & 0xffff) - d.x0);
              const unsigned xh = (unsigned)((xt[j].x >> 16) - d.x0);
              if (xl < (unsigned)d.tw || xh < (unsigned)d.tw) use |= 1u << v;
            }
          }
          if (!use) continue;
          float gv[kLoad];
#pragma unroll
          for (int v = 0; v < kLoad; ++v) {
            gv[v] = (use >> v) & 1u ? __ldg(grow + (size_t)(j0 + v) * channels) : 0.0f;
          }
#pragma unroll
          for (int v = 0; v < kLoad; ++v) {
            if (!((use >> v) & 1u)) continue;
            const int2 x = xt[j0 + v];
            const int xl = (x.x & 0xffff) - d.x0;
            const int xh = (x.x >> 16) - d.x0;
            const float lx = __int_as_float(x.y);
            // the row's weight: top = g - a from its top tap row, bot = a
            // from its bottom one, both when the two rows coincide
            const float a = gv[v] * ly;
            float p = top ? gv[v] - a : 0.0f;
            if (bot) p = top ? p + a : a;
            if ((unsigned)xl < (unsigned)d.tw) {
              fold_add(acc, channels, c, lo_cell, lo_sum, xl, p - p * lx);
            }
            if ((unsigned)xh < (unsigned)d.tw) {
              fold_add(acc, channels, c, hi_cell, hi_sum, xh, p * lx);
            }
          }
        }
      }
    }
    if (lo_cell >= 0) acc[lo_cell * channels + c] += (float)lo_sum;
    if (hi_cell >= 0) acc[hi_cell * channels + c] += (float)hi_sum;
  }
  __syncthreads();
  store_tile(dst, acc, elems);
}

// Block (m, x): map column x0 + x of the m-th tile of several items, the sum
// of its partial tiles in item order, in double.
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_fold(Levels lv, int num_levels, int channels,
         const int* __restrict__ multi_list, const int* __restrict__ tile_count,
         const int* __restrict__ part_start, const float* __restrict__ partials) {
  const int t = multi_list[blockIdx.x];
  const Tile d = decode_tile(lv, num_levels, t);
  const int x = blockIdx.y;
  if (x >= d.tw) return;
  const int items = chunks_of(tile_count[t]);
  const size_t slot = (size_t)kTileW * channels;
  const float* src = partials + (size_t)part_start[t] * slot + (size_t)x * channels;
  float* dst = map_row(lv, d, channels) + (size_t)x * channels;
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    double s = src[c];
#pragma unroll 8
    for (int q = 1; q < items; ++q) s += src[q * slot + c];
    dst[c] = (float)s;
  }
}

// The levels' table; false when a shape is out of range.
bool make_levels(void* const* out_ptrs, const int* heights, const int* widths,
                 int num_levels, int batch, Levels* lv, int* total_tiles) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1) return false;
  *lv = Levels{};
  long long tiles = 0;
  for (int k = 0; k < num_levels; ++k) {
    // taps pack as lo | hi << 16 in a non-negative int
    if (heights[k] < 1 || widths[k] < 1 || heights[k] > 0x7fff || widths[k] > 0x7fff) {
      return false;
    }
    lv->out[k] = out_ptrs ? static_cast<float*>(out_ptrs[k]) : nullptr;
    lv->height[k] = heights[k];
    lv->width[k] = widths[k];
    lv->tiles[k] = (widths[k] + kTileW - 1) / kTileW;
    lv->tile_start[k] = (int)tiles;
    tiles += (long long)batch * heights[k] * lv->tiles[k];
  }
  if (tiles > 0x3fffffffLL) return false;
  lv->tile_start[num_levels] = (int)tiles;
  *total_tiles = (int)tiles;
  return true;
}

// The planning scratch, in ints: info (4 n), ytap (2 n ch), xtap (2 n cw),
// bins (n), bin_start and bin_count (one per key), tile_count, item_start,
// part_start, list_start and multi_list (one per tile), totals (5, last).
struct Scratch {
  int4* info;
  int2* ytap;
  int2* xtap;
  int *bins, *bin_start, *bin_count, *tile_count, *item_start, *part_start, *list_start,
      *multi_list, *totals;
};

long long scratch_layout(int* base, int n, int crop_h, int crop_w, int keys, int tiles,
                         Scratch* s) {
  long long off = 0;
  auto take = [&](long long count) {
    int* p = base ? base + off : nullptr;
    off += count;
    return p;
  };
  Scratch v;
  v.info = reinterpret_cast<int4*>(take(4LL * n));
  v.ytap = reinterpret_cast<int2*>(take(2LL * n * crop_h));
  v.xtap = reinterpret_cast<int2*>(take(2LL * n * crop_w));
  v.bins = take(n);
  v.bin_start = take(keys);
  v.bin_count = take(keys);
  v.tile_count = take(tiles);
  v.item_start = take(tiles);
  v.part_start = take(tiles);
  v.list_start = take(tiles);
  v.multi_list = take(tiles);
  v.totals = take(kTotals);
  if (s) *s = v;
  return off;
}

}  // namespace

// Ints of planning scratch for `n` boxes on these levels, or -1 when a
// shape is out of range. Its last five ints are the plan's totals.
extern "C" long long roi_align_bwd_scratch_ints(const int* heights, const int* widths,
                                                int num_levels, int batch, int n,
                                                int crop_h, int crop_w) {
  Levels lv;
  int tiles = 0;
  if (n < 0 || crop_h < 1 || crop_w < 1 ||
      !make_levels(nullptr, heights, widths, num_levels, batch, &lv, &tiles)) {
    return -1;
  }
  return scratch_layout(nullptr, n, crop_h, crop_w, num_levels * batch, tiles, nullptr);
}

// Floats of the partial tiles for `partials` slots.
extern "C" long long roi_align_bwd_partial_floats(int partials, int channels) {
  return (long long)partials * kTileW * channels;
}

// Passes 1-4. heights/widths: num_levels host ints; boxes [n, 4] float32,
// box_idx and level_idx [n] int32 (0-based level) in device memory;
// inv_h/inv_w: float32 1/(crop-1), as the forward got them; xla: the sample
// positions of the jitted single-level crop (roi_align_taps.cuh), else K1's;
// scratch: device
// ints of roi_align_bwd_scratch_ints, 16-byte aligned. Writes the totals
// (work items, partial slots, tiles of several items, most items of one
// tile, (box, tile) pairs) into the last five ints of scratch and returns
// the first cudaError_t.
extern "C" int roi_align_bwd_plan(const int* heights, const int* widths, int num_levels,
                                  int batch, const float* boxes, const int* box_idx,
                                  const int* level_idx, int n, int crop_h, int crop_w,
                                  float inv_h, float inv_w, int xla, int* scratch,
                                  void* stream) {
  Levels lv;
  int tiles = 0;
  if (n < 0 || crop_h < 1 || crop_w < 1 ||
      !make_levels(nullptr, heights, widths, num_levels, batch, &lv, &tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  const int keys = num_levels * batch;
  Scratch s;
  scratch_layout(scratch, n, crop_h, crop_w, keys, tiles, &s);
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    roi_align_bwd_taps<<<(n + 127) / 128, 128, 0, st>>>(
        lv, num_levels, batch, boxes, box_idx, level_idx, n, crop_h, crop_w, inv_h, inv_w,
        xla != 0, s.info, s.ytap, s.xtap);
  }
  roi_align_bwd_bin<<<keys, kThreads, 0, st>>>(s.info, n, s.bins, s.bin_start, s.bin_count);
  roi_align_bwd_count<<<(tiles + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      lv, num_levels, batch, tiles, s.info, s.bins, s.bin_start, s.bin_count, s.tile_count);
  roi_align_bwd_scan<<<1, kScanThreads, 0, st>>>(tiles, s.tile_count, s.item_start,
                                                s.part_start, s.list_start, s.multi_list,
                                                s.totals);
  return (int)cudaGetLastError();
}

// Passes 5-7, after roi_align_bwd_plan on the same arguments and scratch.
// out_ptrs: num_levels host pointers, each level's gradient a [batch,
// height, width, channels] float32 map in device memory, contiguous, written
// whole by this call; g [n, crop_h, crop_w, channels] float32 contiguous;
// items, multi_tiles and pairs: the plan's first, third and fifth totals;
// work: device ints, items + pairs of them; partials: device floats of
// roi_align_bwd_partial_floats(second total), 16-byte aligned. Returns the
// first cudaError_t.
extern "C" int roi_align_bwd(void* const* out_ptrs, const int* heights, const int* widths,
                             int num_levels, int batch, int channels, const float* g, int n,
                             int crop_h, int crop_w, int* scratch, int items,
                             int multi_tiles, int pairs, int* work, float* partials,
                             void* stream) {
  Levels lv;
  int tiles = 0;
  if (channels < 1 || n < 0 || crop_h < 1 || crop_w < 1 || items < 1 || multi_tiles < 0 ||
      pairs < 0 || !make_levels(out_ptrs, heights, widths, num_levels, batch, &lv, &tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  // the tile, then the staged taps of up to kSplitAbove boxes
  const size_t smem = (size_t)kTileW * channels * sizeof(float) +
                      (size_t)kSplitAbove * (crop_h + crop_w) * sizeof(int2);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  Scratch s;
  scratch_layout(scratch, n, crop_h, crop_w, num_levels * batch, tiles, &s);
  int* item_tile = work;
  int* lists = work + items;
  cudaStream_t st = (cudaStream_t)stream;
  roi_align_bwd_list<<<(tiles + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      lv, num_levels, batch, tiles, s.info, s.bins, s.bin_start, s.bin_count,
      s.tile_count, s.item_start, s.list_start, item_tile, lists);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(roi_align_bwd_accumulate,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  roi_align_bwd_accumulate<<<items, kThreads, smem, st>>>(
      lv, num_levels, channels, crop_h, crop_w, g, s.ytap, s.xtap, s.tile_count,
      s.item_start, s.part_start, s.list_start, item_tile, lists, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess || multi_tiles == 0) return (int)err;
  roi_align_bwd_fold<<<dim3(multi_tiles, kTileW), kThreads, 0, st>>>(
      lv, num_levels, channels, s.multi_list, s.tile_count, s.part_start, partials);
  return (int)cudaGetLastError();
}
