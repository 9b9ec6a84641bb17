// Multilevel FPN RoIAlign backward: the gradient with respect to the maps.
//
// Replaces the Pallas kernel
//   feature_intertwiner_tpu/ops/roi_align_window_bwd.py::_bwd_kernel
// (reached from the custom VJP ops/roi_align_window.py::_hybrid_bwd). The
// TPU kernel tiles each level into row strips, accumulates every box's
// window in VMEM, spills the halo rows and folds them back with XLA; all of
// that serves the TPU's DMA windows. The port's forward (roi_align_fwd.cu)
// has no window, so this kernel is the exact transpose of its sampling for
// every box.
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
// come from roi_align_taps.cuh, the forward's own sampling.
//
// Design, deterministic and without atomics:
//  1. roi_align_bwd_taps: one thread per box computes the taps of its ch
//     sample rows and cw sample columns, and the rectangle of map cells
//     they touch.
//  2. roi_align_bwd_accumulate: one block per (level, image, map row, tile
//     of 32 map columns), 256 threads, thread c owning channel c of the
//     tile in shared memory (32 x C floats, 32 KB at C = 256). The block
//     walks the boxes in index order (a ballot compacts those whose
//     rectangle meets its tile), each box's sample rows in order and each
//     row's samples in order, and adds their weighted cotangents into its
//     tile. The order of every sum is fixed by the data, so two launches
//     give the same bits. Each tile is written once, zeros included.
//     A tile that many boxes meet is walked by one block alone (the
//     zero-padded RoI slots of the second stage all sample cell (0, 0) of
//     P2); so that this walk is not bound by the latency of one load at a
//     time, the cotangents of up to kChunk samples of a row are loaded
//     before they are added.
// Bound on the card: bytes. g is read once (each sample row at most by the
// blocks of its two tap rows) and every map is written once; the work is a
// few flops per value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kTileW = 32;     // map columns per block
constexpr int kThreads = 256;  // threads per accumulate block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;      // samples of a row whose cotangents load together

struct Levels {
  float* out[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  int tiles[kMaxLevels];             // column tiles per map row
  int block_start[kMaxLevels + 1];   // first accumulate block of each level
};

// Per-box taps. info[k] = (level*batch + image, first row, last row,
// first column << 16 | last column) of the cells its valid samples touch,
// or key -1 when no sample of the box is valid.
__global__ void roi_align_bwd_taps(Levels levels, int num_levels, int batch,
                                   const float* __restrict__ boxes,
                                   const int* __restrict__ box_idx,
                                   const int* __restrict__ level_idx, int n,
                                   int crop_h, int crop_w, float inv_h,
                                   float inv_w, int4* __restrict__ info,
                                   int* __restrict__ ylo, int* __restrict__ yhi,
                                   int* __restrict__ yvalid,
                                   float* __restrict__ ylerp,
                                   int* __restrict__ xlo, int* __restrict__ xhi,
                                   int* __restrict__ xvalid,
                                   float* __restrict__ xlerp) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  // The forward clamps its indices the same way.
  const int l = min(max(level_idx[k], 0), num_levels - 1);
  const int b = min(max(box_idx[k], 0), batch - 1);
  const float h = (float)levels.height[l];
  const float w = (float)levels.width[l];
  const float y1 = boxes[4 * k + 0];
  const float x1 = boxes[4 * k + 1];
  const float y2 = boxes[4 * k + 2];
  const float x2 = boxes[4 * k + 3];
  int r0 = 1 << 30, r1 = -1, c0 = 1 << 30, c1 = -1;
  for (int i = 0; i < crop_h; ++i) {
    const Taps t = corner_taps(sample_position(y1, y2, crop_h, inv_h, i, h), h);
    const int s = k * crop_h + i;
    ylo[s] = t.lo;
    yhi[s] = t.hi;
    yvalid[s] = t.valid;
    ylerp[s] = t.lerp;
    if (t.valid) {
      r0 = min(r0, t.lo);
      r1 = max(r1, t.hi);
    }
  }
  for (int j = 0; j < crop_w; ++j) {
    const Taps t = corner_taps(sample_position(x1, x2, crop_w, inv_w, j, w), w);
    const int s = k * crop_w + j;
    xlo[s] = t.lo;
    xhi[s] = t.hi;
    xvalid[s] = t.valid;
    xlerp[s] = t.lerp;
    if (t.valid) {
      c0 = min(c0, t.lo);
      c1 = max(c1, t.hi);
    }
  }
  const bool any = r1 >= 0 && c1 >= 0;
  info[k] = make_int4(any ? l * batch + b : -1, r0, r1, any ? (c0 << 16) | c1 : 0);
}

__device__ __forceinline__ void add_pair(float* acc, int channels, int c,
                                         float p, float lx, int xl, bool inl,
                                         int xh, bool inh) {
  if (inl) acc[xl * channels + c] += p - p * lx;
  if (inh) acc[xh * channels + c] += p * lx;
}

__global__ void __launch_bounds__(kThreads)
roi_align_bwd_accumulate(Levels levels, int num_levels, int batch,
                         int channels, int n, int crop_h, int crop_w,
                         const float* __restrict__ g,
                         const int4* __restrict__ info,
                         const int* __restrict__ ylo,
                         const int* __restrict__ yhi,
                         const int* __restrict__ yvalid,
                         const float* __restrict__ ylerp,
                         const int* __restrict__ xlo,
                         const int* __restrict__ xhi,
                         const int* __restrict__ xvalid,
                         const float* __restrict__ xlerp) {
  extern __shared__ float acc[];  // [kTileW, channels]
  __shared__ int list[kThreads];
  __shared__ int warp_hits[kWarps];

  int l = 0;
  while (l + 1 < num_levels && (int)blockIdx.x >= levels.block_start[l + 1]) ++l;
  const int rel = (int)blockIdx.x - levels.block_start[l];
  const int h = levels.height[l];
  const int w = levels.width[l];
  const int tile = rel % levels.tiles[l];
  const int r = (rel / levels.tiles[l]) % h;
  const int b = rel / levels.tiles[l] / h;
  const int x0 = tile * kTileW;
  const int tw = min(kTileW, w - x0);
  const int key = l * batch + b;

  for (int e = threadIdx.x; e < tw * channels; e += kThreads) acc[e] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int base = 0; base < n; base += kThreads) {
    const int k = base + threadIdx.x;
    bool hit = false;
    if (k < n) {
      const int4 f = info[k];
      const int cmin = f.w >> 16;
      const int cmax = f.w & 0xffff;
      hit = f.x == key && f.y <= r && r <= f.z && cmin < x0 + tw && cmax >= x0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, count = 0;
    for (int q = 0; q < kWarps; ++q) {
      offset += q < warp ? warp_hits[q] : 0;
      count += warp_hits[q];
    }
    if (hit) list[offset + __popc(mask & ((1u << lane) - 1u))] = k;
    __syncthreads();

    for (int q = 0; q < count; ++q) {
      const int box = list[q];
      for (int i = 0; i < crop_h; ++i) {
        const int s = box * crop_h + i;
        if (!yvalid[s]) continue;
        const bool top = ylo[s] == r;
        const bool bot = yhi[s] == r;
        if (!top && !bot) continue;
        const float ly = ylerp[s];
        const float* grow = g + (size_t)s * crop_w * channels;
        for (int j0 = 0; j0 < crop_w; j0 += kChunk) {
          // the chunk's samples that touch this tile: their cotangent rows
          // are loaded together, then added in sample order
          int xl[kChunk], xh[kChunk];
          float lx[kChunk];
          unsigned use = 0;
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            const int t = box * crop_w + j0 + u;
            xl[u] = xh[u] = -1;
            lx[u] = 0.0f;
            if (j0 + u < crop_w && xvalid[t]) {
              xl[u] = xlo[t] - x0;
              xh[u] = xhi[t] - x0;
              lx[u] = xlerp[t];
              if ((xl[u] >= 0 && xl[u] < tw) || (xh[u] >= 0 && xh[u] < tw)) use |= 1u << u;
            }
          }
          if (!use) continue;
          for (int c = threadIdx.x; c < channels; c += kThreads) {
            float gv[kChunk];
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
              gv[u] = (use >> u) & 1u ? __ldg(grow + (size_t)(j0 + u) * channels + c) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
              if (!((use >> u) & 1u)) continue;
              const bool inl = xl[u] >= 0 && xl[u] < tw;
              const bool inh = xh[u] >= 0 && xh[u] < tw;
              const float a = gv[u] * ly;
              if (top) add_pair(acc, channels, c, gv[u] - a, lx[u], xl[u], inl, xh[u], inh);
              if (bot) add_pair(acc, channels, c, a, lx[u], xl[u], inl, xh[u], inh);
            }
          }
        }
      }
    }
    __syncthreads();  // list and warp_hits are rewritten next round
  }

  float* dst = levels.out[l] + (((size_t)b * h + r) * w + x0) * channels;
  for (int e = threadIdx.x; e < tw * channels; e += kThreads) dst[e] = acc[e];
}

}  // namespace

// Scratch the caller allocates for `n` boxes (see roi_align_bwd below).
extern "C" int roi_align_bwd_scratch_ints(int n, int crop_h, int crop_w) {
  return 4 * n + 3 * n * crop_h + 3 * n * crop_w;
}

extern "C" int roi_align_bwd_scratch_floats(int n, int crop_h, int crop_w) {
  return n * crop_h + n * crop_w;
}

// out_ptrs/heights/widths: num_levels entries (host arrays), each level's
// gradient a [batch, height, width, channels] float32 map in device memory,
// contiguous, written whole by this call. g [n, crop_h, crop_w, channels]
// float32 contiguous; boxes [n, 4] float32, box_idx and level_idx [n] int32
// (0-based level). inv_h/inv_w: float32 1/(crop-1), as the forward got
// them. scratch_i/scratch_f: device buffers of the sizes above, scratch_i
// 16-byte aligned. Launches on `stream` and returns the first cudaError_t.
extern "C" int roi_align_bwd(void* const* out_ptrs, const int* heights,
                             const int* widths, int num_levels, int batch,
                             int channels, const float* g,
                             const float* boxes, const int* box_idx,
                             const int* level_idx, int n, int crop_h,
                             int crop_w, float inv_h, float inv_w,
                             int* scratch_i, float* scratch_f, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1 ||
      channels < 1 || crop_h < 1 || crop_w < 1 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kTileW * channels * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  Levels levels = {};
  long long blocks = 0;
  for (int k = 0; k < num_levels; ++k) {
    if (heights[k] < 1 || widths[k] < 1 || widths[k] > 0xffff) {
      return (int)cudaErrorInvalidValue;
    }
    levels.out[k] = static_cast<float*>(out_ptrs[k]);
    levels.height[k] = heights[k];
    levels.width[k] = widths[k];
    levels.tiles[k] = (widths[k] + kTileW - 1) / kTileW;
    levels.block_start[k] = (int)blocks;
    blocks += (long long)batch * heights[k] * levels.tiles[k];
  }
  levels.block_start[num_levels] = (int)blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  int4* info = reinterpret_cast<int4*>(scratch_i);
  int* ylo = scratch_i + 4 * n;
  int* yhi = ylo + n * crop_h;
  int* yvalid = yhi + n * crop_h;
  int* xlo = yvalid + n * crop_h;
  int* xhi = xlo + n * crop_w;
  int* xvalid = xhi + n * crop_w;
  float* ylerp = scratch_f;
  float* xlerp = scratch_f + n * crop_h;
  cudaStream_t s = (cudaStream_t)stream;

  if (n > 0) {
    roi_align_bwd_taps<<<(n + 127) / 128, 128, 0, s>>>(
        levels, num_levels, batch, boxes, box_idx, level_idx, n, crop_h,
        crop_w, inv_h, inv_w, info, ylo, yhi, yvalid, ylerp, xlo, xhi, xvalid,
        xlerp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roi_align_bwd_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  roi_align_bwd_accumulate<<<(unsigned)blocks, kThreads, smem, s>>>(
      levels, num_levels, batch, channels, n, crop_h, crop_w, g, info, ylo,
      yhi, yvalid, ylerp, xlo, xhi, xvalid, xlerp);
  return (int)cudaGetLastError();
}
