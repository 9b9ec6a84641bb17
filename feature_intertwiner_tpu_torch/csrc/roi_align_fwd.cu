// Multilevel FPN RoIAlign forward with TF crop_and_resize sampling.
//
// Replaces the Pallas kernel
//   feature_intertwiner_tpu/ops/roi_align_window.py::_window_roi_kernel
// (and its hybrid wrapper multilevel_crop_and_resize_window). The TPU kernel
// DMAs a fixed window per box and falls back to an XLA gather for boxes that
// do not fit it; all of that exists for the TPU's DMA engine. This kernel
// reads the four taps of each sample straight from device memory and is
// exact for every box.
//
// What it computes, for box n on its level l (maps NHWC, channels last):
//   pos_y(i) = y1*(H-1) + i*((y2-y1)*(H-1)/(ch-1))   (centre when ch == 1)
//   pos_x(j) likewise over W and cw
//   taps floor/ceil, clamped to the map, lerp = pos - floor(pos)
//   out[n,i,j,c] = top + (bot - top)*ly,  top = tl + (tr - tl)*lx,
//                  bot = bl + (br - bl)*lx
//   out = extrapolation_value where pos_y or pos_x lies outside [0, dim-1]
// in fp32, rounded as XLA compiles ops/roi_align.py::_multilevel_gather:
// the division by (crop-1) is a multiply by its float32 reciprocal (passed
// in as inv_h/inv_w), and `i*step + c0*(H-1)` and the three lerps are fused
// multiply-adds (explicit __fmaf_rn; the file is compiled with -fmad=false,
// so nothing else is contracted). The sampling lives in roi_align_taps.cuh,
// shared with the backward. The plain version rounds the same way.
//
// Bound on the card: bytes. Each output value reads four taps that mostly
// hit L2 (boxes of one image share map rows), and the output is written
// once; the work is a few flops per byte.
//
// Design. The crops are a flat list of sample rows (box n, row i), row
// n * crop_h + i, each crop_w * C floats of output. A block takes
// rows_per_block consecutive rows (the caller's plan, ops/roi_align.py::
// fwd_plan: about 4,096 output vectors, so that a small call such as
// the 14² mask pooling on 200 detections still fills the card, and a 1²
// crop puts many boxes in one block; a box's rows may span two blocks).
// It stages, once, each row's y taps (the two map rows as pointers, the
// lerp, the validity) and the x taps of each box it touches into shared
// memory, 32 and 16 bytes each, then crosses one barrier. After it no
// thread waits on a chain of global loads: its threads run over (row,
// sample column, group of V channels) with the channels fastest, stepping
// those three indices kThreads outputs at a time without a division, and
// each issues the four tap loads of kUnroll outputs (V floats each) before
// the first lerp, so that it keeps 4 * kUnroll loads in flight. The crops are
// written with streaming stores, so that they do not evict the taps that
// neighbouring boxes share from L2. V is 4 when the channel count is a
// multiple of 4 and every level and the crops start on 16-byte boundaries
// (the caller chooses, ops/roi_align.py::fwd_vector_width; the entry
// refuses 4 otherwise, since an unaligned vector access loses the CUDA
// context), else 1.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                // outputs a thread loads before their lerps
constexpr int kSharedLimit = 48 * 1024;   // most shared memory for the staged taps

struct Levels {
  const float* data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
};

// A sample row's y taps: its two map rows (at channel 0 of column 0), lerp
// and validity, and where its box's x taps start among the block's.
template <typename T>
struct __align__(16) RowTaps {
  const T* top;
  const T* bot;
  float lerp;
  int cols;
  int valid;
};

// A sample column's x taps, in vectors from the start of a map row.
struct __align__(16) ColTaps {
  int lo;
  int hi;
  float lerp;
  int valid;
};

static_assert(sizeof(RowTaps<float>) == 32 && sizeof(RowTaps<float4>) == 32 &&
                  sizeof(ColTaps) == 16,
              "ops/roi_align.py::fwd_shared_bytes counts 32 and 16 bytes");

__device__ __forceinline__ float lerp3(float tl, float tr, float bl, float br, float lx,
                                       float ly) {
  const float t = __fmaf_rn(tr - tl, lx, tl);
  const float u = __fmaf_rn(br - bl, lx, bl);
  return __fmaf_rn(u - t, ly, t);
}

__device__ __forceinline__ float4 lerp3(float4 tl, float4 tr, float4 bl, float4 br, float lx,
                                        float ly) {
  return make_float4(lerp3(tl.x, tr.x, bl.x, br.x, lx, ly), lerp3(tl.y, tr.y, bl.y, br.y, lx, ly),
                     lerp3(tl.z, tr.z, bl.z, br.z, lx, ly), lerp3(tl.w, tr.w, bl.w, br.w, lx, ly));
}

template <typename T>
__device__ __forceinline__ T splat(float v);
template <>
__device__ __forceinline__ float splat<float>(float v) { return v; }
template <>
__device__ __forceinline__ float4 splat<float4>(float v) { return make_float4(v, v, v, v); }

// T is float (V = 1) or float4 (V = 4); cv = channels / V. Rows [first,
// first + rows_per_block) of the flat [n * crop_h] list.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels levels, int num_levels, int batch, int cv,
                     const float* __restrict__ boxes, const int* __restrict__ box_idx,
                     const int* __restrict__ level_idx, int total_rows, int crop_h, int crop_w,
                     int rows_per_block, float inv_h, float inv_w, float extrap,
                     T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char staged[];
  RowTaps<T>* rows = reinterpret_cast<RowTaps<T>*>(staged);
  ColTaps* cols = reinterpret_cast<ColTaps*>(staged + rows_per_block * sizeof(RowTaps<T>));
  const int first = blockIdx.x * rows_per_block;
  const int count = min(rows_per_block, total_rows - first);
  const int box0 = first / crop_h;
  const int boxes_here = (first + count - 1) / crop_h - box0 + 1;

  // Stage each row's y taps, then each box's x taps. Indices are clamped
  // only to keep every read inside the maps.
  for (int e = threadIdx.x; e < count + boxes_here * crop_w; e += kThreads) {
    if (e < count) {
      const int n = (first + e) / crop_h;
      const int i = first + e - n * crop_h;
      const int l = min(max(level_idx[n], 0), num_levels - 1);
      const int b = min(max(box_idx[n], 0), batch - 1);
      const int h = levels.height[l];
      const float* box = boxes + 4 * (size_t)n;
      const Taps ty =
          corner_taps(sample_position(box[0], box[2], crop_h, inv_h, i, (float)h), (float)h);
      const size_t row = (size_t)levels.width[l] * cv;
      const T* img = reinterpret_cast<const T*>(levels.data[l]) + (size_t)b * h * row;
      rows[e] = RowTaps<T>{img + ty.lo * row, img + ty.hi * row, ty.lerp,
                           (n - box0) * crop_w, ty.valid};
    } else {
      const int u = e - count;
      const int n = box0 + u / crop_w;
      const int j = u - (n - box0) * crop_w;
      const int w = levels.width[min(max(level_idx[n], 0), num_levels - 1)];
      const float* box = boxes + 4 * (size_t)n;
      const Taps tx =
          corner_taps(sample_position(box[1], box[3], crop_w, inv_w, j, (float)w), (float)w);
      cols[u] = ColTaps{tx.lo * cv, tx.hi * cv, tx.lerp, tx.valid};
    }
  }
  __syncthreads();

  const int row_vecs = crop_w * cv;
  const int total = count * row_vecs;
  T* dst = out + (size_t)first * row_vecs;
  // output e of the block is (row r, column j, vector k), e = (r * crop_w +
  // j) * cv + k; a thread's next output is kThreads further on, so it steps
  // (r, j, k) by the digits of kThreads instead of dividing each e
  const int dr = kThreads / row_vecs;
  const int dj = (kThreads - dr * row_vecs) / cv;
  const int dk = kThreads - dr * row_vecs - dj * cv;
  int r = threadIdx.x / row_vecs;
  int j = (threadIdx.x - r * row_vecs) / cv;
  int k = threadIdx.x - r * row_vecs - j * cv;
  for (int base = threadIdx.x; base < total; base += kUnroll * kThreads) {
    // the four taps of kUnroll outputs load together, then their lerps; a
    // tap that repeats (lo == hi) reads the same address again
    T tl[kUnroll], tr[kUnroll], bl[kUnroll], br[kUnroll];
    float lx[kUnroll], ly[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      ok[q] = false;
      tl[q] = tr[q] = bl[q] = br[q] = splat<T>(0.0f);
      lx[q] = ly[q] = 0.0f;
      if (base + q * kThreads < total) {
        const RowTaps<T> ty = rows[r];
        const ColTaps tx = cols[ty.cols + j];
        ok[q] = ty.valid && tx.valid;
        lx[q] = tx.lerp;
        ly[q] = ty.lerp;
        if (ok[q]) {
          tl[q] = __ldg(ty.top + tx.lo + k);
          tr[q] = __ldg(ty.top + tx.hi + k);
          bl[q] = __ldg(ty.bot + tx.lo + k);
          br[q] = __ldg(ty.bot + tx.hi + k);
        }
      }
      // one carry at most per digit: k + dk < 2 cv, j + dj + 1 < 2 crop_w
      k += dk;
      j += dj;
      r += dr;
      if (k >= cv) {
        k -= cv;
        ++j;
      }
      if (j >= crop_w) {
        j -= crop_w;
        ++r;
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int e = base + q * kThreads;
      if (e < total) {
        __stcs(dst + e, ok[q] ? lerp3(tl[q], tr[q], bl[q], br[q], lx[q], ly[q])
                              : splat<T>(extrap));
      }
    }
  }
}

// Shared bytes of a block of `rows` rows: their y taps, and the x taps of
// the most boxes `rows` consecutive rows can touch.
long long shared_bytes(long long rows, int crop_h, int crop_w) {
  const long long boxes = (rows + crop_h - 2) / crop_h + 1;
  return rows * (long long)sizeof(RowTaps<float>) + boxes * crop_w * (long long)sizeof(ColTaps);
}

}  // namespace

// level_ptrs/heights/widths: num_levels entries (host arrays), each level a
// [batch, height, width, channels] float32 map in device memory, contiguous.
// boxes [n, 4] float32, box_idx [n] int32, level_idx [n] int32 (0-based),
// out [n, crop_h, crop_w, channels] float32. vec: floats read and written
// at a time, 1 or 4 (4 needs channels % 4 == 0 and every level and out on
// 16-byte boundaries). rows_per_block: sample rows per block (the plan of
// ops/roi_align.py::fwd_plan; its staged taps must fit kSharedLimit).
// inv_h/inv_w: float32 1/(crop-1) (unused for a crop of 1). Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int roi_align_fwd(const void* const* level_ptrs, const int* heights,
                             const int* widths, int num_levels, int batch, int channels, int vec,
                             const float* boxes, const int* box_idx, const int* level_idx, int n,
                             int crop_h, int crop_w, int rows_per_block, float inv_h, float inv_w,
                             float extrap, float* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1 || channels < 1 || n < 0 ||
      crop_h < 1 || crop_w < 1 || rows_per_block < 1 || (vec != 1 && vec != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  uintptr_t at = reinterpret_cast<uintptr_t>(out);
  Levels levels = {};
  for (int k = 0; k < num_levels; ++k) {
    if (heights[k] < 1 || widths[k] < 1 || (long long)widths[k] * channels > INT_MAX) {
      return (int)cudaErrorInvalidValue;
    }
    levels.data[k] = static_cast<const float*>(level_ptrs[k]);
    levels.height[k] = heights[k];
    levels.width[k] = widths[k];
    at |= reinterpret_cast<uintptr_t>(level_ptrs[k]);
  }
  if (vec == 4 && ((channels & 3) != 0 || (at & 15) != 0)) return (int)cudaErrorInvalidValue;
  const int cv = channels / vec;
  const long long total_rows = (long long)n * crop_h;
  const long long block_vecs = (long long)rows_per_block * crop_w * cv;
  const long long smem = shared_bytes(rows_per_block, crop_h, crop_w);
  if (total_rows > INT_MAX || block_vecs > INT_MAX - kUnroll * kThreads || smem > kSharedLimit) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((total_rows + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4) {
    roi_align_fwd_kernel<float4><<<blocks, kThreads, (size_t)smem, st>>>(
        levels, num_levels, batch, cv, boxes, box_idx, level_idx, (int)total_rows, crop_h,
        crop_w, rows_per_block, inv_h, inv_w, extrap, reinterpret_cast<float4*>(out));
  } else {
    roi_align_fwd_kernel<float><<<blocks, kThreads, (size_t)smem, st>>>(
        levels, num_levels, batch, cv, boxes, box_idx, level_idx, (int)total_rows, crop_h,
        crop_w, rows_per_block, inv_h, inv_w, extrap, out);
  }
  return (int)cudaGetLastError();
}
