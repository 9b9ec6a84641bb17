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
// Design: one block per (box, output row); the threads run over channels,
// so each tap read is one coalesced row of C floats (1 KB at C = 256).
// Bound on the card: bytes. Each output value reads four taps that mostly
// hit L2 (neighbouring samples share taps), and the output is written once;
// the work is a few flops per byte.

#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_taps.cuh"

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  const float* data[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
};

__global__ void roi_align_fwd_kernel(Levels levels, int num_levels, int batch,
                                     int channels,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ box_idx,
                                     const int* __restrict__ level_idx,
                                     int crop_h, int crop_w, float inv_h,
                                     float inv_w, float extrap,
                                     float* __restrict__ out) {
  const int n = blockIdx.x;
  const int i = blockIdx.y;
  // Indices are clamped only to keep every read inside the maps.
  const int l = min(max(level_idx[n], 0), num_levels - 1);
  const int b = min(max(box_idx[n], 0), batch - 1);
  const int h = levels.height[l];
  const int w = levels.width[l];
  const float y1 = boxes[4 * n + 0];
  const float x1 = boxes[4 * n + 1];
  const float y2 = boxes[4 * n + 2];
  const float x2 = boxes[4 * n + 3];

  const Taps ty = corner_taps(sample_position(y1, y2, crop_h, inv_h, i, (float)h),
                              (float)h);
  const size_t row = (size_t)w * channels;
  const float* img = levels.data[l] + (size_t)b * h * row;
  const float* top = img + (size_t)ty.lo * row;
  const float* bot = img + (size_t)ty.hi * row;
  float* dst = out + ((size_t)n * crop_h + i) * crop_w * channels;

  for (int j = 0; j < crop_w; ++j) {
    const Taps tx = corner_taps(sample_position(x1, x2, crop_w, inv_w, j, (float)w),
                                (float)w);
    const bool valid = ty.valid && tx.valid;
    const float* tl = top + (size_t)tx.lo * channels;
    const float* tr = top + (size_t)tx.hi * channels;
    const float* bl = bot + (size_t)tx.lo * channels;
    const float* br = bot + (size_t)tx.hi * channels;
    float* o = dst + (size_t)j * channels;
    for (int c = threadIdx.x; c < channels; c += blockDim.x) {
      float v = extrap;
      if (valid) {
        const float a = __ldg(tl + c);
        const float t = __fmaf_rn(__ldg(tr + c) - a, tx.lerp, a);
        const float d = __ldg(bl + c);
        const float u = __fmaf_rn(__ldg(br + c) - d, tx.lerp, d);
        v = __fmaf_rn(u - t, ty.lerp, t);
      }
      o[c] = v;
    }
  }
}

}  // namespace

// level_ptrs/heights/widths: num_levels entries (host arrays), each level a
// [batch, height, width, channels] float32 map in device memory, contiguous.
// boxes [n, 4] float32, box_idx [n] int32, level_idx [n] int32 (0-based),
// out [n, crop_h, crop_w, channels] float32. inv_h/inv_w: float32
// 1/(crop-1) (unused for a crop of 1). Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int roi_align_fwd(const void* const* level_ptrs,
                             const int* heights, const int* widths,
                             int num_levels, int batch, int channels,
                             const float* boxes, const int* box_idx,
                             const int* level_idx, int n, int crop_h,
                             int crop_w, float inv_h, float inv_w,
                             float extrap, float* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || batch < 1 ||
      channels < 1 || crop_h < 1 || crop_w < 1 || crop_h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  Levels levels = {};
  for (int k = 0; k < num_levels; ++k) {
    levels.data[k] = static_cast<const float*>(level_ptrs[k]);
    levels.height[k] = heights[k];
    levels.width[k] = widths[k];
  }
  int threads = ((channels + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((unsigned)n, (unsigned)crop_h);
  roi_align_fwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      levels, num_levels, batch, channels, boxes, box_idx, level_idx, crop_h,
      crop_w, inv_h, inv_w, extrap, out);
  return (int)cudaGetLastError();
}
