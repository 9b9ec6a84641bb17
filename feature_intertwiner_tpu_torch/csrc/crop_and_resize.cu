// Single-level TF crop_and_resize with the boxes grouped per image, two
// entry points.
//
// crop_and_resize_grouped replaces the Pallas kernel
//   feature_intertwiner_tpu/ops/roi_align.py::_roi_align_kernel
// (behind crop_and_resize_pallas), and crop_and_resize_grouped_mm replaces
//   feature_intertwiner_tpu/ops/roi_align.py::_roi_align_matmul_kernel
// (behind crop_and_resize_pallas_mm). Both TPU kernels hold a channel tile
// of the whole map in VMEM and interpolate on the MXU, as a [crop_w, W]
// two-tap matrix per sample row (K4) or as the products Wy @ img and
// Wx @ rows (K5). On the card a dense [crop, W] product would do W/2 times
// the needed work in fp32, with no tensor core worth the cost, so both
// kernels here read the two taps of each sample and drop the zeros.
//
// What they compute, for box n = (y1, x1, y2, x2) of image b, on a map of
// height H (the same along x over W and crop_w):
//   step  = ((y2 - y1) * (H - 1)) / (crop_h - 1)      true division
//   pos_i = y1 * (H - 1) + i * step                   (centre when crop is 1)
//   lo, hi = floor(pos), ceil(pos) clamped to the map, f = pos - floor(pos)
// K4 (extrapolation_value e): row = t + (b - t) * fy over the tap rows, then
//   out = (1 - fx) * row[lo_x] + fx * row[hi_x];  e where pos_y or pos_x
//   lies outside [0, dim - 1].
// K5 (extrapolation 0): row = (1 - fy) * img[lo_y] + fy * img[hi_y] (weight
//   exactly 1 when lo == hi, as _interp_matrix makes it), then the same x
//   pass; 0 outside the map.
// Everything in fp32 and in that order; the file is compiled with
// -fmad=false, so no multiply and add is contracted and the plain PyTorch
// versions in ops/roi_align.py round the same way.
//
// Bound on the card: bytes. Each output value reads its taps (mostly from
// L2: neighbouring samples share them) and is written once; the work is a
// few flops per value.
//
// Design. K4: one block per (image, tile of kBoxTile boxes, sample row);
// the threads run over (sample column, channel) with the channel fastest,
// so every tap row is read coalesced, and the ragged edge of the box tile
// is masked. K5: one block per (box, channel tile); for each sample row the
// block writes the y-interpolated row over the box's x-tap span into shared
// memory, then takes the x pass from there. The channel tile is chosen by
// the caller so that W * tile floats fit the dynamic shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxTile = 8;
constexpr int kThreads = 256;

struct Axis {
  int lo;
  int hi;
  float frac;
  bool valid;
};

// Sample position of sample i along one axis, rounded as K4 and K5 round it.
__device__ __forceinline__ float sample_pos(float c0, float c1, int crop, int i,
                                            float dm1) {
  if (crop > 1) {
    const float step = __fdiv_rn(__fmul_rn(c1 - c0, dm1), (float)(crop - 1));
    return __fadd_rn(__fmul_rn(c0, dm1), __fmul_rn((float)i, step));
  }
  return __fmul_rn(__fmul_rn(0.5f, c0 + c1), dm1);
}

__device__ __forceinline__ Axis axis_taps(float pos, float dm1) {
  Axis a;
  a.valid = (pos >= 0.0f) && (pos <= dm1);
  const float lo = floorf(pos);
  a.frac = pos - lo;
  // clamped in float first, so that a far position never leaves int range
  a.lo = (int)fminf(fmaxf(lo, 0.0f), dm1);
  a.hi = (int)fminf(fmaxf(ceilf(pos), 0.0f), dm1);
  return a;
}

__global__ void crop_and_resize_kernel(const float* __restrict__ image,
                                       const float* __restrict__ boxes,
                                       int nb, int h, int w, int c, int crop_h,
                                       int crop_w, float extrap,
                                       float* __restrict__ out) {
  const int tiles = (nb + kBoxTile - 1) / kBoxTile;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int i = blockIdx.y;
  const float hm1 = (float)h - 1.0f;
  const float wm1 = (float)w - 1.0f;
  const float* img = image + (size_t)b * h * w * c;
  const int per_box = crop_w * c;

  for (int k = 0; k < kBoxTile; ++k) {
    const int n = tile * kBoxTile + k;
    if (n >= nb) break;  // the ragged edge of the last tile
    const float* box = boxes + ((size_t)b * nb + n) * 4;
    const float y1 = box[0], x1 = box[1], y2 = box[2], x2 = box[3];
    const Axis ay = axis_taps(sample_pos(y1, y2, crop_h, i, hm1), hm1);
    const float* top = img + (size_t)ay.lo * w * c;
    const float* bot = img + (size_t)ay.hi * w * c;
    float* dst = out + (((size_t)b * nb + n) * crop_h + i) * per_box;
    for (int e = threadIdx.x; e < per_box; e += blockDim.x) {
      const int j = e / c;
      const int ch = e - j * c;
      const Axis ax = axis_taps(sample_pos(x1, x2, crop_w, j, wm1), wm1);
      float v = extrap;
      if (ay.valid && ax.valid) {
        const float tl = __ldg(top + (size_t)ax.lo * c + ch);
        const float tr = __ldg(top + (size_t)ax.hi * c + ch);
        const float bl = __ldg(bot + (size_t)ax.lo * c + ch);
        const float br = __ldg(bot + (size_t)ax.hi * c + ch);
        // the y lerp of each tap column, then the 2-tap x product
        const float rl = __fadd_rn(tl, __fmul_rn(__fsub_rn(bl, tl), ay.frac));
        const float rr = __fadd_rn(tr, __fmul_rn(__fsub_rn(br, tr), ay.frac));
        v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, ax.frac), rl),
                      __fmul_rn(ax.frac, rr));
      }
      dst[e] = v;
    }
  }
}

__global__ void crop_and_resize_mm_kernel(const float* __restrict__ image,
                                          const float* __restrict__ boxes,
                                          int nb, int h, int w, int c,
                                          int c_tile, int crop_h, int crop_w,
                                          float* __restrict__ out) {
  extern __shared__ float rows[];  // [span, c_tile]
  __shared__ int span_lo, span_hi;
  const int n = blockIdx.x;  // flat box index b * nb + k
  const int b = n / nb;
  const int c0 = blockIdx.y * c_tile;
  const int ct = min(c_tile, c - c0);  // the ragged last channel tile
  const float hm1 = (float)h - 1.0f;
  const float wm1 = (float)w - 1.0f;
  const float y1 = boxes[4 * (size_t)n + 0], x1 = boxes[4 * (size_t)n + 1];
  const float y2 = boxes[4 * (size_t)n + 2], x2 = boxes[4 * (size_t)n + 3];
  const float* img = image + (size_t)b * h * w * c + c0;
  float* dst = out + (size_t)n * crop_h * crop_w * c + c0;

  // the columns the valid x samples tap
  if (threadIdx.x == 0) {
    int lo = w, hi = -1;
    for (int j = 0; j < crop_w; ++j) {
      const Axis ax = axis_taps(sample_pos(x1, x2, crop_w, j, wm1), wm1);
      if (ax.valid) {
        lo = min(lo, ax.lo);
        hi = max(hi, ax.hi);
      }
    }
    span_lo = lo;
    span_hi = hi;
  }
  __syncthreads();
  const int lo_col = span_lo;
  const int span = span_hi - span_lo + 1;  // <= 0 when no x sample is valid

  for (int i = 0; i < crop_h; ++i) {
    const Axis ay = axis_taps(sample_pos(y1, y2, crop_h, i, hm1), hm1);
    const bool row_valid = ay.valid && span > 0;
    if (row_valid) {
      // y pass over the span: (1 - fy) * img[lo] + fy * img[hi]; one tap
      // with weight 1 when lo == hi
      const float* top = img + (size_t)ay.lo * w * c;
      const float* bot = img + (size_t)ay.hi * w * c;
      const float wt = __fsub_rn(1.0f, ay.frac);
      for (int e = threadIdx.x; e < span * ct; e += blockDim.x) {
        const int x = e / ct;
        const int ch = e - x * ct;
        const size_t off = (size_t)(lo_col + x) * c + ch;
        float r;
        if (ay.lo == ay.hi) {
          r = __ldg(top + off);
        } else {
          r = __fadd_rn(__fmul_rn(wt, __ldg(top + off)),
                        __fmul_rn(ay.frac, __ldg(bot + off)));
        }
        rows[e] = r;
      }
    }
    __syncthreads();
    // x pass from shared memory
    float* drow = dst + (size_t)i * crop_w * c;
    for (int e = threadIdx.x; e < crop_w * ct; e += blockDim.x) {
      const int j = e / ct;
      const int ch = e - j * ct;
      float v = 0.0f;
      if (row_valid) {
        const Axis ax = axis_taps(sample_pos(x1, x2, crop_w, j, wm1), wm1);
        if (ax.valid) {
          const float rl = rows[(ax.lo - lo_col) * ct + ch];
          if (ax.lo == ax.hi) {
            v = rl;
          } else {
            const float rr = rows[(ax.hi - lo_col) * ct + ch];
            v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, ax.frac), rl),
                          __fmul_rn(ax.frac, rr));
          }
        }
      }
      drow[(size_t)j * c + ch] = v;
    }
    __syncthreads();  // rows is rewritten by the next sample row
  }
}

}  // namespace

// image [b, h, w, c] and boxes [b, nb, 4] float32, contiguous, in device
// memory; out [b, nb, crop_h, crop_w, c] float32. Launches on `stream` and
// returns the cudaError_t of the launch.
extern "C" int crop_and_resize_grouped(const float* image, const float* boxes,
                                       int b, int nb, int h, int w, int c,
                                       int crop_h, int crop_w, float extrap,
                                       float* out, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || crop_h < 1 || crop_w < 1 ||
      crop_h > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (nb == 0) return 0;
  const long long blocks = (long long)b * ((nb + kBoxTile - 1) / kBoxTile);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)crop_h);
  crop_and_resize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      image, boxes, nb, h, w, c, crop_h, crop_w, extrap, out);
  return (int)cudaGetLastError();
}

// As crop_and_resize_grouped, extrapolation 0. c_tile channels per block:
// w * c_tile floats of dynamic shared memory, at most 227 KB.
extern "C" int crop_and_resize_grouped_mm(const float* image,
                                          const float* boxes, int b, int nb,
                                          int h, int w, int c, int c_tile,
                                          int crop_h, int crop_w, float* out,
                                          void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || c_tile < 1 || crop_h < 1 ||
      crop_w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (nb == 0) return 0;
  const size_t smem = (size_t)w * c_tile * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        crop_and_resize_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long boxes_total = (long long)b * nb;
  const int tiles = (c + c_tile - 1) / c_tile;
  if (boxes_total > 2147483647LL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)boxes_total, (unsigned)tiles);
  crop_and_resize_mm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      image, boxes, nb, h, w, c, c_tile, crop_h, crop_w, out);
  return (int)cudaGetLastError();
}
