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
// is masked. K5: the TPU kernel's two products keep the zeros of a [crop,
// W] interpolation matrix, which cost nothing on the MXU; on the card every
// column between a box's taps would be a load. So K5 reads only the taps:
// a block takes a few consecutive boxes (image-major, so that one image's
// map is read while it is in L2; enough boxes for about kMmVectors output
// vectors), computes their crop_h y taps and crop_w x taps once into
// shared memory (16 bytes each), and after one barrier its threads run
// over (box, sample row, sample column, group of V channels) with the
// channels fastest. Each thread loads its four taps top[lo_x], top[hi_x],
// bot[lo_x], bot[hi_x] as V-float vectors, takes the y pass of each tap
// column and then the x pass in registers, and writes one vector with a
// streaming store, so that the crops do not evict the map from L2. V is 4
// when the channel count is a multiple of 4 and both the image and the
// crops start on 16-byte boundaries, else 1 (the caller chooses; the entry
// checks). No map row is kept in shared memory, so K5 takes any map width
// and channel count.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBoxTile = 8;
constexpr int kThreads = 256;
constexpr int kMmVectors = 2048;         // K5: output vectors a block aims at
constexpr int kMmBoxes = 32;             // K5: most boxes per block
constexpr int kMmTapBytes = 48 * 1024;   // K5: most shared memory for the taps

struct __align__(16) Axis {
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

__device__ __forceinline__ float lerp2(float a, float b, float wa, float wb) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

__device__ __forceinline__ float4 lerp2(float4 a, float4 b, float wa, float wb) {
  return make_float4(lerp2(a.x, b.x, wa, wb), lerp2(a.y, b.y, wa, wb),
                     lerp2(a.z, b.z, wa, wb), lerp2(a.w, b.w, wa, wb));
}

// T is float (V = 1) or float4 (V = 4); cv = channels / V. Boxes
// [first, first + per_block) of the flat [b * nb] list; taps holds each
// box's crop_h y taps, then its crop_w x taps.
template <typename T>
__global__ void __launch_bounds__(kThreads)
crop_and_resize_mm_kernel(const T* __restrict__ image, const float* __restrict__ boxes,
                          int total, int nb, int h, int w, int cv, int crop_h, int crop_w,
                          int per_block, T* __restrict__ out) {
  extern __shared__ Axis taps[];
  const int first = blockIdx.x * per_block;
  const int count = min(per_block, total - first);
  const int stride = crop_h + crop_w;
  const float hm1 = (float)h - 1.0f;
  const float wm1 = (float)w - 1.0f;
  for (int e = threadIdx.x; e < count * stride; e += blockDim.x) {
    const int u = e / stride;
    const int s = e - u * stride;
    const float* box = boxes + 4 * ((size_t)first + u);
    taps[e] = s < crop_h
                  ? axis_taps(sample_pos(box[0], box[2], crop_h, s, hm1), hm1)
                  : axis_taps(sample_pos(box[1], box[3], crop_w, s - crop_h, wm1), wm1);
  }
  __syncthreads();

  const int row = crop_w * cv;  // vectors per sample row
  const int per_box = crop_h * row;
  T* dst = out + (size_t)first * per_box;
  for (int e = threadIdx.x; e < count * per_box; e += blockDim.x) {
    const int u = e / per_box;
    int r = e - u * per_box;
    const int i = r / row;
    r -= i * row;
    const int j = r / cv;
    const int k = r - j * cv;
    const Axis ay = taps[u * stride + i];
    const Axis ax = taps[u * stride + crop_h + j];
    T v{};
    if (ay.valid && ax.valid) {
      const T* img = image + (size_t)((first + u) / nb) * h * w * cv + k;
      const T* top = img + (size_t)ay.lo * w * cv;
      const T* bot = img + (size_t)ay.hi * w * cv;
      const size_t xl = (size_t)ax.lo * cv;
      const size_t xr = (size_t)ax.hi * cv;
      // the four taps load together; a tap that repeats (lo == hi) reads
      // the same address again
      const T tl = __ldg(top + xl);
      const T tr = __ldg(top + xr);
      const T bl = __ldg(bot + xl);
      const T br = __ldg(bot + xr);
      // y pass of each tap column: (1 - fy) * top + fy * bot, the top tap
      // alone (weight exactly 1) when lo == hi; then the same along x
      const bool one_y = ay.lo == ay.hi;
      const float wy = __fsub_rn(1.0f, ay.frac);
      const T rl = one_y ? tl : lerp2(tl, bl, wy, ay.frac);
      const T rr = one_y ? tr : lerp2(tr, br, wy, ay.frac);
      v = ax.lo == ax.hi ? rl : lerp2(rl, rr, __fsub_rn(1.0f, ax.frac), ax.frac);
    }
    __stcs(dst + e, v);
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

// As crop_and_resize_grouped, extrapolation 0, read vec (1 or 4) floats at
// a time: vec 4 needs c % 4 == 0 and image and out on 16-byte boundaries.
extern "C" int crop_and_resize_grouped_mm(const float* image, const float* boxes, int b,
                                          int nb, int h, int w, int c, int vec, int crop_h,
                                          int crop_w, float* out, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c < 1 || crop_h < 1 || crop_w < 1 ||
      (vec != 1 && vec != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t at = reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(out);
  if (vec == 4 && ((c & 3) != 0 || (at & 15) != 0)) return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const long long total = (long long)b * nb;
  const int cv = c / vec;
  const long long per_box = (long long)crop_h * crop_w * cv;
  const long long stride = (long long)crop_h + crop_w;
  // boxes per block: about kMmVectors output vectors, at most kMmBoxes
  // boxes, their taps within kMmTapBytes of shared memory
  long long per_block = std::min<long long>(kMmBoxes, std::max(1LL, kMmVectors / per_box));
  per_block = std::min<long long>(per_block, kMmTapBytes / (stride * (long long)sizeof(Axis)));
  if (total > INT_MAX || per_block < 1 || per_box * per_block > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((total + per_block - 1) / per_block);
  const size_t smem = (size_t)(per_block * stride) * sizeof(Axis);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4) {
    crop_and_resize_mm_kernel<float4><<<blocks, kThreads, smem, st>>>(
        reinterpret_cast<const float4*>(image), boxes, (int)total, nb, h, w, cv, crop_h,
        crop_w, (int)per_block, reinterpret_cast<float4*>(out));
  } else {
    crop_and_resize_mm_kernel<float><<<blocks, kThreads, smem, st>>>(
        image, boxes, (int)total, nb, h, w, cv, crop_h, crop_w, (int)per_block, out);
  }
  return (int)cudaGetLastError();
}
