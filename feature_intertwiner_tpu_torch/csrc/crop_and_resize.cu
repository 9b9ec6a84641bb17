// Single-level TF crop_and_resize with the boxes grouped per image: one
// kernel body for two TPU kernels,
//   K4 feature_intertwiner_tpu/ops/roi_align.py::_roi_align_kernel
//      (behind crop_and_resize_pallas; here crop_and_resize_grouped), and
//   K5 feature_intertwiner_tpu/ops/roi_align.py::_roi_align_matmul_kernel
//      (behind crop_and_resize_pallas_mm; crop_and_resize_grouped_mm).
// Both hold a channel tile of the whole map in VMEM and interpolate on the
// MXU, as a [crop_w, W] two-tap matrix per sample row (K4) or as Wy @ img
// and Wx @ rows (K5), whose zeros cost nothing there. On the card each
// column between a box's taps would be a load, so this reads only the four
// taps of each sample. For box n = (y1, x1, y2, x2) of image b, on a map
// of height H (the same along x over W and crop_w):
//   step  = ((y2 - y1) * (H - 1)) / (crop_h - 1)      true division
//   pos_i = y1 * (H - 1) + i * step                   (centre when crop is 1)
// or, in K4's `xla` mode, as XLA compiles the JAX single-level
// crop_and_resize under jit (the Dev big-set crop of a train step):
//   ratio = f32(H - 1) * f32(1 / (crop_h - 1))        one folded constant
//   pos_i = fma(i, (y2 - y1) * ratio, y1 * (H - 1))   one rounding
//   lo, hi = floor(pos), ceil(pos) clamped to the map, f = pos - floor(pos)
// K4: rl = tl + (bl - tl) * fy, rr = tr + (br - tr) * fy, out = (1 - fx) *
//   rl + fx * rr, even where lo == hi; extrapolation_value where pos_y or
//   pos_x lies outside [0, dim - 1]. K5: (1 - fy) * top + fy * bot over each
//   tap column (the top tap alone where lo == hi, weight exactly 1, as
//   _interp_matrix makes it), then the same along x; 0 outside the map.
// fp32 in that order, compiled with -fmad=false, so nothing is contracted
// and the plain versions in ops/roi_align.py round the same way.
//
// Bound on the card: bytes. Each output value reads its taps (mostly from
// L2: neighbouring samples share them) and is written once.
//
// Design (K1's, csrc/roi_align_fwd.cu; the lerp chosen at compile time).
// The crops are a flat list of sample rows (box, row) of the [b * nb] box
// list, image-major, so that one image's map is read while it is in L2. A
// block takes rows_per_block consecutive rows (ops/roi_align.py::fwd_plan:
// about 4,096 output vectors; a box's rows may span two blocks), stages once
// each row's y taps (map-row pointers, lerp, validity) and its boxes' x taps
// in shared memory, 32 and 16 bytes each, and crosses one barrier. Its
// threads run over (row, column, group of V channels), channels fastest,
// stepping those indices kThreads outputs at a time without a division, and
// each issues the four tap loads of kUnroll outputs before their lerps. The
// crops go out as streaming stores, so that they do not evict the map from
// L2. V is 4 when C % 4 == 0 and the image and the crops start on 16-byte
// boundaries (ops/roi_align.py::mm_vector_width; the entry refuses 4
// otherwise: an unaligned vector access loses the CUDA context), else 1. No
// map row is kept in shared memory: any map width (a row within INT_MAX
// floats) and channel count.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                // outputs a thread loads before their lerps
constexpr int kSharedLimit = 48 * 1024;   // most shared memory for the staged taps

// A sample's taps along one axis; staged for x with lo and hi in vectors
// from the start of a map row.
struct __align__(16) Axis { int lo, hi; float frac; int valid; };

// A sample row's y taps: its two map rows (at channel 0 of column 0), lerp
// and validity, and where its box's x taps start among the block's.
template <typename T>
struct __align__(16) RowTaps { const T *top, *bot; float frac; int cols, valid; };

static_assert(sizeof(RowTaps<float>) == 32 && sizeof(RowTaps<float4>) == 32 &&
                  sizeof(Axis) == 16,
              "ops/roi_align.py::fwd_shared_bytes counts 32 and 16 bytes");

// Sample position of sample i along one axis, rounded as K4 and K5 round it
// or, with `xla`, as the jitted XLA crop does; `ratio` is (dm1 * (1 / (crop
// - 1))) in float32, which only that rounding reads.
__device__ __forceinline__ float sample_pos(float c0, float c1, int crop, int i, float dm1,
                                           float ratio, bool xla) {
  if (crop > 1) {
    if (xla) return __fmaf_rn((float)i, __fmul_rn(c1 - c0, ratio), __fmul_rn(c0, dm1));
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

__device__ __forceinline__ float lerp2(float a, float b, float wa, float wb) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// One output value from its four taps: K5's separable passes or K4's
// lerps. For a valid sample lo == hi exactly where the lerp is 0.
template <bool kSeparable>
__device__ __forceinline__ float interp(float tl, float tr, float bl, float br, float fx,
                                        float fy) {
  if constexpr (kSeparable) {
    const float wy = __fsub_rn(1.0f, fy);
    const float rl = fy == 0.0f ? tl : lerp2(tl, bl, wy, fy);
    const float rr = fy == 0.0f ? tr : lerp2(tr, br, wy, fy);
    return fx == 0.0f ? rl : lerp2(rl, rr, __fsub_rn(1.0f, fx), fx);
  }
  const float rl = __fadd_rn(tl, __fmul_rn(__fsub_rn(bl, tl), fy));
  const float rr = __fadd_rn(tr, __fmul_rn(__fsub_rn(br, tr), fy));
  return lerp2(rl, rr, __fsub_rn(1.0f, fx), fx);
}

template <bool kSeparable>
__device__ __forceinline__ float4 interp(float4 tl, float4 tr, float4 bl, float4 br, float fx,
                                         float fy) {
  return make_float4(interp<kSeparable>(tl.x, tr.x, bl.x, br.x, fx, fy),
                     interp<kSeparable>(tl.y, tr.y, bl.y, br.y, fx, fy),
                     interp<kSeparable>(tl.z, tr.z, bl.z, br.z, fx, fy),
                     interp<kSeparable>(tl.w, tr.w, bl.w, br.w, fx, fy));
}

// T is float (V = 1) or float4 (V = 4); cv = channels / V. Rows [first,
// first + rows_per_block) of the flat [b * nb * crop_h] list.
template <typename T, bool kSeparable>
__global__ void __launch_bounds__(kThreads)
grouped_crop_kernel(const T* __restrict__ image, const float* __restrict__ boxes,
                    int total_rows, int nb, int h, int w, int cv, int crop_h, int crop_w,
                    int rows_per_block, bool xla, T extrap, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char staged[];
  RowTaps<T>* rows = reinterpret_cast<RowTaps<T>*>(staged);
  Axis* cols = reinterpret_cast<Axis*>(staged + rows_per_block * sizeof(RowTaps<T>));
  const int first = blockIdx.x * rows_per_block;
  const int count = min(rows_per_block, total_rows - first);
  const int box0 = first / crop_h;
  const int boxes_here = (first + count - 1) / crop_h - box0 + 1;
  const float hm1 = (float)h - 1.0f, wm1 = (float)w - 1.0f;
  const float ratio_h = __fmul_rn(hm1, __frcp_rn((float)max(crop_h - 1, 1)));
  const float ratio_w = __fmul_rn(wm1, __frcp_rn((float)max(crop_w - 1, 1)));
  const size_t map_row = (size_t)w * cv;

  // Stage each row's y taps, then each box's x taps.
  for (int e = threadIdx.x; e < count + boxes_here * crop_w; e += kThreads) {
    if (e < count) {
      const int n = (first + e) / crop_h;
      const float* box = boxes + 4 * (size_t)n;
      const Axis ty = axis_taps(
          sample_pos(box[0], box[2], crop_h, first + e - n * crop_h, hm1, ratio_h, xla), hm1);
      const T* img = image + (size_t)(n / nb) * h * map_row;
      rows[e] = RowTaps<T>{img + ty.lo * map_row, img + ty.hi * map_row, ty.frac,
                           (n - box0) * crop_w, ty.valid};
    } else {
      const int u = e - count;
      const int m = u / crop_w;
      const float* box = boxes + 4 * ((size_t)box0 + m);
      Axis tx = axis_taps(sample_pos(box[1], box[3], crop_w, u - m * crop_w, wm1, ratio_w, xla),
                          wm1);
      tx.lo *= cv;
      tx.hi *= cv;
      cols[u] = tx;
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
    float fx[kUnroll], fy[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      ok[q] = false;
      tl[q] = tr[q] = bl[q] = br[q] = T{};
      fx[q] = fy[q] = 0.0f;
      if (base + q * kThreads < total) {
        const RowTaps<T> ty = rows[r];
        const Axis tx = cols[ty.cols + j];
        ok[q] = ty.valid && tx.valid;
        fx[q] = tx.frac;
        fy[q] = ty.frac;
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
        __stcs(dst + e, ok[q] ? interp<kSeparable>(tl[q], tr[q], bl[q], br[q], fx[q], fy[q])
                              : extrap);
      }
    }
  }
}

template <bool kSeparable>
int launch(const float* image, const float* boxes, int b, int nb, int h, int w, int c, bool xla,
           int vec, int crop_h, int crop_w, int rows_per_block, float extrap, float* out,
           void* stream) {
  if (b < 1 || nb < 0 || h < 1 || w < 1 || c < 1 || crop_h < 1 || crop_w < 1 ||
      rows_per_block < 1 || (vec != 1 && vec != 4) || (long long)w * c > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t at = reinterpret_cast<uintptr_t>(image) | reinterpret_cast<uintptr_t>(out);
  if (vec == 4 && ((c & 3) != 0 || (at & 15) != 0)) return (int)cudaErrorInvalidValue;
  const int cv = c / vec;
  const long long total_rows = (long long)b * nb * crop_h;
  const long long block_vecs = (long long)rows_per_block * crop_w * cv;
  // the block's rows' y taps, and the x taps of the most boxes they can touch
  const long long smem = rows_per_block * (long long)sizeof(RowTaps<float>) +
                         ((rows_per_block + crop_h - 2LL) / crop_h + 1) * crop_w * sizeof(Axis);
  if (total_rows > INT_MAX || block_vecs > INT_MAX - kUnroll * kThreads || smem > kSharedLimit) {
    return (int)cudaErrorInvalidValue;
  }
  if (nb == 0) return 0;
  const unsigned blocks = (unsigned)((total_rows + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec == 4) {
    grouped_crop_kernel<float4, kSeparable><<<blocks, kThreads, (size_t)smem, st>>>(
        reinterpret_cast<const float4*>(image), boxes, (int)total_rows, nb, h, w, cv, crop_h,
        crop_w, rows_per_block, xla, make_float4(extrap, extrap, extrap, extrap),
        reinterpret_cast<float4*>(out));
  } else {
    grouped_crop_kernel<float, kSeparable><<<blocks, kThreads, (size_t)smem, st>>>(
        image, boxes, (int)total_rows, nb, h, w, cv, crop_h, crop_w, rows_per_block, xla,
        extrap, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// image [b, h, w, c] and boxes [b, nb, 4] float32, contiguous, in device
// memory; out [b, nb, crop_h, crop_w, c] float32. separable: K5 (its
// extrapolation is 0) or K4. xla: sample positions rounded as the jitted
// XLA crop rounds them, else as the Pallas kernels do (K5 takes 0). vec:
// floats read and written at a time, 1 or 4
// (4 needs c % 4 == 0 and image and out on 16-byte boundaries).
// rows_per_block: the plan of ops/roi_align.py::fwd_plan (its staged taps
// within kSharedLimit). Launches on `stream`, returns the launch's error.
extern "C" int crop_and_resize_grouped(const float* image, const float* boxes, int b, int nb,
                                       int h, int w, int c, int separable, int xla, int vec,
                                       int crop_h, int crop_w, int rows_per_block, float extrap,
                                       float* out, void* stream) {
  return (separable ? launch<true> : launch<false>)(image, boxes, b, nb, h, w, c, xla != 0, vec,
                                                    crop_h, crop_w, rows_per_block, extrap, out,
                                                    stream);
}
