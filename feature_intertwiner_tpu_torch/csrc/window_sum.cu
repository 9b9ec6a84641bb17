// Per-box window sums: out[n, c] = sum over (y, x) of
//   img[b, y0 + y, 8 * x0 + x, c],  0 <= y < sy, 0 <= x < sx,
// with origins[n] = (b, y0, x0) int32 (x stored divided by 8), accumulated
// in fp32.
//
// Replaces the Pallas kernel
//   scripts/profile_window_dma.py::_probe_kernel
// (behind window_dma_checksum), a probe of the TPU's per-box window DMA.
// The TPU kernel packs each origin into one int32 (scalar-prefetch SMEM
// budget) and double-buffers the window copies into VMEM; both were TPU
// constraints and neither is needed here.
//
// Bound on the card: bytes, the map pixels that some window covers read
// once over 3.35 TB/s. Overlapping windows read the same pixels again, and
// L2 serves those repeats: the window bytes themselves stream faster than
// the HBM rate once windows overlap. The work is one add per element.
//
// Design: one block per (window, chunk of channels); the threads run along
// C, two channels each (a bf16 pair or a float2 load), so each pixel's row
// of C values is read coalesced. The block walks the window's pixels in
// row-major order and each thread adds them in that order into fp32
// registers, so the result is deterministic and the plain version in
// ops/window_sum.py, which adds in the same order, matches it bit for bit
// (-fmad=false; there is nothing to contract). An origin whose window leaves
// the map gives NaN for that window instead of a read out of bounds.
// A cp.async or TMA pipeline is not used in this first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // two channels each: 256 channels per block

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// c is even, so every pair is aligned and lies inside one pixel's row.
template <typename T>
__global__ void window_sum_kernel(const T* __restrict__ img,
                                  const int* __restrict__ origins, int batch,
                                  int h, int w, int c, int sy, int sx,
                                  float* __restrict__ out) {
  const int n = blockIdx.x;
  const int ch = 2 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (ch >= c) return;
  const int b = origins[3 * n + 0];
  const int y0 = origins[3 * n + 1];
  const int x0 = 8 * origins[3 * n + 2];
  float* o = out + (size_t)n * c + ch;
  if (b < 0 || b >= batch || y0 < 0 || y0 + sy > h || x0 < 0 || x0 + sx > w) {
    o[0] = o[1] = __int_as_float(0x7fc00000);  // quiet NaN
    return;
  }
  const T* base = img + (((size_t)b * h + y0) * w + x0) * c + ch;
  float a0 = 0.0f, a1 = 0.0f;
  for (int y = 0; y < sy; ++y) {
    const T* row = base + (size_t)y * w * c;
    for (int x = 0; x < sx; ++x) {
      const float2 v = Pair<T>::load(row + (size_t)x * c);
      a0 = __fadd_rn(a0, v.x);
      a1 = __fadd_rn(a1, v.y);
    }
  }
  o[0] = a0;
  o[1] = a1;
}

template <typename T>
int launch(const void* img, const int* origins, int n, int batch, int h, int w,
           int c, int sy, int sx, float* out, void* stream) {
  const int chunks = (c / 2 + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)n, (unsigned)chunks);
  window_sum_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(img), origins, batch, h, w, c, sy, sx, out);
  return (int)cudaGetLastError();
}

}  // namespace

// img [batch, h, w, c] (float32 when is_bf16 is 0, bfloat16 when 1) and
// origins [n, 3] int32, contiguous, in device memory; out [n, c] float32.
// c must be even. Launches on `stream` and returns the cudaError_t of the
// launch.
extern "C" int window_sum(const void* img, int is_bf16, const int* origins,
                          int n, int batch, int h, int w, int c, int sy, int sx,
                          float* out, void* stream) {
  if (batch < 1 || h < 1 || w < 1 || c < 2 || c % 2 || sy < 1 || sx < 1 ||
      (c / 2 + kThreads - 1) / kThreads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  if (is_bf16) {
    return launch<__nv_bfloat16>(img, origins, n, batch, h, w, c, sy, sx, out,
                                 stream);
  }
  return launch<float>(img, origins, n, batch, h, w, c, sy, sx, out, stream);
}
