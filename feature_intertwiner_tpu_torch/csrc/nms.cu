// Greedy-NMS alive mask over boxes already sorted by descending score.
//
// Replaces the Pallas kernel
//   feature_intertwiner_tpu/ops/nms_pallas.py::_nms_kernel
// whose output is bit-identical to ops/nms.py::_greedy_alive_sorted (the XLA
// block sweep). Greedy NMS: walk the boxes in score order; a valid box that no
// kept box suppressed is kept and suppresses every later box whose IoU with
// it passes the threshold (`>` when strict, `>=` otherwise). Invalid rows are
// never kept and never suppress.
//
// Two kernels, both on the caller's stream, no host round trip:
//  (a) nms_mask_kernel: the suppression bitmask mask[b, i, k] (uint64), bit t
//      set when row i suppresses column k*64+t > i. Upper triangle only; the
//      64 column boxes of a block sit in shared memory.
//  (b) nms_sweep_kernel: one block per batch row walks the 64-row tiles in
//      order. A single thread resolves a tile's rows against the `removed`
//      bitset (kept in shared memory, n/64 words) and the tile's diagonal
//      words; then all threads OR the kept rows' words into `removed`.
//
// Bit-exactness: the IoU is computed in fp32 with the expression order of
// ops/nms.py::_pairwise_iou, the file is compiled with -fmad=false (no FMA
// contraction), division is IEEE round-to-nearest, and the threshold
// arrives as a float.
//
// Bound on the card: operations. (a) evaluates n^2/2 IoUs per row (about 20
// flops each); (b) is a serial walk of n/64 tiles whose cost is latency, not
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kSweepThreads = 128;

__device__ __forceinline__ float iou(const float* a, const float* b,
                                     float off) {
  const float y1 = fmaxf(a[0], b[0]);
  const float x1 = fmaxf(a[1], b[1]);
  const float y2 = fminf(a[2], b[2]);
  const float x2 = fminf(a[3], b[3]);
  const float inter = fmaxf(x2 - x1 + off, 0.0f) * fmaxf(y2 - y1 + off, 0.0f);
  const float area_a = (a[2] - a[0] + off) * (a[3] - a[1] + off);
  const float area_b = (b[2] - b[0] + off) * (b[3] - b[1] + off);
  return inter / (area_a + area_b - inter);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int col_blocks, float thresh, float off,
                                int strict,
                                unsigned long long* __restrict__ mask) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (row_block > col_block) return;  // never read by the sweep
  const int t = threadIdx.x;
  const float* bx = boxes + (size_t)blockIdx.z * n * 4;

  __shared__ float cols[kTile * 4];
  const int col = col_block * kTile + t;
#pragma unroll
  for (int k = 0; k < 4; ++k) cols[t * 4 + k] = bx[(size_t)col * 4 + k];
  __syncthreads();

  const int row = row_block * kTile + t;
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = bx[(size_t)row * 4 + k];

  unsigned long long bits = 0ULL;
  const int start = (row_block == col_block) ? t + 1 : 0;
  for (int j = start; j < kTile; ++j) {
    const float v = iou(r, cols + j * 4, off);
    const bool s = strict ? (v > thresh) : (v >= thresh);
    if (s) bits |= 1ULL << j;
  }
  mask[((size_t)blockIdx.z * n + row) * col_blocks + col_block] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid, int n,
                                 int col_blocks, uint8_t* __restrict__ alive) {
  extern __shared__ unsigned long long removed[];  // col_blocks words
  __shared__ unsigned long long diag[kTile];
  __shared__ uint8_t tile_valid[kTile];
  __shared__ unsigned long long tile_keep;

  const unsigned long long* m = mask + (size_t)blockIdx.x * n * col_blocks;
  const uint8_t* v = valid + (size_t)blockIdx.x * n;
  uint8_t* a = alive + (size_t)blockIdx.x * n;
  const int t = threadIdx.x;

  for (int k = t; k < col_blocks; k += blockDim.x) removed[k] = 0ULL;
  __syncthreads();

  for (int cb = 0; cb < col_blocks; ++cb) {
    const int base = cb * kTile;
    if (t < kTile) {
      diag[t] = m[(size_t)(base + t) * col_blocks + cb];
      tile_valid[t] = v[base + t];
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long rem = removed[cb];
      unsigned long long keep = 0ULL;
      for (int r = 0; r < kTile; ++r) {
        if (tile_valid[r] && !((rem >> r) & 1ULL)) {
          keep |= 1ULL << r;
          rem |= diag[r];
        }
      }
      tile_keep = keep;
    }
    __syncthreads();
    const unsigned long long keep = tile_keep;
    if (t < kTile) a[base + t] = (uint8_t)((keep >> t) & 1ULL);
    for (int k = cb + 1 + t; k < col_blocks; k += blockDim.x) {
      unsigned long long acc = removed[k];
      unsigned long long rows = keep;
      while (rows) {
        const int r = __ffsll((long long)rows) - 1;
        rows &= rows - 1ULL;
        acc |= m[(size_t)(base + r) * col_blocks + k];
      }
      removed[k] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [batch, n, 4] float32 sorted by descending score, valid [batch, n]
// bool (one byte each), n a multiple of 64. mask: scratch of
// batch * n * (n / 64) uint64 words. alive [batch, n] bool out. Launches on
// `stream` and returns the cudaError_t of the launches.
extern "C" int nms_alive(const float* boxes, const uint8_t* valid, int batch,
                         int n, float thresh, int plus_one, int strict,
                         unsigned long long* mask, uint8_t* alive,
                         void* stream) {
  if (batch < 0 || n < 0 || n % kTile != 0 || batch > 65535 ||
      n / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n == 0) return 0;
  const int col_blocks = n / kTile;
  const size_t smem = (size_t)col_blocks * sizeof(unsigned long long);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float off = plus_one ? 1.0f : 0.0f;
  const dim3 grid((unsigned)col_blocks, (unsigned)col_blocks, (unsigned)batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(boxes, n, col_blocks, thresh, off,
                                         strict, mask);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(mask, valid, n,
                                                      col_blocks, alive);
  return (int)cudaGetLastError();
}
