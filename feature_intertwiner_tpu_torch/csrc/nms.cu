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
//  (a) nms_mask_kernel: the suppression bitmask, one uint64 word per (row i,
//      column tile k >= i's tile), bit t set when row i suppresses column
//      k*64+t > i. Tile c's rows keep their words c..tiles-1 in one run,
//      row after row, and the runs follow each other (the upper triangle
//      only). A pair whose intersection is zero needs no division.
//  (b) nms_sweep_kernel: one block per batch row walks the tiles in order.
//      Each tile's run is staged in shared memory one tile ahead with
//      cp.async, in two buffers (ops/nms.py::sweep_plan: where the runs do
//      not fit whole, the first words of each row are staged and the rest
//      is read from device memory). Every warp resolves the tile itself
//      from shared memory, in rounds: the lowest candidate, and every
//      candidate that no candidate suppresses, are kept and drop the rows
//      they suppress; a round is two warp reductions and keeps at least one
//      row. Then a thread per later word ORs the kept rows' words into
//      `removed`, a bitset of one word per tile in shared memory that
//      starts as the invalid rows. One barrier per tile.
//
// Bit-exactness: the IoU is computed in fp32 with the expression order of
// ops/nms.py::_pairwise_iou (each box's area by the same expression), the
// file is compiled with -fmad=false (no FMA contraction), division is IEEE
// round-to-nearest, and the threshold arrives as a float. Where the
// intersection is +-0 the quotient is +-0 for every union but 0 and NaN,
// where it is NaN, so the test is decided without the division. The sweep
// only reorders bitwise ORs.
//
// Bound on the card: operations, (a)'s n^2/2 IoUs per image. (b) is a
// serial walk of n/64 tiles whose cost is latency: a round's reductions,
// the OR's shared-memory loads and the barrier, not bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kTile = 64;
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kStages = 2;  // stage buffers: a run is staged one tile ahead
constexpr unsigned kFull = 0xffffffffu;
// shared memory one block may opt in to on the H100 (227 KB)
constexpr size_t kSharedLimit = 232448;

// Words before tile c's run: tile c' < c holds (tiles - c') words per row.
__host__ __device__ __forceinline__ size_t tile_offset(int c, int tiles) {
  return ((size_t)c * tiles - (size_t)c * (c - 1) / 2) * kTile;
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int tiles, float thresh, float off,
                                int strict, u64* __restrict__ mask) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (row_block > col_block) return;  // never read by the sweep
  const int t = threadIdx.x;
  const float* bx = boxes + (size_t)blockIdx.z * n * 4;

  __shared__ float cols[kTile * 4];
  __shared__ float col_area[kTile];
  const int col = col_block * kTile + t;
#pragma unroll
  for (int k = 0; k < 4; ++k) cols[t * 4 + k] = bx[(size_t)col * 4 + k];
  {
    const float* b = cols + t * 4;
    col_area[t] = (b[2] - b[0] + off) * (b[3] - b[1] + off);
  }
  __syncthreads();

  const int row = row_block * kTile + t;
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = bx[(size_t)row * 4 + k];
  const float area_a = (a[2] - a[0] + off) * (a[3] - a[1] + off);
  const bool zero_passes = strict ? (0.0f > thresh) : (0.0f >= thresh);

  u64 bits = 0ULL;
  const int start = (row_block == col_block) ? t + 1 : 0;
  for (int j = start; j < kTile; ++j) {
    const float* b = cols + j * 4;
    const float y1 = fmaxf(a[0], b[0]);
    const float x1 = fmaxf(a[1], b[1]);
    const float y2 = fminf(a[2], b[2]);
    const float x2 = fminf(a[3], b[3]);
    const float inter =
        fmaxf(x2 - x1 + off, 0.0f) * fmaxf(y2 - y1 + off, 0.0f);
    const float uni = area_a + col_area[j] - inter;
    bool s;
    if (inter == 0.0f) {
      s = zero_passes && uni == uni && uni != 0.0f;
    } else {
      const float v = inter / uni;
      s = strict ? (v > thresh) : (v >= thresh);
    }
    if (s) bits |= 1ULL << j;
  }
  const int later = tiles - row_block;
  mask[(size_t)blockIdx.z * tile_offset(tiles, tiles) +
       tile_offset(row_block, tiles) + (size_t)t * later +
       (col_block - row_block)] = bits;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Stage the first `words` of each of a run's 64 rows (row stride `later` in
// device memory) as [64][words] in shared memory, and close the group.
__device__ __forceinline__ void stage_run(u64* dst, const u64* src, int words,
                                          int later, int tid) {
  const unsigned base = smem_addr(dst);
  if (words == later) {  // the whole run: one contiguous copy, 16 B at a time
    const char* from = reinterpret_cast<const char*>(src);
    for (int i = tid; i < words * (kTile / 2); i += kSweepThreads) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 16u * i),
                   "l"(from + 16 * (size_t)i));
    }
  } else {  // a window of each row, 8 B at a time
    for (int i = tid; i < words * kTile; i += kSweepThreads) {
      const int r = i / words;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       base + 8u * i),
                   "l"(src + (size_t)r * later + (i - r * words)));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ u64 warp_or(u64 x) {
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)x);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(x >> 32));
  return ((u64)hi << 32) | lo;
}

// The OR over the rows of `rows` of this lane's two rows' words.
__device__ __forceinline__ u64 rows_or(u64 rows, int lane, u64 d_lo,
                                       u64 d_hi) {
  return warp_or(((rows >> lane) & 1ULL ? d_lo : 0ULL) |
                 ((rows >> (32 + lane)) & 1ULL ? d_hi : 0ULL));
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const u64* __restrict__ mask,
                     const uint8_t* __restrict__ valid, int n, int tiles,
                     int stage_words, uint8_t* __restrict__ alive) {
  // kStages buffers of stage_words * 64 words, `removed` (tiles words), then
  // a list of kept rows for each warp (64 bytes)
  extern __shared__ __align__(16) u64 smem[];
  const int stage_len = stage_words * kTile;
  u64* const removed = smem + kStages * stage_len;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint8_t* const list =
      reinterpret_cast<uint8_t*>(removed + tiles) + warp * kTile;

  const u64* m = mask + (size_t)blockIdx.x * tile_offset(tiles, tiles);
  const uint8_t* v = valid + (size_t)blockIdx.x * n;
  uint8_t* a = alive + (size_t)blockIdx.x * n;
  const u32 below = (1u << lane) - 1u;

  stage_run(smem, m, min(stage_words, tiles), tiles, tid);
  // an invalid row starts removed: it is never kept and never suppresses
  for (int k = warp; k < tiles; k += kSweepWarps) {
    const unsigned lo = __ballot_sync(kFull, v[k * kTile + lane] != 0);
    const unsigned hi = __ballot_sync(kFull, v[k * kTile + 32 + lane] != 0);
    if (lane == 0) removed[k] = ~(((u64)hi << 32) | lo);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int cb = 0; cb < tiles; ++cb) {
    const u64* buf = smem + (cb & 1) * stage_len;
    const u64* run = m + tile_offset(cb, tiles);
    const int later = tiles - cb;                // words cb..tiles-1 a row
    const int staged = min(stage_words, later);  // buf's row stride
    if (cb + 1 < tiles) {
      stage_run(smem + ((cb + 1) & 1) * stage_len,
                m + tile_offset(cb + 1, tiles), min(stage_words, later - 1),
                later - 1, tid);
    }
    // Resolve the tile: the rows' diagonal words hold only later rows, so
    // the lowest candidate is kept, and so is a candidate that no
    // candidate suppresses; the rows they suppress are dropped.
    const u64 d_lo = buf[(size_t)lane * staged];
    const u64 d_hi = buf[(size_t)(32 + lane) * staged];
    u64 cand = ~removed[cb];
    u64 keep = 0ULL;
    while (cand) {
      const u64 k = (cand & ~rows_or(cand, lane, d_lo, d_hi)) |
                    (cand & (0ULL - cand));
      keep |= k;
      cand &= ~k;
      if (cand) cand &= ~rows_or(k, lane, d_lo, d_hi);
    }
    const u32 klo = (u32)keep;
    const u32 khi = (u32)(keep >> 32);
    if (warp == 0) {
      a[cb * kTile + lane] = (uint8_t)((klo >> lane) & 1u);
      a[cb * kTile + 32 + lane] = (uint8_t)((khi >> lane) & 1u);
    }
    // this warp's list of the kept rows, in order
    const int n_lo = __popc(klo);
    if ((klo >> lane) & 1u) list[__popc(klo & below)] = (uint8_t)lane;
    if ((khi >> lane) & 1u) {
      list[n_lo + __popc(khi & below)] = (uint8_t)(32 + lane);
    }
    __syncwarp();
    const int kept = n_lo + __popc(khi);
    // the kept rows remove what they suppress in the later tiles: a thread
    // per later word, the staged words from shared memory, the rest from
    // device memory
    for (int j = 1 + tid; j < later; j += kSweepThreads) {
      u64 acc = 0ULL;
      if (j < staged) {
#pragma unroll 4
        for (int i = 0; i < kept; ++i) {
          acc |= buf[(size_t)list[i] * staged + j];
        }
      } else {
#pragma unroll 8
        for (int i = 0; i < kept; ++i) {
          acc |= run[(size_t)list[i] * later + j];
        }
      }
      removed[cb + j] |= acc;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
}

}  // namespace

// boxes [batch, n, 4] float32 sorted by descending score, valid [batch, n]
// bool (one byte each), n a multiple of 64. stage_words: the words of each
// row of a tile's run staged in shared memory (ops/nms.py::sweep_plan).
// mask: scratch of batch * 64 * t * (t + 1) / 2 uint64 words, t = n / 64.
// alive [batch, n] bool out. Launches on `stream` and returns the
// cudaError_t of the launches; cudaErrorInvalidValue for a shape or a plan
// it cannot hold.
extern "C" int nms_alive(const float* boxes, const uint8_t* valid, int batch,
                         int n, float thresh, int plus_one, int strict,
                         int stage_words, u64* mask, uint8_t* alive,
                         void* stream) {
  if (batch < 0 || n < 0 || n % kTile != 0 || batch > 65535 ||
      n / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n == 0) return 0;
  const int tiles = n / kTile;
  const size_t smem =
      ((size_t)kStages * stage_words * kTile + tiles) * sizeof(u64) +
      kSweepWarps * kTile;
  if (stage_words < 1 || stage_words > tiles || smem > kSharedLimit) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {  // the opt-in above the default, on this device
    const cudaError_t err = cudaFuncSetAttribute(
        nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float off = plus_one ? 1.0f : 0.0f;
  const dim3 grid((unsigned)tiles, (unsigned)tiles, (unsigned)batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(boxes, n, tiles, thresh, off, strict,
                                         mask);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(mask, valid, n, tiles,
                                                      stage_words, alive);
  return (int)cudaGetLastError();
}
