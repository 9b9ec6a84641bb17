// Per-box window sums: out[n, c] = sum over (y, x) of
//   img[b, y0 + y, 8 * x0 + x, c],  0 <= y < sy, 0 <= x < sx,
// with origins[n] = (b, y0, x0) int32 (x stored divided by 8), accumulated
// in fp32, each window's pixels in row-major order.
//
// Replaces the Pallas kernel
//   scripts/profile_window_dma.py::_probe_kernel
// (behind window_dma_checksum), a probe of the TPU's per-box window DMA.
// The TPU kernel packs each origin into one int32 (scalar-prefetch SMEM
// budget) and double-buffers each window's copy into VMEM; both were TPU
// constraints and neither is kept.
//
// Design: overlapping windows share their map rows through shared memory.
// The windows are sorted by the key b * H + y0 (window_sum_keys, then a sort
// in ops/window_sum.py; windows that leave the map sort last) and split into
// groups of `group` (64) consecutive windows. One block of kThreads takes one
// group and one chunk of 32 * V channels (V = 4 where C and the map's
// alignment allow, else 2). It finds the rows its windows cover (the union
// of their row ranges over the flattened [B * H] rows, so a group that
// straddles two images walks each image's rows in turn) and the x range
// from its leftmost to its rightmost window. It walks those rows top to
// bottom, each in pieces of at most `piece` pixels left to right, and
// stages each piece (pixels x chunk channels) in shared memory with
// cp.async into two buffers: the next piece loads while one is summed, one
// block barrier per piece. Its threads hold (window, V channels) items, a
// warp's 32 lanes on one window, so a warp's read of one staged pixel is
// one or two conflict-free 128-byte wavefronts. For each piece, each item
// whose window covers the row adds the window's pixels in the piece, left
// to right, one __fadd_rn at a time into fp32 registers, 8 loads in
// flight. So every window still gets its pixels in row-major
// order, as the plain version in ops/window_sum.py adds them, and matches
// it bit for bit (-fmad=false; nothing is contracted). A window that leaves
// the map reads nothing and gives NaN. Each (window, V channels) is written
// once, to the window's original index, with a streaming store; no
// atomics. Small windows barely overlap (1.3 windows per covered pixel at
// 8x8 on the window sweep): ops/window_sum.py::window_plan gives them group
// 1, and a group of one has nothing to stage, so its warp reads its window
// straight from global memory, two channels a lane, with no sort. A map
// whose channel count is odd, or that does not start on a channel pair,
// cannot be read in pairs: window_plan gives it group 1 at any window size,
// one channel a lane (V = 1), in the same order.
//
// Bound on the card. Bytes: the map pixels some window covers, read once,
// over 3.35 TB/s; operations: one fp32 add per window element, one issue
// slot each (33.5e12 per second). The staged kernel as committed is bound
// by shared memory and instruction issue together: every window element is
// read from shared memory once (8.6 GB at 64x64 on the window sweep, about
// 0.30 ms at 128 B per clock per SM) and costs about 2.25 issue slots (a
// quarter of an 8-byte load, a bfloat16 widening, an add); staging reads
// each group's rows once, so rows that two groups cover come from device
// memory twice. The direct reads of small windows are bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 32;                // items per window in a chunk: one warp
constexpr int kGroup = 64;                // the most windows a staging block takes
constexpr int kItems = kGroup * kLanes / kThreads;  // (window, V channels) items a thread holds
static_assert(kGroup * kLanes % kThreads == 0, "a staging block's items fill its threads");
constexpr int kUnroll = 8;                // pixels a thread loads before adding them
constexpr int kSharedLimit = 232448;      // the most shared memory a block can use
constexpr int kMetaInts = 8;              // a block's scalars, before its windows
constexpr int kNoRow = INT_MAX;           // start row of a window that leaves the map

// The shared bytes of a block: its scalars, five ints per window (original
// index, start row, x, and a row segment), rounded up to 128 bytes; then
// the staged pieces. ops/window_sum.py::window_shared_bytes counts the same.
__host__ __device__ constexpr int meta_bytes(int group) {
  return (kMetaInts * 4 + group * 5 * 4 + 127) / 128 * 128;
}

// V consecutive channels (V = 1, 2 or 4) as one thread reads them, widened
// to fp32.
template <typename T, int V>
struct Lanes;

template <>
struct Lanes<float, 1> {
  using Word = float;
  static __device__ __forceinline__ void widen(float v, float* f) { f[0] = v; }
};

template <>
struct Lanes<float, 2> {
  using Word = float2;
  static __device__ __forceinline__ void widen(float2 v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
  }
};

template <>
struct Lanes<float, 4> {
  using Word = float4;
  static __device__ __forceinline__ void widen(float4 v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

// A bfloat16 is the top half of a float; the lower address holds the lower
// channel.
template <>
struct Lanes<__nv_bfloat16, 1> {
  using Word = unsigned short;
  static __device__ __forceinline__ void widen(unsigned short v, float* f) {
    f[0] = __uint_as_float((unsigned)v << 16);
  }
};

template <>
struct Lanes<__nv_bfloat16, 2> {
  using Word = unsigned;
  static __device__ __forceinline__ void widen(unsigned v, float* f) {
    f[0] = __uint_as_float(v << 16);
    f[1] = __uint_as_float(v & 0xffff0000u);
  }
};

template <>
struct Lanes<__nv_bfloat16, 4> {
  using Word = uint2;
  static __device__ __forceinline__ void widen(uint2 v, float* f) {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

template <typename T, int V>
__device__ __forceinline__ void add(float* acc, typename Lanes<T, V>::Word raw) {
  float f[V];
  Lanes<T, V>::widen(raw, f);
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], f[v]);
}

// Add n pixels, `stride` words apart from q on, into acc, in order;
// kUnroll loads in flight before their adds.
template <typename T, int V, bool kGlobal>
__device__ __forceinline__ void add_run(const typename Lanes<T, V>::Word* q, int n, size_t stride,
                                        float* acc) {
  using Word = typename Lanes<T, V>::Word;
  int x = 0;
  for (; x + kUnroll <= n; x += kUnroll, q += kUnroll * stride) {
    Word raw[kUnroll];
#pragma unroll
    for (int d = 0; d < kUnroll; ++d) {
      if constexpr (kGlobal) {
        raw[d] = __ldg(q + d * stride);
      } else {
        raw[d] = q[d * stride];
      }
    }
#pragma unroll
    for (int d = 0; d < kUnroll; ++d) add<T, V>(acc, raw[d]);
  }
  for (; x < n; ++x, q += stride) {
    if constexpr (kGlobal) {
      add<T, V>(acc, __ldg(q));
    } else {
      add<T, V>(acc, q[0]);
    }
  }
}

// The streaming store of V sums, or of V NaNs for a window that leaves the
// map.
template <int V>
__device__ __forceinline__ void store(float* p, float* acc, bool inside) {
  if (!inside) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = __int_as_float(0x7fc00000);  // quiet NaN
  }
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(acc[0], acc[1]));
  } else {
    __stcs(p, acc[0]);
  }
}

__device__ __forceinline__ bool inside_map(int b, int y0, long long x0, int batch, int h, int w,
                                           int sy, int sx) {
  return b >= 0 && b < batch && y0 >= 0 && (long long)y0 + sy <= h && x0 >= 0 && x0 + sx <= w;
}

// The walk over a group's staged pieces: a row segment, a row in it (of
// the flattened [B * H] map) and the first pixel of a piece.
struct Cursor {
  int seg, row, x;
};

__device__ __forceinline__ void advance(Cursor& cu, const int* seg_lo, const int* seg_hi,
                                        int nseg, int xlo, int xhi, int piece) {
  cu.x += piece;
  if (cu.x < xhi) return;
  cu.x = xlo;
  if (++cu.row < seg_hi[cu.seg]) return;
  if (++cu.seg < nseg) cu.row = seg_lo[cu.seg];
}

template <int B>
__device__ __forceinline__ void cp_async(unsigned dst, const unsigned char* src) {
  if (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(B));
  }
}

// Copy `pixels` pixels (source pixel stride `stride_bytes`, staged pixel
// stride `pitch_bytes`) into shared memory at `dst`, B bytes at a time:
// this thread's vectors are t, t + kThreads, ..., stepped as (pixel p,
// part q) of vpp parts without a division.
template <int B>
__device__ __forceinline__ void stage_piece(unsigned dst, const unsigned char* src, int pixels,
                                            int pitch_bytes, size_t stride_bytes, int p0, int q0,
                                            int dp, int dq, int vpp) {
  for (int p = p0, q = q0; p < pixels;) {
    cp_async<B>(dst + (unsigned)(p * pitch_bytes + q * B), src + p * stride_bytes + q * B);
    q += dq;
    p += dp;
    if (q >= vpp) {
      q -= vpp;
      ++p;
    }
  }
}

// Grid (groups, channel chunks of kLanes * V), kThreads threads. `order`
// lists the windows sorted by b * H + y0 (stable, leavers last); a group
// is `group` (at most kGroup) consecutive windows of it. Item i = k *
// kThreads + threadIdx.x of a block is window i / kLanes of its group,
// channels V * (i % kLanes) + [0, V) of its chunk, so a warp's items of
// one k lie on one window, and a thread's windows are kThreads / kLanes
// apart in the sorted order: every warp has windows over the whole row
// range. Two buffers of `piece` pixels: the next piece loads while one is
// summed.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
    window_sum_staged(const T* __restrict__ img, const int* __restrict__ origins,
                      const long long* __restrict__ order, int n, int batch, int h, int w,
                      int c, int sy, int sx, int group, int piece, int vbytes,
                      float* __restrict__ out) {
  using Word = typename Lanes<T, V>::Word;
  constexpr int kChunk = kLanes * V;
  extern __shared__ __align__(128) unsigned char smem[];
  int* meta = reinterpret_cast<int*>(smem);  // nseg, xlo, xhi, units
  int* win_n = meta + kMetaInts;
  int* win_start = win_n + group;
  int* win_x = win_start + group;
  int* seg_lo = win_x + group;
  int* seg_hi = seg_lo + group;
  unsigned char* staged = smem + meta_bytes(group);

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * group;
  const int count = min(group, n - g0);
  const int c0 = blockIdx.y * kChunk;
  const int cc = min(kChunk, c - c0);  // channels of this chunk, a multiple of V

  for (int j = tid; j < count; j += kThreads) {
    const int idx = (int)order[g0 + j];
    const int b = origins[3 * idx], y0 = origins[3 * idx + 1];
    const long long x0 = 8LL * origins[3 * idx + 2];
    const bool inside = inside_map(b, y0, x0, batch, h, w, sy, sx);
    win_n[j] = idx;
    win_start[j] = inside ? b * h + y0 : kNoRow;
    win_x[j] = inside ? (int)x0 : 0;
  }
  __syncthreads();
  if (tid == 0) {  // the union of the row ranges, in order; the x range
    int nseg = 0, xlo = INT_MAX, xhi = 0, rows = 0;
    for (int j = 0; j < count; ++j) {
      const int s = win_start[j];
      if (s == kNoRow) continue;
      if (nseg > 0 && s <= seg_hi[nseg - 1]) {
        seg_hi[nseg - 1] = max(seg_hi[nseg - 1], s + sy);
      } else {
        seg_lo[nseg] = s;
        seg_hi[nseg++] = s + sy;
      }
      xlo = min(xlo, win_x[j]);
      xhi = max(xhi, win_x[j] + sx);
    }
    for (int k = 0; k < nseg; ++k) rows += seg_hi[k] - seg_lo[k];
    meta[0] = nseg;
    meta[1] = xlo;
    meta[2] = xhi;
    meta[3] = nseg ? rows * ((xhi - xlo + piece - 1) / piece) : 0;
  }
  __syncthreads();
  const int nseg = meta[0], xlo = meta[1], xhi = meta[2], units = meta[3];

  // this thread's first vector of a staged piece, and its step
  const int es = (int)sizeof(T);
  const int vpp = cc * es / vbytes;
  const int p0 = tid / vpp, q0 = tid % vpp;
  const int dp = kThreads / vpp, dq = kThreads % vpp;
  const size_t stride_bytes = (size_t)c * es;
  const unsigned char* img_bytes = reinterpret_cast<const unsigned char*>(img) + (size_t)c0 * es;
  const unsigned stage_bytes = (unsigned)(piece * kChunk * es);
  const unsigned staged_addr = (unsigned)__cvta_generic_to_shared(staged);

  Cursor load = {0, nseg ? seg_lo[0] : 0, xlo}, sum = load;
  auto issue = [&](int u) {
    if (u < units) {
      const int pixels = min(piece, xhi - load.x);
      const unsigned dst = staged_addr + (unsigned)(u % 2) * stage_bytes;
      const unsigned char* src = img_bytes + ((size_t)load.row * w + load.x) * stride_bytes;
      if (vbytes == 16) {
        stage_piece<16>(dst, src, pixels, kChunk * es, stride_bytes, p0, q0, dp, dq, vpp);
      } else if (vbytes == 8) {
        stage_piece<8>(dst, src, pixels, kChunk * es, stride_bytes, p0, q0, dp, dq, vpp);
      } else {
        stage_piece<4>(dst, src, pixels, kChunk * es, stride_bytes, p0, q0, dp, dq, vpp);
      }
      advance(load, seg_lo, seg_hi, nseg, xlo, xhi, piece);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int lane = tid % kLanes;
  const bool live_lane = V * lane < cc;
  float acc[kItems][V];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[k][v] = 0.0f;
  }

  issue(0);
  for (int u = 0; u < units; ++u) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // this thread's copies of piece u
    __syncthreads();      // everyone's have landed; everyone is done with piece u - 1
    issue(u + 1);         // into piece u - 1's buffer
    const int r = sum.row, xa = sum.x, xb = min(sum.x + piece, xhi);
    const Word* base = reinterpret_cast<const Word*>(staged + (u % 2) * stage_bytes) + lane;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int j = (k * kThreads + tid) / kLanes;
      if (j < count && live_lane) {
        const int s = win_start[j];
        if (r >= s && r < s + sy) {  // the window's pixels in this piece
          const int x0 = win_x[j];
          const int a = max(x0, xa);
          add_run<T, V, false>(base + (a - xa) * kLanes, min(x0 + sx, xb) - a, kLanes, acc[k]);
        }
      }
    }
    advance(sum, seg_lo, seg_hi, nseg, xlo, xhi, piece);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = (k * kThreads + tid) / kLanes;
    if (j < count && live_lane) {
      store<V>(out + (size_t)win_n[j] * c + c0 + V * lane, acc[k], win_start[j] != kNoRow);
    }
  }
}

// A group of one: the window has nothing to share, so its warp reads its
// pixels straight from global memory, V (2, or 1 for an odd or unpaired
// map) channels a lane, kUnroll loads in flight. Grid (windows / (kThreads
// / kLanes), channel chunks of kLanes * V).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    window_sum_direct(const T* __restrict__ img, const int* __restrict__ origins, int n,
                      int batch, int h, int w, int c, int sy, int sx, float* __restrict__ out) {
  using Word = typename Lanes<T, V>::Word;
  const int j = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int ch = blockIdx.y * kLanes * V + V * (threadIdx.x % kLanes);
  if (j >= n || ch >= c) return;
  const int b = origins[3 * j], y0 = origins[3 * j + 1];
  const long long x0 = 8LL * origins[3 * j + 2];
  const bool inside = inside_map(b, y0, x0, batch, h, w, sy, sx);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  if (inside) {
    const size_t pixel = (size_t)c / V;  // words
    const Word* q = reinterpret_cast<const Word*>(img + ((size_t)b * h + y0) * w * c + x0 * c + ch);
    for (int y = 0; y < sy; ++y, q += w * pixel) add_run<T, V, true>(q, sx, pixel, acc);
  }
  store<V>(out + (size_t)j * c + ch, acc, inside);
}

// The sort key of each window: b * H + y0, or B * H for a window that
// leaves the map, so that those sort last.
__global__ void window_keys_kernel(const int* __restrict__ origins, int n, int batch, int h,
                                   int w, int sy, int sx, int* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = origins[3 * i], y0 = origins[3 * i + 1];
  const long long x0 = 8LL * origins[3 * i + 2];
  keys[i] = inside_map(b, y0, x0, batch, h, w, sy, sx) ? b * h + y0 : batch * h;
}

struct Args {
  const void* img;
  const int* origins;
  const long long* order;
  int n, batch, h, w, c, sy, sx, group, piece, vbytes, shared;
  float* out;
  cudaStream_t stream;
};

template <typename T, int V>
int launch_staged(const Args& a) {
  if (a.shared > 48 * 1024) {  // the opt-in above the default, on this device
    const cudaError_t err = cudaFuncSetAttribute(
        window_sum_staged<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((a.n + a.group - 1) / a.group),
                  (unsigned)((a.c + kLanes * V - 1) / (kLanes * V)));
  window_sum_staged<T, V><<<grid, kThreads, a.shared, a.stream>>>(
      static_cast<const T*>(a.img), a.origins, a.order, a.n, a.batch, a.h, a.w, a.c, a.sy, a.sx,
      a.group, a.piece, a.vbytes, a.out);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_direct(const Args& a) {
  constexpr int kWindows = kThreads / kLanes;
  const dim3 grid((unsigned)((a.n + kWindows - 1) / kWindows),
                  (unsigned)((a.c + kLanes * V - 1) / (kLanes * V)));
  window_sum_direct<T, V><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.img), a.origins, a.n, a.batch, a.h, a.w, a.c, a.sy, a.sx, a.out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, int vec) {
  if (a.group == 1) return vec == 1 ? launch_direct<T, 1>(a) : launch_direct<T, 2>(a);
  return vec == 4 ? launch_staged<T, 4>(a) : launch_staged<T, 2>(a);
}

bool shape_ok(int n, int batch, int h, int w, int sy, int sx) {
  return n >= 0 && batch >= 1 && h >= 1 && w >= 1 && sy >= 1 && sx >= 1 &&
         (long long)batch * h < INT_MAX;
}

}  // namespace

// The sort keys [n] int32 of origins [n, 3] int32 (device memory) for a
// [batch, h, w, *] map and sy x sx windows. Launches on `stream` and returns
// the cudaError_t of the launch.
extern "C" int window_sum_keys(const int* origins, int n, int batch, int h, int w, int sy,
                               int sx, int* keys, void* stream) {
  if (!shape_ok(n, batch, h, w, sy, sx)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  window_keys_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(origins, n, batch, h, w,
                                                                        sy, sx, keys);
  return (int)cudaGetLastError();
}

// img [batch, h, w, c] (float32 when is_bf16 is 0, bfloat16 when 1) and
// origins [n, 3] int32, contiguous, in device memory, the map aligned to V
// channels (vec, 1, 2 or 4; c a multiple of it); out [n, c] float32. The
// plan is ops/window_sum.py::window_plan's: group 1 reads each window
// directly, vec (1 or 2) channels a lane; a group of 2 to kGroup windows stages their rows,
// `piece` pixels at a time, and needs `order`, [n] int64, the windows
// sorted by window_sum_keys (stable). Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int window_sum(const void* img, int is_bf16, const int* origins,
                          const long long* order, int n, int batch, int h, int w, int c, int sy,
                          int sx, int group, int piece, int vec, float* out, void* stream) {
  const int es = is_bf16 ? 2 : 4;
  const bool staged = group > 1;
  const long long shared = staged ? meta_bytes(group) + 2LL * piece * kLanes * vec * es : 0;
  if (!shape_ok(n, batch, h, w, sy, sx) || (vec != 1 && vec != 2 && vec != 4) ||
      (staged && vec == 1) || (!staged && vec == 4) ||
      c < vec || c % vec || (uintptr_t)img % (vec * es) || group < 1 || group > kGroup ||
      (c + kLanes * vec - 1) / (kLanes * vec) > 65535 ||
      (staged && (piece < 1 || shared > kSharedLimit))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  if (staged && order == nullptr) return (int)cudaErrorInvalidValue;
  // the widest copy that every staged pixel's source and destination allow
  const uintptr_t bits = (uintptr_t)img | ((uintptr_t)c * es);
  const int vbytes = bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : 4;
  const Args a = {img, origins, order, n, batch, h, w, c, sy, sx, group, piece, vbytes,
                  (int)shared, out, (cudaStream_t)stream};
  return is_bf16 ? launch<__nv_bfloat16>(a, vec) : launch<float>(a, vec);
}
