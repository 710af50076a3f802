// Exact window rank selection (median and rank filters) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of arcadia_microscopy_tools_tpu/ops/rank_pallas.py:
//   amt_rank_select <- _rank_kernel (ops/rank_pallas.py:67), wrapper rank_select_pallas (:114)
//
// For each pixel of each image of a padded float32 batch (N, H + 2r, W + 2r),
// r = window / 2, and for each of one or two ranks k, the k-th smallest value
// of the pixel's window (padded rows y .. y + window - 1, columns
// x .. x + window - 1), written to out (n_ranks, N, H, W).
//
// Order: values compare by their order-isomorphic int32 keys,
// key = bits < 0 ? bits ^ 0x7FFFFFFF : bits (an involution), so -0.0 sorts
// below +0.0 and a positive NaN above +inf, exactly as in the Pallas kernel.
// The result is a key of the window mapped back to its bits: an element of
// the window, bit for bit.
//
// Bound: neighbouring windows share all but 2 x window of their keys, so a
// selection that shares that work needs, per pixel and rank, 2 x window
// histogram updates and one read of the selected key, plus the pixel's share
// of ranking its tile's keys once (E log2 E compares for E staged keys). At
// window 21 on 8 x 2048^2 with one rank that is ~69 operations a pixel,
// ~0.035 ms at 67 T op/s, below the bytes (the padded input read once, the
// output written once, 271 MB), ~0.081 ms at 3.35 TB/s: the function is
// bound by bytes. (A radix select per pixel, 4 x (window^2 + 256)
// operations, would take ~1.4 ms.)
//
// Design, windows up to 74 (the sliding branch): one CTA of 32 columns x 4
// walkers per 32-column tile of TH = 4R output rows and one image.
// 1. The CTA stages the tile's sx x sy keys (sx = 32 + window - 1,
//    sy = TH + window - 1, at most P = 4096 or 8192 of them) as 64-bit sort
//    keys, (key in unsigned order) << 32 | (row << 16 | column), and sorts
//    them once in shared memory (bitonic). Every element now has a unique
//    sorted position s, and the order of s is the order of the keys (ties
//    broken by position, which does not change the selected key).
// 2. Each walker owns one output column and R consecutive output rows. It
//    keeps a private coarse histogram of s / 64 over its window: w^2 adds
//    for its first row, then per row down 2 x window updates (the row that
//    leaves, the row that enters). Per rank it tracks the bin that holds the
//    k-th element and the count below that bin, moving it a few bins per row.
// 3. The k-th element is then found inside that one bin by walking its 64
//    sorted entries and counting those that lie in the window.
// So a pixel costs ~2 x window histogram updates, a short bin walk and its
// share of one sort of the tile, instead of 32 rounds of window^2 counts.
// Both ranks of an even window share the histogram. Each walker's histogram
// is interleaved with its warp's (bin-major, thread-minor), so the updates
// of a warp never conflict on a bank.
//
// Windows 75..225 (the sort buffer no longer holds a tile of 32 columns and
// a few rows) use the earlier bisection branch: a CTA of 16 x 16 threads
// stages the (16 + window - 1)^2 keys of its tile in shared memory and each
// thread bisects for its own pixel, 32 MSB-first rounds of
// count(key < prefix + 2^(31 - t)) <= k over the window (the int32 addition
// done in uint32, so round 0's wrap from INT32_MIN is defined). Windows
// above 225, whose staged tile does not fit in 227 KB, bisect on keys read
// from device memory (through L1/L2). The branch is chosen by window alone
// (`branch_of`). Building with -DAMT_RANK_BRANCH=<n> forces branch n for
// every window the branch can serve, so that tools/rank_branch_times.py can
// time the branches against each other at one window; times stand in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may opt in to

__device__ __forceinline__ int32_t to_key(int32_t bits) {
  return bits < 0 ? (bits ^ 0x7FFFFFFF) : bits;
}

// ---- sliding branch ---------------------------------------------------------

constexpr int kCols = 32;                 // output columns per CTA: one walker each
constexpr int kSegs = 4;                  // walkers per column
constexpr int kSThreads = kCols * kSegs;  // 128
constexpr int kBinShift = 6;              // 64 sorted positions per coarse bin

// Output rows per walker for a sort buffer of P keys (< 1: does not fit).
inline int slide_rows(int window, int P) {
  const int sx = kCols + window - 1;
  return (P / sx - (window - 1)) / kSegs;
}
template <int P>
constexpr size_t slide_smem() {
  return (size_t)P * 8 + (size_t)P * 2 + (size_t)(P >> kBinShift) * kSThreads * 2;
}

template <int P, int NR>
__global__ void __launch_bounds__(kSThreads)
    slide_kernel(const int32_t* __restrict__ padded, float* __restrict__ out, int H, int W,
                 int window, int R, int k0, int k1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem_raw);      // [P] sort keys
  uint16_t* sidx = reinterpret_cast<uint16_t*>(buf + P);      // [sx * sy] sorted position
  uint16_t* hist = sidx + P;                                  // [P / 64][kSThreads]
  const int r = window / 2;
  const int Hp = H + 2 * r, Wp = W + 2 * r;
  const int TH = kSegs * R;
  const int sx = kCols + window - 1, sy = TH + window - 1;
  const int E = sx * sy;
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * TH;
  const int32_t* src = padded + static_cast<size_t>(blockIdx.z) * Hp * Wp;
  const int tid = threadIdx.x;

  for (int i = tid; i < P; i += kSThreads) {
    uint64_t v = ~0ull;  // padding sorts last
    if (i < E) {
      const int py = i / sx, px = i - py * sx;
      const int gy = y0 + py, gx = x0 + px;
      // rows and columns past a ragged edge feed no output pixel
      const int32_t key = (gy < Hp && gx < Wp) ? to_key(src[static_cast<size_t>(gy) * Wp + gx]) : 0;
      v = (static_cast<uint64_t>(static_cast<uint32_t>(key) ^ 0x80000000u) << 32) |
          static_cast<uint32_t>((py << 16) | px);
    }
    buf[i] = v;
  }
  uint32_t* hist32 = reinterpret_cast<uint32_t*>(hist);
  for (int i = tid; i < (P >> kBinShift) * kSThreads / 2; i += kSThreads) hist32[i] = 0u;
  __syncthreads();

  // bitonic sort, ascending; the non-padding values are distinct
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P / 2; i += kSThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & k) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int s = tid; s < E; s += kSThreads) {
    const uint32_t pos = static_cast<uint32_t>(buf[s]);
    sidx[(pos >> 16) * sx + (pos & 0xFFFFu)] = static_cast<uint16_t>(s);
  }
  __syncthreads();

  const int tx = tid % kCols, ty0 = (tid / kCols) * R;
  const int x = x0 + tx;
  if (x >= W || y0 + ty0 >= H) return;  // after the block's last barrier
  const int rows = min(R, H - y0 - ty0);
  uint16_t* h = hist + tid;  // this walker's bin b is h[b * kSThreads]

  for (int dy = 0; dy < window; ++dy) {
    const uint16_t* row = sidx + (ty0 + dy) * sx + tx;
    for (int dx = 0; dx < window; ++dx) ++h[(row[dx] >> kBinShift) * kSThreads];
  }
  const int ks[2] = {k0, k1};
  int bin[NR], below[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) bin[j] = below[j] = 0;

  const size_t plane = static_cast<size_t>(gridDim.z) * H * W;
  for (int yy = 0; yy < rows; ++yy) {
    const int ty = ty0 + yy;
    if (yy > 0) {  // slide down one row: drop row ty - 1, add row ty + window - 1
      const uint16_t* gone = sidx + (ty - 1) * sx + tx;
      const uint16_t* come = gone + window * sx;
      for (int dx = 0; dx < window; ++dx) {
        const int bo = gone[dx] >> kBinShift, bn = come[dx] >> kBinShift;
        --h[bo * kSThreads];
        ++h[bn * kSThreads];
#pragma unroll
        for (int j = 0; j < NR; ++j) below[j] += (bn < bin[j]) - (bo < bin[j]);
      }
    }
    const size_t p = static_cast<size_t>(blockIdx.z) * H * W + static_cast<size_t>(y0 + ty) * W + x;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      // move to the bin that holds the k-th element of the window
      int b = bin[j], lo = below[j];
      while (lo > ks[j]) lo -= h[--b * kSThreads];
      while (lo + h[b * kSThreads] <= ks[j]) lo += h[b++ * kSThreads];
      bin[j] = b;
      below[j] = lo;
      // the (k - lo)-th window element of that bin, in sorted order
      int need = ks[j] - lo;
      int s = b << kBinShift;
      for (;; ++s) {
        const uint32_t pos = static_cast<uint32_t>(buf[s]);
        const uint32_t py = (pos >> 16) - static_cast<uint32_t>(ty);
        const uint32_t px = (pos & 0xFFFFu) - static_cast<uint32_t>(tx);
        if (py < static_cast<uint32_t>(window) && px < static_cast<uint32_t>(window)) {
          if (need == 0) break;
          --need;
        }
      }
      const int32_t key = static_cast<int32_t>(static_cast<uint32_t>(buf[s] >> 32) ^ 0x80000000u);
      out[j * plane + p] = __int_as_float(to_key(key));
    }
  }
}

// ---- bisection branch (windows above the sliding branch's reach) -----------

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

// Staged tile: span x span keys with a row stride of 16 mod 32 words, so the
// two 16-pixel rows of a warp fall on disjoint banks.
inline int tile_span(int window) { return kTile + window - 1; }
inline int tile_stride(int span) { return span + ((16 - span % 32) + 32) % 32; }
inline size_t staged_bytes(int window) {
  const int span = tile_span(window);
  return static_cast<size_t>(tile_stride(span)) * span * sizeof(int32_t);
}
inline bool fits_smem(int window) {
  return staged_bytes(window) <= static_cast<size_t>(kMaxSmemBytes);
}

template <int NR, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    bisect_kernel(const int32_t* __restrict__ padded, float* __restrict__ out, int H, int W,
                  int window, int stride, int k0, int k1) {
  extern __shared__ int32_t keys_s[];
  const int r = window / 2;
  const int Hp = H + 2 * r, Wp = W + 2 * r;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int32_t* src = padded + static_cast<size_t>(blockIdx.z) * Hp * Wp;

  if (STAGED) {
    const int span = kTile + window - 1;
    for (int i = threadIdx.x; i < span * span; i += kThreads) {
      const int sy = i / span, sx = i - sy * span;
      const int gy = y0 + sy, gx = x0 + sx;
      // rows and columns past a ragged edge feed no output pixel
      keys_s[sy * stride + sx] =
          (gy < Hp && gx < Wp) ? to_key(src[static_cast<size_t>(gy) * Wp + gx]) : 0;
    }
    __syncthreads();
  }

  const int x = x0 + tx, y = y0 + ty;
  if (x >= W || y >= H) return;  // after the block's only barrier

  const int ks[2] = {k0, k1};
  int32_t prefix[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) prefix[j] = -2147483647 - 1;

  for (int t = 0; t < 32; ++t) {
    const uint32_t step = 1u << (31 - t);
    int32_t cand[NR];
    int cnt[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      cand[j] = static_cast<int32_t>(static_cast<uint32_t>(prefix[j]) + step);
      cnt[j] = 0;
    }
    for (int dy = 0; dy < window; ++dy) {
      const int32_t* row = STAGED ? keys_s + (ty + dy) * stride + tx
                                  : src + static_cast<size_t>(y + dy) * Wp + x;
#pragma unroll 4
      for (int dx = 0; dx < window; ++dx) {
        const int32_t key = STAGED ? row[dx] : to_key(__ldg(row + dx));
#pragma unroll
        for (int j = 0; j < NR; ++j) cnt[j] += key < cand[j];
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j)
      if (cnt[j] <= ks[j]) prefix[j] = cand[j];
  }

  const size_t plane = static_cast<size_t>(gridDim.z) * H * W;
  const size_t p = static_cast<size_t>(blockIdx.z) * H * W + static_cast<size_t>(y) * W + x;
#pragma unroll
  for (int j = 0; j < NR; ++j) out[j * plane + p] = __int_as_float(to_key(prefix[j]));
}

// ---- launch -------------------------------------------------------------------

enum Branch { kSlide4096 = 0, kSlide8192 = 1, kBisectStaged = 2, kBisectDevice = 3 };

inline Branch branch_of(int window) {
#ifdef AMT_RANK_BRANCH
  return static_cast<Branch>(AMT_RANK_BRANCH);
#endif
  // tools/rank_branch_times.py: the 4096-key sort is faster up to window 35
  // (7 rows a walker), the 8192-key sort from window 36
  if (slide_rows(window, 4096) >= 7) return kSlide4096;
  if (slide_rows(window, 8192) >= 1) return kSlide8192;
  return fits_smem(window) ? kBisectStaged : kBisectDevice;
}

template <int P, int NR>
int launch_slide(const void* padded, void* out, int N, int H, int W, int window, int k0, int k1,
                 cudaStream_t stream) {
  auto kernel = slide_kernel<P, NR>;
  constexpr size_t smem = slide_smem<P>();
  const int R = slide_rows(window, P);
  if (R < 1) return static_cast<int>(cudaErrorInvalidValue);  // the tile does not fit
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int TH = kSegs * R;
  dim3 grid((W + kCols - 1) / kCols, (H + TH - 1) / TH, N);
  kernel<<<grid, kSThreads, smem, stream>>>(static_cast<const int32_t*>(padded),
                                            static_cast<float*>(out), H, W, window, R, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

template <int NR, bool STAGED>
int launch_bisect(const void* padded, void* out, int N, int H, int W, int window, int k0, int k1,
                  cudaStream_t stream) {
  auto kernel = bisect_kernel<NR, STAGED>;
  if (STAGED && !fits_smem(window)) return static_cast<int>(cudaErrorInvalidValue);
  const int span = tile_span(window);
  const int stride = STAGED ? tile_stride(span) : 0;
  const size_t smem = STAGED ? staged_bytes(window) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const int32_t*>(padded),
                                           static_cast<float*>(out), H, W, window, stride, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

template <int NR>
int launch(const void* padded, void* out, int N, int H, int W, int window, int k0, int k1,
           cudaStream_t s) {
  switch (branch_of(window)) {
    case kSlide4096: return launch_slide<4096, NR>(padded, out, N, H, W, window, k0, k1, s);
    case kSlide8192: return launch_slide<8192, NR>(padded, out, N, H, W, window, k0, k1, s);
    case kBisectStaged: return launch_bisect<NR, true>(padded, out, N, H, W, window, k0, k1, s);
    default: return launch_bisect<NR, false>(padded, out, N, H, W, window, k0, k1, s);
  }
}

}  // namespace

// padded: float32 (N, H + 2r, W + 2r), r = window / 2; out: float32
// (n_ranks, N, H, W); n_ranks 1 (k1 unused) or 2. Returns a cudaError_t code.
extern "C" int amt_rank_select(const void* padded, void* out, int N, int H, int W, int window,
                               int n_ranks, int k0, int k1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_ranks == 1) return launch<1>(padded, out, N, H, W, window, k0, k0, s);
  if (n_ranks == 2) return launch<2>(padded, out, N, H, W, window, k0, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
