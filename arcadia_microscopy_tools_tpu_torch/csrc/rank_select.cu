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
// The k-th key is found by a 32-round MSB-first bisection: starting from
// prefix = INT32_MIN, round t tries cand = prefix + 2^(31 - t) (the int32
// addition wraps at t = 0, which splits on the sign bit) and keeps it when
// count(key < cand) <= k. The result is a key of the window, mapped back to
// its bits: an element of the window, bit for bit.
//
// Design: one CTA of 16 x 16 threads per 16 x 16 output tile and image; the
// image index is the grid's z axis. The CTA stages the (16 + window - 1)^2
// keys of its tile's window in dynamic shared memory (rows padded to a
// stride of 16 mod 32 words, so the two 16-pixel rows of a warp fall on
// disjoint banks), then each thread bisects for its own pixel, counting for
// both ranks in the same pass over the window. Windows whose staged tile
// does not fit the 227 KB a block may use (window > 225) read the keys from
// device memory (through L1/L2) instead; both branches are in this file.
//
// Bound: the function needs, per pixel and rank, about what an 8-bit radix
// select does: 4 digit passes, each counting the window^2 keys into 256 bins
// and scanning the bins, 4 x (window^2 + 256) operations. At window 21 on
// 8 x 2048^2 with one rank that is ~9.4e10 integer operations, ~1.4 ms at
// 67 T op/s, while the bytes (the padded input read once, the output written
// once, 271 MB) take ~0.08 ms at 3.35 TB/s: the function is bound by
// operations. This kernel's bisection does 32 x window^2 compare-and-add
// steps instead (~14 ms of operations at window 21), each a shared-memory
// load, a compare and an add per rank; a radix or sliding-window
// (histogram) selection would remove that 32 x factor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may opt in to

__device__ __forceinline__ int32_t to_key(int32_t bits) {
  return bits < 0 ? (bits ^ 0x7FFFFFFF) : bits;
}

// Staged tile: span x span keys with a row stride of 16 mod 32 words.
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
    rank_kernel(const int32_t* __restrict__ padded, float* __restrict__ out, int H, int W,
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

template <int NR, bool STAGED>
int launch(const void* padded, void* out, int N, int H, int W, int window, int k0, int k1,
           cudaStream_t stream) {
  auto kernel = rank_kernel<NR, STAGED>;
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

}  // namespace

// padded: float32 (N, H + 2r, W + 2r), r = window / 2; out: float32
// (n_ranks, N, H, W); n_ranks 1 (k1 unused) or 2. Returns a cudaError_t code.
extern "C" int amt_rank_select(const void* padded, void* out, int N, int H, int W, int window,
                               int n_ranks, int k0, int k1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = fits_smem(window);
  if (n_ranks == 1)
    return staged ? launch<1, true>(padded, out, N, H, W, window, k0, k0, s)
                  : launch<1, false>(padded, out, N, H, W, window, k0, k0, s);
  if (n_ranks == 2)
    return staged ? launch<2, true>(padded, out, N, H, W, window, k0, k1, s)
                  : launch<2, false>(padded, out, N, H, W, window, k0, k1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
