// Block-local connected-components sweeps for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of arcadia_microscopy_tools_tpu/ops/cc_pallas.py:
//   amt_cc_local   <- _kernel          (ops/cc_pallas.py:32), CC phase 1
//   amt_cc_resweep <- _resweep_kernel  (ops/cc_pallas.py:69), CC phase 3
//
// Each computes, per 128x128 tile of each image of a batch (B, H, W), the
// in-tile min-label fixpoint over 8 (connectivity 2) or 4 (connectivity 1)
// neighbours. Labels start at the pixel's per-image linear index y*W + x
// (amt_cc_local) or at a given seed image (amt_cc_resweep); background, and
// every pixel outside the image on a ragged edge, holds 2^30. Neighbours
// outside the tile count as background. Sweeps are Jacobi steps, two per
// iteration; a tile-wide vote after each iteration ends the loop when
// nothing changed, and the loop stops at 256 sweeps as the Pallas kernel does
// (_MAX_SWEEPS). Jacobi order plus the same cap makes the result equal the
// Pallas kernel and the plain PyTorch version bit for bit, even for tiles that
// hit the cap.
//
// amt_cc_local (`cc_local_kernel`): 256 threads per tile, labels in registers.
// - Tile-local 16-bit labels: a foreground pixel starts at ly * 128 + lx,
//   background holds 0xFFFF. Within a tile the map to (y0 + ly) * W + (x0 + lx)
//   is strictly increasing (a row step outweighs any column step, as lx < W),
//   and 0xFFFF maps to the sentinel above every index, so every min-sweep
//   commutes with it: each sweep, capped or not, gives the same bits as the
//   sweep on global indices. The map is applied at the store.
// - Warp w owns rows 16w..16w+15; lane l owns columns 4l..4l+3 as two words of
//   two 16-bit labels, 32 registers. Up and down neighbours are the thread's
//   own registers; left and right come from the neighbouring lanes by one
//   shuffle each per row, and __vminu2 takes two minimums per instruction.
//   Only a strip's first and last rows pass through shared memory, to the
//   warps above and below (double-buffered, one barrier per sweep). A sweep
//   runs down the strip in place, keeping the old rows it still needs, and
//   skips the rows that hold no foreground in all 128 columns: they stay
//   background.
// - Labels only fall, so a pair of sweeps changed something iff one of them
//   did: each sweep compares its output with its input.
// - The mask is staged in shared memory with 16-byte loads and the labels are
//   stored with 16-byte stores where the rows allow it (W a multiple of 16,
//   resp. 4, aligned rows, and the columns inside the image); elsewhere per
//   pixel.
// - A tile without foreground stores its sentinels straight after the load vote.
// - 24 KB of shared memory and 256 threads let four tiles share an SM, so one
//   tile's loads overlap another's sweeps.
//
// amt_cc_resweep (`cc_resweep_kernel`): seeds are global int32 labels, so one
// CTA of 1024 threads per tile keeps them in two int32 buffers in shared
// memory (2 x 64 KB) plus a byte mask (16 KB) and sweeps there.
//
// Bound: at 8 x 2048^2, amt_cc_local reads 1 B/px (mask) and writes 4 B/px
// (labels), 168 MB, about 50 us at 3.35 TB/s; amt_cc_resweep reads 5 B/px
// and writes 4 B/px, 302 MB, about 90 us. The sweeps' own work (9 operations
// per pixel per sweep of a tile that has foreground) is below that at the
// plate's ~1% foreground, so bytes bound both; what keeps a kernel above its
// bound is the sweeps' latency, a barrier per sweep times the in-tile
// geodesic length. No single PyTorch call computes this function.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kMaxSweeps = 256;
constexpr int kSentinel = 1 << 30;

// -- amt_cc_local: tile-local 16-bit labels in registers -------------------------

constexpr int kLocalThreads = 256;
constexpr int kLocalWarps = kLocalThreads / 32;
constexpr int kStrip = kTile / kLocalWarps;  // 16 rows per warp
constexpr uint32_t kBg2 = 0xFFFFFFFFu;       // two background labels
constexpr unsigned kFull = 0xFFFFFFFFu;

// The minimum of each of a lane's four labels (two words) and its left and
// right neighbours in the row; the tile's edge columns see background.
__device__ __forceinline__ uint2 row_min(uint2 a, int lane) {
  uint32_t left = __shfl_up_sync(kFull, a.y, 1);    // columns 4l - 2, 4l - 1
  uint32_t right = __shfl_down_sync(kFull, a.x, 1);  // columns 4l + 4, 4l + 5
  if (lane == 0) left = kBg2;
  if (lane == 31) right = kBg2;
  const uint32_t l0 = __byte_perm(left, a.x, 0x5432);   // columns 4l - 1, 4l
  const uint32_t mid = __byte_perm(a.x, a.y, 0x5432);   // columns 4l + 1, 4l + 2
  const uint32_t r1 = __byte_perm(a.y, right, 0x5432);  // columns 4l + 3, 4l + 4
  return make_uint2(__vminu2(a.x, __vminu2(l0, mid)), __vminu2(a.y, __vminu2(mid, r1)));
}

__device__ __forceinline__ uint2 min2(uint2 a, uint2 b) {
  return make_uint2(__vminu2(a.x, b.x), __vminu2(a.y, b.y));
}

// One Jacobi sweep of a warp's strip, in place; `ends` passes the strip's first
// and last rows to the warps above and below. Bit r of `rows` says that row r
// holds foreground: a row without any stays background and is not computed.
// Returns whether a label changed.
template <int CONN>
__device__ __forceinline__ bool sweep_strip(uint2 (&a)[kStrip], uint32_t rows,
                                            uint2 (*ends)[2][32], int warp, int lane) {
  ends[warp][0][lane] = a[0];
  ends[warp][1][lane] = a[kStrip - 1];
  __syncthreads();
  if (rows == 0u) return false;
  const uint2 bg = make_uint2(kBg2, kBg2);
  const uint2 above = warp > 0 ? ends[warp - 1][1][lane] : bg;
  const uint2 below = warp < kLocalWarps - 1 ? ends[warp + 1][0][lane] : bg;
  bool changed = false;
  // for connectivity 2 the rows' horizontal minimums, else the rows themselves
  uint2 prev = CONN == 2 ? row_min(above, lane) : above;
  uint2 cur = CONN == 2 && (rows & 1u) ? row_min(a[0], lane) : a[0];
#pragma unroll
  for (int r = 0; r < kStrip; ++r) {
    uint2 nxt = r + 1 < kStrip ? a[r + 1] : below;
    if (CONN == 2 && (r + 1 == kStrip || (rows >> (r + 1) & 1u))) nxt = row_min(nxt, lane);
    if (rows >> r & 1u) {
      uint2 v = CONN == 2 ? min2(prev, min2(cur, nxt))
                          : min2(row_min(cur, lane), min2(prev, nxt));
      // background stays background; a foreground label never reaches 0xFFFF
      v.x |= __vcmpeq2(a[r].x, kBg2);
      v.y |= __vcmpeq2(a[r].y, kBg2);
      changed |= (v.x != a[r].x) | (v.y != a[r].y);
      a[r] = v;
    }
    prev = cur;
    cur = nxt;
  }
  return changed;
}

// a tile-local label (ly * 128 + lx, or 0xFFFF) as the per-image index
__device__ __forceinline__ int global_label(uint32_t l, int x0, int y0, int W) {
  return l == 0xFFFFu ? kSentinel : (y0 + (int)(l >> 7)) * W + x0 + (int)(l & 127u);
}

template <int CONN>
__global__ void __launch_bounds__(kLocalThreads, 4)
    cc_local_kernel(const uint8_t* __restrict__ fg_g, int32_t* __restrict__ out_g, int H, int W,
                    bool vec_in) {
  __shared__ __align__(16) uint8_t m[kTile * kTile];
  __shared__ uint2 ends[2][kLocalWarps][2][32];

  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (vec_in && x0 + kTile <= W) {
    for (int k = tid; k < kTile * kTile / 16; k += kLocalThreads) {
      const int gy = y0 + k / (kTile / 16);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy < H)
        v = __ldg(reinterpret_cast<const uint4*>(fg_g + base + static_cast<size_t>(gy) * W + x0) +
                  k % (kTile / 16));
      reinterpret_cast<uint4*>(m)[k] = v;
    }
  } else {
    for (int k = tid; k < kTile * kTile; k += kLocalThreads) {
      const int gy = y0 + k / kTile, gx = x0 + k % kTile;
      m[k] = gy < H && gx < W && fg_g[base + static_cast<size_t>(gy) * W + gx] != 0;
    }
  }
  __syncthreads();

  uint2 a[kStrip];
  uint32_t rows = 0u;  // the strip's rows that hold foreground
#pragma unroll
  for (int r = 0; r < kStrip; ++r) {
    const int p = (warp * kStrip + r) * kTile + 4 * lane;
    const uint32_t mb = *reinterpret_cast<const uint32_t*>(m + p);
    uint32_t c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = (mb >> (8 * k)) & 0xFFu ? p + k : 0xFFFFu;
    a[r] = make_uint2(c[0] | c[1] << 16, c[2] | c[3] << 16);
    rows |= (__any_sync(kFull, mb != 0u) ? 1u : 0u) << r;
  }
  if (__syncthreads_or(rows != 0u)) {
    for (int it = 0; it < kMaxSweeps; it += 2) {
      bool changed = sweep_strip<CONN>(a, rows, ends[0], warp, lane);
      changed |= sweep_strip<CONN>(a, rows, ends[1], warp, lane);
      // labels only fall, so the pair changed something iff one sweep did
      if (!__syncthreads_or(changed)) break;
    }
  }

  const int gx = x0 + 4 * lane;
  const bool vec = W % 4 == 0 && gx + 3 < W;
#pragma unroll
  for (int r = 0; r < kStrip; ++r) {
    const int gy = y0 + warp * kStrip + r;
    if (gy >= H) break;
    const int4 v = make_int4(global_label(a[r].x & 0xFFFFu, x0, y0, W),
                             global_label(a[r].x >> 16, x0, y0, W),
                             global_label(a[r].y & 0xFFFFu, x0, y0, W),
                             global_label(a[r].y >> 16, x0, y0, W));
    int32_t* row = out_g + base + static_cast<size_t>(gy) * W;
    if (vec) {
      *reinterpret_cast<int4*>(row + gx) = v;
    } else {
      if (gx < W) row[gx] = v.x;
      if (gx + 1 < W) row[gx + 1] = v.y;
      if (gx + 2 < W) row[gx + 2] = v.z;
      if (gx + 3 < W) row[gx + 3] = v.w;
    }
  }
}

// -- amt_cc_resweep: global int32 seeds in shared memory --------------------------

constexpr int kThreads = 1024;
constexpr int kRowsPerPass = kThreads / kTile;  // 8 rows per pass over the tile
constexpr int kPasses = kTile / kRowsPerPass;   // 16 pixels per thread
constexpr size_t kSmemBytes = 2 * kTile * kTile * sizeof(int32_t) + kTile * kTile;

// One Jacobi step at tile pixel (y, x): the minimum over the pixel and its
// in-tile neighbours, or the sentinel on background.
template <int CONN>
__device__ __forceinline__ int sweep_px(const int32_t* __restrict__ src,
                                        const uint8_t* __restrict__ fg, int y, int x) {
  const int p = y * kTile + x;
  if (!fg[p]) return kSentinel;
  const bool up = y > 0, dn = y < kTile - 1, lf = x > 0, rt = x < kTile - 1;
  int v = src[p];
  if (up) v = min(v, src[p - kTile]);
  if (dn) v = min(v, src[p + kTile]);
  if (lf) v = min(v, src[p - 1]);
  if (rt) v = min(v, src[p + 1]);
  if (CONN == 2) {
    if (up && lf) v = min(v, src[p - kTile - 1]);
    if (up && rt) v = min(v, src[p - kTile + 1]);
    if (dn && lf) v = min(v, src[p + kTile - 1]);
    if (dn && rt) v = min(v, src[p + kTile + 1]);
  }
  return v;
}

template <int CONN>
__global__ void __launch_bounds__(kThreads)
    cc_resweep_kernel(const uint8_t* __restrict__ fg_g, const int32_t* __restrict__ init_g,
                      int32_t* __restrict__ out_g, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* a = reinterpret_cast<int32_t*>(smem);
  int32_t* b = a + kTile * kTile;
  uint8_t* m = reinterpret_cast<uint8_t*>(b + kTile * kTile);

  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const size_t base = static_cast<size_t>(blockIdx.z) * H * W;
  const int lx = threadIdx.x % kTile;
  const int ly0 = threadIdx.x / kTile;
  const int gx = x0 + lx;

#pragma unroll
  for (int r = 0; r < kPasses; ++r) {
    const int ly = ly0 + r * kRowsPerPass;
    const int gy = y0 + ly;
    const bool inside = gy < H && gx < W;
    const size_t g = base + static_cast<size_t>(gy) * W + gx;
    const uint8_t f = inside ? (fg_g[g] != 0) : 0;
    int lab = kSentinel;
    if (f) lab = init_g[g];
    m[ly * kTile + lx] = f;
    a[ly * kTile + lx] = lab;
  }
  __syncthreads();

  for (int it = 0; it < kMaxSweeps; it += 2) {
#pragma unroll
    for (int r = 0; r < kPasses; ++r) {
      const int ly = ly0 + r * kRowsPerPass;
      b[ly * kTile + lx] = sweep_px<CONN>(a, m, ly, lx);
    }
    __syncthreads();
    int changed = 0;
#pragma unroll
    for (int r = 0; r < kPasses; ++r) {
      const int ly = ly0 + r * kRowsPerPass;
      const int p = ly * kTile + lx;
      const int v = sweep_px<CONN>(b, m, ly, lx);
      // labels only decrease, so the pair of sweeps changed something iff
      // some pixel ends below where it started
      changed |= v != a[p];
      a[p] = v;
    }
    if (!__syncthreads_or(changed)) break;
  }

#pragma unroll
  for (int r = 0; r < kPasses; ++r) {
    const int ly = ly0 + r * kRowsPerPass;
    const int gy = y0 + ly;
    if (gy < H && gx < W) out_g[base + static_cast<size_t>(gy) * W + gx] = a[ly * kTile + lx];
  }
}

template <int CONN>
int launch_local(const void* fg, void* out, int B, int H, int W, cudaStream_t stream) {
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  // 16-byte mask loads need 16-byte aligned rows
  const bool vec_in = W % 16 == 0 && reinterpret_cast<uintptr_t>(fg) % 16 == 0;
  cc_local_kernel<CONN><<<grid, kLocalThreads, 0, stream>>>(
      static_cast<const uint8_t*>(fg), static_cast<int32_t*>(out), H, W, vec_in);
  return static_cast<int>(cudaGetLastError());
}

template <int CONN>
int launch_resweep(const void* fg, const void* init, void* out, int B, int H, int W,
                   cudaStream_t stream) {
  auto kernel = cc_resweep_kernel<CONN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(static_cast<const uint8_t*>(fg),
                                                 static_cast<const int32_t*>(init),
                                                 static_cast<int32_t*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fg: bool/uint8 (B, H, W); out: int32 (B, H, W). Returns a cudaError_t code.
extern "C" int amt_cc_local(const void* fg, void* out, int B, int H, int W, int connectivity,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return connectivity == 2 ? launch_local<2>(fg, out, B, H, W, s)
                           : launch_local<1>(fg, out, B, H, W, s);
}

// fg: bool/uint8 (B, H, W); init, out: int32 (B, H, W). Returns a cudaError_t code.
extern "C" int amt_cc_resweep(const void* fg, const void* init, void* out, int B, int H, int W,
                              int connectivity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return connectivity == 2 ? launch_resweep<2>(fg, init, out, B, H, W, s)
                           : launch_resweep<1>(fg, init, out, B, H, W, s);
}
