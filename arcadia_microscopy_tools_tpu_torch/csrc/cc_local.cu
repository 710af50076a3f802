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
// outside the tile count as background.
//
// Design: one CTA of 1024 threads per (tile, image). The tile's labels live
// in shared memory in two int32 buffers (2 x 64 KB) plus a byte mask (16 KB),
// so a sweep touches no device memory. Sweeps are Jacobi steps (read one
// buffer, write the other), two per iteration; a block-wide vote after each
// iteration ends the loop when nothing changed, and the loop stops at 256
// sweeps as the Pallas kernel does (_MAX_SWEEPS). Jacobi order plus the same
// cap makes the result equal the Pallas kernel and the plain PyTorch version
// bit for bit, even for tiles that hit the cap.
//
// Bound: at 8 x 2048^2, amt_cc_local reads 1 B/px (mask) and writes 4 B/px
// (labels), 168 MB, about 50 us at 3.35 TB/s; amt_cc_resweep reads 5 B/px
// and writes 4 B/px, 302 MB, about 90 us. Both are expected to be bound far
// above that by the sweeps themselves (shared-memory traffic and the
// __syncthreads between sweeps, times the in-tile geodesic length). No single
// PyTorch call computes this function.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 1024;
constexpr int kRowsPerPass = kThreads / kTile;  // 8 rows per pass over the tile
constexpr int kPasses = kTile / kRowsPerPass;   // 16 pixels per thread
constexpr int kMaxSweeps = 256;
constexpr int kSentinel = 1 << 30;
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

template <int CONN, bool SEEDED>
__global__ void __launch_bounds__(kThreads)
    cc_tile_kernel(const uint8_t* __restrict__ fg_g, const int32_t* __restrict__ init_g,
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
    if (f) lab = SEEDED ? init_g[g] : gy * W + gx;
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

template <int CONN, bool SEEDED>
int launch(const void* fg, const void* init, void* out, int B, int H, int W,
           cudaStream_t stream) {
  auto kernel = cc_tile_kernel<CONN, SEEDED>;
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
  return connectivity == 2 ? launch<2, false>(fg, nullptr, out, B, H, W, s)
                           : launch<1, false>(fg, nullptr, out, B, H, W, s);
}

// fg: bool/uint8 (B, H, W); init, out: int32 (B, H, W). Returns a cudaError_t code.
extern "C" int amt_cc_resweep(const void* fg, const void* init, void* out, int B, int H, int W,
                              int connectivity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return connectivity == 2 ? launch<2, true>(fg, init, out, B, H, W, s)
                           : launch<1, true>(fg, init, out, B, H, W, s);
}
