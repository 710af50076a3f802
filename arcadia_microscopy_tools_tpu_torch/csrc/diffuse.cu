// Masked Jacobi heat diffusion for Hopper (sm_90a), temporally blocked.
//
// Replaces the Pallas TPU kernel arcadia_microscopy_tools_tpu/models/flows_pallas.py:78
// (`_diffuse_kernel`, wrapper `diffuse_pallas` :169). Per image of a batch
// (B, H, W), with labels `lbl` (int32) and a source `src` (f32), each iteration does
//
//   T <- where(lbl > 0, fma(T + up + down + left + right, 0.2f, src), 0)
//
// where a neighbour contributes its T only if it lies in the image and has the
// same label (else +0). The reference writes `(...) / 5.0 + src`; XLA compiles
// that into a multiplication by the float32 constant 0.2 fused with the add,
// and the kernel does the same: the four adds in that order, each rounded
// (__fadd_rn), then one __fmaf_rn. The result equals the JAX loop and the plain
// PyTorch version bit for bit.
//
// Design: one pass of this kernel runs `iters` <= `halo` iterations on a
// 128 x 128 window held in shared memory (two 64 KB f32 buffers of T, read one
// and write the other, and 64 KB of f32 source) and writes back the
// (128 - 2*halo)^2 interior. After k iterations a wrong value at the window
// edge has moved k pixels inward, so the interior, `halo` pixels from the edge,
// is exact. 1024 threads each own 16 pixels of one window column; their labels
// become 5 flag bits (fg and the four same-label tests) held in registers for
// the whole pass, and an iteration is one sweep and one barrier. Pixels outside
// the image get label -1, T = 0 and no flags.
//
// Bound: the function reads lbl and src and writes T once, 12 bytes per pixel
// (0.12 ms at 8 x 2048^2 and 3.35 TB/s), and does 6 f32 operations per pixel
// per iteration (4 neighbour adds, the scaling and the source add): 128 iterations
// at 8 x 2048^2 are 25.8 GFLOP, 0.38 ms at 67 TFLOP/s, so operations bound it.
// One iteration per launch would instead move ~13 bytes per pixel per
// iteration through device memory; blocking divides that traffic by `halo`
// at the cost of recomputing the window overlap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWin = 128;
constexpr int kThreads = 1024;
constexpr int kRows = kThreads / kWin;  // window rows per thread step
constexpr int kPer = kWin / kRows;      // pixels per thread
constexpr unsigned kUp = 1u, kDown = 2u, kLeft = 4u, kRight = 8u, kFg = 16u;

__global__ void __launch_bounds__(kThreads, 1)
    diffuse_pass(const int32_t* __restrict__ lbl, const float* __restrict__ tin,
                 const float* __restrict__ src, float* __restrict__ tout, int H, int W, int halo,
                 int iters, int ntx) {
  extern __shared__ __align__(16) float smem[];
  float* T = smem;                                     // T, read in even iterations
  float* U = smem + kWin * kWin;                       // T, read in odd iterations
  float* S = smem + 2 * kWin * kWin;                   // the source
  int32_t* L = reinterpret_cast<int32_t*>(U);          // labels, before U holds T

  const int inner = kWin - 2 * halo;
  const int wy0 = (blockIdx.x / ntx) * inner - halo;
  const int wx0 = (blockIdx.x % ntx) * inner - halo;
  const size_t base = (size_t)blockIdx.y * H * W;
  const int lx = threadIdx.x % kWin;
  const int ly0 = threadIdx.x / kWin;
  const int gx = wx0 + lx;

#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int ly = ly0 + r * kRows;
    const int gy = wy0 + ly;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    L[ly * kWin + lx] = inside ? lbl[base + (size_t)gy * W + gx] : -1;
  }
  __syncthreads();

  uint32_t flags[kPer / 4];
#pragma unroll
  for (int r = 0; r < kPer / 4; ++r) flags[r] = 0u;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int ly = ly0 + r * kRows;
    const int p = ly * kWin + lx;
    const int l = L[p];
    unsigned f = l > 0 ? kFg : 0u;
    // labels outside the image are -1, so an equal neighbour lies inside it
    if (ly > 0 && L[p - kWin] == l) f |= kUp;
    if (ly < kWin - 1 && L[p + kWin] == l) f |= kDown;
    if (lx > 0 && L[p - 1] == l) f |= kLeft;
    if (lx < kWin - 1 && L[p + 1] == l) f |= kRight;
    flags[r / 4] |= f << (8 * (r % 4));
    const int gy = wy0 + ly;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    S[p] = inside ? src[base + (size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int ly = ly0 + r * kRows;
    const int gy = wy0 + ly;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    T[ly * kWin + lx] = inside ? tin[base + (size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float* src_t = (it & 1) ? U : T;
    float* dst_t = (it & 1) ? T : U;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int p = (ly0 + r * kRows) * kWin + lx;
      const unsigned f = (flags[r / 4] >> (8 * (r % 4))) & 0xffu;
      float acc = src_t[p];
      acc = __fadd_rn(acc, (f & kUp) ? src_t[p - kWin] : 0.f);
      acc = __fadd_rn(acc, (f & kDown) ? src_t[p + kWin] : 0.f);
      acc = __fadd_rn(acc, (f & kLeft) ? src_t[p - 1] : 0.f);
      acc = __fadd_rn(acc, (f & kRight) ? src_t[p + 1] : 0.f);
      dst_t[p] = (f & kFg) ? __fmaf_rn(acc, 0.2f, S[p]) : 0.f;
    }
    __syncthreads();
  }
  const float* res = (iters & 1) ? U : T;

  if (lx < halo || lx >= halo + inner || gx >= W) return;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int ly = ly0 + r * kRows;
    const int gy = wy0 + ly;
    if (ly >= halo && ly < halo + inner && gy < H) tout[base + (size_t)gy * W + gx] = res[ly * kWin + lx];
  }
}

}  // namespace

// One temporally blocked pass of `iters` iterations (1 <= iters <= halo <= 32).
// lbl: int32 (B, H, W); tin, src, tout: f32 (B, H, W); tout must not alias tin.
// Returns a cudaError_t code.
extern "C" int amt_diffuse_pass(const void* lbl, const void* tin, const void* src, void* tout,
                                int B, int H, int W, int halo, int iters, void* stream) {
  const size_t bytes = 3 * (size_t)kWin * kWin * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(diffuse_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int inner = kWin - 2 * halo;
  const int ntx = (W + inner - 1) / inner;
  const int nty = (H + inner - 1) / inner;
  dim3 grid(ntx * nty, B);
  diffuse_pass<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lbl), static_cast<const float*>(tin),
      static_cast<const float*>(src), static_cast<float*>(tout), H, W, halo, iters, ntx);
  return (int)cudaGetLastError();
}
