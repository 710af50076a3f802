// Per-channel GroupNorm moments for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel arcadia_microscopy_tools_tpu/models/gn_pallas.py:66
// (`_moments_kernel`, wrapper `lane_moments` :101): for a bf16 NHWC activation
// (B, H, W, C) it computes, per (b, c), the f32 sums of x and x^2 over H * W.
//
// Design: one pass over the activation with 16-byte loads. A CTA of 256 threads
// takes a run of `run` pixels of one image (the wrapper passes whole rows: the
// most rows, a power of two, that fit in 4096 pixels, so the runs of a row slab
// that starts on a multiple of that many rows are the whole image's runs, and
// 4096 pixels whenever W divides 4096); C/8 neighbouring threads read one
// pixel's C channels (8 each), so a warp reads contiguous memory. Each thread
// accumulates its 8 channels in registers, the CTA folds its threads together
// in shared memory in a fixed order, and writes one partial per (b, chunk, c)
// to part[b][chunk][2][C]. The caller sums the partials over chunks in a fixed
// order. No float atomics: every launch gives the same bits.
//
// Bound: the activation is read once, 2 bytes per value, and the work is 3 FLOP
// per value, so the kernel is bound by bytes: at the U-Net's one call (the
// 3 -> 32 channel stem conv's output, 8 x 2048^2 x 32 bf16 = 2.1 GB) that is
// ~0.64 ms at 3.35 TB/s. The TPU kernel carried the sums across a sequential
// grid; Hopper's CTAs run in parallel, hence the partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;

__global__ void __launch_bounds__(kThreads) moments_kernel(const __nv_bfloat16* __restrict__ x,
                                                           float* __restrict__ part, long long N,
                                                           int C, int chunks, int run) {
  __shared__ float red[2][kThreads][kVec];
  const int lanes = C / kVec;          // threads per pixel
  const int rows = kThreads / lanes;   // pixels per step of the CTA
  const int cv = threadIdx.x % lanes;
  const int r0 = threadIdx.x / lanes;
  const int b = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * run;
  const long long p1 = min(N, p0 + run);

  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  if (r0 < rows) {
    for (long long p = p0 + r0; p < p1; p += rows) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(x + ((size_t)b * N + p) * C + cv * kVec));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = __bfloat162float(e[j]);
        s1[j] = __fadd_rn(s1[j], f);
        s2[j] = __fadd_rn(s2[j], __fmul_rn(f, f));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    red[0][threadIdx.x][j] = s1[j];
    red[1][threadIdx.x][j] = s2[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * C; k += kThreads) {
    const int which = k / C;
    const int c = k % C;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s = __fadd_rn(s, red[which][r * lanes + c / kVec][c % kVec]);
    part[(((size_t)b * chunks + blockIdx.x) * 2 + which) * C + c] = s;
  }
}

}  // namespace

// x: bf16 (B, H, W, C) with C a multiple of 8 and at most 2048; part: f32
// (B, chunks, 2, C) with chunks = amt_lane_moments_chunks(H * W, run), one
// partial per run of `run` > 0 pixels. Returns a cudaError_t code.
extern "C" int amt_lane_moments(const void* x, void* part, int B, long long N, int C, int run,
                                void* stream) {
  if (run <= 0) return (int)cudaErrorInvalidValue;
  const int chunks = (int)((N + run - 1) / run);
  dim3 grid(chunks, B);
  moments_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(part), N, C, chunks, run);
  return (int)cudaGetLastError();
}

extern "C" int amt_lane_moments_chunks(long long N, int run) {
  return (int)((N + run - 1) / run);
}
