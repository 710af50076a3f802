// Block tail of the U-Net forward for Hopper (sm_90a): kernel 9.
//
// Replaces no TPU kernel. The JAX package's `_fused_tail`
// (arcadia_microscopy_tools_tpu/models/unet_s2d.py) is XLA elementwise code,
// and the port ran it as six PyTorch passes with float32 temporaries
// (`models/tail_cuda.py`, `unet_tail_plain`). After conv2 of every residual
// block, per pixel and channel of the bf16 NHWC activation, it computes
//
//   t = bf16(fadd_rn(fmul_rn(float(y2), scale[b,c]), bias[b,c]))    GroupNorm-2 affine
//   r = skip                                                        one operand
//     | bf16(float(up[b, y>>1, x>>1, c]) + float(skip))             split decoder skip
//   o = relu(bf16(float(t) + float(r)))
//   o = bf16(float(o) + float(style[b,c]))                          with a style row
//
// with exactly the rounding points of that PyTorch sequence, so the two
// agree bit for bit: every product and sum is an explicit `__fmul_rn` /
// `__fadd_rn` (never contracted into an FMA), every rounding to bf16 a
// `__float2bfloat16_rn`, and ReLU keeps a NaN as it is and otherwise takes
// fmaxf(v, 0) of the rounded value, as PyTorch's `relu_` on bf16 does (-0
// becomes +0). `up` is the half-resolution part of the decoder's 1x1
// projection (taken before the nearest upsample, which commutes with it),
// read at (y>>1, x>>1), so the upsampled tensor is never built. The output
// may be y2's own storage.
//
// Bound: bytes. Per element the kernel reads y2 and the skip (2 + 2 bytes),
// a quarter of a bf16 `up` element where there is one, and writes 2 bytes:
// 6 or 6.5 bytes against the 38 of the six PyTorch passes (two float32
// temporaries) and the 8.5 of the materialised upsample and its sum. The
// seven tails of one forward at 8 x 2048^2 move ~24.3 GB, ~7.3 ms at 3.35
// TB/s. Per element it does a handful of float operations, far below the
// card's rate.
//
// Design: 16-byte vectors of 8 channels along C. Each block serves one image
// (blockIdx.y); C / 8 neighbouring threads cover one pixel's channels, so a
// warp reads contiguous memory, and each thread keeps the same 8 channels for
// its whole grid-stride loop over pixels: its scale, bias and style values
// stay in registers, read once. The grid is one wave of resident blocks;
// each thread loads the operands of `kUnroll` pixels before it computes and
// stores any of them, to keep enough bytes in flight to cover the latency of
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;     // bf16 channels per 16-byte vector
constexpr int kUnroll = 4;  // pixels whose operands a thread loads before storing

__device__ __forceinline__ float lane(const uint4& q, int j) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&q)[j]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kSplit, bool kStyle>
__global__ void __launch_bounds__(kThreads) unet_tail_kernel(
    const __nv_bfloat16* y, const float* __restrict__ scale, const float* __restrict__ bias,
    const __nv_bfloat16* skip, const __nv_bfloat16* __restrict__ up,
    const __nv_bfloat16* __restrict__ style, __nv_bfloat16* out, int N, int W, int C, int Hu,
    int Wu) {
  const int lanes = C / kVec;         // threads per pixel
  const int rows = kThreads / lanes;  // pixels per step of the block
  const int cv = threadIdx.x % lanes;
  const int r0 = threadIdx.x / lanes;
  if (r0 >= rows) return;
  const int b = blockIdx.y;
  const size_t row = (size_t)b * C + cv * kVec;
  float sc[kVec], bi[kVec], st[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sc[j] = scale[row + j];
    bi[j] = bias[row + j];
    st[j] = 0.f;
  }
  if (kStyle) {
    const uint4 s = *reinterpret_cast<const uint4*>(style + row);
#pragma unroll
    for (int j = 0; j < kVec; ++j) st[j] = lane(s, j);
  }
  const size_t image = (size_t)b * N;
  const long long step = (long long)gridDim.x * rows;
  for (long long p0 = (long long)blockIdx.x * rows + r0; p0 < N; p0 += kUnroll * step) {
    uint4 a[kUnroll], s[kUnroll], u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long p = p0 + k * step;
      if (p < N) {
        const size_t off = (image + p) * C + cv * kVec;
        a[k] = *reinterpret_cast<const uint4*>(y + off);
        s[k] = *reinterpret_cast<const uint4*>(skip + off);
        if (kSplit) {
          const int py = (int)p / W, px = (int)p - py * W;
          const size_t uoff = (((size_t)b * Hu + (py >> 1)) * Wu + (px >> 1)) * C + cv * kVec;
          u[k] = __ldg(reinterpret_cast<const uint4*>(up + uoff));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long p = p0 + k * step;
      if (p >= N) break;
      uint4 o4;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&o4);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float t = round_bf16(__fadd_rn(__fmul_rn(lane(a[k], j), sc[j]), bi[j]));
        const float r =
            kSplit ? round_bf16(__fadd_rn(lane(u[k], j), lane(s[k], j))) : lane(s[k], j);
        float v = round_bf16(__fadd_rn(t, r));
        v = isnan(v) ? v : fmaxf(v, 0.f);  // relu_: NaN kept, else max(v, 0)
        if (kStyle) v = __fadd_rn(v, st[j]);
        o[j] = __float2bfloat16_rn(v);
      }
      *reinterpret_cast<uint4*>(out + (image + p) * C + cv * kVec) = o4;
    }
  }
}

template <bool kSplit, bool kStyle>
int launch(const void* y, const void* scale, const void* bias, const void* skip, const void* up,
           const void* style, void* out, int B, int N, int W, int C, int Hu, int Wu,
           cudaStream_t stream) {
  auto kernel = unet_tail_kernel<kSplit, kStyle>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // one wave of resident blocks, shared out between the images
  const int rows = kThreads / (C / kVec);
  const long long needed = ((long long)N + rows - 1) / rows;
  const long long wave = ((long long)sms * per_sm + B - 1) / B;
  const int blocks = (int)(needed < wave ? needed : (wave > 0 ? wave : 1));
  kernel<<<dim3(blocks, B), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(skip),
      static_cast<const __nv_bfloat16*>(up), static_cast<const __nv_bfloat16*>(style),
      static_cast<__nv_bfloat16*>(out), N, W, C, Hu, Wu);
  return (int)cudaGetLastError();
}

}  // namespace

// y, skip, out: bf16 (B, H, W, C), C a multiple of 8 and at most 2048, N = H * W
// pixels below 2^31; out may be y. scale, bias: f32 (B, C). up: null, or bf16
// (B, Hu, Wu, C) with Hu = ceil(H / 2), Wu = ceil(W / 2). style: null, or bf16
// (B, C). Every pointer 16-byte aligned. Returns a cudaError_t code.
extern "C" int amt_unet_tail(const void* y, const void* scale, const void* bias, const void* skip,
                             const void* up, const void* style, void* out, int B, int H, int W,
                             int C, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || C % kVec || C > kThreads * kVec ||
      (long long)H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = H * W, Hu = (H + 1) / 2, Wu = (W + 1) / 2;
  if (up != nullptr && style != nullptr)
    return launch<true, true>(y, scale, bias, skip, up, style, out, B, N, W, C, Hu, Wu, st);
  if (up != nullptr)
    return launch<true, false>(y, scale, bias, skip, up, style, out, B, N, W, C, Hu, Wu, st);
  if (style != nullptr)
    return launch<false, true>(y, scale, bias, skip, up, style, out, B, N, W, C, Hu, Wu, st);
  return launch<false, false>(y, scale, bias, skip, up, style, out, B, N, W, C, Hu, Wu, st);
}
