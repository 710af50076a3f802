// Fused SAME 3x3 convolution for Hopper (sm_90a), NHWC, bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel arcadia_microscopy_tools_tpu/models/conv_pallas.py:129
// (`_kernel`, wrapper `conv3x3_fused` :336). One launch computes
//
//   y = bf16( conv3x3( prologue(x), w ) + accum )        (f32 accumulation)
//   prologue(x) = bf16( max(x * scale[b,c] + bias[b,c], 0) )   (optional; ReLU optional)
//   moments: per (b, co) partial sums of y and y^2 over the CTA's pixels, taken of
//            the bf16-rounded output and accumulated in f32
//
// Design: an implicit GEMM on the tensor cores with mma.sync m16n8k16 bf16 -> f32.
// M = the 16x16 output pixels of one CTA, N = a tile of TN (32 or 64) output
// channels, K = 9 * C, walked in chunks of 32 input channels. For each chunk the
// CTA stages the (16+2) x (16+2) x 32 input slab in shared memory, with the
// prologue applied on load and every halo pixel outside the image written as 0
// (affine(0) != 0, so zero padding has to come after the prologue, on rows and
// columns alike), and the chunk's 9 x TN x 32 weights. Eight warps each own two
// output rows (two m16 tiles) times TN channels. Shared-memory rows are padded
// to 40 bf16 so the 32-bit fragment loads hit 32 distinct banks.
//
// Epilogue: adds `accum` in f32 before the one rounding to bf16, stores, and
// writes per-CTA moment partials to part[b][tile][2][Co]. Warps reduce in a
// fixed order (shuffles, then warp 0..7 in turn) and never use float atomics, so
// every launch gives the same bits; the partials are summed over tiles by the
// caller in a fixed order too. The TPU kernel carried the moments across its
// sequential grid; Hopper's CTAs run in parallel, hence the partial buffer.
//
// Bound (at the U-Net's shapes, 8 images): a call moves x, w, accum and y once
// and does 2 * 9 * C * Co FLOP per output pixel. At 32 -> 32 channels the
// intensity is 144 FLOP/byte, below the H100's ~295 (989 TFLOP/s bf16 over
// 3.35 TB/s), so the full-resolution 32-channel convs are bound by bytes; at 64
// channels both bounds are close; the 128- and 256-channel levels are bound by
// the tensor cores. The 16 calls of one 2048^2 x 8 forward do ~10.8 TFLOP, about
// 11 ms at the dense bf16 peak. This first version does not reach either bound:
// loads are synchronous (no cp.async / TMA pipeline) and mma.sync runs below the
// wgmma rate; its times stand in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 16;                 // output rows per CTA
constexpr int kTW = 16;                 // output columns per CTA (one m16 tile per row)
constexpr int kWarps = kTH / 2;         // each warp owns two output rows
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 32;                 // input channels per shared-memory chunk
constexpr int kPitch = kKC + 8;         // bf16 per staged pixel / weight row
constexpr int kSlabH = kTH + 2;
constexpr int kSlabW = kTW + 2;
constexpr int kVec = 8;                 // bf16 per 16-byte vector

struct ConvArgs {
  const __nv_bfloat16* x;      // (B, H, W, C)
  const __nv_bfloat16* w;      // (9, Co, C): tap-major, then output channel
  const float* scale;          // (B, C) or null: prologue
  const float* bias;           // (B, C) or null
  const __nv_bfloat16* accum;  // (B, H, W, Co) or null
  __nv_bfloat16* y;            // (B, H, W, Co)
  float* part;                 // (B, tiles, 2, Co) or null: moment partials
  int H, W, C, Co, ntx, tiles, relu;
};

template <int TN>
constexpr size_t smem_bytes() {
  return (size_t)(kSlabH * kSlabW + 9 * TN) * kPitch * sizeof(__nv_bfloat16) +
         (size_t)kWarps * 2 * TN * sizeof(float);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 2) conv3x3_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);  // [18*18][kPitch]
  __nv_bfloat16* wsm = slab + kSlabH * kSlabW * kPitch;           // [9*TN][kPitch]
  float* red = reinterpret_cast<float*>(wsm + 9 * TN * kPitch);    // [kWarps][2][TN]

  constexpr int NT = TN / 8;
  const int tile = blockIdx.x;
  const int y0 = (tile / a.ntx) * kTH;
  const int x0 = (tile % a.ntx) * kTW;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int c0 = 0; c0 < a.C; c0 += kKC) {
    // input slab with the prologue applied; zero outside the image
    for (int v = threadIdx.x; v < kSlabH * kSlabW * (kKC / kVec); v += kThreads) {
      const int cv = v % (kKC / kVec);
      const int pix = v / (kKC / kVec);
      const int gy = y0 - 1 + pix / kSlabW;
      const int gx = x0 - 1 + pix % kSlabW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
        const int c = c0 + cv * kVec;
        val = *reinterpret_cast<const uint4*>(a.x + (((size_t)b * a.H + gy) * a.W + gx) * a.C + c);
        if (a.scale != nullptr) {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
          const float* sc = a.scale + (size_t)b * a.C + c;
          const float* bi = a.bias + (size_t)b * a.C + c;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            float f = __fadd_rn(__fmul_rn(__bfloat162float(e[j]), sc[j]), bi[j]);
            if (a.relu) f = fmaxf(f, 0.f);
            e[j] = __float2bfloat16_rn(f);
          }
        }
      }
      *reinterpret_cast<uint4*>(slab + pix * kPitch + cv * kVec) = val;
    }
    // the chunk's weights: rows (tap, n), kKC channels each
    for (int v = threadIdx.x; v < 9 * TN * (kKC / kVec); v += kThreads) {
      const int cv = v % (kKC / kVec);
      const int row = v / (kKC / kVec);
      const int tap = row / TN;
      const int n = row % TN;
      const size_t off = ((size_t)tap * a.Co + n0 + n) * a.C + c0 + cv * kVec;
      *reinterpret_cast<uint4*>(wsm + row * kPitch + cv * kVec) =
          *reinterpret_cast<const uint4*>(a.w + off);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // m-tile row i is output pixel (y0 + r, x0 + i); tap (dy, dx) reads
          // slab pixel (r + dy, i + dx)
          const int r = warp * 2 + mt;
          const __nv_bfloat16* base = slab + ((r + dy) * kSlabW + dx) * kPitch + k0 + 2 * t;
          af[mt][0] = ld32(base + g * kPitch);
          af[mt][1] = ld32(base + (g + 8) * kPitch);
          af[mt][2] = ld32(base + g * kPitch + 8);
          af[mt][3] = ld32(base + (g + 8) * kPitch + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* wb = wsm + (tap * TN + nt * 8 + g) * kPitch + k0 + 2 * t;
          const uint32_t b0 = ld32(wb);
          const uint32_t b1 = ld32(wb + 8);
          mma16816(acc[0][nt], af[0], b0, b1);
          mma16816(acc[1][nt], af[1], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + accum, one rounding to bf16, store, moments of the stored values
  float s1[NT][2], s2[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = y0 + warp * 2 + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gx = x0 + g + 8 * half;
      if (gy >= a.H || gx >= a.W) continue;
      const size_t pix = ((size_t)b * a.H + gy) * a.W + gx;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = n0 + nt * 8 + 2 * t;
        float v0 = acc[mt][nt][2 * half];
        float v1 = acc[mt][nt][2 * half + 1];
        if (a.accum != nullptr) {
          const __nv_bfloat162 av =
              *reinterpret_cast<const __nv_bfloat162*>(a.accum + pix * a.Co + co);
          v0 = __fadd_rn(v0, __low2float(av));
          v1 = __fadd_rn(v1, __high2float(av));
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(a.y + pix * a.Co + co) = o;
        const float f0 = __low2float(o);
        const float f1 = __high2float(o);
        s1[nt][0] = __fadd_rn(s1[nt][0], f0);
        s1[nt][1] = __fadd_rn(s1[nt][1], f1);
        s2[nt][0] = __fadd_rn(s2[nt][0], __fmul_rn(f0, f0));
        s2[nt][1] = __fadd_rn(s2[nt][1], __fmul_rn(f1, f1));
      }
    }
  }
  if (a.part == nullptr) return;

  // reduce over the 8 row groups of the warp (lanes with equal t), fixed order
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s1[nt][j] = __fadd_rn(s1[nt][j], __shfl_xor_sync(0xffffffffu, s1[nt][j], m));
        s2[nt][j] = __fadd_rn(s2[nt][j], __shfl_xor_sync(0xffffffffu, s2[nt][j], m));
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red[(warp * 2 + 0) * TN + nt * 8 + 2 * t + j] = s1[nt][j];
        red[(warp * 2 + 1) * TN + nt * 8 + 2 * t + j] = s2[nt][j];
      }
  }
  __syncthreads();
  if (threadIdx.x < 2 * TN) {
    const int which = threadIdx.x / TN;  // 0: sum, 1: sum of squares
    const int n = threadIdx.x % TN;
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s = __fadd_rn(s, red[(wi * 2 + which) * TN + n]);
    a.part[(((size_t)b * a.tiles + tile) * 2 + which) * a.Co + n0 + n] = s;
  }
}

template <int TN>
int launch(const ConvArgs& args, int B, cudaStream_t stream) {
  auto kernel = conv3x3_kernel<TN>;
  constexpr size_t bytes = smem_bytes<TN>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(args.tiles, args.Co / TN, B);
  kernel<<<grid, kThreads, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 (B, H, W, C); w: bf16 (9, Co, C); scale, bias: f32 (B, C) or null;
// accum: bf16 (B, H, W, Co) or null; y: bf16 (B, H, W, Co); part: f32
// (B, tiles, 2, Co) or null, tiles = ceil(H/16) * ceil(W/16). C and Co are
// multiples of 32. Returns a cudaError_t code.
extern "C" int amt_conv3x3_fused(const void* x, const void* w, const void* scale, const void* bias,
                                 const void* accum, void* y, void* part, int B, int H, int W,
                                 int C, int Co, int relu, void* stream) {
  ConvArgs args;
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.w = static_cast<const __nv_bfloat16*>(w);
  args.scale = static_cast<const float*>(scale);
  args.bias = static_cast<const float*>(bias);
  args.accum = static_cast<const __nv_bfloat16*>(accum);
  args.y = static_cast<__nv_bfloat16*>(y);
  args.part = static_cast<float*>(part);
  args.H = H;
  args.W = W;
  args.C = C;
  args.Co = Co;
  args.ntx = (W + kTW - 1) / kTW;
  args.tiles = args.ntx * ((H + kTH - 1) / kTH);
  args.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Co % 64 == 0 ? launch<64>(args, B, s) : launch<32>(args, B, s);
}

// Tile geometry the caller needs to size `part`.
extern "C" int amt_conv3x3_tiles(int H, int W) {
  return ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH);
}
