// Segment Anything's mask head for Hopper (sm_90a): kernel 10.
//
// Replaces no TPU kernel: the JAX package runs no mask decoder. It is the
// end of `SegmentAnything.decode` (models/sam_decoder.py): SAM's
// `output_upscaling` (ConvT 2 x 2 stride 2 from 256 to 64 channels,
// LayerNorm2d, GELU, ConvT from 64 to 32 channels, GELU) and the product of
// the upscaled map with the hypernetwork rows of mask tokens 1-3, for a batch
// of P prompts. Each of the G x G tokens of `keys` (the two-way
// transformer's image side, 256 channels) gives a 2 x 2 block of 64 channels,
// then a 4 x 4 block of 32 channels, then 3 logits per output pixel, so the
// whole chain is local to one token. Per token and sub-pixel, with the
// rounding points of the PyTorch sequence it replaces
// (`models/sam_upscale_cuda.py`, `sam_upscale_plain`):
//
//   y = bf16(bf16(keys W0^T) + b0)                   ConvT 0, float32 accumulation
//   z = bf16(w1 (rstd (y - mean)) + b1)              LayerNorm over the 64 channels,
//                                                    float32 statistics, eps 1e-6
//   z = bf16(gelu(z))                                exact erf
//   u = bf16(gelu(bf16(bf16(z W3^T) + b3)))          ConvT 3
//   logit[m] = bf16(u . hyper[m]),  m = 1, 2, 3      the hypernetwork product
//
// Only the order of the sums inside the three products differs (and the
// LayerNorm's statistics are two passes here, Welford's in PyTorch's kernel).
// A bias add of two bf16 values is one bf16x2 add: its single rounding of the
// exact sum equals PyTorch's float32 sum rounded to bf16. Every GELU has the
// bits of PyTorch's float32 expression (see `gelu_pairs`). Mask token 0's
// product, which `decode` drops, is not computed.
//
// Bound: operations and bytes alike. At P = 64 and G = 64 the three products
// are 34.4, 17.2 and 0.8 GFLOP (0.053 ms at 989 TFLOP/s), against 134 MB of
// keys read and 25 MB of logits written (0.047 ms at 3.35 TB/s). The PyTorch
// sequence moved ~3.7 GB through device memory for the same work: ten passes
// over tensors of 134-268 MB. Besides the products the kernel evaluates 201 M
// GELUs and 1 M LayerNorms of 64 values a prompt batch on the CUDA cores,
// which the bound does not count; they, and not the tensor cores, set its
// pace (without the GELUs it takes about 60% of its time).
//
// Design: persistent blocks, one per SM, of two warpgroups that each walk
// their own tiles, so that one's epilogues overlap the other's products.
// Both ConvT weights stay in shared memory for the block's life (W0 128 KB,
// W3 16 KB), their rows permuted as they are staged so that each
// sub-pixel's channels are contiguous (row s * 64 + c of W0, q * 32 + c2 of
// W3). A tile is 64 consecutive tokens of one prompt (one grid row at G =
// 64), 32 KB, brought in by cp.async; every operand of the tensor cores sits
// in wgmma's K-major core-matrix layout without swizzle. Per tile a
// warpgroup
// - runs the first product on wgmma (m64n256k16, bf16 in, float32 out, A and
//   B from shared memory), then starts the copy of its next tile into the
//   same buffer;
// - adds the bias, takes the LayerNorm (each row's 64 channels of a
//   sub-pixel lie in one quad of threads: two shuffles per sum), its affine
//   and the GELU on the accumulators, which it packs in place as the A
//   fragments of the second product (wgmma's accumulator layout is its
//   register A layout);
// - per sub-pixel runs the second product (two m64n64k16 halves, A from
//   registers, the second half's product during the first half's epilogue),
//   bias and GELU, and the third on mma.sync with the three hypernetwork rows
//   (zero-padded to 8) as B, four registers a thread;
// - stages the logits of each half tile (one dy, 3 KB) in shared memory and
//   stores them as 16-byte vectors, runs of 4 G logits.
// A GELU reads an 8 KB table that the block fills at its start with the
// plain expression in float32 (erff), and patches the values outside it with
// bf16x2 arithmetic, without a branch: a branch per value, or per warp, cost
// more than the table saved.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kIn = 256;    // keys' channels
constexpr int kMid = 64;    // channels after the first ConvT
constexpr int kOut = 32;    // channels after the second ConvT
constexpr int kMasks = 3;   // mask tokens 1-3
constexpr int kTile = 64;   // tokens a tile: the M of one wgmma
constexpr int kGroups = 2;  // warpgroups a block, each on its own tiles
constexpr int kThreads = 128 * kGroups;
constexpr float kEps = 1e-6f;
constexpr float kAlpha = 0.70710678118654752440f;
// the GELU table: per sign 2048 entries, the 2047 bf16 values with |x| in
// (2^-13, 8), then a signed zero that stands for every value outside them
constexpr uint32_t kLutLo = (114u << 7) + 1;
constexpr uint32_t kLutSpan = 2047;
constexpr int kLut = 2 * (kLutSpan + 1);
constexpr int kLutBytes = kLut * 2;

typedef __nv_bfloat16 bf16;

// shared memory, in bytes
constexpr int kW0Bytes = 4 * kMid * kIn * 2;     // 131072
constexpr int kW3Bytes = 4 * kOut * kMid * 2;    // 16384
constexpr int kKeyBytes = kTile * kIn * 2;       // 32768 a warpgroup
constexpr int kParBytes = (kMid / 2 + 2 * kMid + kOut / 2) * 4;  // 704
constexpr int kStage = kMasks * kTile * 8;      // logits of a tile's half (one dy), 3 KB
constexpr int kSmem =
    kW0Bytes + kW3Bytes + kGroups * (kKeyBytes + kStage * 2) + kLutBytes + kParBytes;
static_assert(kSmem <= 232448, "fits an H100 block's shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of warpgroup `wg`
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// byte offset of the 16-byte chunk (row, kc) of a K-major operand of `rows`
// rows in wgmma's core-matrix layout without swizzle: 8 rows x 8 k per
// 128-byte core matrix, rows / 8 core matrices down each 8-k column, so the
// leading byte offset (along K) is rows * 16 and the stride byte offset (8
// rows) 128
__device__ __forceinline__ uint32_t cm_off(int row, int kc, int rows) {
  return static_cast<uint32_t>((kc * (rows >> 3) + (row >> 3)) * 128 + (row & 7) * 16);
}

// a [rows][kcs * 8] bf16 operand into the core-matrix layout, row n from row
// src_row(n) of the source; 32 consecutive chunks are 8 rows x 4 chunks, so
// each 8 lanes fill one core matrix and read 8 rows' 64-byte runs
template <typename SrcRow>
__device__ __forceinline__ void stage_operand(uint32_t dst, const bf16* src, int ld, int rows,
                                              int kcs, int first, int step, SrcRow src_row) {
  const int rgs = rows >> 3;
  for (int i = first; i < rows * kcs; i += step) {
    const int r = i & 7, kl = (i >> 3) & 3, rg = (i >> 5) % rgs, kq = (i >> 5) / rgs;
    const int n = rg * 8 + r, kc = kq * 4 + kl;
    cp_async16(dst + cm_off(n, kc, rows), src + static_cast<long long>(src_row(n)) * ld + kc * 8);
  }
}

// shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// wgmma.mma_async m64nNk16 bf16 -> f32, D (+)= A B, B K-major from shared
// memory; A from shared memory (K-major, N = 256) or from registers (N = 64)
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// c += a b on mma.sync: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 in float32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// a + b on two bf16 pairs, each sum rounded once
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

// PyTorch's exact GELU of one bf16 value (its bits), in float32, rounded to bf16
__device__ __forceinline__ uint32_t gelu_exact(uint32_t b) {
  const float x = __uint_as_float(b << 16);
  const bf16 r = __float2bfloat16_rn(x * 0.5f * (1.0f + erff(x * kAlpha)));
  return *reinterpret_cast<const uint16_t*>(&r);
}
// The GELU of each bf16 pair v[i] into o[i], without a branch. The table
// gives gelu_exact's bits for |x| in (2^-13, 8) and a zero of x's sign
// elsewhere; bf16x2 arithmetic, exact on these operands, adds x * (x >= 8)
// (x from 8 up, where erf(x / sqrt 2) is 1 in float32; -0 for x <= -8, -inf
// and NaN give NaN, as in float32) and x / 2 * (|x| <= 2^-13) (there 1 +
// erf(x / sqrt 2) lies within 2^-13 of 1, under half a bf16 step, and x / 2
// is a bf16 value or, for subnormals, rounds as float32's does). Both
// halves' table offsets come from 16 x 2 integer operations on the pair.
template <int N>
__device__ __forceinline__ void gelu_pairs(uint32_t (&o)[N], const uint32_t (&v)[N],
                                           const uint16_t* lut) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(lut);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // per half: |x|'s bits - kLutLo, modulo 2^16, clamped to the zero entry
    uint32_t idx = ((v[i] | 0x80008000u) - kLutLo * 0x10001u) ^ 0x80008000u;
    asm("min.u16x2 %0, %1, %2;" : "=r"(idx) : "r"(idx), "r"(kLutSpan * 0x10001u));
    // byte offsets, the sign bit choosing the half of the table
    const uint32_t off = (idx << 1) | ((v[i] >> 3) & 0x10001000u);
    const uint32_t tab = *reinterpret_cast<const uint16_t*>(base + (off & 0xffffu)) |
                         (static_cast<uint32_t>(
                              *reinterpret_cast<const uint16_t*>(base + (off >> 16))) << 16);
    uint32_t big, tiny, half, r;
    asm("set.ge.bf16x2.bf16x2 %0, %1, %2;" : "=r"(big) : "r"(v[i]), "r"(0x41004100u));
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(big) : "r"(v[i]), "r"(big));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(r) : "r"(tab), "r"(0x3f803f80u), "r"(big));
    asm("set.lt.bf16x2.bf16x2 %0, %1, %2;"
        : "=r"(tiny)
        : "r"(v[i] & 0x7fff7fffu), "r"(kLutLo * 0x10001u));
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(half) : "r"(v[i]), "r"(0x3f003f00u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(o[i]) : "r"(half), "r"(tiny), "r"(r));
  }
}

template <int GRID>
__global__ void __launch_bounds__(kThreads, 1)
    sam_upscale_kernel(const bf16* __restrict__ keys, const bf16* __restrict__ w0,
                       const bf16* __restrict__ b0, const bf16* __restrict__ ln_w,
                       const bf16* __restrict__ ln_b, const bf16* __restrict__ w3,
                       const bf16* __restrict__ b3, const bf16* __restrict__ hyper,
                       bf16* __restrict__ out, int prompts) {
  constexpr int kTokens = GRID * GRID;  // per prompt
  constexpr int kTilesPerPrompt = kTokens / kTile;
  constexpr int kSide = 4 * GRID;  // the logits' side
  constexpr int kPlane = kSide * kSide;
  static_assert(kTokens % kTile == 0 && kTile % GRID == 0, "a tile holds whole grid rows");

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_w0 = smem_addr(smem), s_w3 = s_w0 + kW0Bytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wt = tid & 127, ww = warp & 3;  // warpgroup, its thread and warp
  const uint32_t s_keys = s_w3 + kW3Bytes + wg * kKeyBytes;
  bf16* s_out = reinterpret_cast<bf16*>(smem + kW0Bytes + kW3Bytes + kGroups * kKeyBytes) +
                wg * kStage;
  uint16_t* s_gelu = reinterpret_cast<uint16_t*>(smem + kW0Bytes + kW3Bytes +
                                                 kGroups * (kKeyBytes + kStage * 2));
  // bf16 pairs of b0 and b3, float32 rows of the LayerNorm's affine
  uint32_t* s_b0 =
      reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(s_gelu) + kLutBytes);
  float* s_lnw = reinterpret_cast<float*>(s_b0 + kMid / 2);
  float* s_lnb = s_lnw + kMid;
  uint32_t* s_b3 = reinterpret_cast<uint32_t*>(s_lnb + kMid);
  const int tiles = prompts * kTilesPerPrompt;

  // the weights, rows permuted so that each sub-pixel's channels are
  // contiguous: W0 row s * 64 + c <- (c * 4 + s), W3 row q * 32 + c2 <- (c2 * 4 + q)
  stage_operand(s_w0, w0, kIn, 4 * kMid, kIn / 8, tid, kThreads,
                [](int n) { return (n & (kMid - 1)) * 4 + (n >> 6); });
  stage_operand(s_w3, w3, kMid, 4 * kOut, kMid / 8, tid, kThreads,
                [](int n) { return (n & (kOut - 1)) * 4 + (n >> 5); });
  for (int i = tid; i < kMid / 2; i += kThreads)
    s_b0[i] = reinterpret_cast<const uint32_t*>(b0)[i];
  for (int i = tid; i < kMid; i += kThreads) {
    s_lnw[i] = __bfloat162float(ln_w[i]);
    s_lnb[i] = __bfloat162float(ln_b[i]);
  }
  for (int i = tid; i < kOut / 2; i += kThreads)
    s_b3[i] = reinterpret_cast<const uint32_t*>(b3)[i];
  for (int i = tid; i < kLut; i += kThreads) {
    const uint32_t sign = i >> 11, k = i & 2047;
    s_gelu[i] = k == kLutSpan ? sign << 15 : gelu_exact((sign << 15) | (kLutLo + k));
  }

  auto load_keys = [&](int tile) {
    const int p = tile / kTilesPerPrompt, tl = tile % kTilesPerPrompt;
    const bf16* src = keys + (static_cast<long long>(p) * kTokens + tl * kTile) * kIn;
    stage_operand(s_keys, src, kIn, kTile, kIn / 8, wt, 128, [](int n) { return n; });
  };
  const int stride = gridDim.x * kGroups;
  int tile = blockIdx.x * kGroups + wg;
  if (tile < tiles) load_keys(tile);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  for (; tile < tiles; tile += stride) {
    const int p = tile / kTilesPerPrompt, tl = tile % kTilesPerPrompt;
    // B of the third product: hyper[p, n, k] at (k, n), n = g < 3, zero elsewhere
    uint32_t hb[2][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        hb[kk][half] = g < kMasks ? *reinterpret_cast<const uint32_t*>(
                                        hyper + (p * kMasks + g) * kOut + kk * 16 + half * 8 +
                                        2 * t)
                                  : 0u;

    // the first product: the tile's 64 tokens x 256 outputs (4 sub-pixels x
    // 64 channels), K = 256; the thread holds rows ww * 16 + g (+ 8)
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kIn / 16; ++ks)
      wgmma(acc, make_desc(s_keys + ks * 2 * kTile * 16, kTile * 16, 128),
            make_desc(s_w0 + ks * 2 * 4 * kMid * 16, 4 * kMid * 16, 128), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    group_sync(wg);  // every warp's product has read the keys: the next tile's copy
    if (tile + stride < tiles) load_keys(tile + stride);
    cp_async_commit();

    // bias, LayerNorm over each sub-pixel's 64 channels (one quad), affine,
    // GELU; packed as the A fragments of the second product: z[s][nt][h]
    // holds row g + 8 h, channels nt * 8 + 2 t and + 1 of sub-pixel s
    uint32_t z[4][8][2];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[8][2];
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int j = (s * 8 + nt) * 4 + 2 * h;
          const uint32_t y = add_bf16x2(pack_bf16(acc[j], acc[j + 1]), s_b0[nt * 4 + t]);
          v[nt][0] = lo_f(y);
          v[nt][1] = hi_f(y);
          sum += v[nt][0] + v[nt][1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float mean = sum * (1.0f / kMid);
        float sq = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = v[nt][e] - mean;
            sq += d * d;
          }
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        const float rstd = rsqrtf(sq * (1.0f / kMid) + kEps);
        uint32_t pre[8], post[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nt * 8 + 2 * t;
          const float2 w = *reinterpret_cast<const float2*>(s_lnw + c);
          const float2 b = *reinterpret_cast<const float2*>(s_lnb + c);
          pre[nt] = pack_bf16(w.x * (rstd * (v[nt][0] - mean)) + b.x,
                              w.y * (rstd * (v[nt][1] - mean)) + b.y);
        }
        gelu_pairs(post, pre, s_gelu);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) z[s][nt][h] = post[nt];
      }

    // per sub-pixel s = (dy, dx): the second product, 64 tokens x 128
    // outputs (4 sub-pixels q = (ey, ex) x 32 channels), K = 64, in two
    // halves (ey = 0, 1) so that the second runs during the first's epilogue
    bf16* dst = out + static_cast<long long>(p) * kMasks * kPlane;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float acc2[2][32];
#pragma unroll
      for (int ey = 0; ey < 2; ++ey) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc2[ey][i] = 0.f;
        fence_regs(acc2[ey]);
      }
      wgmma_fence();
#pragma unroll
      for (int ey = 0; ey < 2; ++ey) {
#pragma unroll
        for (int kk = 0; kk < kMid / 16; ++kk) {
          const uint32_t a[4] = {z[s][2 * kk][0], z[s][2 * kk][1], z[s][2 * kk + 1][0],
                                 z[s][2 * kk + 1][1]};
          wgmma(acc2[ey], a,
                make_desc(s_w3 + ey * 64 * 16 + kk * 2 * 4 * kOut * 16, 4 * kOut * 16, 128), 1);
        }
        wgmma_commit();
      }
#pragma unroll
      for (int ey = 0; ey < 2; ++ey) {
        if (ey == 0) wgmma_wait1(); else wgmma_wait0();
        fence_regs(acc2[ey]);
        float acc3[2][4] = {};  // [ex]
#pragma unroll
        for (int ex = 0; ex < 2; ++ex) {
          // bias and GELU, packed as the A fragments of the third product
          uint32_t pre[8], u[8];  // [nt * 2 + h]
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = (ex * 4 + nt) * 4 + 2 * h;
              pre[nt * 2 + h] =
                  add_bf16x2(pack_bf16(acc2[ey][j], acc2[ey][j + 1]), s_b3[nt * 4 + t]);
            }
          gelu_pairs(u, pre, s_gelu);
#pragma unroll
          for (int kk = 0; kk < kOut / 16; ++kk) {
            const uint32_t a[4] = {u[4 * kk], u[4 * kk + 1], u[4 * kk + 2], u[4 * kk + 3]};
            mma(acc3[ex], a, hb[kk][0], hb[kk][1]);
          }
        }
        // the thread holds masks 2 t + e of rows g + 8 h: two neighbouring
        // logits of one output row into the half tile's staging area,
        // [mask][grid row][ey][4 G]
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (2 * t + e < kMasks) {
              const int tok = ww * 16 + g + 8 * h;  // in the tile
              *reinterpret_cast<uint32_t*>(s_out + (2 * t + e) * (kTile * 8) +
                                           ((tok / GRID) * 2 + ey) * kSide + 4 * (tok % GRID) +
                                           2 * (s & 1)) =
                  pack_bf16(acc3[0][2 * h + e], acc3[1][2 * h + e]);
            }
      }
      if (s & 1) {
        // both sub-pixels of this dy are staged: out as 16-byte vectors, runs
        // of 4 G logits on rows 4 i + 2 dy + ey
        group_sync(wg);
        for (int i = wt; i < kStage / 8; i += 128) {
          const int m = i / (kTile * 8 / 8), el = (i % (kTile * 8 / 8)) * 8;
          const int lr = el / kSide;  // (grid row in the tile) * 2 + ey
          const int row = 4 * (tl * (kTile / GRID) + (lr >> 1)) + 2 * (s >> 1) + (lr & 1);
          *reinterpret_cast<uint4*>(dst + static_cast<long long>(m) * kPlane + row * kSide +
                                    el % kSide) =
              *reinterpret_cast<const uint4*>(s_out + m * (kTile * 8) + el);
        }
        if (s == 1) group_sync(wg);  // read: the next dy may stage
      }
    }
    cp_async_wait_all();
    fence_proxy_async();
    group_sync(wg);  // the next tile's keys are in
  }
}

template <int GRID>
int launch(const bf16* keys, const bf16* w0, const bf16* b0, const bf16* ln_w, const bf16* ln_b,
           const bf16* w3, const bf16* b3, const bf16* hyper, bf16* out, int prompts,
           cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sam_upscale_kernel<GRID>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = prompts * (GRID * GRID / kTile);
  const int wanted = (tiles + kGroups - 1) / kGroups;
  const int blocks = wanted < sms ? wanted : sms;
  sam_upscale_kernel<GRID><<<blocks, kThreads, kSmem, stream>>>(keys, w0, b0, ln_w, ln_b, w3, b3,
                                                                 hyper, out, prompts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys (P, G^2, 256) bf16, the two-way transformer's image side; w0 (256, 256)
// [c * 4 + s][in] and b0 (64) the first ConvT as `decode` holds it; ln_w, ln_b
// (64) the LayerNorm2d; w3 (128, 64) [c2 * 4 + q][in] and b3 (32) the second
// ConvT; hyper (P, 3, 32) the hypernetwork rows of mask tokens 1-3; out
// (P, 3, 4 G, 4 G) bf16. G 64 (SAM's) or 16. Every pointer 16-byte aligned,
// every tensor contiguous. Returns a cudaError_t code.
extern "C" int amt_sam_upscale(const void* keys, const void* w0, const void* b0, const void* ln_w,
                               const void* ln_b, const void* w3, const void* b3,
                               const void* hyper, void* out, int prompts, int grid,
                               void* stream) {
  if (prompts <= 0 || static_cast<long long>(prompts) * grid * grid >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* k = static_cast<const bf16*>(keys);
  const bf16* a = static_cast<const bf16*>(w0);
  const bf16* ab = static_cast<const bf16*>(b0);
  const bf16* lw = static_cast<const bf16*>(ln_w);
  const bf16* lb = static_cast<const bf16*>(ln_b);
  const bf16* c = static_cast<const bf16*>(w3);
  const bf16* cb = static_cast<const bf16*>(b3);
  const bf16* h = static_cast<const bf16*>(hyper);
  bf16* o = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (grid) {
    case 16:
      return launch<16>(k, a, ab, lw, lb, c, cb, h, o, prompts, st);
    case 64:
      return launch<64>(k, a, ab, lw, lb, c, cb, h, o, prompts, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
