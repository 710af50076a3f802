// Fused SAME 3x3 convolution for Hopper (sm_90a), NHWC, bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel arcadia_microscopy_tools_tpu/models/conv_pallas.py:129
// (`_kernel`, wrapper `conv3x3_fused` :336). One launch computes
//
//   y = bf16( conv3x3( prologue(x), w ) + accum )        (f32 accumulation)
//   prologue(x) = bf16( max(x * scale[b,c] + bias[b,c], 0) )   (optional; ReLU optional)
//   moments: per (b, co) partial sums of y and y^2 over a tile's pixels, taken of
//            the bf16-rounded output and accumulated in f32
//
// Bound (at the U-Net's shapes, 8 images): a call moves x, w, accum and y once
// and does 2 * 9 * C * Co FLOP per output pixel. At 32 -> 32 channels the
// intensity is 144 FLOP/byte, below the H100's ~295 (989 TFLOP/s bf16 over
// 3.35 TB/s), so the full-resolution 32-channel calls are bound by bytes; at 64
// channels both bounds are close; the 128- and 256-channel levels are bound by
// the tensor cores. The 16 calls of one 2048^2 x 8 forward have a bound of
// ~14.8 ms, the sum over calls of max(bytes, FLOP).
//
// Design: an implicit GEMM on wgmma (m64nNk16, bf16 -> f32, N = 32..256).
// - Tile: 64 consecutive output pixels of a row are the M of one wgmma; a CTA
//   of two warpgroups covers TH = 512 / N output rows (each warpgroup RW = TH/2
//   rows, so every thread holds 128 f32 accumulators) and N output channels,
//   which is all of Co at every U-Net level: each input element is staged
//   once per output tile for all Co (only Co > 256 or Co not a power-of-two
//   multiple of 32 splits into N blocks and restages).
// - K = 9 taps x C is walked in chunks of 16 input channels. A chunk is the
//   (TH + 2) x 66 input slab and the chunk's 9 x N x 16 weights. Both sit in
//   the no-swizzle core-matrix layout: 8 consecutive pixels (or output
//   channels) x 8 channels per 128-byte core matrix, the two 8-channel halves
//   one LBO apart (a slab half, rounded up to 128 bytes; for the weights
//   9 x N x 16 bytes). Tap (dy, dx) of output row r is then
//   the same descriptor started at slab pixel (r + dy) * 66 + dx: a one-pixel
//   shift is a 16-byte move of the start address, so the slab is staged once
//   and never re-laid out per tap.
// - Copies overlap the maths: a ring of 2-6 stages (as many as fit in 227 KB)
//   is filled by TMA, STAGES - 1 chunks ahead of the one the tensor cores
//   read: one thread issues four box copies per chunk (the two 8-channel
//   halves of the slab, whose pixels outside the image TMA fills with zeros,
//   and of the weights) onto the stage's mbarrier. CTAs are persistent, one
//   per SM, and walk tiles in a grid-stride loop; the ring runs on across
//   tile boundaries, so the next tile's copies are in flight during a tile's
//   epilogue. (Per-thread cp.async copies, tried first, could not keep the
//   tensor cores fed; two CTAs per SM with half the accumulators were slower
//   at 64 and 128 channels.)
// - Prologue: a pass over the landed slab chunk (f32 affine with
//   __fmul_rn/__fadd_rn, optional ReLU, one rounding to bf16) on in-image
//   pixels only, done for chunk i + 1 while the tensor cores run chunk i;
//   halo pixels outside the image stay 0 (affine(0) != 0, so zero padding has
//   to come after the prologue). A proxy fence makes the pass's stores
//   visible to wgmma.
// - Epilogue: adds `accum` in f32 before the one rounding to bf16, stores
//   (16-byte accesses after a transpose within each lane quad), and
//   writes per-tile moment partials to part[b][tile][2][Co]: shuffles over the
//   warp's rows, then warps 0..7 in turn through shared memory, never float
//   atomics, so every launch gives the same bits; the caller sums the partials
//   over tiles in a fixed order too. (The TPU kernel carried the moments across
//   its sequential grid; Hopper's CTAs run in parallel, hence the partials.)
//   Below N = 256 the output tile is staged in shared memory: the tile's
//   accum, if any, comes by TMA while the tile's products run, y is written
//   over it, and one TMA store, which drops what lies outside the image,
//   overlaps the next tile. At N = 256 the two-stage ring leaves no room for
//   it, and the epilogue stores to global memory directly.
// - Halo rows: for one row slab of an image whose slabs lie on several ranks,
//   x may hold one real row of the neighbouring slab above (top = 1) and below
//   (bottom = 1) the H output rows. The slab and its tiles are then addressed
//   in x's rows shifted by `top`; halo rows are image pixels, so the prologue
//   applies to them, and only rows past them are the image's zero padding. The
//   tile grid, y, accum and the moment partials cover the H output rows alone,
//   so for a slab that starts on a multiple of the tile height its partials are
//   the whole image's partials of those tiles, with the same bits.
// C and Co are multiples of 32 (the wrapper checks); ragged H and W are masked
// here. Times against the bound and against cuDNN stand in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kTW = 64;         // output columns per tile: the M of one wgmma
constexpr int kSW = kTW + 2;    // slab pixels per row
constexpr int kKC = 16;         // input channels per K chunk: one k16 step per tap
constexpr int kSmemBudget = 232448;  // 227 KB, the most a block may opt in to

// Output rows per tile for N output channels per CTA: two warpgroups of
// 256 / N rows each, so that every thread holds 128 f32 accumulators.
__host__ __device__ constexpr int tile_h(int N) { return 512 / N; }

template <int N>
struct Cfg {
  static constexpr int TH = tile_h(N);          // output rows per tile
  static constexpr int RW = TH / 2;             // output rows per warpgroup
  static constexpr int NPIX = (TH + 2) * kSW;   // slab pixels
  static constexpr int KS = (NPIX * 16 + 127) / 128 * 128;  // one 8-channel half of the slab
  static constexpr int WK = 9 * N * 16;         // one 8-channel half of the weights
  static constexpr int STAGE = 2 * KS + 2 * WK; // [slab half 0][slab half 1][weights 0][weights 1]
  static constexpr int TX = 2 * NPIX * 16 + 2 * WK;  // bytes the four copies of a chunk land
  static constexpr int RED = 8 * 2 * N * 4;     // per-warp moment partials
  // the output tile [TH][64][N] bf16 staged for a TMA store and `accum`'s TMA
  // load (never at N = 256, whose two-stage ring leaves no room for it)
  static constexpr bool SO = N < 256;
  static constexpr int OUT = SO ? TH * kTW * N * 2 : 0;
  static constexpr int FIT = (kSmemBudget - RED - OUT - 256) / STAGE;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int SMEM = STAGES * STAGE + OUT + RED + 128;  // + alignment slack
  static_assert(STAGES >= 2, "the ring needs two stages");
};

struct ConvArgs {
  const __nv_bfloat16* x;      // (B, Hx, W, C): H output rows and top + bottom halo rows
  const __nv_bfloat16* w;      // (9, Co, C): tap-major, then output channel
  const float* scale;          // (B, C) or null: prologue
  const float* bias;           // (B, C) or null
  const __nv_bfloat16* accum;  // (B, H, W, Co) or null
  __nv_bfloat16* y;            // (B, H, W, Co)
  float* part;                 // (B, tiles, 2, Co) or null: moment partials
  int B, H, W, C, Co, ntx, tiles, total, relu;
  int Hx, top;                 // rows of x; halo rows above the first output row (0 or 1)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// TMA tile copies, global -> shared, completing on an mbarrier; coordinates
// innermost first; boxes that reach outside the tensor are zero-filled.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// The thread's earlier TMA stores have read their shared memory / are done.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 4 x 4 transpose of 32-bit words across the 4 lanes of a quad (lanes with
// equal lane / 4): lane q's w[k] goes to lane k's w[q]. The wgmma fragment
// holds channel pairs (8 k + 2 q, + 1) of n8 block k; after the transpose a
// lane holds the 8 consecutive channels of block q, one 16-byte access.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4], int q) {
  uint32_t u[4];
  u[0] = w[0], u[1] = w[1], u[2] = w[2], u[3] = w[3];
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const int k = q ^ r;  // the partner lane, and the slot exchanged with it
    const uint32_t send = k == 0 ? w[0] : k == 1 ? w[1] : k == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, r);
    if (k == 0) u[0] = got;
    if (k == 1) u[1] = got;
    if (k == 2) u[2] = got;
    if (k == 3) u[3] = got;
  }
  w[0] = u[0], w[1] = u[1], w[2] = u[2], w[3] = u[3];
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between the two 8-channel core matrices along K) and stride byte
// offset (between 8-row core matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// wgmma.mma_async m64nNk16 bf16 -> f32, A and B K-major from shared memory,
// D += A * B; one overload per N (d holds N / 2 accumulators a thread).
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

struct Tile {
  int b, y0, x0, n0, sp;
};

template <int N>
__device__ __forceinline__ Tile tile_of(const ConvArgs& a, int i, int nchunks) {
  const int t = blockIdx.x + (i / nchunks) * gridDim.x;
  Tile r;
  r.sp = t % a.tiles;  // spatial tile within the image
  const int bn = t / a.tiles;
  r.b = bn % a.B;
  r.n0 = (bn / a.B) * N;
  r.y0 = (r.sp / a.ntx) * tile_h(N);
  r.x0 = (r.sp % a.ntx) * kTW;
  return r;
}

// Issue the TMA copies of iteration i (tile, channel chunk) into its ring
// stage, on the stage's mbarrier (one thread): the two 8-channel halves of
// the (TH + 2) x 66 slab (x's rows, shifted by the halo above the output),
// whose pixels outside x TMA fills with zeros, and
// the two halves of the chunk's 9 x N weights.
template <int N, class K>
__device__ __forceinline__ void issue_chunk(const ConvArgs& a, const CUtensorMap* tmx,
                                            const CUtensorMap* tmw, int i, int nchunks,
                                            uint32_t sbase, uint32_t bars) {
  const Tile t = tile_of<N>(a, i, nchunks);
  const int c0 = (i % nchunks) * kKC;
  const int s = i % K::STAGES;
  const uint32_t st = sbase + s * K::STAGE, bar = bars + s * 8;
  mbar_expect_tx(bar, K::TX);
#pragma unroll
  for (int kg = 0; kg < 2; ++kg) {
    tma_load_4d(st + kg * K::KS, tmx, bar, c0 + 8 * kg, t.x0 - 1, t.y0 - 1 + a.top, t.b);
    tma_load_3d(st + 2 * K::KS + kg * K::WK, tmw, bar, c0 + 8 * kg, t.n0, 0);
  }
}

// The prologue over the landed slab chunk of iteration i, in place. Each
// thread touches one 8-channel half (v & 1 is fixed by the stride); pixels
// outside x (the image's zero padding) stay 0, halo rows are x's and take it.
template <int N, class K>
__device__ __forceinline__ void prologue_pass(const ConvArgs& a, int i, int nchunks,
                                              unsigned char* smem) {
  const Tile t = tile_of<N>(a, i, nchunks);
  unsigned char* st = smem + (i % K::STAGES) * K::STAGE;
  const int kg = threadIdx.x & 1;
  const int c = (i % nchunks) * kKC + kg * 8;
  float sc[8], bi[8];
  const float4* s4 = reinterpret_cast<const float4*>(a.scale + (size_t)t.b * a.C + c);
  const float4* b4 = reinterpret_cast<const float4*>(a.bias + (size_t)t.b * a.C + c);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 u = __ldg(s4 + j), v = __ldg(b4 + j);
    sc[4 * j] = u.x, sc[4 * j + 1] = u.y, sc[4 * j + 2] = u.z, sc[4 * j + 3] = u.w;
    bi[4 * j] = v.x, bi[4 * j + 1] = v.y, bi[4 * j + 2] = v.z, bi[4 * j + 3] = v.w;
  }
  for (int v = threadIdx.x; v < K::NPIX * 2; v += kThreads) {
    const int pix = v >> 1;
    const int gy = t.y0 - 1 + a.top + pix / kSW, gx = t.x0 - 1 + pix % kSW;  // in x's rows
    if (gy < 0 || gy >= a.Hx || gx < 0 || gx >= a.W) continue;  // stays 0
    uint4* p = reinterpret_cast<uint4*>(st + kg * K::KS + pix * 16);
    uint4 val = *p;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __fadd_rn(__fmul_rn(__bfloat162float(e[j]), sc[j]), bi[j]);
      if (a.relu) f = fmaxf(f, 0.f);
      e[j] = __float2bfloat16_rn(f);
    }
    *p = val;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const ConvArgs a, const __grid_constant__ CUtensorMap tmx,
                   const __grid_constant__ CUtensorMap tmw, const __grid_constant__ CUtensorMap tmy,
                   const __grid_constant__ CUtensorMap tmacc) {
  using K = Cfg<N>;
  constexpr int RW = K::RW, STAGES = K::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];  // chunk landed, one per ring stage
  __shared__ __align__(8) uint64_t acc_full;       // the tile's accum landed
  // stages 128-byte aligned for TMA
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + (((raw + 127) & ~127u) - raw);
  unsigned char* out = smem + STAGES * K::STAGE;                       // [TH][64][N] bf16
  float* red = reinterpret_cast<float*>(out + K::OUT);                  // [8 warps][2][N]
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t bars = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t acc_bar = static_cast<uint32_t>(__cvta_generic_to_shared(&acc_full));
  const uint32_t out_s = sbase + STAGES * K::STAGE;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;            // warpgroup: output rows wg * RW .. + RW - 1
  const int warp = tid >> 5;          // 0..7
  const int wrow = (tid & 127) >> 5;  // warp within the warpgroup: M rows 16 * wrow ..
  const int lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nchunks = a.C / kKC;
  const int my_tiles = a.total > (int)blockIdx.x ? (a.total - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int iters = my_tiles * nchunks;

  float acc[RW][N / 2];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[r][j] = 0.f;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + s * 8, 1);
    mbar_init(acc_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < STAGES - 1 && s < iters; ++s)
      issue_chunk<N, K>(a, &tmx, &tmw, s, nchunks, sbase, bars);
  if (iters > 0 && a.scale != nullptr) {
    mbar_wait(bars, 0);  // chunk 0 has landed
    prologue_pass<N, K>(a, 0, nchunks, smem);
  }

#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    fence_proxy_async();  // the prologue's generic-proxy stores -> the tensor cores' reads
    __syncthreads();      // chunk i's prologue done; all are past chunk i - 1's products
    // the stage chunk i - 1 used is free: copies of chunk i + STAGES - 1 into it
    if (tid == 0 && i + STAGES - 1 < iters)
      issue_chunk<N, K>(a, &tmx, &tmw, i + STAGES - 1, nchunks, sbase, bars);
    if (K::SO && a.accum != nullptr && tid == 0 && i % nchunks == 0) {
      // the tile's accum into the output buffer, once the last tile's store has read it
      const Tile t = tile_of<N>(a, i, nchunks);
      tma_store_wait_read();
      mbar_expect_tx(acc_bar, K::OUT);
      tma_load_4d(out_s, &tmacc, acc_bar, t.n0, t.x0, t.y0, t.b);
    }
    mbar_wait(bars + (i % STAGES) * 8, (i / STAGES) & 1);  // chunk i has landed

    const uint32_t st = sbase + (i % STAGES) * K::STAGE;
#pragma unroll
    for (int r = 0; r < RW; ++r) fence_regs(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t db = make_desc(st + 2 * K::KS + tap * N * 16, K::WK, 128);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int pix = (wg * RW + r + dy) * kSW + dx;
        wgmma(acc[r], make_desc(st + pix * 16, K::KS, 128), db);
      }
    }
    wgmma_commit();

    // while the tensor cores run: the prologue of chunk i + 1
    if (i + 1 < iters && a.scale != nullptr) {
      mbar_wait(bars + ((i + 1) % STAGES) * 8, ((i + 1) / STAGES) & 1);
      prologue_pass<N, K>(a, i + 1, nchunks, smem);
    }

    wgmma_wait0();
#pragma unroll
    for (int r = 0; r < RW; ++r) fence_regs(acc[r]);

    if (i % nchunks == nchunks - 1) {
      // epilogue: + accum, one rounding to bf16, store, moments of the stored
      // values; n8 blocks in groups of 4, moved as 16-byte words through a
      // quad transpose (each lane loads and stores 8 consecutive channels).
      // Below N = 256 accum and y go through the output buffer and TMA, and
      // the store overlaps the next tile's products.
      const Tile t = tile_of<N>(a, i, nchunks);
      const bool mom = a.part != nullptr;
      if (K::SO) {
        if (a.accum != nullptr) {
          mbar_wait(acc_bar, (i / nchunks) & 1);
        } else {
          if (tid == 0) tma_store_wait_read();  // the last tile's store has read the buffer
          __syncthreads();
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < N / 8; j0 += 4) {
        float s1[4][2], s2[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s1[jj][0] = s1[jj][1] = s2[jj][0] = s2[jj][1] = 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int gy = t.y0 + wg * RW + r;
          uint32_t av[2][4];
          uint4* yp[2];  // this lane's 8 channels of pixel (gy, gx): output buffer or y
          const uint4* ap[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 16 * wrow + g + 8 * h, gx = t.x0 + m;
            const bool in = gy < a.H && gx < a.W;
            if (K::SO) {
              yp[h] = reinterpret_cast<uint4*>(out + (((wg * RW + r) * kTW + m) * N + 8 * (j0 + q)) * 2);
              ap[h] = yp[h];
            } else {
              const size_t off = (((size_t)t.b * a.H + gy) * a.W + gx) * a.Co + t.n0 + 8 * (j0 + q);
              yp[h] = reinterpret_cast<uint4*>(a.y + off);
              ap[h] = reinterpret_cast<const uint4*>(a.accum + off);
            }
            av[h][0] = av[h][1] = av[h][2] = av[h][3] = 0u;
            if (a.accum != nullptr && (K::SO || in)) {
              const uint4 v = *ap[h];
              av[h][0] = v.x, av[h][1] = v.y, av[h][2] = v.z, av[h][3] = v.w;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gx = t.x0 + 16 * wrow + g + 8 * h;
            const bool in = gy < a.H && gx < a.W;
            if (a.accum != nullptr) quad_transpose(av[h], q);  // back to fragment pairs
            uint32_t o[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float v0 = acc[r][4 * (j0 + jj) + 2 * h];
              float v1 = acc[r][4 * (j0 + jj) + 2 * h + 1];
              if (a.accum != nullptr) {
                __nv_bfloat162 ab;
                *reinterpret_cast<uint32_t*>(&ab) = av[h][jj];
                v0 = __fadd_rn(v0, __low2float(ab));
                v1 = __fadd_rn(v1, __high2float(ab));
              }
              const __nv_bfloat162 ob = __floats2bfloat162_rn(v0, v1);
              o[jj] = *reinterpret_cast<const uint32_t*>(&ob);
              if (in) {
                const float f0 = __low2float(ob), f1 = __high2float(ob);
                s1[jj][0] = __fadd_rn(s1[jj][0], f0);
                s1[jj][1] = __fadd_rn(s1[jj][1], f1);
                s2[jj][0] = __fadd_rn(s2[jj][0], __fmul_rn(f0, f0));
                s2[jj][1] = __fadd_rn(s2[jj][1], __fmul_rn(f1, f1));
              }
            }
            quad_transpose(o, q);
            if (K::SO || in) *yp[h] = make_uint4(o[0], o[1], o[2], o[3]);
          }
        }
        if (mom) {
          // over the warp's 8 row groups (lanes with equal q), fixed order
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int m = 4; m < 32; m <<= 1)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                s1[jj][e] = __fadd_rn(s1[jj][e], __shfl_xor_sync(0xffffffffu, s1[jj][e], m));
                s2[jj][e] = __fadd_rn(s2[jj][e], __shfl_xor_sync(0xffffffffu, s2[jj][e], m));
              }
            if (g == 0) {
              const int n = 8 * (j0 + jj) + 2 * q;
              red[(warp * 2 + 0) * N + n] = s1[jj][0];
              red[(warp * 2 + 0) * N + n + 1] = s1[jj][1];
              red[(warp * 2 + 1) * N + n] = s2[jj][0];
              red[(warp * 2 + 1) * N + n + 1] = s2[jj][1];
            }
          }
        }
      }
      if (K::SO) {  // TMA drops the parts of the box outside the image
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) tma_store_4d(&tmy, out_s, t.n0, t.x0, t.y0, t.b);
      }
      if (mom) {
        __syncthreads();
        for (int v = tid; v < 2 * N; v += kThreads) {
          const int which = v / N, n = v % N;  // which 0: sum, 1: sum of squares
          float s = 0.f;
#pragma unroll
          for (int wi = 0; wi < 8; ++wi) s = __fadd_rn(s, red[(wi * 2 + which) * N + n]);
          a.part[(((size_t)t.b * a.tiles + t.sp) * 2 + which) * a.Co + t.n0 + n] = s;
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int j = 0; j < N / 2; ++j) acc[r][j] = 0.f;
    }
  }
  if (tid == 0) tma_store_wait_all();
}

// Output channels per CTA: the widest wgmma N that divides Co.
inline int n_block(int Co) {
  return Co % 256 == 0 ? 256 : Co % 128 == 0 ? 128 : Co % 64 == 0 ? 64 : 32;
}

inline int tile_rows(int Co) { return tile_h(n_block(Co)); }

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library links against no libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first) with one box per copy.
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch(ConvArgs args, cudaStream_t stream) {
  using K = Cfg<N>;
  CUtensorMap tmx, tmw;  // input slab and weights
  const cuuint64_t xdims[4] = {(cuuint64_t)args.C, (cuuint64_t)args.W, (cuuint64_t)args.Hx,
                               (cuuint64_t)args.B};
  const cuuint32_t xbox[4] = {8, kSW, K::TH + 2, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)args.C, (cuuint64_t)args.Co, 9};
  const cuuint32_t wbox[3] = {8, N, 9};
  const cuuint64_t ydims[4] = {(cuuint64_t)args.Co, (cuuint64_t)args.W, (cuuint64_t)args.H,
                               (cuuint64_t)args.B};
  const cuuint32_t ybox[4] = {N, kTW, K::TH, 1};
  CUtensorMap tmy, tmacc;
  if (!make_map(&tmx, args.x, 4, xdims, xbox) || !make_map(&tmw, args.w, 3, wdims, wbox) ||
      !make_map(&tmy, args.y, 4, ydims, ybox) ||
      !make_map(&tmacc, args.accum != nullptr ? args.accum : args.y, 4, ydims, ybox))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv3x3_kernel<N>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, K::SMEM)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  args.total = args.tiles * args.B * (args.Co / N);
  const int grid = args.total < sms * per_sm ? args.total : sms * per_sm;
  kernel<<<grid, kThreads, K::SMEM, stream>>>(args, tmx, tmw, tmy, tmacc);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 (B, top + H + bottom, W, C), top and bottom 0 or 1 halo rows of a
// row slab; w: bf16 (9, Co, C); scale, bias: f32 (B, C) or null; accum: bf16
// (B, H, W, Co) or null; y: bf16 (B, H, W, Co); part: f32 (B, tiles, 2, Co) or
// null, tiles = amt_conv3x3_tiles(H, W, Co). C and Co are multiples of 32.
// Returns a cudaError_t code.
extern "C" int amt_conv3x3_fused(const void* x, const void* w, const void* scale, const void* bias,
                                 const void* accum, void* y, void* part, int B, int H, int W,
                                 int C, int Co, int relu, int top, int bottom, void* stream) {
  ConvArgs args;
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.w = static_cast<const __nv_bfloat16*>(w);
  args.scale = static_cast<const float*>(scale);
  args.bias = static_cast<const float*>(bias);
  args.accum = static_cast<const __nv_bfloat16*>(accum);
  args.y = static_cast<__nv_bfloat16*>(y);
  args.part = static_cast<float*>(part);
  args.B = B;
  args.H = H;
  args.W = W;
  args.C = C;
  args.Co = Co;
  args.ntx = (W + kTW - 1) / kTW;
  args.tiles = args.ntx * ((H + tile_rows(Co) - 1) / tile_rows(Co));
  args.total = 0;
  args.relu = relu;
  args.Hx = H + top + bottom;
  args.top = top;
  if (C % 32 != 0 || Co % 32 != 0) return (int)cudaErrorInvalidValue;
  if (top < 0 || top > 1 || bottom < 0 || bottom > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_block(Co)) {
    case 256: return launch<256>(args, s);
    case 128: return launch<128>(args, s);
    case 64: return launch<64>(args, s);
    default: return launch<32>(args, s);
  }
}

// Spatial tiles per image, the second axis of `part` (the tile height depends
// on the output channel block).
extern "C" int amt_conv3x3_tiles(int H, int W, int Co) {
  return ((W + kTW - 1) / kTW) * ((H + tile_rows(Co) - 1) / tile_rows(Co));
}
