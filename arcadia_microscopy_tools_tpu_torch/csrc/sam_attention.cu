// Attention with SAM's decomposed relative-position bias for Hopper
// (sm_90a): kernel 8.
//
// Replaces no TPU kernel: the JAX package runs no vision transformer. It is
// the attention of one block of a SAM ViT encoder (models/vit_sam.py),
// every tile, window and head of a micro-batch in one launch. Two kernels:
// `sam_attention_kernel<GRID, TAB>`, global attention over a GRID x GRID
// token map (8, 16 and 32 for Cellpose-SAM's tiles, 64 for SAM's global
// blocks at 1024^2, whose stored 127-row tables are staged in TAB = 128
// rows), and `sam_window_kernel<WIN>`, attention inside each WIN x WIN
// window of SAM's windowed blocks (14: 196 tokens, which neither a step of
// 64 keys nor a block of 64 queries divides).
// For query i = (iy, ix) and key j = (jy, jx) of a GRID x GRID token map
//
//   S[i, j] = (q_i / sqrt(d)) . k_j + q_i . Rh[iy - jy + GRID - 1]
//                                   + q_i . Rw[ix - jx + GRID - 1],
//
// then a softmax over j and P V. The bias cannot go to a library attention,
// and materialised it is (N, GRID^2, GRID^2): 32 MiB of bfloat16 per tile
// and block at the published sizes, ~600 GiB of traffic per call of 8
// images. q, k and v are read where the block's qkv Linear put them, a
// bfloat16 (T, GRID^2, 3 W) tensor, and o is written as (T, GRID^2, W),
// heads side by side, the layout the proj Linear reads.
//
// Design: a flash-attention forward on mma.sync (m16n8k16, bfloat16 in,
// float32 accumulation). A block of kWarps = 4 warps takes 64 queries of one
// (tile, head); each warp owns 16 of them. Before the key loop the block
// stages Q and the two (2 GRID - 1, 64) tables (zero rows up to TAB) in
// shared memory and each warp computes Q Rh^T and Q Rw^T for its rows on the
// tensor cores: two products as large as one step of the loop. Q Rw^T is
// then gathered, through shared memory, into the registers of the threads
// that hold each score: a key's column jx repeats in every block of 64 keys
// (whole rows of the grid), so each thread needs the same 2 x 16 terms in
// every step. Q Rh^T stays in shared memory (its rows XOR-swizzled so the
// eight rows of a warp read eight banks) and each step reads the 2 x 64 /
// GRID terms of its key rows. Keys and values come 64 at a time through a
// two-stage cp.async ring of 128-byte rows, 16-byte chunks XOR-swizzled by
// row so that ldmatrix reads without bank conflicts. Eight warps a block
// were 16% slower on an H100; 168-172 registers a thread leave two blocks
// an SM, and bounding them for three gained under 1% beside the fast exp2. Scores, the bias and
// the online softmax are float32 in log2 units; P is rounded to bfloat16
// for P V (as a bfloat16 attention does). Neither the bias nor S leaves the
// chip.
//
// Bound: operations. Per tile and block at the published sizes (16 heads,
// 1024 tokens, d = 64) Q K^T and P V are 4.295 GFLOP and the two table
// products 0.134, 4.478 us at the bf16 peak, against 8.4 MB of q, k, v and
// o, 2.51 us at 3.35 TB/s (`benchmark/sam_arithmetic.py` counts both).
// mma.sync reaches about two thirds of the peak that wgmma does; blocks of
// one (tile, head) are neighbours in the grid, so their keys and values come
// from the L2 cache. At SAM's 64 x 64 grid (4096 tokens) a global block's
// attention is 69.8 GFLOP per image, 70.6 us at the peak; a windowed
// block's 25 windows of 196 tokens 4.2 GFLOP, of which the window kernel's
// blocks of 64 queries and steps of 64 keys compute 256^2 / 196^2 = 1.7
// times. The plain version (`sam_attention.sam_attention_plain`)
// materialises the bias in float32; `chip_smoke.py` holds the kernel to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHead = 64;    // head size d
constexpr int kBlockN = 64;  // keys per step
constexpr int kWarps = 4;    // warps a block, 16 queries each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row, col) in a [rows][64] bfloat16 tile whose 16-byte
// chunks are XOR-swizzled by the row
__device__ __forceinline__ int swz(int row, int col) {
  return row * kHead + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// offset of (row, col) in a [rows][TAB] float32 table whose columns are
// XOR-swizzled by the row's low three bits
template <int TAB>
__device__ __forceinline__ int fswz(int row, int col) { return row * TAB + (col ^ (row & 7)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 in float32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (relative error ~2^-22; 2^-inf = 0):
// 6.5% off a micro-batch against exp2f on an H100
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, rows) of a [.][64] bfloat16 matrix with row stride `ld` into a
// swizzled tile, 16 bytes per cp.async; rows [rows, 64) of a table as zeros
template <int NT>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, long long ld, int tile_rows,
                                          int rows) {
  for (int i = threadIdx.x; i < tile_rows * 8; i += NT) {
    const int row = i >> 3, ch = i & 7;
    bf16* dst = s + swz(row, ch * 8);
    if (row < rows)
      cp_async16(dst, g + row * ld + ch * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// 16 x 64 per warp: acc[nt] += A (16 x 64, fragments a) times the 64 x 64
// matrix whose rows are the n index (keys, or table rows) of tile s
__device__ __forceinline__ void rows_product(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                             const bf16* s, int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, s + swz(np * 16 + (lane & 7) + ((lane >> 4) << 3), ks * 16 + ((lane >> 3) & 1) * 8));
      mma(acc[2 * np], a[ks], b[0], b[1]);
      mma(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// Q times the TAB table rows staged at s (TAB / 64 products of 16 x 64 per
// warp), in log2 units, into the swizzled [BM][TAB] float32 table dst;
// `sync` runs before the stores (dst may overlay s)
template <int TAB>
__device__ __forceinline__ void table_product(float* dst, const uint32_t (&qf)[4][4],
                                              const bf16* s, int warp, int lane, bool sync) {
  const int g = lane >> 2, t = lane & 3;
  float acc[TAB / 64][8][4] = {};
#pragma unroll
  for (int half = 0; half < TAB / 64; ++half) rows_product(acc[half], qf, s + half * 64 * kHead, lane);
  if (sync) __syncthreads();
#pragma unroll
  for (int half = 0; half < TAB / 64; ++half)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h, col = half * 64 + nt * 8 + 2 * t;
        dst[fswz<TAB>(row, col)] = acc[half][nt][2 * h] * kLog2e;
        dst[fswz<TAB>(row, col + 1)] = acc[half][nt][2 * h + 1] * kLog2e;
      }
}

template <int GRID, int TAB>
__global__ void __launch_bounds__(kThreads)
    sam_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                         const bf16* __restrict__ rh, const bf16* __restrict__ rw, int heads,
                         long long stride_qt, long long stride_qn, long long stride_ot,
                         long long stride_on, float scale_log2) {
  constexpr int L = GRID * GRID;
  constexpr int BM = 16 * kWarps;
  constexpr int NT = kThreads;
  constexpr int KROWS = kBlockN / GRID;          // grid rows of keys in a step
  constexpr int NTW = GRID / 8 < 8 ? GRID / 8 : 8;  // n-tiles of distinct key columns
  static_assert(L % BM == 0 && L % kBlockN == 0 && kBlockN % GRID == 0 && GRID % 8 == 0,
                "a step holds whole rows of the grid");
  static_assert(TAB % 64 == 0 && 2 * GRID - 1 <= TAB, "the tables fit TAB rows");

  extern __shared__ __align__(128) unsigned char smem[];
  // [stage][K, V][64 x 64] bfloat16; before the loop Q, then Q Rw^T in float32
  bf16* s_kv = reinterpret_cast<bf16*>(smem);
  // Q Rh^T, [BM][TAB] float32; before the loop the two tables in bfloat16
  float* s_qrh = reinterpret_cast<float*>(smem + 2 * 2 * kBlockN * kHead * sizeof(bf16));
  static_assert(BM * kHead * sizeof(bf16) <= 2 * 2 * kBlockN * kHead * sizeof(bf16), "Q fits");
  static_assert(BM * TAB * sizeof(float) <= 2 * 2 * kBlockN * kHead * sizeof(bf16),
                "Q Rw^T fits");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.y / heads, head = blockIdx.y % heads;
  const int q0 = blockIdx.x * BM;
  const long long width = static_cast<long long>(heads) * kHead;
  const bf16* q_base = qkv + tile * stride_qt + head * kHead;
  const bf16* k_base = q_base + width;
  const bf16* v_base = q_base + 2 * width;

  // Q and the tables into shared memory
  bf16* s_q = s_kv;
  bf16* s_rh = reinterpret_cast<bf16*>(s_qrh);
  bf16* s_rw = s_rh + TAB * kHead;
  load_rows<NT>(s_q, q_base + q0 * stride_qn, stride_qn, BM, BM);
  load_rows<NT>(s_rh, rh, kHead, TAB, 2 * GRID - 1);
  load_rows<NT>(s_rw, rw, kHead, TAB, 2 * GRID - 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's Q fragments, kept in registers for the whole loop
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(qf[ks], s_q + swz(warp * 16 + (lane & 15), ks * 16 + (lane >> 4) * 8));
  __syncthreads();  // Q is read: Q Rw^T may overwrite it

  // Q Rw^T, then Q Rh^T over the tables once they are read, in log2 units
  float* s_qrw = reinterpret_cast<float*>(s_kv);
  table_product<TAB>(s_qrw, qf, s_rw, warp, lane, false);
  table_product<TAB>(s_qrh, qf, s_rh, warp, lane, true);
  __syncthreads();

  // each of this thread's two rows: its grid row, and the Rw terms of the key
  // columns it holds scores of (the same in every step)
  int row_of[2], iy[2];
  float relw[2][NTW][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_of[h] = warp * 16 + g + 8 * h;
    const int m = q0 + row_of[h];
    iy[h] = m / GRID;
    const int ix = m % GRID;
#pragma unroll
    for (int nw = 0; nw < NTW; ++nw)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        relw[h][nw][e] = s_qrw[fswz<TAB>(row_of[h], ix - (nw * 8 + 2 * t + e) + GRID - 1)];
  }
  __syncthreads();  // the ring may now overwrite Q Rw^T

  auto load_kv = [&](int step, int stage) {
    const long long start = static_cast<long long>(step) * kBlockN;
    bf16* s_k = s_kv + stage * 2 * kBlockN * kHead;
    load_rows<NT>(s_k, k_base + start * stride_qn, stride_qn, kBlockN, kBlockN);
    load_rows<NT>(s_k + kBlockN * kHead, v_base + start * stride_qn, stride_qn, kBlockN, kBlockN);
  };

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[8][4] = {};
  constexpr int STEPS = L / kBlockN;
  load_kv(0, 0);
  cp_async_commit();
  for (int step = 0; step < STEPS; ++step) {
    if (step + 1 < STEPS) load_kv(step + 1, (step + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* s_k = s_kv + (step & 1) * 2 * kBlockN * kHead;
    const bf16* s_v = s_k + kBlockN * kHead;

    float s[8][4] = {};
    rows_product(s, qf, s_k, lane);

    // the bias: Rh terms of this step's key rows, Rw terms of its columns
    const int jy0 = step * kBlockN / GRID;
    float relh[2][KROWS];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kr = 0; kr < KROWS; ++kr)
        relh[h][kr] = s_qrh[fswz<TAB>(row_of[h], iy[h] - (jy0 + kr) + GRID - 1)];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int kr = nt * 8 / GRID, nw = nt % NTW;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[nt][2 * h + e] = s[nt][2 * h + e] * scale_log2 + relh[h][kr] + relw[h][nw][e];
    }

    // online softmax, per row over the 4 threads that hold it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      const float alpha = fast_exp2(m_i[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(s[nt][2 * h + e] - m_new);
          s[nt][2 * h + e] = p;
          sum += p;
        }
        acc[nt][2 * h] *= alpha;
        acc[nt][2 * h + 1] *= alpha;
      }
      l_i[h] = l_i[h] * alpha + sum;
      m_i[h] = m_new;
    }

    // P V: P in bfloat16 as the A operand, V by transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, s_v + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, dp * 16 + (lane >> 4) * 8));
        mma(acc[2 * dp], a, b[0], b[1]);
        mma(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is read: the next step's load may refill it
  }

  bf16* o_base = out + tile * stride_ot + head * kHead;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    bf16* o_row = o_base + (q0 + row_of[h]) * stride_on;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(o_row + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2 * h] * inv, acc[nt][2 * h + 1] * inv);
  }
}

// Attention inside each WIN x WIN window of SAM's windowed blocks: the
// windows of the zero-padded token map, gathered by the caller into a
// (windows, WIN^2, 3 W) qkv tensor (a pad token's q, k and v are the qkv
// bias, and it is a key like any other: SAM does not mask it). The same
// mma.sync flash loop as `sam_attention_kernel`, but WIN^2 tokens (196 at
// WIN = 14) fill neither the 64-query blocks nor the 64-key steps, and a
// step does not hold whole rows of the window: each score looks up its two
// bias terms, Q Rh^T[iy - jy] and Q Rw^T[ix - jx], from float32 tables in
// shared memory (both kept for the whole loop), keys past WIN^2 score -inf
// (the first step is always full, so every row's running maximum is finite
// from the start) and queries past it are computed on zero rows and not
// stored. Tables of 2 WIN - 1 rows, staged in 64.
template <int WIN>
__global__ void __launch_bounds__(kThreads)
    sam_window_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                      const bf16* __restrict__ rh, const bf16* __restrict__ rw, int heads,
                      long long stride_qt, long long stride_qn, long long stride_ot,
                      long long stride_on, float scale_log2) {
  constexpr int L = WIN * WIN;
  constexpr int BM = 16 * kWarps;
  constexpr int NT = kThreads;
  constexpr int TAB = 64;
  constexpr int STEPS = (L + kBlockN - 1) / kBlockN;
  static_assert(2 * WIN - 1 <= TAB && L >= kBlockN, "the tables fit 64 rows, a step is full");

  extern __shared__ __align__(128) unsigned char smem[];
  // [stage][K, V][64 x 64] bfloat16; before the loop Q
  bf16* s_kv = reinterpret_cast<bf16*>(smem);
  // Q Rh^T and Q Rw^T, [BM][64] float32 each; before the loop the tables
  float* s_qrh = reinterpret_cast<float*>(smem + 2 * 2 * kBlockN * kHead * sizeof(bf16));
  float* s_qrw = s_qrh + BM * TAB;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.y / heads, head = blockIdx.y % heads;
  const int q0 = blockIdx.x * BM;
  const long long width = static_cast<long long>(heads) * kHead;
  const bf16* q_base = qkv + tile * stride_qt + head * kHead;
  const bf16* k_base = q_base + width;
  const bf16* v_base = q_base + 2 * width;

  bf16* s_q = s_kv;
  bf16* s_rh = reinterpret_cast<bf16*>(s_qrh);
  bf16* s_rw = s_rh + TAB * kHead;
  load_rows<NT>(s_q, q_base + q0 * stride_qn, stride_qn, BM, min(BM, L - q0));
  load_rows<NT>(s_rh, rh, kHead, TAB, 2 * WIN - 1);
  load_rows<NT>(s_rw, rw, kHead, TAB, 2 * WIN - 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldsm_x4(qf[ks], s_q + swz(warp * 16 + (lane & 15), ks * 16 + (lane >> 4) * 8));
  __syncthreads();  // Q is read: the ring may overwrite it
  // Q Rw^T after Q Rh^T: both overlay the tables, so the stores wait for
  // every warp's products
  {
    float qrh[8][4] = {}, qrw[8][4] = {};
    rows_product(qrh, qf, s_rh, lane);
    rows_product(qrw, qf, s_rw, lane);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h, col = nt * 8 + 2 * t;
        s_qrh[fswz<TAB>(row, col)] = qrh[nt][2 * h] * kLog2e;
        s_qrh[fswz<TAB>(row, col + 1)] = qrh[nt][2 * h + 1] * kLog2e;
        s_qrw[fswz<TAB>(row, col)] = qrw[nt][2 * h] * kLog2e;
        s_qrw[fswz<TAB>(row, col + 1)] = qrw[nt][2 * h + 1] * kLog2e;
      }
  }

  // this thread's two rows: the window row and column of each (0 past the
  // window's tokens, whose outputs are not stored)
  int row_of[2], iy[2], ix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_of[h] = warp * 16 + g + 8 * h;
    const int m = q0 + row_of[h];
    iy[h] = m < L ? m / WIN : 0;
    ix[h] = m < L ? m % WIN : 0;
  }

  auto load_kv = [&](int step, int stage) {
    const int start = step * kBlockN;
    const int rows = min(kBlockN, L - start);
    bf16* s_k = s_kv + stage * 2 * kBlockN * kHead;
    load_rows<NT>(s_k, k_base + start * stride_qn, stride_qn, kBlockN, rows);
    load_rows<NT>(s_k + kBlockN * kHead, v_base + start * stride_qn, stride_qn, kBlockN, rows);
  };

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float acc[8][4] = {};
  __syncthreads();  // the tables of Q Rh^T and Q Rw^T are stored
  load_kv(0, 0);
  cp_async_commit();
  for (int step = 0; step < STEPS; ++step) {
    if (step + 1 < STEPS) load_kv(step + 1, (step + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* s_k = s_kv + (step & 1) * 2 * kBlockN * kHead;
    const bf16* s_v = s_k + kBlockN * kHead;

    float s[8][4] = {};
    rows_product(s, qf, s_k, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = step * kBlockN + nt * 8 + 2 * t + e;
        const bool key = j < L;  // past the window's tokens: no key, and no lookup
        const int jy = key ? j / WIN : 0, jx = key ? j % WIN : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float bias = s_qrh[fswz<TAB>(row_of[h], iy[h] - jy + WIN - 1)] +
                             s_qrw[fswz<TAB>(row_of[h], ix[h] - jx + WIN - 1)];
          s[nt][2 * h + e] = key ? s[nt][2 * h + e] * scale_log2 + bias : -INFINITY;
        }
      }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      const float alpha = fast_exp2(m_i[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(s[nt][2 * h + e] - m_new);
          s[nt][2 * h + e] = p;
          sum += p;
        }
        acc[nt][2 * h] *= alpha;
        acc[nt][2 * h + 1] *= alpha;
      }
      l_i[h] = l_i[h] * alpha + sum;
      m_i[h] = m_new;
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, s_v + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, dp * 16 + (lane >> 4) * 8));
        mma(acc[2 * dp], a, b[0], b[1]);
        mma(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  bf16* o_base = out + tile * stride_ot + head * kHead;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int m = q0 + row_of[h];
    if (m >= L) continue;
    const float inv = 1.f / l;
    bf16* o_row = o_base + m * stride_on;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(o_row + nt * 8 + 2 * t) =
          pack_bf16(acc[nt][2 * h] * inv, acc[nt][2 * h + 1] * inv);
  }
}

template <typename Kernel>
int launch(Kernel kernel, int smem, int query_blocks, const bf16* qkv, bf16* out, const bf16* rh,
           const bf16* rw, int tiles, int heads, long long stride_qt, long long stride_qn,
           long long stride_ot, long long stride_on, float scale_log2, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(query_blocks, tiles * heads);
  kernel<<<grid, kThreads, smem, stream>>>(qkv, out, rh, rw, heads, stride_qt, stride_qn,
                                           stride_ot, stride_on, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kRing = 2 * 2 * kBlockN * kHead * sizeof(bf16);  // the K, V ring's bytes
constexpr int kBM = 16 * kWarps;

template <int GRID>
int launch_global(const bf16* qkv, bf16* out, const bf16* rh, const bf16* rw, int tiles, int heads,
                  long long stride_qt, long long stride_qn, long long stride_ot,
                  long long stride_on, float scale_log2, cudaStream_t stream) {
  constexpr int TAB = 2 * GRID - 1 <= 64 ? 64 : 128;
  return launch(sam_attention_kernel<GRID, TAB>, kRing + kBM * TAB * sizeof(float),
                GRID * GRID / kBM, qkv, out, rh, rw, tiles, heads, stride_qt, stride_qn,
                stride_ot, stride_on, scale_log2, stream);
}

template <int WIN>
int launch_window(const bf16* qkv, bf16* out, const bf16* rh, const bf16* rw, int tiles, int heads,
                  long long stride_qt, long long stride_qn, long long stride_ot,
                  long long stride_on, float scale_log2, cudaStream_t stream) {
  return launch(sam_window_kernel<WIN>, kRing + 2 * kBM * 64 * sizeof(float),
                (WIN * WIN + kBM - 1) / kBM, qkv, out, rh, rw, tiles, heads, stride_qt, stride_qn,
                stride_ot, stride_on, scale_log2, stream);
}

}  // namespace

// qkv (tiles, GRID^2, 3 heads 64) and out (tiles, GRID^2, heads 64) with the
// given element strides of a tile and a token; rh, rw (2 GRID - 1, 64),
// contiguous; all bfloat16. GRID 8, 16, 32 or 64: global attention over the
// GRID x GRID map; GRID 14: each "tile" is one 14 x 14 window.
// scale_log2 = log2(e) / sqrt(64).
extern "C" int amt_sam_attention(const void* qkv, void* out, const void* rh, const void* rw,
                                 int tiles, int heads, int grid, long long stride_qt,
                                 long long stride_qn, long long stride_ot, long long stride_on,
                                 float scale_log2, void* stream) {
  if (tiles <= 0 || heads <= 0 || static_cast<long long>(tiles) * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  const bf16* h = static_cast<const bf16*>(rh);
  const bf16* w = static_cast<const bf16*>(rw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (grid) {
    case 8:
      return launch_global<8>(q, o, h, w, tiles, heads, stride_qt, stride_qn, stride_ot,
                              stride_on, scale_log2, st);
    case 14:
      return launch_window<14>(q, o, h, w, tiles, heads, stride_qt, stride_qn, stride_ot,
                               stride_on, scale_log2, st);
    case 16:
      return launch_global<16>(q, o, h, w, tiles, heads, stride_qt, stride_qn, stride_ot,
                               stride_on, scale_log2, st);
    case 32:
      return launch_global<32>(q, o, h, w, tiles, heads, stride_qt, stride_qn, stride_ot,
                               stride_on, scale_log2, st);
    case 64:
      return launch_global<64>(q, o, h, w, tiles, heads, stride_qt, stride_qn, stride_ot,
                               stride_on, scale_log2, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
