// Masked Jacobi heat diffusion for Hopper (sm_90a), cell by cell on chip.
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
// and the kernels do the same: the four adds in that order, each rounded
// (__fadd_rn), then one __fmaf_rn. T starts at src.
//
// Design. Labels never exchange heat: a neighbour with another label adds +0.
// So a pixel's T after any number of iterations depends only on the pixels of
// its own label and their sources, and each label can be diffused alone, over
// its bounding box, with no halo. Three steps:
//
// 1. Box pass (`diffuse_boxes`, then `diffuse_classify`): one read of the
//    labels, 16 bytes a thread, which also zeroes the output (background
//    stays 0). Each foreground pixel on a label's top, bottom, left or right
//    border (that neighbour has another label) takes part in an atomicMin
//    into a per-image table of boxes, `kBoxLabels` labels deep; each block's
//    largest label goes into a global maximum with one atomic. A label above
//    the table's depth marks its pixels' dense windows (step 3), and so does,
//    over its box, each label whose box does not fit the cell pass.
// 2. Cell pass (`diffuse_cells`): persistent CTAs of 256 threads take
//    (label, image) items from a device-side counter up to the largest label
//    seen, so no host read-back sizes the grid. A label whose box, padded by
//    a ring of one pixel, holds at most `kCellArea` pixels runs all n_iter
//    iterations in shared memory: two f32 buffers of T over the box, read one
//    and write the other, one barrier per iteration. The label's pixels are
//    first listed, so each thread keeps the box offsets (16 bits) and sources
//    of its (up to 16) pixels in registers and an iteration costs what the
//    label holds, not its box. Pixels of other labels and the ring hold +0
//    forever, which is exactly what the reference adds for a neighbour of
//    another label, so the sweep needs no flags and no bounds tests. Its
//    pixels are written at the end.
// 3. Dense branch (`diffuse_dense`): the pixels of labels that do not fit
//    (whole-image cells, a label split between far corners, labels above the
//    table) go through the blocked stencil: `iters` <= `halo` iterations on a
//    128 x 128 window held in shared memory, writing back the (128 - 2*halo)^2
//    interior, one launch per `halo` iterations, over the listed windows only.
//    After k iterations a wrong value at the window edge has moved k pixels
//    inward, so the interior is exact. Only dense pixels count as foreground
//    there and only they are written, so the cell pass's results stand. Every
//    dense pixel lies in a listed window's interior, so a halo pixel of the same
//    label was written by the previous launch. The wrapper copies the number
//    of listed windows to the host after step 1, launches step 2, and then
//    waits for the copy: the card runs the cell pass meanwhile. It launches
//    this branch only when that number is not 0.
//
// Bit for bit: each step computes the reference's arithmetic in the
// reference's order for every pixel it writes, and label independence makes
// the restriction to a box or to dense pixels exact.
//
// Bound: the function must read every label and write every T once, 8 bytes
// per pixel, and read the source of foreground pixels only (a background
// pixel's T is 0 whatever its source): ~8.06 bytes per pixel at the QC's 1.6%
// foreground, 0.081 ms at 8 x 2048^2 and 3.35 TB/s. Its 6 f32 operations per
// foreground pixel per iteration are far less, so bytes bound it. The box pass
// and the zeroing move the 8 bytes per pixel; the cell pass touches only the
// boxes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBoxLabels = 4096;  // box table depth per image (labels 1..kBoxLabels)
constexpr int kCellThreads = 256;
constexpr int kCellPer = 16;                        // a cell's pixels per thread, at most
constexpr int kCellArea = kCellThreads * kCellPer;  // padded box pixels of a cell, at most
constexpr int kEmpty = 0x7F7F7F7F;                  // the table's fill byte 0x7F
constexpr int kWin = 128;
constexpr int kThreads = 1024;
constexpr int kRows = kThreads / kWin;  // window rows per thread step
constexpr int kPer = kWin / kRows;      // pixels per thread
constexpr unsigned kUp = 1u, kDown = 2u, kLeft = 4u, kRight = 8u, kFg = 16u;

// Control block: the next cell item, the largest label seen up to the
// table's depth, the number of listed dense windows, the labels up to the
// table's depth whose box does not fit and those whose box fits, the
// foreground pixels of labels above the table's depth, two words unused (the
// table that follows is 16-byte aligned); then the box table (B x (kBoxLabels + 1) int4s of {ymin, xmin, -ymax, -xmax}), the dense
// window flags (B * nty * ntx ints) and the dense window list (as many).
constexpr int kCtl = 8;

struct Geometry {
  int B, H, W, inner, nty, ntx;
};

__device__ __forceinline__ int4* box_table(int32_t* ctl) {
  return reinterpret_cast<int4*>(ctl + kCtl);
}
__device__ __forceinline__ int32_t* window_flags(int32_t* ctl, int B) {
  return ctl + kCtl + 4 * B * (kBoxLabels + 1);
}

// padded box area of a table entry (the box plus a ring of one pixel)
__device__ __forceinline__ int padded_area(int4 bx) {
  return (-bx.z - bx.x + 3) * (-bx.w - bx.y + 3);
}

__device__ __forceinline__ void mark_window(int32_t* ctl, const Geometry& g, int b, int ty,
                                            int tx) {
  int32_t* flags = window_flags(ctl, g.B);
  const int w = (b * g.nty + ty) * g.ntx + tx;
  if (*reinterpret_cast<volatile int32_t*>(flags + w) == 0 && atomicExch(flags + w, 1) == 0) {
    flags[g.B * g.nty * g.ntx + atomicAdd(ctl + 2, 1)] = w;
  }
}

// One foreground pixel of the box pass: a border pixel takes part in its
// label's box; a label above the table marks its dense window and counts.
__device__ __forceinline__ void box_pixel(const int32_t* __restrict__ lbl, int32_t* ctl,
                                          const Geometry& g, size_t i, int l, int& local_max,
                                          int& above) {
  const size_t hw = (size_t)g.H * g.W;
  const int b = (int)(i / hw);
  const int r = (int)(i - (size_t)b * hw);
  const int y = r / g.W, x = r - y * g.W;
  if (l > kBoxLabels) {
    mark_window(ctl, g, b, y / g.inner, x / g.inner);
    ++above;
    return;
  }
  local_max = max(local_max, l);
  int4* e = box_table(ctl) + (size_t)b * (kBoxLabels + 1) + l;
  if (y == 0 || __ldg(lbl + i - g.W) != l) atomicMin(&e->x, y);
  if (y == g.H - 1 || __ldg(lbl + i + g.W) != l) atomicMin(&e->z, -y);
  if (x == 0 || __ldg(lbl + i - 1) != l) atomicMin(&e->y, x);
  if (x == g.W - 1 || __ldg(lbl + i + 1) != l) atomicMin(&e->w, -x);
}

// Zero the output and find the boxes: 4 pixels per thread and step, by
// 16-byte loads and stores (the batch's last n % 4 pixels one by one).
__global__ void __launch_bounds__(256)
    diffuse_boxes(const int32_t* __restrict__ lbl, float* __restrict__ out,
                  int32_t* __restrict__ ctl, Geometry g) {
  __shared__ int block_max, block_above;
  if (threadIdx.x == 0) block_max = block_above = 0;
  __syncthreads();
  const size_t n = (size_t)g.H * g.W * g.B;
  const size_t n4 = n / 4;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  int local_max = 0, above = 0;
  for (size_t v = (size_t)blockIdx.x * blockDim.x + threadIdx.x; v < n4; v += stride) {
    const int4 l = __ldg(reinterpret_cast<const int4*>(lbl) + v);
    reinterpret_cast<float4*>(out)[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (l.x > 0) box_pixel(lbl, ctl, g, 4 * v, l.x, local_max, above);
    if (l.y > 0) box_pixel(lbl, ctl, g, 4 * v + 1, l.y, local_max, above);
    if (l.z > 0) box_pixel(lbl, ctl, g, 4 * v + 2, l.z, local_max, above);
    if (l.w > 0) box_pixel(lbl, ctl, g, 4 * v + 3, l.w, local_max, above);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const size_t i = 4 * n4 + threadIdx.x;
    out[i] = 0.f;
    if (lbl[i] > 0) box_pixel(lbl, ctl, g, i, lbl[i], local_max, above);
  }
  if (local_max) atomicMax(&block_max, local_max);
  if (above) atomicAdd(&block_above, above);
  __syncthreads();
  if (threadIdx.x == 0 && block_max) atomicMax(ctl + 1, block_max);
  if (threadIdx.x == 0 && block_above) atomicAdd(ctl + 5, block_above);
}

// Each label up to the table's depth whose padded box exceeds the cell pass
// marks the dense windows its box meets; both kinds are counted.
__global__ void __launch_bounds__(256)
    diffuse_classify(int32_t* __restrict__ ctl, Geometry g) {
  const int4* table = box_table(ctl);
  const int n = *reinterpret_cast<volatile int32_t*>(ctl + 1) * g.B;
  for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < n; item += gridDim.x * blockDim.x) {
    const int b = item % g.B, l = item / g.B + 1;
    const int4 bx = table[(size_t)b * (kBoxLabels + 1) + l];
    if (bx.x == kEmpty) continue;
    if (padded_area(bx) <= kCellArea) {
      atomicAdd(ctl + 4, 1);
      continue;
    }
    const int ty0 = bx.x / g.inner, ty1 = -bx.z / g.inner;
    const int tx0 = bx.y / g.inner, tx1 = -bx.w / g.inner;
    for (int ty = ty0; ty <= ty1; ++ty)
      for (int tx = tx0; tx <= tx1; ++tx) mark_window(ctl, g, b, ty, tx);
    atomicAdd(ctl + 3, 1);
  }
}

__global__ void __launch_bounds__(kCellThreads, 6)
    diffuse_cells(const int32_t* __restrict__ lbl, const float* __restrict__ src,
                  float* __restrict__ out, int32_t* __restrict__ ctl, Geometry g, int n_iter) {
  extern __shared__ __align__(16) float cell_smem[];
  float* T0 = cell_smem;
  float* T1 = cell_smem + kCellArea;
  __shared__ int item_s, count_s;
  const int tid = threadIdx.x;
  const int n_items = *reinterpret_cast<volatile int32_t*>(ctl + 1) * g.B;
  const int4* table = box_table(ctl);

  for (;;) {
    __syncthreads();  // the previous item's buffers and item_s are free
    if (tid == 0) {
      item_s = atomicAdd(ctl, 1);
      count_s = 0;
    }
    __syncthreads();
    const int item = item_s;
    if (item >= n_items) break;
    const int b = item % g.B, l = item / g.B + 1;  // label-major: busy items first
    const int4 bx = table[(size_t)b * (kBoxLabels + 1) + l];
    if (bx.x == kEmpty) continue;
    const int y0 = bx.x, x0 = bx.y, y1 = -bx.z, x1 = -bx.w;
    const int pw = x1 - x0 + 3, ph = y1 - y0 + 3, area = pw * ph;
    if (area > kCellArea) continue;  // the dense branch's
    const size_t base = (size_t)b * g.H * g.W + (size_t)(y0 - 1) * g.W + (x0 - 1);
    // the label's pixels, in any order, as a list of box offsets (held in T1
    // until the thread has taken its entries); T0 takes the sources
    int* list = reinterpret_cast<int*>(T1);
    for (int q = tid; q < area; q += kCellThreads) {
      const int py = q / pw, px = q - py * pw;
      float t = 0.f;
      if (py > 0 && py < ph - 1 && px > 0 && px < pw - 1) {
        const size_t gi = base + (size_t)py * g.W + px;
        if (__ldg(lbl + gi) == l) {
          t = __ldg(src + gi);
          list[atomicAdd(&count_s, 1)] = q;
        }
      }
      T0[q] = t;
    }
    __syncthreads();
    const int n_px = count_s;
    const int per = (n_px + kCellThreads - 1) / kCellThreads;  // <= kCellPer
    uint32_t qs[kCellPer / 2];  // two 16-bit box offsets per word
    float s[kCellPer];
#pragma unroll
    for (int j = 0; j < kCellPer; ++j) {
      const int k = tid + j * kCellThreads;
      const int q = j < per && k < n_px ? list[k] : 0;
      if (j % 2 == 0) qs[j / 2] = (uint32_t)q; else qs[j / 2] |= (uint32_t)q << 16;
      s[j] = T0[q];
    }
    __syncthreads();
    for (int q = tid; q < area; q += kCellThreads) T1[q] = 0.f;
    __syncthreads();
    for (int it = 0; it < n_iter; ++it) {
      const float* a = (it & 1) ? T1 : T0;
      float* o = (it & 1) ? T0 : T1;
#pragma unroll
      for (int j = 0; j < kCellPer; ++j) {
        if (j >= per) break;
        if (tid + j * kCellThreads < n_px) {
          const int q = (qs[j / 2] >> (16 * (j % 2))) & 0xFFFF;
          float acc = a[q];
          acc = __fadd_rn(acc, a[q - pw]);
          acc = __fadd_rn(acc, a[q + pw]);
          acc = __fadd_rn(acc, a[q - 1]);
          acc = __fadd_rn(acc, a[q + 1]);
          o[q] = __fmaf_rn(acc, 0.2f, s[j]);
        }
      }
      __syncthreads();
    }
    const float* res = (n_iter & 1) ? T1 : T0;
#pragma unroll
    for (int j = 0; j < kCellPer; ++j) {
      if (j >= per) break;
      if (tid + j * kCellThreads < n_px) {
        const int q = (qs[j / 2] >> (16 * (j % 2))) & 0xFFFF;
        const int py = q / pw, px = q - py * pw;
        out[base + (size_t)py * g.W + px] = res[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    diffuse_dense(const int32_t* __restrict__ lbl, const float* __restrict__ tin,
                  const float* __restrict__ src, float* __restrict__ tout,
                  int32_t* __restrict__ ctl, Geometry g, int halo, int iters) {
  extern __shared__ __align__(16) float smem[];
  float* T = smem;                                     // T, read in even iterations
  float* U = smem + kWin * kWin;                       // T, read in odd iterations
  float* S = smem + 2 * kWin * kWin;                   // the source
  int32_t* L = reinterpret_cast<int32_t*>(U);          // labels, before U holds T

  const int w = window_flags(ctl, g.B)[g.B * g.nty * g.ntx + blockIdx.x];
  const int b = w / (g.nty * g.ntx);
  const int t = w - b * g.nty * g.ntx;
  const int H = g.H, W = g.W;
  const int wy0 = (t / g.ntx) * g.inner - halo;
  const int wx0 = (t % g.ntx) * g.inner - halo;
  const size_t base = (size_t)b * H * W;
  const int4* table = box_table(ctl) + (size_t)b * (kBoxLabels + 1);
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
    // only pixels of labels that the cell pass left count as foreground; a
    // label's pixels are all dense or none, so the same-label tests hold
    const bool dense = l > kBoxLabels || (l > 0 && padded_area(table[l]) > kCellArea);
    unsigned f = dense ? kFg : 0u;
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

  if (lx < halo || lx >= halo + g.inner || gx >= W) return;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int ly = ly0 + r * kRows;
    const int gy = wy0 + ly;
    const unsigned f = (flags[r / 4] >> (8 * (r % 4))) & 0xffu;
    if ((f & kFg) && ly >= halo && ly < halo + g.inner && gy < H)
      tout[base + (size_t)gy * W + gx] = res[ly * kWin + lx];
  }
}

Geometry geometry(int B, int H, int W, int halo) {
  const int inner = kWin - 2 * halo;
  return Geometry{B, H, W, inner, (H + inner - 1) / inner, (W + inner - 1) / inner};
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace

// Int32 words of the control block `ctl` for a (B, H, W) batch.
extern "C" long long amt_diffuse_ctl_words(int B, int H, int W, int halo) {
  const Geometry g = geometry(B, H, W, halo);
  return kCtl + 4LL * B * (kBoxLabels + 1) + 2LL * B * g.nty * g.ntx;
}

// Zero `out`, find the boxes, and list the dense windows. lbl: int32 (B, H,
// W), 16-byte aligned; out: f32 (B, H, W); ctl: int32 scratch of
// amt_diffuse_ctl_words. Once the stream has run it, ctl[2] holds the number
// of dense windows, ctl[3] and ctl[4] the labels (per image) up to the
// table's depth whose box does not fit and fits, and ctl[5] the foreground
// pixels of labels above it. Returns a cudaError_t code.
extern "C" int amt_diffuse_boxes(const void* lbl, void* out, void* ctl, int B, int H, int W,
                                 int halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(B, H, W, halo);
  int32_t* c = static_cast<int32_t*>(ctl);
  const size_t table_bytes = 16ull * B * (kBoxLabels + 1);
  cudaError_t err = cudaMemsetAsync(c, 0, kCtl * sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(c + kCtl, 0x7F, table_bytes, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(c + kCtl + 4 * B * (kBoxLabels + 1), 0,
                          sizeof(int32_t) * (size_t)B * g.nty * g.ntx, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * H * W;
  // 32 blocks of 256 threads per SM keep enough 16-byte loads in flight
  const int box_blocks = (int)std::min<size_t>((n + 1023) / 1024 + 1, (size_t)sm_count() * 32);
  diffuse_boxes<<<box_blocks, 256, 0, s>>>(static_cast<const int32_t*>(lbl),
                                           static_cast<float*>(out), c, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int items = B * kBoxLabels;
  diffuse_classify<<<std::min((items + 255) / 256, sm_count()), 256, 0, s>>>(c, g);
  return (int)cudaGetLastError();
}

// Run every label whose box fits all n_iter >= 1 iterations, after
// amt_diffuse_boxes on the same ctl. src: f32 (B, H, W). Returns a
// cudaError_t code.
extern "C" int amt_diffuse_cells(const void* lbl, const void* src, void* out, void* ctl, int B,
                                 int H, int W, int halo, int n_iter, void* stream) {
  static int per_sm = 0;
  const int smem = 2 * kCellArea * (int)sizeof(float);
  if (per_sm == 0) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, diffuse_cells, kCellThreads, smem);
    if (err != cudaSuccess) return (int)err;
    per_sm = std::max(per_sm, 1);
  }
  diffuse_cells<<<sm_count() * per_sm, kCellThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lbl), static_cast<const float*>(src), static_cast<float*>(out),
      static_cast<int32_t*>(ctl), geometry(B, H, W, halo), n_iter);
  return (int)cudaGetLastError();
}

// One dense pass of `iters` iterations (1 <= iters <= halo <= 32) over the
// `n_windows` windows that amt_diffuse_boxes listed in `ctl`, writing only the
// pixels of labels that did not fit. tout must not alias tin. Returns a
// cudaError_t code.
extern "C" int amt_diffuse_dense(const void* lbl, const void* tin, const void* src, void* tout,
                                 void* ctl, int B, int H, int W, int halo, int iters,
                                 int n_windows, void* stream) {
  const size_t bytes = 3 * (size_t)kWin * kWin * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(diffuse_dense, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  diffuse_dense<<<n_windows, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lbl), static_cast<const float*>(tin),
      static_cast<const float*>(src), static_cast<float*>(tout), static_cast<int32_t*>(ctl),
      geometry(B, H, W, halo), halo, iters);
  return (int)cudaGetLastError();
}
