// Percentile stretch of segmentation input for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package prepares `batch_segment`'s input on
// the host with numpy (arcadia_microscopy_tools_tpu/models/segmentation.py,
// `_prepare_image`), and so does the port's `SegmentationModel._prepare_image`.
// This kernel moves that preparation onto the card for images that need no
// zoom, for a whole chunk of images at once. Per (image, channel) plane it
// finds the exact order statistics that np.percentile(x, (1, 99)) interpolates
// between, applies numpy's float32 interpolation, and writes
//
//   clip((x - p1) / max(p99 - p1, 1e-6f), 0, 1)
//
// in float32 straight into the (N, Hp, Wp, 3) batch that the U-Net takes: the
// last channel replicated up to 3, the image edge-padded to (Hp, Wp). The
// result equals `_prepare_image`'s bit for bit (up to the sign of zero).
//
// Design: a radix select over the order-preserving 32-bit key of each value's
// float32 cast (NaN takes the largest key: numpy sorts NaN last, and a plane
// with a NaN gives NaN percentiles). Three histogram passes of 11, 11 and 10
// bits (`hist_kernel`) each read every plane once, all planes and all four
// ranks of a plane in one launch: the floor and floor + 1 positions of the
// 1st and 99th percentiles, which numpy interpolates between. In passes 2 and
// 3 a value counts only towards the ranks whose prefix it shares; ranks with
// the same prefix share one histogram (a slot). Histograms live in shared
// memory; each block adds its nonzero bins into the pass's global histogram.
// (On an H100, warp-aggregated atomics, `__match_any_sync`, made a pass 12%
// slower on the benchmark's clustered intensities, and a call 1.5x slower on
// spread ones.)
// After each pass one block per plane
// (`step_kernel`) scans the histograms and fixes the next digit of each rank;
// after the last it interpolates (__fsub_rn / __fmul_rn / __fadd_rn, never
// contracted into an FMA) and writes p1 and the divisor. `stretch_kernel` then
// reads each plane once more and writes the batch, one output row per block.
//
// Bound: bytes. At batch_segment's chunk of 8 float64 2048^2 images: 256 MiB
// read (each input byte once) and 384 MiB written, ~0.20 ms at 3.35 TB/s; the
// algorithm reads the input four times (three passes and the stretch), 1.38
// GiB with the writes, ~0.44 ms. Work per value is a few integer operations.
// The CPU plain version (`stretch_cuda.percentile_stretch_plain`) sorts the
// same keys; the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 2048;  // 11-bit digits; the last pass uses the first 1024
constexpr int kRanks = 4;    // floor, floor + 1 of the 1st and of the 99th percentile
constexpr uint32_t kNanKey = 0xFFFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // a value that counts towards no slot

// int64 fields of a plane: data pointer, values, dtype, the 4 ranks, then the
// float32 bits of (t, 1 - t) of the 1st and of the 99th percentile
constexpr int kPlaneFields = 9;
// int64 fields of an image: data pointer, dtype, channels, h, w, first plane
constexpr int kImageFields = 6;

enum : int { kFloat64 = 0, kFloat32 = 1, kUint16 = 2 };

__device__ __forceinline__ float as_f32(double v) { return __double2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(unsigned short v) { return __uint2float_rn(v); }

// Order-preserving key: -inf < ... < -0 < +0 < ... < +inf < NaN.
__device__ __forceinline__ uint32_t key_of(float f) {
  const uint32_t u = __float_as_uint(f);
  if (f != f) return kNanKey;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ int digit_shift(int pass) { return pass == 0 ? 21 : pass == 1 ? 10 : 0; }

struct Slots {
  uint32_t prefix[kRanks];  // the distinct prefixes of the plane's ranks
  int of_rank[kRanks];      // each rank's slot
  int count;
};

// The slots of `plane` in `pass`, from the state the previous step left
// (every rank has the empty prefix in pass 0).
__device__ void find_slots(const uint32_t* state, int plane, int pass, Slots& s) {
  s.count = 0;
  for (int r = 0; r < kRanks; ++r) {
    const uint32_t pre = pass == 0 ? 0u : state[(plane * kRanks + r) * 2];
    int found = -1;
    for (int j = 0; j < s.count; ++j)
      if (s.prefix[j] == pre) found = j;
    if (found < 0) {
      found = s.count;
      s.prefix[s.count++] = pre;
    }
    s.of_rank[r] = found;
  }
}

// The shared-histogram index a value counts towards in `pass`, or kNone.
__device__ __forceinline__ uint32_t bin_of(float f, int pass, const Slots& s) {
  const uint32_t k = key_of(f);
  if (pass == 0) return k >> 21;
  const int pshift = pass == 1 ? 21 : 10;
  const uint32_t d = (k >> digit_shift(pass)) & (pass == 1 ? 0x7FFu : 0x3FFu);
  for (int j = 0; j < s.count; ++j)
    if ((k >> pshift) == (s.prefix[j] >> pshift)) return j * kBins + d;
  return kNone;
}

__device__ __forceinline__ void count(uint32_t* sh, uint32_t idx) {
  if (idx != kNone) atomicAdd(sh + idx, 1u);
}

template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[kVec]) {
  if constexpr (kVec * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = e[j];
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = __ldg(p + j);
  }
}

// This block's share of one plane into the shared histograms. A thread takes
// kUnroll vectors a step, one grid stride apart, and loads them all before it
// counts any, so enough bytes are in flight.
template <typename T, int kVec>
__device__ void hist_plane(const T* __restrict__ src, long long n, int pass, const Slots& s,
                           uint32_t* sh) {
  constexpr int kUnroll = 4;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long nvec = n / kVec;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i0 = first; i0 < nvec; i0 += stride * kUnroll) {
    T v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * stride < nvec) load_vec<T, kVec>(src + (i0 + u * stride) * kVec, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * stride < nvec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) count(sh, bin_of(as_f32(v[u][j]), pass, s));
      }
  }
  for (long long i = nvec * kVec + first; i < n; i += stride)  // the last n % kVec values
    count(sh, bin_of(as_f32(__ldg(src + i)), pass, s));
}

template <typename T>
__device__ void hist_typed(long long ptr, long long n, int pass, const Slots& s, uint32_t* sh) {
  const T* src = reinterpret_cast<const T*>(ptr);
  if (ptr % 16 == 0)
    hist_plane<T, 16 / sizeof(T)>(src, n, pass, s, sh);
  else
    hist_plane<T, 1>(src, n, pass, s, sh);
}

// grid (blocks per plane, planes): one pass's histograms of every plane.
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const long long* __restrict__ planes, const uint32_t* __restrict__ state,
                uint32_t* __restrict__ hist, int pass, int P) {
  __shared__ uint32_t sh[kRanks * kBins];
  __shared__ Slots s;
  const int plane = blockIdx.y;
  const long long* d = planes + (long long)plane * kPlaneFields;
  if (threadIdx.x == 0) find_slots(state, plane, pass, s);
  __syncthreads();
  const int used = s.count * kBins;
  for (int b = threadIdx.x; b < used; b += kThreads) sh[b] = 0;
  __syncthreads();
  const long long ptr = d[0], n = d[1];
  switch ((int)d[2]) {
    case kFloat64: hist_typed<double>(ptr, n, pass, s, sh); break;
    case kFloat32: hist_typed<float>(ptr, n, pass, s, sh); break;
    default: hist_typed<unsigned short>(ptr, n, pass, s, sh); break;
  }
  __syncthreads();
  uint32_t* g = hist + ((long long)pass * P + plane) * kRanks * kBins;
  for (int b = threadIdx.x; b < used; b += kThreads)
    if (sh[b]) atomicAdd(g + b, sh[b]);
}

// grid (planes): fix each rank's digit of `pass` from that pass's histograms;
// after the last pass, interpolate the percentiles and write (p1, divisor).
__global__ void __launch_bounds__(kThreads)
    step_kernel(const long long* __restrict__ planes, const uint32_t* __restrict__ hist,
                uint32_t* __restrict__ state, float* __restrict__ params, int pass, int P) {
  constexpr int kPer = kBins / kThreads;
  __shared__ Slots s;
  __shared__ uint32_t warp_sum[kThreads / 32];
  __shared__ uint32_t found_digit, found_below;
  const int plane = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long* d = planes + (long long)plane * kPlaneFields;
  if (threadIdx.x == 0) find_slots(state, plane, pass, s);
  __syncthreads();
  const uint32_t* g = hist + ((long long)pass * P + plane) * kRanks * kBins;
  for (int r = 0; r < kRanks; ++r) {
    uint32_t* st = state + (plane * kRanks + r) * 2;
    const uint32_t pre = pass == 0 ? 0u : st[0];
    const uint32_t k = pass == 0 ? (uint32_t)d[3 + r] : st[1];
    const uint32_t* h = g + s.of_rank[r] * kBins + threadIdx.x * kPer;
    uint32_t c[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      c[j] = h[j];
      sum += c[j];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    uint32_t below = incl - sum;
    for (int w = 0; w < warp; ++w) below += warp_sum[w];
    if (k >= below && k - below < sum) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (k - below < c[j]) {
          found_digit = threadIdx.x * kPer + j;
          found_below = below;
          break;
        }
        below += c[j];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      st[0] = pre | (found_digit << digit_shift(pass));
      st[1] = k - found_below;
    }
    __syncthreads();
  }
  if (pass != 2 || threadIdx.x != 0) return;
  // numpy's linear interpolation of a float32 array (numpy >= 2): a + (b - a) * t,
  // or b - (b - a) * (1 - t) where t >= 0.5, each operation rounded alone; a
  // plane holding a NaN gives NaN (the first pass's top bin holds only NaN keys)
  const bool has_nan = hist[(long long)plane * kRanks * kBins + kBins - 1] != 0;
  float p[2];
  for (int q = 0; q < 2; ++q) {
    const float a = value_of(state[(plane * kRanks + 2 * q) * 2]);
    const float b = value_of(state[(plane * kRanks + 2 * q + 1) * 2]);
    const long long bits = d[7 + q];
    const float t = __uint_as_float((uint32_t)(bits & 0xFFFFFFFFll));
    const float omt = __uint_as_float((uint32_t)((unsigned long long)bits >> 32));
    const float diff = __fsub_rn(b, a);
    p[q] = t >= 0.5f ? __fsub_rn(b, __fmul_rn(diff, omt)) : __fadd_rn(a, __fmul_rn(diff, t));
    if (has_nan) p[q] = __uint_as_float(0x7FFFFFFFu);
  }
  const float span = __fsub_rn(p[1], p[0]);
  params[plane * 2] = p[0];
  params[plane * 2 + 1] = (span >= 1e-6f || span != span) ? span : 1e-6f;  // np.maximum
}

// np.clip(v, 0, 1) as numpy computes it: NaN stays NaN, -0 becomes +0.
__device__ __forceinline__ float stretch_one(float x, float p1, float den) {
  float v = __fdiv_rn(__fsub_rn(x, p1), den);
  v = (v != v || v > 0.f) ? v : 0.f;
  return (v != v || v < 1.f) ? v : 1.f;
}

template <typename T>
__device__ void stretch_row(const T* __restrict__ src, int cs, int h, int w, const float* prm,
                            float* __restrict__ row, int Wp, int y) {
  const long long n = (long long)h * w;
  const long long row0 = (long long)min(y, h - 1) * w;
  float p1[3], den[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p1[c] = prm[2 * min(c, cs - 1)];
    den[c] = prm[2 * min(c, cs - 1) + 1];
  }
  for (int x = threadIdx.x; x < Wp; x += kThreads) {
    const long long off = row0 + min(x, w - 1);
    float r[3];
    r[0] = stretch_one(as_f32(__ldg(src + off)), p1[0], den[0]);
#pragma unroll
    for (int c = 1; c < 3; ++c)
      r[c] = c < cs ? stretch_one(as_f32(__ldg(src + c * n + off)), p1[c], den[c]) : r[c - 1];
#pragma unroll
    for (int c = 0; c < 3; ++c) row[x * 3 + c] = r[c];
  }
}

// grid (Hp, images): one output row of one image per block.
__global__ void __launch_bounds__(kThreads)
    stretch_kernel(const long long* __restrict__ images, const float* __restrict__ params,
                   float* __restrict__ out, int Hp, int Wp) {
  const long long* d = images + (long long)blockIdx.y * kImageFields;
  const int y = blockIdx.x;
  const int cs = (int)d[2], h = (int)d[3], w = (int)d[4];
  const float* prm = params + 2 * d[5];
  float* row = out + (((long long)blockIdx.y * Hp + y) * Wp) * 3;
  switch ((int)d[1]) {
    case kFloat64:
      stretch_row(reinterpret_cast<const double*>(d[0]), cs, h, w, prm, row, Wp, y);
      break;
    case kFloat32:
      stretch_row(reinterpret_cast<const float*>(d[0]), cs, h, w, prm, row, Wp, y);
      break;
    default:
      stretch_row(reinterpret_cast<const unsigned short*>(d[0]), cs, h, w, prm, row, Wp, y);
      break;
  }
}

}  // namespace

// planes: int64 (P, 9) and images: int64 (N, 6), device tables as above; hist:
// uint32 (3, P, 4, 2048), zeroed; state: uint32 (P, 4, 2); params: f32 (P, 2);
// out: f32 (N, Hp, Wp, 3). Seven launches on `stream`: three histogram passes,
// each followed by its step, then the stretch. Returns a cudaError_t code.
extern "C" int amt_percentile_stretch(const void* planes, const void* images, void* hist,
                                      void* state, void* params, void* out, int P, int N, int Hp,
                                      int Wp, int blocks_per_plane, void* stream) {
  if (P <= 0 || N <= 0 || P > 65535 || N > 65535 || blocks_per_plane <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* pl = static_cast<const long long*>(planes);
  for (int pass = 0; pass < 3; ++pass) {
    hist_kernel<<<dim3(blocks_per_plane, P), kThreads, 0, st>>>(
        pl, static_cast<const uint32_t*>(state), static_cast<uint32_t*>(hist), pass, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    step_kernel<<<P, kThreads, 0, st>>>(pl, static_cast<const uint32_t*>(hist),
                                         static_cast<uint32_t*>(state),
                                         static_cast<float*>(params), pass, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  stretch_kernel<<<dim3(Hp, N), kThreads, 0, st>>>(static_cast<const long long*>(images),
                                                     static_cast<const float*>(params),
                                                     static_cast<float*>(out), Hp, Wp);
  return (int)cudaGetLastError();
}
