// Pearson correlation of rows on Hopper, standardisation fused:
//
//   corr[f, t] = mean_m( (X[f,m] - mu_x[f]) / sd_x[f] * (Y[t,m] - mu_y[t]) / sd_y[t] )
//
// with two-pass row statistics (mean, then mean squared deviation) and each
// standard deviation clamped at 1e-12, so a constant row correlates 0.
//
// Replaces the TPU kernel src/repro/kernels/pearson.py::pearson_corr_pallas
// (body `_kernel`, row statistics `_row_stats`), the hot loop of the paper's
// Listing-8 score (PearsonMIScore) on the alternative encoding: one call per
// greedy pick, with T = 1 (the class, then each selected feature's row).
//
// Bound on this card: bytes. At T = 1 each element of X is read once for
// two flops of product and two of statistics: 4 bytes against ~5 flops, far
// below the ~20 flops per byte where the SMs would set the limit. The floor
// is one read of X: 2.0 GB, 0.597 ms, at 50,000 features x 10,000
// observations.
//
// What the design does about it (the streaming path, `pearson_ring_kernel`):
//   * Persistent blocks, one per SM, walk over the feature rows. A block
//     keeps a ring of 2-4 row buffers in shared memory, each filled by one
//     1-D bulk copy (cp.async.bulk, completion counted on an mbarrier): while
//     the block reduces row i, the next rows are in flight, and a buffer is
//     refilled as soon as its row is reduced, so 40-160 KB per SM are on
//     their way at M = 10,000. A bulk copy rather than float4 loads into
//     registers: one thread keeps a whole row in flight without spending
//     registers or the other threads' time on it, and the row must sit in
//     shared memory anyway for the second sweep.
//   * The mean comes from the first sweep over the staged row; the squared
//     deviations and the products against every standardised Y row from a
//     second sweep over the same copy, 16 bytes per access. HBM reads X once.
//   * The standardised Y rows (from a small second kernel, written once per
//     call into a scratch buffer the wrapper allocates) are copied into
//     shared memory once per block, as many as fit beside two row buffers
//     (T = 1 at M = 10,000 is 40 KB); the rest are read from L2. Buffers
//     beyond two take what room is left.
//   * Block sums reduce with warp shuffles and then over the warps in a
//     fixed order, each thread over a fixed set of elements: the result is
//     deterministic, with no atomics across blocks. Only the mean is sent
//     back to every thread; the second sweep's sums go to thread 0 alone,
//     which writes the row's correlations and refills the buffer while the
//     other threads start on the next row.
//   * A bulk copy needs a 16-byte-aligned source and a multiple of 16 bytes.
//     Rows that break that (M or the row stride not a multiple of 4 floats,
//     or a misaligned start) take the scalar staged path instead,
//     `pearson_rows_kernel`: one block per row, the row staged in shared
//     memory by 4-byte loads. Rows too long for the ring (above 24,576
//     floats) take its unstaged form, which reads the row a second time.
//     The wrapper (kernels/pearson.py, `pearson_plan`) picks the path, the
//     number of buffers and the Y rows kept in shared memory.
//   * The product is this kernel's own loop: no matrix library. Y rows go in
//     groups of 4 accumulators, so any T works with bounded registers.
//   * X must be contiguous along M (feature-major rows, any row stride); the
//     alternative engine makes one feature-major copy per fit for this.
//
// Plain C interface, bound with ctypes; every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTGroup = 4;  // Y rows per sweep
constexpr float kEps = 1e-12f;

// Scalar staged path.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Rows longer than this (in floats) are not staged in shared memory.
constexpr int64_t kStageMax = 48 * 1024 / sizeof(float) - kWarps * (kTGroup + 1);

// Streaming path.
constexpr int kRingThreads = 512;
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kRingStagesMax = 4;
constexpr int64_t kRingMax = 24576;  // floats per row: two buffers in 192 KB
constexpr int64_t kSmemMax = 232448;

// Path codes, chosen by the wrapper.
enum Path { kReread = 0, kStaged = 1, kStream = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of K values over W warps; every thread receives the same totals.
template <int K, int W>
__device__ __forceinline__ void block_sum(float (&v)[K], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += scratch[w * K + k];
    v[k] = s;
  }
  __syncthreads();  // scratch may be reused
}

// Sums of K values over W warps into thread 0's v (the other threads' v are
// partial). One barrier: `scratch` is read by thread 0 alone afterwards, so
// the block may go on while it sums.
template <int K, int W>
__device__ __forceinline__ void block_sum_first(float (&v)[K], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int w = 0; w < W; ++w) s += scratch[w * K + k];
      v[k] = s;
    }
  }
}

// ys[t, :] = (Y[t, :] - mean) / max(sd, eps), one block per row.
__global__ void standardize_rows_kernel(const float* __restrict__ y, int64_t m,
                                        int64_t ld_y, float* __restrict__ ys) {
  __shared__ float scratch[kWarps];
  const float* row = y + (int64_t)blockIdx.x * ld_y;
  float* dst = ys + (int64_t)blockIdx.x * m;
  float s[1] = {0.f};
  for (int64_t i = threadIdx.x; i < m; i += kThreads) s[0] += row[i];
  block_sum<1, kWarps>(s, scratch);
  const float mu = s[0] / (float)m;
  float q[1] = {0.f};
  for (int64_t i = threadIdx.x; i < m; i += kThreads) {
    const float d = row[i] - mu;
    q[0] += d * d;
  }
  block_sum<1, kWarps>(q, scratch);
  const float sd = fmaxf(sqrtf(q[0] / (float)m), kEps);
  for (int64_t i = threadIdx.x; i < m; i += kThreads) dst[i] = (row[i] - mu) / sd;
}

template <bool STAGED>
__global__ void pearson_rows_kernel(const float* __restrict__ x, int64_t m, int64_t ld_x,
                                    const float* __restrict__ ys, int t_count,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* scratch = smem;                          // kWarps * (kTGroup + 1)
  float* row_s = smem + kWarps * (kTGroup + 1);   // m floats when STAGED
  const int64_t f = blockIdx.x;
  const float* row = x + f * ld_x;

  float s[1] = {0.f};
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < m; i += kThreads) {
    const float v = row[i];
    if (STAGED) row_s[i] = v;
    s[0] += v;
  }
  block_sum<1, kWarps>(s, scratch);  // its barrier also publishes row_s
  const float mu = s[0] / (float)m;
  const float* src = STAGED ? row_s : row;

  float inv_sd = 0.f;
  for (int t0 = 0; t0 < t_count; t0 += kTGroup) {
    float acc[kTGroup + 1];
#pragma unroll
    for (int u = 0; u <= kTGroup; ++u) acc[u] = 0.f;
    for (int64_t i = threadIdx.x; i < m; i += kThreads) {
      const float d = src[i] - mu;
      if (t0 == 0) acc[kTGroup] += d * d;
#pragma unroll
      for (int u = 0; u < kTGroup; ++u) {
        if (t0 + u < t_count) acc[u] += d * ys[(int64_t)(t0 + u) * m + i];
      }
    }
    block_sum<kTGroup + 1, kWarps>(acc, scratch);
    if (t0 == 0) inv_sd = 1.f / fmaxf(sqrtf(acc[kTGroup] / (float)m), kEps);
    if (threadIdx.x == 0) {
      for (int u = 0; u < kTGroup && t0 + u < t_count; ++u) {
        out[f * t_count + t0 + u] = acc[u] * inv_sd / (float)m;
      }
    }
  }
}

// The streaming path: m a multiple of 4 and at most kRingMax, every row
// 16-byte aligned. Shared memory: the ring (stages * m floats), the first
// y_rows standardised Y rows (y_rows * m floats; the others are read from
// L2), two reduction scratch areas, then the ring's barriers. TG Y rows per
// sweep (1 when T = 1, else kTGroup).
template <int TG>
__global__ void __launch_bounds__(kRingThreads, 1)
pearson_ring_kernel(const float* __restrict__ x, int64_t f_count, int m, int64_t ld_x,
                    const float* __restrict__ ys, int t_count, int stages, int y_rows,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const float4* y_s = reinterpret_cast<const float4*>(ring + stages * m);
  float* mean_scratch = ring + (stages + y_rows) * m;  // kRingWarps
  float* prod_scratch = mean_scratch + kRingWarps;     // kRingWarps * (TG + 1)
  const uint32_t bars = smem_u32(mean_scratch + kRingWarps * (kTGroup + 2));
  const int m4 = m / 4;
  const uint32_t row_bytes = (uint32_t)m * 4;
  const float4* yg = reinterpret_cast<const float4*>(ys);

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(bars + 8 * st, 1);
    mbar_fence_init();
    for (int st = 0; st < stages; ++st) {
      const int64_t f = blockIdx.x + (int64_t)st * gridDim.x;
      if (f < f_count) {
        mbar_expect_tx(bars + 8 * st, row_bytes);
        bulk_load(smem_u32(ring + st * m), x + f * ld_x, row_bytes, bars + 8 * st);
      }
    }
  }
  for (int i = threadIdx.x; i < y_rows * m4; i += kRingThreads) {
    const_cast<float4*>(y_s)[i] = yg[i];
  }
  __syncthreads();

  int i = 0;
  for (int64_t f = blockIdx.x; f < f_count; f += gridDim.x, ++i) {
    const int st = i % stages;
    const float4* row = reinterpret_cast<const float4*>(ring + st * m);
    mbar_wait(bars + 8 * st, (i / stages) & 1);

    float s[1] = {0.f};
    for (int e = threadIdx.x; e < m4; e += kRingThreads) {
      const float4 v = row[e];
      s[0] += (v.x + v.y) + (v.z + v.w);
    }
    block_sum<1, kRingWarps>(s, mean_scratch);
    const float mu = s[0] / (float)m;

    float inv_sd = 0.f;  // thread 0's
    for (int t0 = 0; t0 < t_count; t0 += TG) {
      float acc[TG + 1];
#pragma unroll
      for (int u = 0; u <= TG; ++u) acc[u] = 0.f;
      // Unrolled so that several iterations' Y loads are in flight at once:
      // with one block of 16 warps per SM, a Y row read from L2 is latency-bound.
#pragma unroll 4
      for (int e = threadIdx.x; e < m4; e += kRingThreads) {
        const float4 v = row[e];
        const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
        if (t0 == 0) acc[TG] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
#pragma unroll
        for (int u = 0; u < TG; ++u) {
          const int tu = t0 + u;
          if (TG == 1 || tu < t_count) {
            const int64_t at = (int64_t)tu * m4 + e;
            const float4 w = tu < y_rows ? y_s[at] : yg[at];  // shared copy, else L2
            acc[u] += (d0 * w.x + d1 * w.y) + (d2 * w.z + d3 * w.w);
          }
        }
      }
      // After its barrier every thread is past its reads of the row.
      block_sum_first<TG + 1, kRingWarps>(acc, prod_scratch);
      if (threadIdx.x == 0) {
        if (t0 == 0) inv_sd = 1.f / fmaxf(sqrtf(acc[TG] / (float)m), kEps);
        for (int u = 0; u < TG && t0 + u < t_count; ++u) {
          out[f * t_count + t0 + u] = acc[u] * inv_sd / (float)m;
        }
        // Refill this buffer; thread 0 reaches the next barrier (the next
        // row's mean) before anyone writes prod_scratch again.
        const int64_t next = f + (int64_t)stages * gridDim.x;
        if (t0 + TG >= t_count && next < f_count) {
          fence_proxy_async();
          mbar_expect_tx(bars + 8 * st, row_bytes);
          bulk_load(smem_u32(ring + st * m), x + next * ld_x, row_bytes, bars + 8 * st);
        }
      }
      if (t0 + TG < t_count) __syncthreads();  // prod_scratch is reused by the next group
    }
  }
}

template <int TG>
int launch_ring(const float* x, int64_t f_count, int64_t m, int64_t ld_x, const float* ys,
                int t_count, int stages, int y_rows, float* out, cudaStream_t s) {
  const size_t bytes = sizeof(float) * ((size_t)(stages + y_rows) * m +
                                        kRingWarps * (kTGroup + 2)) + 8 * stages;
  if (m % 4 != 0 || m > kRingMax || (f_count > 1 && ld_x % 4 != 0) ||
      (uintptr_t)x % 16 != 0 || stages < 2 || stages > kRingStagesMax || y_rows < 0 ||
      y_rows > t_count || bytes > (size_t)kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = pearson_ring_kernel<TG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = f_count < sms ? f_count : sms;
  kernel<<<(unsigned)grid, kRingThreads, bytes, s>>>(x, f_count, (int)m, ld_x, ys, t_count,
                                                     stages, y_rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (f_count, m) float32 rows, contiguous along m, rows `ld_x` apart.
// y: (t_count, m) float32 rows, contiguous along m, rows `ld_y` apart.
// ys: scratch of t_count * m floats. out: contiguous (f_count, t_count).
// path: 0 reread, 1 scalar staged, 2 streaming through a ring of `stages`
// row buffers with the first `y_rows` Y rows in shared memory (the
// wrapper's `pearson_plan`); a path whose conditions the arguments break
// returns cudaErrorInvalidValue.
extern "C" int pearson_corr_launch(const void* x, int64_t f_count, int64_t m, int64_t ld_x,
                                   const void* y, int t_count, int64_t ld_y, void* ys,
                                   void* out, int path, int stages, int y_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ysf = static_cast<float*>(ys);
  standardize_rows_kernel<<<(unsigned)t_count, kThreads, 0, s>>>(
      static_cast<const float*>(y), m, ld_y, ysf);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t scratch = kWarps * (kTGroup + 1) * sizeof(float);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  switch (path) {
    case kStream:
      if (t_count == 1) return launch_ring<1>(xf, f_count, m, ld_x, ysf, 1, stages, y_rows, o, s);
      return launch_ring<kTGroup>(xf, f_count, m, ld_x, ysf, t_count, stages, y_rows, o, s);
    case kStaged:
      if (m > kStageMax) return (int)cudaErrorInvalidValue;
      pearson_rows_kernel<true><<<(unsigned)f_count, kThreads, scratch + m * sizeof(float), s>>>(
          xf, m, ld_x, ysf, t_count, o);
      return (int)cudaGetLastError();
    case kReread:
      pearson_rows_kernel<false><<<(unsigned)f_count, kThreads, scratch, s>>>(
          xf, m, ld_x, ysf, t_count, o);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}
